"""The LM on a mesh (encoder-decoder and audio families):
``test_torch_lm_mesh.py``'s checks, with its tolerances, for
seamless-m4t-medium as ``audio`` (its config) and as ``encdec`` on 2 gloo
ranks as ``1x2`` and ``2x1``: the encoder, cross attention and the static
cross caches (``ck``/``cv``, placed as the self-attention caches).  Its
weights are the reference's rescaled to std 1/sqrt(d_model), as
``test_torch_lm_train_encdec.py`` holds it; its caches with ``atol`` times
their largest |value|.
"""

import lm_mesh_cases


def test_audio_and_encdec_on_two_ranks(tmp_path):
    lm_mesh_cases.run(tmp_path, [{"arch": "seamless-m4t-medium"},
                                 {"arch": "seamless-m4t-medium", "family": "encdec"}],
                      meshes=[(1, 2), (2, 1)])
