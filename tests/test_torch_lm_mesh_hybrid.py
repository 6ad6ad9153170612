"""The LM on a mesh (hybrid family): ``test_torch_lm_mesh.py``'s checks,
with its tolerances, for jamba-1.5-large-398b at ``reduced()`` (one period
block: attention, seven mamba sublayers, MLPs and MoEs) on 2 gloo ranks as
``1x2`` and ``2x1``, also under ``seq_sharded_kv``.  Its weights are the
reference's rescaled to std 1/sqrt(d_model) (``test_torch_lm_train.py``'s
``rescaled``): at the reference's init float32 itself is ill-conditioned
there (``test_torch_lm_serve.py``).
"""

import lm_mesh_cases


def test_hybrid_on_two_ranks(tmp_path):
    lm_mesh_cases.run(tmp_path, [{"arch": "jamba-1.5-large-398b", "seq_sharded_kv": True}],
                      meshes=[(1, 2), (2, 1)])
