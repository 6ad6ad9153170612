"""The LM on a mesh (MoE and SSM families): ``test_torch_lm_mesh.py``'s
checks, with its tolerances, for deepseek-moe-16b (the ``index``
dispatch: a global sort of replicated tokens, its expert products on the
tp-sharded stacks) and falcon-mamba-7b (the selective scan on each rank's
d_inner shard), on 2 gloo ranks as ``1x2`` and ``2x1``.  Routed expert ids
equal the reference's but where its top-k margin is below 1e-5 (counted,
at most 1e-3 of the routed slots); the SSM state ``rtol=1e-3, atol=2e-4``
and falcon's caches with ``atol`` times their largest |value|, as
``test_torch_lm_serve.py`` holds them.
"""

import lm_mesh_cases


def test_moe_and_ssm_on_two_ranks(tmp_path):
    lm_mesh_cases.run(tmp_path, [{"arch": "deepseek-moe-16b"},
                                 {"arch": "falcon-mamba-7b"}], meshes=[(1, 2), (2, 1)])
