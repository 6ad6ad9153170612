"""The LM on a mesh of 4 gloo ranks (``2x2``, data x model): the dense
model and the MoE model with the ``local_index`` dispatch (each data
shard sorts and scatters its own tokens; the dispatch block's all-to-all
to the tp-sharded experts) against the unsharded reference, with
``test_torch_lm_mesh.py``'s checks and tolerances.  Every rank asserts its
local shapes: on 2x2 ``wq`` is split on both d_model (fsdp) and heads
(tp), the expert stacks on experts (tp) and d_model (fsdp).
"""

import lm_mesh_cases


def test_dense_and_local_index_moe_on_four_ranks(tmp_path):
    lm_mesh_cases.run(tmp_path, [{"arch": "qwen3-0.6b"},
                                 {"arch": "deepseek-moe-16b", "moe_dispatch": "local_index"}],
                      meshes=[(2, 2)])


def test_kv_heads_the_model_axis_does_not_divide(tmp_path):
    """1 KV head over a 2-way ``model`` axis (2x2) and 2 over a 4-way one
    (1x4, the reference's small-mesh head split): the KV projections and
    K/V run replicated over ``model`` (``_sanitize``) while the query heads
    shard, and each rank attends its query heads' KV heads."""
    lm_mesh_cases.run_each(tmp_path, [
        ({"arch": "qwen3-0.6b", "n_kv_heads": 1}, (2, 2)),
        ({"arch": "qwen3-0.6b", "n_kv_heads": 2}, (1, 4))])
