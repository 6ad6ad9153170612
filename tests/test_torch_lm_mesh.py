"""The LM on a mesh (dense and VLM families): the port's sharded train
step, prefill and decode on 2 gloo ranks, as ``1x2`` and ``2x1`` (data x
model), held against the unsharded reference.

One spawn of ranks a mesh runs every case of the file
(``tests/mesh_worker.py`` ``lm``; the reference's answers from
``tests/lm_mesh_cases.py``): the loss and every gradient, two AdamW steps
(qwen3-0.6b with ``grad_compress``), prefill and 8 greedy decode steps,
and for qwen3-0.6b the same under ``seq_sharded_kv`` (the caches' sequence
over the data axis).  Every rank asserts that its parameters, gradients,
AdamW moments and caches have the local shapes the reference's rules give
them, and that some of each are split.

Tolerances (float32 on both sides): loss, xent and aux ``rtol=1e-5``; each
gradient leaf within 1e-4 of the leaf's largest |value|, or, where float32
itself is that far off (falcon's ``a_log``: the reference stands 1.0e-4
from a float64 run of the port), at most twice as far from the float64
run as the reference's; after each step
every parameter within 1e-2 of its leaf's largest |update| (Adam eps 1e-4,
as ``test_torch_lm_train.py``); with ``grad_compress`` the int8 round trip
rounds g / scale half to even, so a rounding of the sharded sums can move
an element across a rounding boundary (one quantum of its gradient): at
most one element or 1e-3 of a leaf's elements may then exceed that bound,
each within 0.5 of the leaf's largest update (measured: one of 16384 in
``w_down`` at 1x2, 5.9% of it); logits ``rtol=1e-4, atol=1e-4``, caches
with ``atol`` times their largest |value| (a sharded contraction sums
d_model in another order: deepseek's K cache, up to 17, was 2e-4 off in
one element), the SSM state ``rtol=1e-3``; greedy tokens equal.
"""

import lm_mesh_cases


def test_dense_and_vlm_on_two_ranks(tmp_path):
    lm_mesh_cases.run(tmp_path, [
        {"arch": "qwen3-0.6b", "grad_compress": True, "seq_sharded_kv": True},
        {"arch": "internvl2-2b"},
    ], meshes=[(1, 2), (2, 1)])
