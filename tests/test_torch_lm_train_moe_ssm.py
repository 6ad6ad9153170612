"""The port's LM training path for the MoE and SSM families held against
the JAX package on the CPU: ``test_torch_lm_train.py``'s ``family_case``
(loss and every gradient leaf, then two train steps) for deepseek-moe-16b
(index dispatch, the load-balance aux) and falcon-mamba-7b at
``reduced()`` and the reference's init, and the naive MoE dispatch's
gradients, with that file's tolerances.
"""

from test_torch_lm_train import (assert_loss_and_grads, configs, family_case,
                                 reference_weights, train_batch)


def test_moe_loss_grads_and_two_steps_match_reference():
    family_case("deepseek-moe-16b")


def test_moe_dense_dispatch_grads_match_reference():
    """The naive dispatch (every expert on every token) takes a gradient too."""
    jc, tc = configs("deepseek-moe-16b", moe_dispatch="dense")
    assert_loss_and_grads(jc, tc, reference_weights(jc), train_batch(tc))


def test_ssm_loss_grads_and_two_steps_match_reference():
    family_case("falcon-mamba-7b")
