"""The port's LM training path for the hybrid family held against the JAX
package on the CPU: ``test_torch_lm_train.py``'s ``family_case`` for
jamba-1.5-large-398b at ``reduced()``, with that file's tolerances.

jamba at ``reduced()`` is one period block, so the reference's init draws
every mamba and MLP leaf at std 1 (ROADMAP queue 3) and float32 is
ill-conditioned there: at that init its gradients are held against a
float64 run of the port (the port's float32 at most twice as far from it
as the reference's over all leaves, the two packages within 5e-2 of each
leaf's largest |value|), and after one step at that init the two
packages' losses part by some 5%.  The tolerances of the file then hold
it on the same arrays rescaled to std 1/sqrt(d_model), which both
packages take.
"""

from test_torch_lm_train import family_case


def test_hybrid_loss_grads_and_two_steps_match_reference():
    family_case("jamba-1.5-large-398b", ill_conditioned=True)
