"""The port's LM training path for the encoder-decoder families held
against the JAX package on the CPU: ``test_torch_lm_train.py``'s
``family_case`` for seamless-m4t-medium at ``reduced()`` as the registry
has it (``audio``: the encoder fed stub frames) and as ``encdec`` (the
same stacks under the other family name), with that file's tolerances.

The reference's init draws the stacked attention and MLP leaves at
1/sqrt(layers) (ROADMAP queue 3), so each softmax over the 40 encoder
frames is near an argmax and float32 rounds visibly: both packages'
gradients lie 2e-4 to 5e-4 of their largest value from a float64 run.
At that init the gradients are held against the float64 run (the port's
float32 at most twice as far from it as the reference's over all leaves,
the two packages within 5e-2); the tolerances of the file then hold the same arrays
rescaled to std 1/sqrt(d_model), which both packages take.
"""

import pytest

from test_torch_lm_train import family_case


@pytest.mark.parametrize("family", ["audio", "encdec"])
def test_encdec_loss_grads_and_two_steps_match_reference(family):
    family_case("seamless-m4t-medium", family=family, ill_conditioned=True)
