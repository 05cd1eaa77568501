"""Port parity: the zoo's networks (repro_torch.core.zoo), plain layer kinds.

The reference's parameters are carried across by ``zoo_params_from_jax``;
one batch of 4 at 32 px goes through both packages: fp32 logits and loss,
and gradients in float64 (see ``_torch_parity.zoo_parity`` for why and for
the tolerances). The mobile and grouped nets are in
``tests/test_torch_zoo_mobile.py``; every net of the zoo runs in the
``slow`` sweep below.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, zoo_parity  # noqa: E402,F401
from repro_torch.core.zoo import ZOO  # noqa: E402

# one net per layer kind: Flatten, VALID conv with bias, tanh and avg pool
# (lenet5); Fire branches (squeezenet); SAME 3x3 max pool in inception
# branches (googlenet); squeeze-excitation (se_resnet18); pre-activation
# blocks (preact_resnet18); dense blocks and 2x2 avg pools (densenet63); a
# scaled residual (stochastic_depth34)
NETS = ["lenet5", "squeezenet", "googlenet", "se_resnet18", "preact_resnet18", "densenet63",
        "stochastic_depth34"]


@pytest.mark.parametrize("name", NETS)
def test_zoo_net_matches_reference(name):
    zoo_parity(name)


@pytest.mark.slow  # all 29 nets: the deep ResNets' XLA compiles take minutes on the CPU
@pytest.mark.parametrize("name", sorted(ZOO))
def test_every_zoo_net_matches_reference(name):
    zoo_parity(name, grad_dtype="float32" if name == "convmixer_lite" else "float64",
               fwd_dtype="float64" if name in ("resnet101", "resnet152") else "float32")
