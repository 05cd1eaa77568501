"""Port parity: the zoo's mobile and grouped networks (repro_torch.core.zoo).

As ``tests/test_torch_zoo_nets.py``, for the layer kinds of the lightweight
nets: SAME average pooling with stride 2 and the channel shuffle
(shufflenet_v1), the channel split and shuffle (shufflenet_v2), stride-2
SAME depthwise convolutions and relu6 (mobilenet_v2), grouped convolutions
(resnext29), swish and squeeze-excitation in MBConv blocks
(efficientnet_lite0), and a 9x9 depthwise mixer with an even 2x2 stride-2
stem (convmixer_lite).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, zoo_parity  # noqa: E402,F401


@pytest.mark.parametrize("name", ["shufflenet_v1", "shufflenet_v2", "mobilenet_v2", "resnext29",
                                  "efficientnet_lite0"])
def test_zoo_net_matches_reference(name):
    zoo_parity(name)


def test_convmixer_matches_reference():
    zoo_parity("convmixer_lite", grad_dtype="float32")
