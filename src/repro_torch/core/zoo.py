"""The paper's 29 classic CNNs, in PyTorch (CIFAR-scale).

Port of ``repro.core.zoo``. The reference's layers take their input width in
a stateful ``spec(cin)``; here a layer is an ``nn.Module`` built for its
input width, and everything it holds (parameters, sub-layers, a residual's
projection) is made in ``__init__``. The networks are written as in the
reference, with recipes: ``Conv.of(64, 3)`` is a convolution waiting for
its input width, and ``recipe.build(cin)`` makes the module. A recipe
repeated in a list builds a new module, with its own parameters, each time.

Layout: activations are NCHW, torch's native convolution layout, contiguous
(``channels_last`` is left to a later performance change); the reference
computes in NHWC. The functions agree up to that transpose
of the input: channel concatenation runs on axis 1, the channel shuffle
groups the same channels, and ``Flatten`` permutes to NHWC before it
flattens, so the Dense after it takes the reference's rows in their order.
Parameters keep the reference's initialisers and fan-in scales; conv
weights are OIHW (``zoo_params_from_jax`` carries the reference's HWIO ones
across, for grouped and depthwise convolutions as well: both packages group
the output channels in consecutive blocks).

Where a straight translation would compute another function:
  - SAME padding is the reference's: ``lo = total // 2``, ``hi = total - lo``,
    so a 3x3 stride-2 conv on 32 px pads (0, 1); uneven padding goes through
    ``F.pad`` and a VALID convolution or pooling;
  - SAME max pooling pads with -inf; SAME average pooling pads with zeros and
    divides by k * k (the padding counts in the average);
  - BN normalises with the batch's own statistics (population variance, eps
    1e-5, no running statistics), in plain ops as the reference.

The unseen-model split of Fig. 13 (InceptionV3, StochasticDepth-34,
ResNet-50, PreActResNet-152, SE-ResNet-34) matches the paper exactly.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.models.module import ParamSpec, init_params, spec


class Recipe:
    """A layer waiting for its input width: ``build(cin)`` makes the module."""

    def __init__(self, cls, *args, **kwargs):
        self.cls, self.args, self.kwargs = cls, args, kwargs

    def build(self, cin: int) -> "Layer":
        return self.cls(cin, *self.args, **self.kwargs)


def _built(recipes, cin: int) -> Tuple[List["Layer"], int]:
    """Build recipes one after another, each on the last one's output width."""
    layers = []
    for r in recipes:
        if r is not None:
            layers.append(r.build(cin))
            cin = layers[-1].cout
    return layers, cin


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _padded(x, k: int, stride: int, pad: str, value: float):
    """``x`` with uneven SAME padding applied; the even padding left to the
    operator. Returns (x, padding for the operator)."""
    if pad == "VALID":
        return x, 0
    (hl, hh), (wl, wh) = (_same_pads(n, k, stride) for n in x.shape[2:])
    if hl == hh == wl == wh:
        return x, hl
    return F.pad(x, (wl, wh, hl, hh), value=value), 0


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """A layer built for input width ``cin``; ``cout`` is its output width.

    ``specs`` holds the ParamSpecs of its own parameters, registered as
    meta tensors of those names: a model's values live outside it (``ZooModel``
    applies the network functionally). ``ref_tree`` gives the reference's
    parameter tree of the layer, with this port's parameter names as leaves.
    """

    def __init__(self, cin: int):
        super().__init__()
        self.cin = self.cout = cin
        self.specs: Dict[str, ParamSpec] = {}

    @classmethod
    def of(cls, *args, **kwargs) -> Recipe:
        return Recipe(cls, *args, **kwargs)

    def _param(self, name: str, ps: ParamSpec) -> None:
        self.specs[name] = ps
        self.register_parameter(name, nn.Parameter(torch.empty(ps.shape, device="meta")))

    def ref_tree(self, prefix: str):
        return {k: prefix + k for k in self.specs}


class Conv(Layer):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, bias=False, pad="SAME"):
        super().__init__(cin)
        self.cout, self.k, self.stride = cout, k, stride
        self.groups, self.pad = groups, pad
        fan_in = k * k * cin // groups  # the reference's HWIO fan-in
        self._param("w", spec((cout, cin // groups, k, k), (None,) * 4, scale=fan_in ** -0.5))
        if bias:
            self._param("b", spec((cout,), (None,), "zeros"))

    def forward(self, x):
        x, padding = _padded(x, self.k, self.stride, self.pad, 0.0)
        y = F.conv2d(x, self.w, None, self.stride, padding, groups=self.groups)
        if "b" in self.specs:
            y = y + self.b[:, None, None]
        return y


class Depthwise(Conv):
    def __init__(self, cin, k=3, stride=1, bias=False):
        super().__init__(cin, cin, k, stride, groups=cin, bias=bias)


class BN(Layer):
    def __init__(self, cin):
        super().__init__(cin)
        self._param("g", spec((cin,), (None,), "ones"))
        self._param("b", spec((cin,), (None,), "zeros"))

    def forward(self, x):
        mu = x.mean((0, 2, 3), keepdim=True)
        var = x.var((0, 2, 3), correction=0, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * self.g[:, None, None] + self.b[:, None, None]


_ACTS = {"relu": torch.relu, "relu6": F.relu6, "swish": F.silu, "tanh": torch.tanh}


class Act(Layer):
    def __init__(self, cin, kind="relu"):
        super().__init__(cin)
        self.kind = kind

    def forward(self, x):
        return _ACTS[self.kind](x)


class Pool(Layer):
    def __init__(self, cin, kind="max", k=2, stride=None, pad="VALID"):
        super().__init__(cin)
        self.kind, self.k = kind, k
        self.stride = stride or k
        self.pad = pad

    def forward(self, x):
        if self.kind == "max":
            x, padding = _padded(x, self.k, self.stride, self.pad, -float("inf"))
            return F.max_pool2d(x, self.k, self.stride, padding)
        x, padding = _padded(x, self.k, self.stride, self.pad, 0.0)
        return F.avg_pool2d(x, self.k, self.stride, padding, count_include_pad=True)


class Flatten(Layer):
    """Flatten HxWxC -> features; spatial extent given statically. The map
    is permuted to NHWC first, so the features come in the reference's order."""

    def __init__(self, cin, spatial: int):
        super().__init__(cin)
        self.cout = cin * spatial * spatial

    def forward(self, x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class GlobalAvg(Layer):
    def forward(self, x):
        return x.mean((2, 3))


class Dense(Layer):
    def __init__(self, cin, cout):
        super().__init__(cin)
        self.cout = cout
        self._param("w", spec((cin, cout), (None, None)))
        self._param("b", spec((cout,), (None,), "zeros"))

    def forward(self, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return x @ self.w + self.b


class Seq(Layer):
    def __init__(self, cin, *recipes):
        super().__init__(cin)
        layers, self.cout = _built(recipes, cin)
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def ref_tree(self, prefix):
        return [l.ref_tree(f"{prefix}layers.{i}.") for i, l in enumerate(self.layers)]


class Residual(Layer):
    """x + f(x), with an optional 1x1 projection when shape changes."""

    def __init__(self, cin, inner: Recipe, stride=1, scale=1.0):
        super().__init__(cin)
        self.f = inner.build(cin)
        self.cout, self.scale = self.f.cout, scale
        self.proj = None
        if self.cout != cin or stride != 1:
            self.proj = Seq(cin, Conv.of(self.cout, 1, stride), BN.of())

    def forward(self, x):
        y = self.f(x)
        sc = x if self.proj is None else self.proj(x)
        return sc + self.scale * y

    def ref_tree(self, prefix):
        return {"f": self.f.ref_tree(prefix + "f."),
                "proj": {} if self.proj is None else self.proj.ref_tree(prefix + "proj.")}


class Branches(Layer):
    """Parallel branches, channel-concatenated (Inception / Fire)."""

    def __init__(self, cin, *recipes):
        super().__init__(cin)
        self.branches = nn.ModuleList(r.build(cin) for r in recipes)
        self.cout = sum(b.cout for b in self.branches)

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], dim=1)

    def ref_tree(self, prefix):
        return [b.ref_tree(f"{prefix}branches.{i}.") for i, b in enumerate(self.branches)]


class SE(Layer):
    """Squeeze-and-excitation."""

    def __init__(self, cin, r=4):
        super().__init__(cin)
        hid = max(4, cin // r)
        self._param("w1", spec((cin, hid), (None, None)))
        self._param("w2", spec((hid, cin), (None, None)))

    def forward(self, x):
        s = x.mean((2, 3))
        s = torch.relu(s @ self.w1)
        s = torch.sigmoid(s @ self.w2)
        return x * s[:, :, None, None]


class Shuffle(Layer):
    def __init__(self, cin, groups):
        super().__init__(cin)
        self.g = groups

    def forward(self, x):
        b, c, h, w = x.shape
        return x.reshape(b, self.g, c // self.g, h, w).transpose(1, 2).reshape(b, c, h, w)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def cbr(cout, k=3, stride=1, groups=1, act="relu"):
    return Seq.of(Conv.of(cout, k, stride, groups), BN.of(), Act.of(act))


def basic_block(cout, stride=1, se=False, scale=1.0):
    inner = Seq.of(Conv.of(cout, 3, stride), BN.of(), Act.of(),
                   Conv.of(cout, 3), BN.of(), SE.of() if se else None)
    return Seq.of(Residual.of(inner, stride, scale), Act.of())


def bottleneck(cout, stride=1, expansion=4, se=False):
    inner = Seq.of(Conv.of(cout, 1), BN.of(), Act.of(),
                   Conv.of(cout, 3, stride), BN.of(), Act.of(),
                   Conv.of(cout * expansion, 1), BN.of(), SE.of() if se else None)
    return Seq.of(Residual.of(inner, stride), Act.of())


def preact_basic(cout, stride=1):
    return Residual.of(Seq.of(BN.of(), Act.of(), Conv.of(cout, 3, stride),
                              BN.of(), Act.of(), Conv.of(cout, 3)), stride)


def preact_bottleneck(cout, stride=1, expansion=4):
    return Residual.of(Seq.of(BN.of(), Act.of(), Conv.of(cout, 1),
                              BN.of(), Act.of(), Conv.of(cout, 3, stride),
                              BN.of(), Act.of(), Conv.of(cout * expansion, 1)), stride)


def inception(c1, c3r, c3, c5r, c5, pp):
    return Branches.of(
        cbr(c1, 1),
        Seq.of(cbr(c3r, 1), cbr(c3, 3)),
        Seq.of(cbr(c5r, 1), cbr(c5, 5)),
        Seq.of(Pool.of("max", 3, 1, "SAME"), cbr(pp, 1)))


def fire(s1, e1, e3):
    return Seq.of(cbr(s1, 1), Branches.of(cbr(e1, 1), cbr(e3, 3)))


class _SeqBlock(Layer):
    """A block whose layers are one ``Seq``, with a residual add when it keeps
    the shape (the reference's closure-built ``_Inv`` and ``_MB``)."""

    def __init__(self, cin, cout, stride, *recipes):
        super().__init__(cin)
        self.seq = Seq(cin, *recipes)
        self.cout = cout
        self.use_res = (stride == 1 and cin == cout)

    def forward(self, x):
        y = self.seq(x)
        return x + y if self.use_res else y

    def ref_tree(self, prefix):
        return self.seq.ref_tree(prefix + "seq.")


class InvResidual(_SeqBlock):
    def __init__(self, cin, cout, stride, expand):
        hid = cin * expand
        super().__init__(cin, cout, stride, cbr(hid, 1, act="relu6"),
                         Depthwise.of(3, stride), BN.of(), Act.of("relu6"),
                         Conv.of(cout, 1), BN.of())


def inv_residual(cout, stride, expand):
    return InvResidual.of(cout, stride, expand)


class MBConv(_SeqBlock):
    def __init__(self, cin, cout, stride, expand, se=True):
        hid = max(cin * expand, cin)
        super().__init__(cin, cout, stride, cbr(hid, 1, act="swish") if expand > 1 else None,
                         Depthwise.of(3, stride), BN.of(), Act.of("swish"),
                         SE.of(4) if se else None,
                         Conv.of(cout, 1), BN.of())


def mbconv(cout, stride, expand, se=True):
    return MBConv.of(cout, stride, expand, se)


class ShuffleUnitV1(Layer):
    def __init__(self, cin, cout, stride, groups=4):
        super().__init__(cin)
        mid = cout // 4
        self.body = Seq(cin, Conv.of(mid, 1, groups=groups), BN.of(), Act.of(),
                        Shuffle.of(groups),
                        Depthwise.of(3, stride), BN.of(),
                        Conv.of(cout if stride == 1 else cout - cin, 1, groups=groups), BN.of())
        self.cout, self.stride = cout, stride
        self.pool = Pool(cin, "avg", 3, 2, "SAME")

    def forward(self, x):
        y = self.body(x)
        if self.stride == 1:
            return torch.relu(x + y) if x.shape == y.shape else torch.relu(y)
        return torch.relu(torch.cat([self.pool(x), y], dim=1))

    def ref_tree(self, prefix):
        return self.body.ref_tree(prefix + "body.")


def shuffle_unit_v1(cout, stride, groups=4):
    return ShuffleUnitV1.of(cout, stride, groups)


class ShuffleUnitV2(Layer):
    def __init__(self, cin, cout, stride):
        super().__init__(cin)
        half = cout // 2
        self.cout, self.stride = cout, stride
        self.right = Seq(cin if stride > 1 else cin // 2,
                         cbr(half, 1), Depthwise.of(3, stride), BN.of(), cbr(half, 1))
        self.left = (Seq(cin, Depthwise.of(3, stride), BN.of(), cbr(half, 1))
                     if stride > 1 else None)
        self.shuffle = Shuffle(cout, 2)

    def forward(self, x):
        if self.stride > 1:
            l, r = self.left(x), self.right(x)
        else:
            c = x.shape[1] // 2
            l, r = x[:, :c], self.right(x[:, c:])
        return self.shuffle(torch.cat([l, r], dim=1))

    def ref_tree(self, prefix):
        return {"l": {} if self.left is None else self.left.ref_tree(prefix + "left."),
                "r": self.right.ref_tree(prefix + "right.")}


def shuffle_unit_v2(cout, stride):
    return ShuffleUnitV2.of(cout, stride)


class DenseBlock(Layer):
    def __init__(self, cin, n, growth):
        super().__init__(cin)
        units, c = [], cin
        for _ in range(n):
            units.append(Seq(c, BN.of(), Act.of(), Conv.of(growth, 3)))
            c += growth
        self.units = nn.ModuleList(units)
        self.cout = c

    def forward(self, x):
        for u in self.units:
            x = torch.cat([x, u(x)], dim=1)
        return x

    def ref_tree(self, prefix):
        return [u.ref_tree(f"{prefix}units.{i}.") for i, u in enumerate(self.units)]


def dense_block(n, growth):
    return DenseBlock.of(n, growth)


# ---------------------------------------------------------------------------
# Networks (CIFAR-scale stem; 10-class head)
# ---------------------------------------------------------------------------


def _resnet(layers: Sequence[int], block="basic", width=64, se=False,
            preact=False, scale=1.0):
    blocks: List[Recipe] = [cbr(width, 3)]
    cmul = [1, 2, 4, 8]
    for i, n in enumerate(layers):
        c = width * cmul[i]
        for j in range(n):
            stride = 2 if (j == 0 and i > 0) else 1
            if preact:
                b = (preact_basic(c, stride) if block == "basic"
                     else preact_bottleneck(c, stride))
            elif block == "basic":
                b = basic_block(c, stride, se=se, scale=scale)
            else:
                b = bottleneck(c, stride, se=se)
            blocks.append(b)
    blocks += [GlobalAvg.of(), Dense.of(10)]
    return Seq.of(*blocks)


def _vgg(cfg: Sequence) -> Recipe:
    blocks: List[Recipe] = []
    for v in cfg:
        if v == "M":
            blocks.append(Pool.of("max", 2))
        else:
            blocks.append(cbr(v, 3))
    blocks += [GlobalAvg.of(), Dense.of(512), Act.of(), Dense.of(10)]
    return Seq.of(*blocks)


_VGG_CFG = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512],
}


def _googlenet():
    return Seq.of(
        cbr(64, 3), cbr(192, 3), Pool.of("max", 2),
        inception(64, 96, 128, 16, 32, 32),
        inception(128, 128, 192, 32, 96, 64), Pool.of("max", 2),
        inception(192, 96, 208, 16, 48, 64),
        inception(160, 112, 224, 24, 64, 64),
        inception(128, 128, 256, 24, 64, 64),
        inception(112, 144, 288, 32, 64, 64),
        inception(256, 160, 320, 32, 128, 128), Pool.of("max", 2),
        inception(256, 160, 320, 32, 128, 128),
        inception(384, 192, 384, 48, 128, 128),
        GlobalAvg.of(), Dense.of(10))


def _inception_v3_lite():
    def factored(c):
        return Branches.of(cbr(c, 1),
                           Seq.of(cbr(c, 1), Conv.of(c, 3), BN.of(), Act.of()),
                           Seq.of(cbr(c, 1), Conv.of(c, 3), BN.of(), Act.of(),
                                  Conv.of(c, 3), BN.of(), Act.of()),
                           Seq.of(Pool.of("avg", 3, 1, "SAME"), cbr(c, 1)))
    return Seq.of(cbr(32, 3), cbr(64, 3), Pool.of("max", 2),
                  factored(48), factored(64), Pool.of("max", 2),
                  factored(96), factored(96), Pool.of("max", 2),
                  factored(128), GlobalAvg.of(), Dense.of(10))


def _squeezenet():
    return Seq.of(cbr(64, 3), Pool.of("max", 2),
                  fire(16, 64, 64), fire(16, 64, 64), Pool.of("max", 2),
                  fire(32, 128, 128), fire(32, 128, 128), Pool.of("max", 2),
                  fire(48, 192, 192), fire(48, 192, 192),
                  fire(64, 256, 256), fire(64, 256, 256),
                  Conv.of(10, 1), GlobalAvg.of())


def _mobilenet_v1():
    def dw(cout, stride=1):
        return Seq.of(Depthwise.of(3, stride), BN.of(), Act.of(),
                      Conv.of(cout, 1), BN.of(), Act.of())
    return Seq.of(cbr(32, 3), dw(64), dw(128, 2), dw(128), dw(256, 2), dw(256),
                  dw(512, 2), *[dw(512) for _ in range(5)], dw(1024, 2),
                  dw(1024), GlobalAvg.of(), Dense.of(10))


def _mobilenet_v2():
    cfg = [(16, 1, 1), (24, 1, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
           (32, 1, 6), (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
           (96, 1, 6), (96, 1, 6), (96, 1, 6), (160, 2, 6), (160, 1, 6),
           (160, 1, 6), (320, 1, 6)]
    return Seq.of(cbr(32, 3), *[inv_residual(c, s, e) for c, s, e in cfg],
                  cbr(1280, 1), GlobalAvg.of(), Dense.of(10))


def _shufflenet_v1():
    return Seq.of(cbr(24, 3),
                  shuffle_unit_v1(240, 2), *[shuffle_unit_v1(240, 1)] * 3,
                  shuffle_unit_v1(480, 2), *[shuffle_unit_v1(480, 1)] * 7,
                  shuffle_unit_v1(960, 2), *[shuffle_unit_v1(960, 1)] * 3,
                  GlobalAvg.of(), Dense.of(10))


def _shufflenet_v2():
    return Seq.of(cbr(24, 3),
                  shuffle_unit_v2(116, 2), *[shuffle_unit_v2(116, 1)] * 3,
                  shuffle_unit_v2(232, 2), *[shuffle_unit_v2(232, 1)] * 7,
                  shuffle_unit_v2(464, 2), *[shuffle_unit_v2(464, 1)] * 3,
                  cbr(1024, 1), GlobalAvg.of(), Dense.of(10))


def _densenet63():
    return Seq.of(cbr(32, 3),
                  dense_block(6, 16), cbr(64, 1), Pool.of("avg", 2),
                  dense_block(8, 16), cbr(96, 1), Pool.of("avg", 2),
                  dense_block(8, 16), cbr(128, 1), Pool.of("avg", 2),
                  dense_block(6, 16), GlobalAvg.of(), Dense.of(10))


def _nin():
    return Seq.of(cbr(192, 5), cbr(160, 1), cbr(96, 1), Pool.of("max", 2),
                  cbr(192, 5), cbr(192, 1), cbr(192, 1), Pool.of("avg", 2),
                  cbr(192, 3), cbr(192, 1), Conv.of(10, 1), GlobalAvg.of())


def _resnext29():
    def block(cout, stride=1):
        inner = Seq.of(Conv.of(cout // 2, 1), BN.of(), Act.of(),
                       Conv.of(cout // 2, 3, stride, groups=8), BN.of(), Act.of(),
                       Conv.of(cout, 1), BN.of())
        return Seq.of(Residual.of(inner, stride), Act.of())
    return Seq.of(cbr(64, 3),
                  *[block(256, 2 if i == 0 else 1) for i in range(3)],
                  *[block(512, 2 if i == 0 else 1) for i in range(3)],
                  *[block(1024, 2 if i == 0 else 1) for i in range(3)],
                  GlobalAvg.of(), Dense.of(10))


def _efficientnet_lite0():
    cfg = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (40, 2, 6), (40, 1, 6),
           (80, 2, 6), (80, 1, 6), (80, 1, 6), (112, 1, 6), (112, 1, 6),
           (192, 2, 6), (192, 1, 6), (192, 1, 6), (320, 1, 6)]
    return Seq.of(cbr(32, 3, act="swish"),
                  *[mbconv(c, s, e) for c, s, e in cfg],
                  cbr(1280, 1, act="swish"), GlobalAvg.of(), Dense.of(10))


def _convmixer_lite(dim=256, depth=8, k=9):
    def mixer():
        return Seq.of(Residual.of(Seq.of(Depthwise.of(k, 1), Act.of("swish"), BN.of())),
                      Conv.of(dim, 1), Act.of("swish"), BN.of())
    return Seq.of(Conv.of(dim, 2, 2), Act.of("swish"), BN.of(),
                  *[mixer() for _ in range(depth)], GlobalAvg.of(), Dense.of(10))


def _lenet5(image=32):
    s1 = (image - 4) // 2
    s2 = (s1 - 4) // 2
    return Seq.of(Conv.of(6, 5, bias=True, pad="VALID"), Act.of("tanh"), Pool.of("avg", 2),
                  Conv.of(16, 5, bias=True, pad="VALID"), Act.of("tanh"), Pool.of("avg", 2),
                  Flatten.of(s2),
                  Dense.of(120), Act.of("tanh"), Dense.of(84), Act.of("tanh"), Dense.of(10))


def _alexnet(image=32):
    return Seq.of(cbr(64, 5), Pool.of("max", 2), cbr(192, 5), Pool.of("max", 2),
                  cbr(384, 3), cbr(256, 3), cbr(256, 3), Pool.of("max", 2),
                  Flatten.of(image // 8),
                  Dense.of(1024), Act.of(), Dense.of(512), Act.of(), Dense.of(10))


ZOO: Dict[str, Callable[[], Recipe]] = {
    "lenet5": _lenet5,  # image-aware
    "alexnet": _alexnet,
    "vgg11": lambda: _vgg(_VGG_CFG[11]),
    "vgg13": lambda: _vgg(_VGG_CFG[13]),
    "vgg16": lambda: _vgg(_VGG_CFG[16]),
    "vgg19": lambda: _vgg(_VGG_CFG[19]),
    "resnet18": lambda: _resnet([2, 2, 2, 2]),
    "resnet34": lambda: _resnet([3, 4, 6, 3]),
    "resnet50": lambda: _resnet([3, 4, 6, 3], "bottleneck"),
    "resnet101": lambda: _resnet([3, 4, 23, 3], "bottleneck"),
    "resnet152": lambda: _resnet([3, 8, 36, 3], "bottleneck"),
    "preact_resnet18": lambda: _resnet([2, 2, 2, 2], preact=True),
    "preact_resnet152": lambda: _resnet([3, 8, 36, 3], "bottleneck",
                                        preact=True),
    "se_resnet18": lambda: _resnet([2, 2, 2, 2], se=True),
    "se_resnet34": lambda: _resnet([3, 4, 6, 3], se=True),
    "googlenet": _googlenet,
    "inception_v3_lite": _inception_v3_lite,
    "squeezenet": _squeezenet,
    "mobilenet_v1": _mobilenet_v1,
    "mobilenet_v2": _mobilenet_v2,
    "shufflenet_v1": _shufflenet_v1,
    "shufflenet_v2": _shufflenet_v2,
    "densenet63": _densenet63,
    "nin": _nin,
    "wideresnet16_4": lambda: _resnet([2, 2, 2], width=64 * 4 // 4),
    "stochastic_depth34": lambda: _resnet([3, 4, 6, 3], scale=0.8),
    "resnext29": _resnext29,
    "efficientnet_lite0": _efficientnet_lite0,
    "convmixer_lite": _convmixer_lite,
}

# the paper's Fig.13 zero-shot holdout — identical families
UNSEEN = ("inception_v3_lite", "stochastic_depth34", "resnet50",
          "preact_resnet152", "se_resnet34")

LIGHTWEIGHT = ("squeezenet", "mobilenet_v1", "mobilenet_v2",
               "shufflenet_v1", "shufflenet_v2")  # paper's 1x1-conv group


def _flat_paths(tree, prefix: str = "") -> Dict[str, str]:
    """The reference's tree path ("3/0/f/1/g": list indices and dict keys
    joined by "/") of every leaf of a ``ref_tree``."""
    items = enumerate(tree) if isinstance(tree, list) else sorted(tree.items())
    out = {}
    for k, v in items:
        if isinstance(v, str):
            out[f"{prefix}{k}"] = v
        else:
            out.update(_flat_paths(v, f"{prefix}{k}/"))
    return out


@dataclasses.dataclass
class ZooModel:
    """A zoo network built for ``cin`` input channels. Its parameters live
    outside it, as ``{name: tensor}`` under ``net``'s parameter names:
    ``init`` draws them and ``apply`` runs the network on them."""
    name: str
    net: Layer
    cin: int

    def param_specs(self) -> Dict[str, ParamSpec]:
        out = {}
        for prefix, m in self.net.named_modules():
            for k, ps in getattr(m, "specs", {}).items():
                out[f"{prefix}.{k}" if prefix else k] = ps
        return out

    def param_shapes(self) -> Dict[str, torch.Tensor]:
        """``meta`` tensors of every parameter's shape (float32)."""
        return {k: torch.empty(ps.shape, device="meta") for k, ps in self.param_specs().items()}

    def param_count(self) -> int:
        return int(sum(np.prod(ps.shape) for ps in self.param_specs().values()))

    def init(self, generator: torch.Generator, image: int = 32) -> Dict[str, torch.Tensor]:
        """Parameters with the reference's initialisers, drawn from
        ``generator`` on its device (``image`` is the reference's argument and
        changes nothing)."""
        return init_params(self.param_specs(), generator, torch.float32, generator.device)

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Logits of the NCHW batch ``x`` under ``params``."""
        return functional_call(self.net, params, (x,))

    def ref_paths(self) -> Dict[str, str]:
        """The reference's parameter path -> this port's parameter name."""
        return _flat_paths(self.net.ref_tree(""))

    def layer_count(self) -> int:
        return sum(isinstance(m, (Conv, Dense)) for m in self.net.modules())


def zoo_params_from_jax(model: ZooModel, flat: Dict[str, np.ndarray],
                        dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Carry the reference's parameters across: ``flat`` maps its tree paths
    (list indices and dict keys joined by "/") to arrays. Conv weights go
    from HWIO to OIHW, for grouped and depthwise ones too; Dense weights keep
    their (in, out) layout. Keys and shapes are checked."""
    paths = model.ref_paths()
    if set(paths) != set(flat):
        missing, extra = sorted(set(paths) - set(flat)), sorted(set(flat) - set(paths))
        raise KeyError(f"parameter paths differ: missing {missing}, unexpected {extra}")
    specs = model.param_specs()
    out = {}
    for path, name in paths.items():
        arr = np.asarray(flat[path])
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        if arr.shape != specs[name].shape:
            raise ValueError(f"{path} -> {name}: shape {arr.shape}, expected {specs[name].shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    return out


def build_zoo_model(name: str, channels: int = 3, image: int = 32) -> ZooModel:
    builder = ZOO[name]
    if "image" in inspect.signature(builder).parameters:
        recipe = builder(image=image)
    else:
        recipe = builder()
    return ZooModel(name, recipe.build(channels), channels)
