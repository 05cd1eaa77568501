"""Parameter specs, initialisation and weight import for the PyTorch port.

Mirrors ``repro.models.module``: a module's parameters are described by a
nested dict of :class:`ParamSpec` leaves (shape + logical axis names +
initialiser), and ``init_params`` materialises such a tree with the same
initialisers and fan-in scales as the JAX package. The numbers differ from
``jax.random``'s, so parity tests carry the JAX weights across with
:func:`params_from_jax` instead of replaying the draw.

Trees are addressed by flat ``"a/b/c"`` keys, the JAX tree path joined by
``/``. The reference stacks every layer parameter over the periods of the
layer pattern (``stack_specs``); the port keeps one module per layer, and
``port_names`` / ``unstack_layers`` map one layout onto the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: Optional[float] = None
    dtype: Optional[torch.dtype] = None  # overrides the model dtype (fp32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def spec(shape: Sequence[int], axes: Sequence[Optional[str]], init: str = "normal",
         scale: Optional[float] = None, dtype: Optional[torch.dtype] = None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}, keys in sorted order (JAX's dict order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _fan_in(shape: tuple) -> int:
    # Convention: last dim is fan-out, everything before is fan-in.
    if len(shape) <= 1:
        return max(1, shape[0] if shape else 1)
    return max(1, math.prod(shape[:-1]))


def _scale(ps: ParamSpec) -> float:
    if ps.init == "embed":
        return ps.scale if ps.scale is not None else 1.0
    # dense-kernel initialisers: normal scaled by fan-in
    sc = ps.scale if ps.scale is not None else 1.0 / math.sqrt(_fan_in(ps.shape))
    return sc * 0.1 if ps.init == "small" else sc


def init_params(spec_tree: Tree, generator: torch.Generator, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """Materialise a ParamSpec tree as flat ``{"a/b": tensor}``.

    Leaves draw from ``generator`` one after another in sorted key order, so
    one seed gives one model. ``generator`` must live on ``device``.
    """
    out = {}
    for k, ps in flatten(spec_tree).items():
        out[k] = torch.empty(ps.shape, dtype=ps.dtype or dtype, device=device)
        fill_leaf(out[k], ps, generator)
    return out


# elements drawn at a time by ``fill_leaf`` (256 MB of fp32)
_DRAW = 1 << 26


def fill_leaf(t: torch.Tensor, ps: ParamSpec, generator: torch.Generator) -> None:
    """Fill the contiguous tensor ``t`` in place with ``ps``'s initialiser,
    scaled by ``ps``'s shape (for a layer of a stacked tree, the stacked
    shape, as in the reference), drawing fp32 normals from ``generator``
    ``_DRAW`` elements at a time so that no draw as large as ``t`` is held."""
    if ps.init == "zeros":
        t.zero_()
    elif ps.init == "ones":
        t.fill_(1)
    else:
        sc = _scale(ps)
        for part in t.view(-1).split(_DRAW):
            part.copy_(torch.randn(part.shape, generator=generator, dtype=torch.float32,
                                   device=t.device) * sc)


def stack_specs(spec_tree: Tree, n: int, axis_name: Optional[str] = None) -> Tree:
    """Prepend a stacking dim (the periods of the layer pattern) to every leaf."""
    out = {}
    for k, v in spec_tree.items():
        if isinstance(v, dict):
            out[k] = stack_specs(v, n, axis_name)
        else:
            out[k] = ParamSpec((n,) + v.shape, (axis_name,) + v.axes, v.init,
                               v.scale, v.dtype)
    return out


def count_params(spec_tree: Tree) -> int:
    """Number of scalar parameters in a spec tree."""
    return sum(math.prod(ps.shape) for ps in flatten(spec_tree).values())


# stacked subtrees of the reference's tree: the decoder's layers (over the
# periods of the layer pattern) and the encoder's (period 1)
_STACKS = ("layers", "encoder")


def port_names(key: str, cfg) -> List[str]:
    """The port's ``state_dict`` names of a flat spec key.

    ``layers/L{i}/<path>``, stacked over ``n`` periods, names
    ``layers.{j*period+i}.<path with dots>`` for each period ``j``, and
    ``encoder/L0/<path>`` names ``encoder.{j}.<path>`` for each encoder
    layer; any other key only swaps ``/`` for ``.``.
    """
    parts = key.split("/")
    if parts[0] not in _STACKS:
        return [".".join(parts)]
    period, n = ((cfg.period, cfg.num_periods) if parts[0] == "layers"
                 else (1, cfg.encoder_layers))
    i, rest = int(parts[1][1:]), ".".join(parts[2:])
    return [f"{parts[0]}.{j * period + i}.{rest}" for j in range(n)]


def unstack_layers(flat: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """Stacked flat keys -> the port's ``state_dict`` (see ``port_names``)."""
    out = {}
    for key, val in flat.items():
        stacked = key.split("/")[0] in _STACKS
        out.update({name: val[j] if stacked else val
                    for j, name in enumerate(port_names(key, cfg))})
    return out


def params_from_jax(cfg, flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Carry weights from the JAX package into the port.

    ``flat`` maps JAX tree paths joined by ``/`` (``"layers/L0/mixer/wq"``,
    stacked over periods as ``stack_specs`` lays them out) to numpy arrays.
    bf16 weights cross as float32, which holds every bf16 value exactly, and
    are cast back here. Returns a ``state_dict`` for
    ``StackModel.load_state_dict``; keys and shapes are checked against the
    port's spec tree.
    """
    from repro_torch.models.stack import StackModel, dtype_of

    specs = flatten(StackModel.param_spec_of(cfg))
    if set(specs) != set(flat):
        missing, extra = sorted(set(specs) - set(flat)), sorted(set(flat) - set(specs))
        raise KeyError(f"parameter keys differ: missing {missing}, unexpected {extra}")
    dt = dtype_of(cfg)
    tensors = {}
    for k, ps in specs.items():
        arr = np.asarray(flat[k])
        if tuple(arr.shape) != ps.shape:
            raise ValueError(f"{k}: shape {arr.shape}, expected {ps.shape}")
        tensors[k] = torch.from_numpy(arr.astype(np.float32)).to(ps.dtype or dt)
    return unstack_layers(tensors, cfg)
