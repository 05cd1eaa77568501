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
``unstack_layers`` maps one layout onto the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

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


def _init_leaf(ps: ParamSpec, generator: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    dt = ps.dtype or dtype
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dt, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dt, device=device)
    if ps.init == "embed":
        sc = ps.scale if ps.scale is not None else 1.0
    else:  # dense-kernel initialisers: normal scaled by fan-in
        sc = ps.scale if ps.scale is not None else 1.0 / math.sqrt(_fan_in(ps.shape))
        if ps.init == "small":
            sc = sc * 0.1
    draw = torch.randn(ps.shape, generator=generator, dtype=torch.float32, device=device)
    return (draw * sc).to(dt)


def init_params(spec_tree: Tree, generator: torch.Generator, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """Materialise a ParamSpec tree as flat ``{"a/b": tensor}``.

    Leaves draw from ``generator`` one after another in sorted key order, so
    one seed gives one model. ``generator`` must live on ``device``.
    """
    return {k: _init_leaf(ps, generator, dtype, device)
            for k, ps in flatten(spec_tree).items()}


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


def unstack_layers(flat: Dict[str, torch.Tensor], period: int) -> Dict[str, torch.Tensor]:
    """Stacked flat keys -> the port's ``state_dict`` names.

    ``layers/L{i}/<path>`` with leading period axis ``n`` becomes
    ``layers.{j*period+i}.<path with dots>`` for each period ``j``; every
    other key only swaps ``/`` for ``.``.
    """
    out = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[0] != "layers":
            out[".".join(parts)] = val
            continue
        i = int(parts[1][1:])
        rest = ".".join(parts[2:])
        for j in range(val.shape[0]):
            out[f"layers.{j * period + i}.{rest}"] = val[j]
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
    return unstack_layers(tensors, cfg.period)
