"""Logical-axis -> mesh-axis sharding resolution, and its DTensor placements.

Port of ``repro.distributed.sharding``. Every parameter / cache / activation
tensor carries a tuple of *logical* axis names (``StackModel.param_axes``,
``cache_axes``, ``_ACT_AXES``). A :class:`ShardingRules` maps logical names
to mesh axes; :func:`resolve_spec` turns (logical axes, shape, mesh) into a
concrete :class:`PartitionSpec`, by the reference's rules:

- mesh axes absent from the mesh (e.g. ``pod`` on the single-pod mesh) are
  dropped;
- a dim is sharded only when evenly divisible, or when the padding waste
  ``ceil(d/n)*n/d`` stays within ``pad_tolerance`` (default 1.0, strict;
  ``make_sharder`` admits 4/3 for activations);
- a mesh axis is consumed at most once per tensor, first (leftmost logical
  dim) wins.

The reference hands the spec to GSPMD, which partitions the program. Here
the last step is DTensor's: :func:`placements` turns a spec into one
``Shard(d)`` or ``Replicate()`` per mesh dim of a ``DeviceMesh``, and DTensor
propagates the shardings through each op and inserts the redistributions. A
dim sharded over several mesh axes (``("pod", "data")``) is ``Shard(d)`` on
each of them, which splits it major to minor in the mesh's own dim order;
axes named in another order raise. Where GSPMD pads an uneven dim, DTensor
splits it as ``torch.chunk`` does: that reaches activations only (strict
rules keep parameters, caches and inputs even).

The port's parameter trees are flat ``{name: tensor}`` dicts with one tensor
per layer, where the reference stacks each layer parameter over the periods
of the layer pattern. ``fsdp_axes`` and ``zero_axes`` pick the first
suitable dim of the tensor they are given, so on the port's per-layer leaves
they never pick a layer dim (the reference may, for a stack whose period
count divides the axis: mamba2-370m and phi4-mini-3.8b under ``"dp"``); on
the same leaf shapes the two packages agree.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": (),
    "mlp": ("model",),
    "heads": ("model",),        # even head counts (SSM heads, 32/64-head attn)
    "heads_flat": ("model",),   # flattened H*hd projections (always divisible)
    "kv_flat": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "experts": ("model",),
    "seq": (),
    # Megatron-style sequence parallelism: the residual stream between
    # blocks is sharded over `model` on the sequence dim; the surrounding
    # all-reduces become the matching all-gather/reduce-scatter pairs.
    "act_seq": ("model",),
    "cache_seq": ("model",),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of mesh
    axis names; trailing Nones trimmed (``tuple(spec)`` compares with JAX's)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    # pad_tolerance 1.0 (strict) for params/caches/inputs; make_sharder
    # relaxes it for activation constraints.
    rules: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    pad_tolerance: float = 1.0

    def replace(self, **updates) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(updates)
        return dataclasses.replace(self, rules=merged)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object with
    ``axis_names`` and ``devices`` (a JAX mesh, or a duck-typed one)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                 mesh, rules: ShardingRules) -> PartitionSpec:
    sizes = _axis_sizes(mesh)
    used = set()
    out = []
    for name, dim in zip(axes, shape):
        entry = rules.rules.get(name, ()) if name else ()
        mesh_axes = tuple(a for a in entry if a in sizes and a not in used)
        if not mesh_axes:
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in mesh_axes)
        if n <= 1:
            out.append(None)
            continue
        waste = (-(-dim // n) * n) / max(dim, 1)
        if dim % n != 0 and waste > rules.pad_tolerance:
            out.append(None)
            continue
        used.update(mesh_axes)
        out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per dim of ``mesh`` (a
    ``DeviceMesh``) for ``spec``. A tensor dim sharded over several mesh axes
    must name them in the mesh's dim order; any other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {axes}, not in the mesh's dim "
                             f"order {names}; DTensor splits major to minor in that order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``, with the DTensor
    placements it stands for."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _shape(shp) -> Tuple[int, ...]:
    return tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)


def tree_map_axes(fn: Callable, axes_tree, shape_tree):
    """``fn(axes, shape)`` over parallel trees (nested dicts and lists) whose
    leaves are logical-axes tuples and shapes (tensors, or shape tuples)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, shape_tree)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, shape_tree[k]) for k, v in axes_tree.items()}
    return type(axes_tree)(tree_map_axes(fn, a, s) for a, s in zip(axes_tree, shape_tree))


def tree_shardings(mesh, axes_tree, shape_tree, rules: ShardingRules):
    """Parallel trees of logical axes + shapes -> NamedSharding tree."""
    def leaf(axes, shp):
        shape = _shape(shp)
        return NamedSharding(mesh, resolve_spec(tuple(axes), shape, mesh, rules))
    return tree_map_axes(leaf, axes_tree, shape_tree)


# Activation constraint points used inside models (name -> logical axes).
_ACT_AXES = {
    "acts": ("batch", "act_seq", "embed"),
    "acts_qkv": ("batch", "seq", "heads", "head_dim"),
    "acts_kv": ("batch", "seq", "kv_heads", "head_dim"),
    "acts_kv_repl": ("batch", "seq", None, "head_dim"),  # batch-only
    "moe_disp": ("batch", None, "experts", None),   # (G, gs, E, C)
    "moe_xe": ("batch", "experts", None, None),     # (G, E, C, D)
    "decode_scores": ("batch", None, None, "cache_seq"),  # (B, H, 1, S)
    "decode_scores5": ("batch", None, None, None, "cache_seq"),  # grouped
    "logits": ("batch", "seq", "vocab"),
}


# Activation-sharding schemes, as in the reference:
#   "sp"       — residual stream sharded over model on the seq dim
#                (Megatron sequence parallelism); attention internals left
#                to propagation (no q/k/v constraints).
#   "sp_heads" — sp + forced head sharding of q/k/v.
#   "tp"       — replicated-seq residual + head-sharded attention.
#   "dp"       — no tensor parallelism: the model axis joins the batch
#                axis and parameters are FSDP-sharded over `model`.
SCHEMES = ("sp", "sp_heads", "tp", "dp")


def scheme_rules(scheme: str, rules: Optional[ShardingRules] = None) -> ShardingRules:
    rules = rules or ShardingRules()
    if scheme == "tp":
        return rules.replace(act_seq=())
    if scheme == "dp":
        # vocab stays model-sharded: a 200k-vocab fp32 logits tensor must
        # never materialize unsharded
        return rules.replace(
            batch=("pod", "data", "model"), act_seq=(),
            mlp=(), heads=(), heads_flat=(), kv_flat=(),
            experts=(), fsdp=("model",))
    return rules


def fsdp_axes(axes_tree, shape_tree, mesh):
    """Rewrite param logical axes for the "dp" scheme: shard the first
    model-axis-divisible dim of every tensor as "fsdp" (ZeRO-3 over the
    model axis; DTensor all-gathers each parameter where an op needs it)."""
    n = _axis_sizes(mesh).get("model", 1)

    def leaf(axes, shp):
        shape = _shape(shp)
        if n <= 1:
            return axes
        for i, (name, dim) in enumerate(zip(axes, shape)):
            if dim % n == 0 and dim >= n:
                new = list(axes)
                new[i] = "fsdp"
                return tuple(new)
        return axes

    return tree_map_axes(leaf, axes_tree, shape_tree)


def even_axes(mesh_axes: Tuple[str, ...], dim: int, mesh) -> Tuple[str, ...]:
    """The leading ``mesh_axes`` (those ``mesh`` has) over which ``dim`` still
    splits evenly. The reference's spec leaves a batch that does not split
    over all of its axes whole (a microbatch of 8 rows on a (4, 4) mesh
    under "dp"), and GSPMD then partitions around the constraint as it sees
    fit; DTensor would hold it whole and repeat its whole work on every
    rank, so the port splits it as far as it goes evenly (over the 4 ranks
    of the first mesh dim)."""
    sizes = _axis_sizes(mesh)
    out, n = [], 1
    for a in mesh_axes:
        if a not in sizes:
            continue
        if dim % (n * sizes[a]):
            break
        out.append(a)
        n *= sizes[a]
    return tuple(out)


class Sharder:
    """The ``sharder(name, shape)`` hook consumed by StackModel: the layout of
    the activation at a named constraint point, or None.

    ``whole(p)`` is a parameter in its compute layout: whole along the
    data-parallel mesh axes (those the batch is split over), which an FSDP
    or ZeRO-3 layout splits it over, and as it is along the others (tensor
    and expert parallelism). The model calls it where a layer reads its
    weights, so each layer's parameters are all-gathered where they are used
    and their gradients reduce-scattered back, as GSPMD does per scan step
    in the reference; DTensor left to itself would rather gather the
    activations."""

    def __init__(self, mesh, rules: ShardingRules, names):
        self.mesh, self.rules, self.names = mesh, rules, names
        self.dp_axes = set(rules.rules.get("batch", ()))

    def __call__(self, name: str, shape: Tuple[int, ...], rules=None):
        axes = _ACT_AXES.get(name)
        if name not in self.names or axes is None or len(axes) != len(shape):
            return None
        return NamedSharding(self.mesh, resolve_spec(axes, shape, self.mesh, rules or self.rules))

    def layout(self, name: str, shape: Tuple[int, ...]):
        """The layout DTensor is given at a constraint point: the reference's
        spec (``__call__``), but with a batch that does not split evenly
        over all of its mesh axes split over those of them it does
        (``even_axes``)."""
        axes = _ACT_AXES.get(name) or ()
        if "batch" not in axes or len(axes) != len(shape):
            return self(name, shape)
        batch = even_axes(self.rules.rules.get("batch", ()), shape[axes.index("batch")],
                          self.mesh)
        return self(name, shape, self.rules.replace(batch=batch))

    def whole(self, p, keep=()):
        """``p`` in its compute layout; its splits over the mesh dims
        ``keep`` (indices) are kept, whatever their axes."""
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(p, DTensor):
            return p
        names = p.device_mesh.mesh_dim_names
        pls = tuple(Replicate() if pl.is_shard() and names[i] in self.dp_axes and i not in keep
                    else pl for i, pl in enumerate(p.placements))
        return p if pls == tuple(p.placements) else p.redistribute(p.device_mesh, pls)


def make_sharder(mesh, rules: Optional[ShardingRules] = None, scheme: str = "sp"):
    """Returns the ``sharder(name, shape)`` hook consumed by StackModel."""
    if mesh is None:
        return None
    assert scheme in SCHEMES, scheme
    rules = scheme_rules(scheme, rules)
    rules = dataclasses.replace(rules, pad_tolerance=4.0 / 3.0)
    names = ({"acts", "acts_kv_repl", "moe_disp", "moe_xe", "decode_scores",
              "decode_scores5"}
             if scheme in ("sp", "dp") else set(_ACT_AXES))
    return Sharder(mesh, rules, names)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_index(mesh, dims) -> int:
    """This rank's shard over the mesh dims ``dims`` (indices), major to
    minor: the order in which DTensor splits a tensor dim over them."""
    index = 0
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    return index


def local_part(t, mesh, pls):
    """This rank's part of the whole tensor ``t`` under placements ``pls`` of
    ``mesh``: a view, split as DTensor splits (``torch.chunk``, mesh dims in
    order)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if p.is_shard():
            chunks = torch.chunk(t, mesh.size(i), dim=p.dim)
            t = chunks[coord[i]] if coord[i] < len(chunks) else t.narrow(p.dim, 0, 0)
    return t


def distribute(t, sharding: NamedSharding):
    """The whole tensor ``t``, held alike on every rank, as a DTensor laid out
    as ``sharding`` says. Each rank keeps its own part (a contiguous copy of
    it; ``t`` itself where nothing is split), so no collective runs."""
    from torch.distributed.tensor import DTensor

    mesh, pls = sharding.mesh, sharding.placements
    return DTensor.from_local(local_part(t, mesh, pls).contiguous(), mesh, pls,
                              run_check=False, shape=t.shape, stride=t.stride())


def whole_dim(t, dim: int):
    """A DTensor made whole along ``dim``; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    pls = [Replicate() if p.is_shard() and p.dim % t.ndim == dim else p for p in t.placements]
    return t if pls == list(t.placements) else t.redistribute(t.device_mesh, pls)


def split_ready(t, dim: int, parts: int):
    """``t`` ready for a reshape that splits ``dim`` into ``parts`` leading
    groups (heads): a DTensor split over ``dim`` where the groups are not
    split evenly over the same ranks is made whole along ``dim`` first, as
    GSPMD reshards it (DTensor refuses that reshape); anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    on = [i for i, p in enumerate(t.placements) if p.is_shard() and p.dim % t.ndim == dim % t.ndim]
    if not on or parts % math.prod(t.device_mesh.size(i) for i in on) == 0:
        return t
    return whole_dim(t, dim)


class _SplitReadyGrad(torch.autograd.Function):
    """Identity forward; the gradient made ready (``split_ready``) for the
    reshape that splits its last dim into ``parts`` groups."""

    @staticmethod
    def forward(ctx, y, parts):
        ctx.parts = parts
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return split_ready(dy, -1, ctx.parts), None


def split_ready_grad(y, parts: int):
    """``y``, a merge of ``parts`` groups (heads) into its last dim, whose
    gradient is made ready for the reshape back into the groups
    (``split_ready``): the gradient of a projection's input comes back split
    over the dim as the weight is, where the groups may not split evenly
    (40 heads over 16 ranks)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not torch.is_grad_enabled():
        return y
    return _SplitReadyGrad.apply(y, parts)


def split_like_weight(x, w):
    """``x``, the input of ``x @ w``, split over its last dim wherever ``w``
    splits its first (the contracted dim) and ``x`` is whole: a local slice
    on each rank, no collective. DTensor multiplies a whole ``x`` by a split
    ``w`` as it is, but its backward then takes ``w``'s gradient from the
    whole ``x`` on every rank of the split and keeps the rank's part: each
    rank repeats the whole product (an attention context whose heads do not
    divide the ranks comes back whole)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return x
    last = x.ndim - 1
    pls = [Shard(last) if px.is_replicate() and pw.is_shard(0) else px
           for px, pw in zip(x.placements, w.placements)]
    n = math.prod(x.device_mesh.size(i) for i, p in enumerate(pls) if p.is_shard(last))
    if pls == list(x.placements) or x.shape[-1] % n:
        return x
    return x.redistribute(x.device_mesh, pls)


def whole_sequence(t):
    """A DTensor made whole along its middle (sequence) dims; anything else
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    pls = [Replicate() if p.is_shard() and 0 < p.dim % t.ndim < t.ndim - 1 else p
           for p in t.placements]
    return t if pls == list(t.placements) else t.redistribute(t.device_mesh, pls)


def reduce_partials(t):
    """A DTensor's partial placements summed (all-reduce); anything else as
    it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


class _WholeSequenceGrad(torch.autograd.Function):
    """Identity forward; the gradient made whole along the sequence."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return whole_sequence(dy)


def whole_sequence_grad(y):
    """``y``, a projection's output that joins a sequence-sharded residual
    stream, whose gradient comes back whole along the sequence (the
    all-gather that Megatron's sequence parallelism pairs with the forward
    reduce-scatter): DTensor cannot multiply a gradient whose batch and
    sequence are split over two mesh dims once they merge into one."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not torch.is_grad_enabled():
        return y
    return _WholeSequenceGrad.apply(y)


def _ranks_split_over(t, pls) -> int:
    return math.prod(t.device_mesh.size(i) for i, p in enumerate(pls) if p.is_shard())


class _GradInLayout(torch.autograd.Function):
    """Identity forward; see ``grad_in_layout``."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate

        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import Shard

        n = dy.ndim
        pls = tuple(dy.placements)
        dims = [p.dim % n for p in pls if p.is_shard()]
        if 0 in dims and any(0 < d < n - 1 for d in dims):  # batch and sequence split
            pls = tuple(Shard(n - 1) if p.is_shard() and 0 < p.dim % n < n - 1 else p
                        for p in pls)
            if dy.shape[-1] % math.prod(dy.device_mesh.size(i) for i, p in enumerate(pls)
                                        if p.is_shard() and p.dim == n - 1):
                pls = ctx.placements
        if _ranks_split_over(dy, ctx.placements) > _ranks_split_over(dy, pls):
            pls = ctx.placements
        return dy if pls == tuple(dy.placements) else dy.redistribute(dy.device_mesh, pls)


def grad_in_layout(y):
    """``y``, a projection's output, whose gradient comes back split at
    least as finely as ``y`` is, and never with its batch and its sequence
    split over two mesh dims: such a gradient has its sequence split moved
    to its features (or takes ``y``'s layout where they do not split
    evenly). DTensor may hand the gradient back split over the sequence
    where the output was split over its features (a rank's batch of one
    row: a microbatch of a small batch), and the batch and sequence splits
    merge into a strided shard that DTensor cannot multiply once the
    projection's backward flattens them; or hand it back whole where the
    output was split, and the backward repeats its products on every rank
    of the split."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not torch.is_grad_enabled():
        return y
    return _GradInLayout.apply(y)


class _WholeGrad(torch.autograd.Function):
    """Identity forward; a gradient partial over mesh dims ``dims`` summed
    there."""

    @staticmethod
    def forward(ctx, y, dims):
        ctx.dims = dims
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import Replicate

        pls = [Replicate() if i in ctx.dims and p.is_partial() else p
               for i, p in enumerate(dy.placements)]
        if pls != list(dy.placements):
            dy = dy.redistribute(dy.device_mesh, pls)
        return dy, None


def local_map(fn, out_placements, in_placements, mesh):
    """``fn`` on each rank's local tensors (torch's ``local_map``, inputs
    redistributed to ``in_placements``), with the gradients of a split
    computation. On a mesh dim where an input or an output is split
    (``Shard``) or an output is each rank's share of a sum (``Partial``),
    each rank does a part of the work: the gradient of an input held whole
    there is the sum of the ranks' parts (``Partial``; torch would take it
    as whole), and a ``Partial`` output's gradient reaches every rank summed
    (torch hands each rank its own part of it). An output held whole on such a dim would
    have its gradient counted once a rank, so it is refused: make it
    ``Partial`` with zeros on all ranks but one."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map as torch_local_map

    single = bool(out_placements) and isinstance(out_placements[0], Placement)
    outs = [out_placements] if single else list(out_placements)
    split = ({i for pls in in_placements if pls is not None
              for i, p in enumerate(pls) if p.is_shard()}
             | {i for pls in outs for i, p in enumerate(pls) if not p.is_replicate()})
    for pls in outs:
        bad = [i for i in split if pls[i].is_replicate()]
        if bad:
            raise ValueError(f"an output held whole on the split mesh dims {bad}: {pls}")
    grads = tuple(None if pls is None else
                  [Partial() if i in split and p.is_replicate() else p
                   for i, p in enumerate(pls)] for pls in in_placements)
    local = torch_local_map(fn, out_placements=out_placements, in_placements=in_placements,
                            in_grad_placements=grads, device_mesh=mesh,
                            redistribute_inputs=True)

    def run(*args):
        ys = local(*args)
        ys = [ys] if single else list(ys)
        ys = [_WholeGrad.apply(y, frozenset(i for i, p in enumerate(pls) if p.is_partial()))
              if any(p.is_partial() for p in pls) and y.requires_grad else y
              for y, pls in zip(ys, outs)]
        return ys[0] if single else tuple(ys)

    return run


def split_idle(t, dim: int, spill: Optional[int] = None) -> list:
    """One placement a mesh dim for a per-shard region over the DTensor
    ``t`` that is independent across its rows (dim 0) and its ``dim``
    (heads, channels): ``t``'s split of either is kept and anything else
    made whole; and ``dim`` is split as well over each mesh dim of more than
    one rank that splits neither, in mesh order, as long as it still splits
    evenly. Each rank of such a dim then runs its share of the region, where
    it would repeat all of it on the rows that every rank of the dim holds
    alike (the model axis under "dp" when a microbatch has fewer rows than
    there are ranks), as GSPMD divides it. Where ``dim`` does not split
    evenly over such a mesh dim (14 heads over 16 ranks), ``spill`` (a dim
    the region is independent across for ``t`` alone, as attention is
    across its query rows) is split there instead, as long as it splits
    evenly. A mesh dim of one rank is left as it is."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    out = [p if p.is_shard() and p.dim % t.ndim in (0, dim) else Replicate()
           for p in t.placements]
    for d in (dim, spill):
        if d is None:
            continue
        for i, p in enumerate(out):
            n = math.prod(mesh.size(j) for j, q in enumerate(out) if q.is_shard(d))
            if p.is_replicate() and mesh.size(i) > 1 and t.shape[d] % (n * mesh.size(i)) == 0:
                out[i] = Shard(d)
    return out


def sequence_split_product(x, w):
    """``x @ w`` for ``x`` (B, S, D) and a weight ``w`` that no mesh dim
    splits. On a DTensor ``x`` split over nothing but its batch and its
    sequence, each rank multiplies its own rows and its share of the
    sequence (``local_map``), the sequence split over every mesh dim of more
    than one rank that does not split the batch, and the result is split
    so: GSPMD partitions such a product that way. DTensor left to itself
    repeats the whole product on every rank of a mesh dim that does not
    split the batch (the model axis under "dp" when a microbatch has fewer
    rows than there are ranks), and cannot multiply a rank's single row
    split over its sequence (the batch and sequence splits merge into a
    strided shard). Anything else is multiplied as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor) or not isinstance(w, DTensor) or x.ndim != 3 \
            or any(not p.is_replicate() for p in w.placements) \
            or any(not (p.is_replicate() or p.is_shard(0) or p.is_shard(1))
                   for p in x.placements):
        return x @ w
    mesh = x.device_mesh
    pls = tuple(Shard(1) if p.is_replicate() and mesh.size(i) > 1 else p
                for i, p in enumerate(x.placements))
    seq = [i for i, p in enumerate(pls) if p.is_shard(1)]
    if not seq or x.shape[1] % math.prod(mesh.size(i) for i in seq):
        return x @ w
    return local_map(lambda xl, wl: xl @ wl, list(pls), (pls, w.placements), mesh)(x, w)


_REPLICATING = contextvars.ContextVar("replicating_plain_tensors", default=False)


@contextlib.contextmanager
def replicate_plain_tensors(leaf):
    """When ``leaf`` is a DTensor, plain tensors that a step makes for itself
    (positions, masks) count as replicated inside the scope (DTensor's
    ``implicit_replication``, made re-entrant: an inner scope leaves the
    outer one's setting); else nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if not isinstance(leaf, DTensor) or _REPLICATING.get():
        yield
        return
    token = _REPLICATING.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.reset(token)


def with_sharding_constraint(x, sharding: Optional[NamedSharding]):
    """``x`` laid out as ``sharding`` says: a DTensor is redistributed to its
    placements; a plain tensor, or no sharding, passes as it is (so every
    single-device path is unchanged)."""
    from torch.distributed.tensor import DTensor

    if sharding is None or not isinstance(x, DTensor):
        return x
    pl = sharding.placements
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def constrain(shard, name: str, x):
    """The models' constraint points: ``x`` under ``shard(name, shape)``
    (a ``Sharder``'s ``layout``)."""
    if shard is None:
        return x
    return with_sharding_constraint(x, getattr(shard, "layout", shard)(name, tuple(x.shape)))
