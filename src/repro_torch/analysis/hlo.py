"""Static cost analysis of a traced per-rank graph: the dry run's cost model.

Port of ``repro.analysis.hlo``. torch has no HLO: the port counts on the
aten graph that ``make_fx`` traces from one rank's DTensor program, where
shapes are the rank's local shapes and each collective that DTensor
inserts is a ``_c10d_functional`` node. The reference's charging rules are
kept:

  - dot FLOPs = 2 x result elements x contracted elements (``mm``, ``bmm``
    and the products ``addmm`` / ``baddbmm`` make, whose added term is one
    more FLOP per result element); convolution FLOPs = 2 x result elements
    x kernel elements / output channels (``convolution`` and both halves of
    ``convolution_backward``);
  - every other op is charged 1 FLOP per result element, or per element of
    its first input where that is larger (a reduction);
  - HBM bytes are charged at op boundaries, each op's tensor inputs read
    and its outputs written once: eager PyTorch runs op by op, with no
    fusion to keep intermediates in registers (views, and the collectives'
    ``wait_tensor``, move nothing);
  - collective bytes are result bytes, weighted 2x for an all-reduce and 1x
    for the others, by kind: ``all_reduce`` -> all-reduce,
    ``all_gather_into_tensor`` -> all-gather, ``reduce_scatter_tensor`` ->
    reduce-scatter, ``all_to_all_single`` -> all-to-all, ``broadcast`` ->
    collective-broadcast.

The graph is unrolled (the port's layers are a Python loop, remat
recomputes are traced where they run), so a layer's collective counts once
each time it runs: the reference's loop multiplier by construction.
``analyze_graph(gm)`` takes the place of ``analyze_text``.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Iterable

import torch

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "collective-broadcast", "ragged-all-to-all")
_COLL_WEIGHT = {k: (2.0 if k == "all-reduce" else 1.0) for k in COLL_OPS}

# ``_c10d_functional`` op name (and its coalesced form) -> the reference's kind
COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_weighted: float = 0.0
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        self.coll_weighted += other.coll_weighted * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult


def tensors(val) -> Iterable[torch.Tensor]:
    """The tensors in a node's value (a tensor, or a tuple/list of them); a
    DTensor (a traced input) stands for its local shard."""
    if isinstance(val, torch.Tensor):
        yield getattr(val, "_local_tensor", val)
    elif isinstance(val, (tuple, list)):
        for v in val:
            yield from tensors(v)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _val(arg):
    return arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None


def _inputs(node) -> list:
    """The tensors a node reads, each operand as often as it is passed."""
    out = []
    torch.fx.node.map_arg((node.args, node.kwargs), lambda a: out.extend(tensors(_val(a))))
    return out


def is_view(target) -> bool:
    """An op whose results alias its input (no data moves)."""
    if target is operator.getitem:
        return True
    schema = getattr(target, "_schema", None)
    return bool(schema and schema.returns and all(
        r.alias_info is not None and not r.alias_info.is_write for r in schema.returns))


def coll_kind(target):
    """The reference's kind of a ``_c10d_functional`` collective, else None."""
    ns = getattr(target, "namespace", None)
    if ns != "_c10d_functional":
        return None
    return COLL_KIND.get(target._opname)


_OVERLOAD = torch._ops.OpOverload
_A = torch.ops.aten


def _dot_flops(target, node, out) -> float:
    """2 x result x contracted for the products; None for any other op."""
    args = [_val(a) for a in node.args]
    packet = target.overloadpacket if isinstance(target, _OVERLOAD) else None
    if packet in (_A.mm, _A.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in (_A.addmm, _A.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1] + out.numel()
    if packet is _A.convolution:
        w = args[1]
        return 2.0 * out.numel() * w.numel() / max(w.shape[0], 1)
    if packet is _A.convolution_backward:
        grad_out, x, w = args[0], args[1], args[2]
        mask = node.args[-1]
        per = w.numel() / max(w.shape[0], 1)
        flops = 0.0
        if mask[0]:  # input gradient: a convolution producing x's shape
            flops += 2.0 * x.numel() * per * w.shape[0] / max(x.shape[1], 1)
        if mask[1]:  # weight gradient: one forward's products
            flops += 2.0 * grad_out.numel() * per
        return flops
    return None


def node_cost(node) -> Cost:
    c = Cost()
    if node.op != "call_function":
        return c
    target = node.target
    outs = list(tensors(node.meta.get("val")))
    out_bytes = sum(nbytes(t) for t in outs)
    kind = coll_kind(target)
    if kind is not None:
        c.coll_bytes += out_bytes
        c.coll_weighted += out_bytes * _COLL_WEIGHT[kind]
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        c.bytes += out_bytes + sum(nbytes(t) for t in _inputs(node))
        return c
    if is_view(target) or getattr(target, "namespace", None) == "_c10d_functional":
        return c  # views, wait_tensor
    ins = _inputs(node)
    dot = _dot_flops(target, node, outs[0]) if outs else None
    if dot is not None:
        c.flops += dot
    else:
        first = ins[0].numel() if ins else 0
        c.flops += max(sum(t.numel() for t in outs), first)
    c.bytes += out_bytes + sum(nbytes(t) for t in ins)
    return c


def dot_flops(gm: torch.fx.GraphModule) -> float:
    """The FLOPs of one rank's matrix products and convolutions alone: the
    count that compares with the dots of the reference's compiled HLO (its
    total charges the elementwise ops by XLA's fusions, the port's by the
    eager ops)."""
    total = 0.0
    for node in gm.graph.nodes:
        if node.op == "call_function" and coll_kind(node.target) is None:
            outs = list(tensors(node.meta.get("val")))
            total += (_dot_flops(node.target, node, outs[0]) if outs else None) or 0.0
    return total


def analyze_graph(gm: torch.fx.GraphModule) -> Cost:
    """FLOPs, HBM bytes and collective bytes of one rank's traced program."""
    total = Cost()
    for node in gm.graph.nodes:
        total.add(node_cost(node))
    return total


def live_bytes(gm: torch.fx.GraphModule, top: int = 0) -> Dict[str, float]:
    """Peak live bytes of one rank's program, run op by op in graph order:
    ``argument`` (the placeholders: the state and batch shards, live
    throughout), ``temp`` (the most bytes of op results alive at once: a
    result is allocated at its op and freed after its last use; views
    allocate nothing and keep their base alive), ``output`` (the results
    returned) and ``peak`` = argument + temp. With ``top``, ``at_peak``
    lists the ``top`` largest results alive at the peak (``[name, op,
    shape, bytes, index of the op, index of its last use]``) and
    ``peak_at`` the index of the op the peak comes at."""
    nodes = list(gm.graph.nodes)
    base = {}  # node -> the node whose storage it uses
    for n in nodes:
        if n.op == "call_function" and is_view(n.target) and n.all_input_nodes:
            base[n] = base.get(n.all_input_nodes[0], n.all_input_nodes[0])
        else:
            base[n] = n
    last = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last[base[a]] = i
    argument = sum(nbytes(t) for n in nodes if n.op == "placeholder"
                   for t in tensors(n.meta.get("val")))
    out_node = nodes[-1]
    returned = {base[a] for a in out_node.all_input_nodes} if out_node.op == "output" else set()
    output = sum(nbytes(t) for b in returned if b.op != "placeholder"
                 for t in tensors(b.meta.get("val")))
    live = peak = 0
    frees, alive, at_peak = {}, {}, (0, {})
    for i, n in enumerate(nodes):
        if n.op == "call_function" and base[n] is n:
            size = sum(nbytes(t) for t in tensors(n.meta.get("val")))
            live += size
            if top:
                alive[n] = (i, size)
            if n not in returned:
                frees.setdefault(last.get(n, i), []).append(n)
        if live > peak:
            peak = live
            if top:
                at_peak = (i, dict(alive))
        for dead in frees.pop(i, []):
            live -= sum(nbytes(t) for t in tensors(dead.meta.get("val")))
            alive.pop(dead, None)
    out = {"argument": float(argument), "temp": float(peak), "output": float(output),
           "peak": float(argument + peak)}
    if top:
        big = sorted(at_peak[1].items(), key=lambda kv: -kv[1][1])[:top]
        out["peak_at"] = at_peak[0]
        out["at_peak"] = [[n.name, str(n.target), [list(t.shape) for t in tensors(n.meta["val"])],
                           size, i, last.get(n, i)] for n, (i, size) in big]
    return out
