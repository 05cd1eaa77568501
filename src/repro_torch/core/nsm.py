"""Network Structural Matrix (NSM) — the paper's §3.2.2, on aten graphs.

Port of ``repro.core.nsm``. The NSM counts, for every ordered operator pair
(src, dst), the number of edges src->dst in the computation DAG. The
reference walks a jaxpr; here the function is traced by ``make_fx`` on fake
tensors (no data, no allocation) into an aten-level ``torch.fx`` graph,
whose nodes come in topological order, so the construction is one pass:
each node consumes values whose producing operator is already known,
incrementing cell (producer, consumer), once per use.

Aten names are canonicalised into the reference's vocabulary (``mm`` ->
``dot``, ``view`` -> ``reshape``, ...). Ops the reference has no
operator for (``detach``, ``t``, ``alias``, ``flip``) and tuple indexing are
transparent: edges flow through them, as
through the reference's call-like primitives. Python loops unroll in the
trace, so a stack of L layers is L copies of a layer, as the reference's
scan-trip multiplication makes it. Tracing pins every kernel to its plain
version: a ctypes kernel cannot take a fake tensor, and the reference too
traces its XLA path; so the NSM of a step is the same with or without a
card.
"""

from __future__ import annotations

import operator
import threading
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._pytree import tree_leaves

from repro_torch.models.api import use_impls

EdgeCounts = Dict[Tuple[str, str], float]

# aten op name -> the reference's primitive name (its ``_CANON`` applied)
_CANON = {
    "mm": "dot", "addmm": "dot", "bmm": "dot", "baddbmm": "dot", "matmul": "dot",
    "convolution": "conv", "convolution_backward": "conv",
    "_to_copy": "convert", "to": "convert",
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "squeeze": "reshape", "flatten": "reshape", "unflatten": "reshape",
    "unsqueeze": "broadcast", "expand": "broadcast", "full": "broadcast", "full_like": "broadcast",
    "zeros": "broadcast", "zeros_like": "broadcast", "ones": "broadcast",
    "ones_like": "broadcast", "new_zeros": "broadcast", "new_ones": "broadcast",
    "scalar_tensor": "broadcast",
    "arange": "iota",
    "permute": "transpose",
    "cat": "concatenate", "stack": "concatenate",
    # JAX transposes a slice into a pad
    "slice_backward": "pad", "select_backward": "pad", "constant_pad_nd": "pad",
    "where": "select",
    "embedding": "gather", "index_select": "gather", "index": "gather",
    "embedding_dense_backward": "scatter-add", "scatter_add": "scatter-add",
    "index_put": "scatter-add", "slice_scatter": "dus", "select_scatter": "dus",
    "sum": "reduce_sum",
    "amax": "reduce_max",
    "maximum": "max", "clamp_min": "max", "minimum": "min", "clamp_max": "min",
    "sigmoid": "logistic",
    "rsub": "sub", "reciprocal": "div",
    "bitwise_and": "and", "logical_and": "and",
    # the zoo's ReLU and pooling: jax.nn.relu is a maximum with 0; a max pool
    # is a reduce_window_max, whose transpose scatters to the window's argmax
    "relu": "max",
    "max_pool2d_with_indices": "reduce_window_max",
    "max_pool2d_with_indices_backward": "select_and_scatter_add",
    "clone": "identity", "copy": "identity", "copy_": "identity",
    # the MoE router's top-k is a stable descending sort and a slice (see
    # ``_node_names``), whose gradient autograd scatters back to the sorted
    # positions; the reference's top_k transposes its gather into a
    # scatter-add
    "sort": "top_k", "scatter": "scatter-add",
}

# aten ops that are a chain of primitives in the reference: ``x[:, 0]`` is
# a slice and a reshape, a mean a sum and a division, an average pool a
# window sum and a division, and its transpose a division, the cotangent
# padded to the input's extent and a window sum
_CHAIN = {"select": ("slice", "reshape"), "mean": ("reduce_sum", "div"),
          "avg_pool2d": ("reduce_window_sum", "div"),
          "avg_pool2d_backward": ("div", "pad", "reduce_window_sum")}

# No operator of their own in the reference's jaxpr: ``detach`` and
# ``alias`` are autograd's bookkeeping of saved tensors; ``t`` is how
# autograd transposes a matrix product's operands, which JAX folds into the
# dot's dimension numbers; ``flip`` is how autograd reverses a cumulative
# sum, which JAX does with ``cumsum(reverse=True)``.
_TRANSPARENT = {"detach", "t", "alias", "lift_fresh", "lift_fresh_copy", "flip"}


def _name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(target, "__name__", str(target))


def canonical(target) -> Optional[str]:
    """The NSM name of a graph node's target; None for a transparent one."""
    if target is operator.getitem:
        return None
    name = _name(target)
    if name in _TRANSPARENT:
        return None
    return _CANON.get(name, name)


def _of_sort(src) -> bool:
    """Whether ``src`` is one of a sort's two outputs."""
    return (isinstance(src, torch.fx.Node) and src.target is operator.getitem
            and _name(src.args[0].target) == "sort")


def _node_names(node: torch.fx.Node) -> Optional[Tuple[str, ...]]:
    """The chain of reference primitives a node stands for (None when
    transparent): a clamp is ``max`` and/or ``min``, as ``jnp.clip`` is; a
    ``max`` or ``min`` of one tensor is a reduction; a power of an integer
    exponent is ``integer_pow``, but of 2 ``square``: ``Tensor.square``
    traces as ``pow(x, 2)``, and the port squares where the reference
    calls ``jnp.square``; and ``pow(x, 1)``, with which autograd
    differentiates a square (``2 * x ** 1``, where JAX's is ``2 * x``), is
    transparent."""
    name = _name(node.target)
    args = node.args
    if name == "slice" and _of_sort(args[0]):
        return None  # top-k is a sort and this slice, one ``top_k`` in the reference
    if name in ("sum", "mean", "amax") and len(args) > 2 and args[2]:
        # keepdim: the reference reduces, then broadcasts the axis back
        chain = _CHAIN.get(name) or (_CANON[name],)
        return chain[:1] + ("broadcast",) + chain[1:]
    if name in _CHAIN:
        return _CHAIN[name]
    if (name == "mul" and len(args) == 2 and isinstance(args[1], (int, float))
            and isinstance(args[0], torch.fx.Node) and _name(args[0].target) == "reciprocal"):
        return None  # ``c / x`` traces as reciprocal(x) * c: one ``div`` in JAX
    exp = args[1] if name == "pow" else None
    if isinstance(exp, (int, float)) and float(exp).is_integer():
        return None if exp == 1 else ("square",) if exp == 2 else ("integer_pow",)
    if name in ("max", "min"):
        two = len(args) > 1 and isinstance(args[1], torch.fx.Node)
        return (name,) if two else ("reduce_" + name,)
    if name == "clamp":
        lo = args[1] if len(args) > 1 else node.kwargs.get("min")
        hi = args[2] if len(args) > 2 else node.kwargs.get("max")
        return tuple(n for n, b in (("max", lo), ("min", hi)) if b is not None)
    name = canonical(node.target)
    return None if name is None else (name,)


# The aten ops with no single primitive in the reference, traced as the
# primitives ``jax.nn`` and ``jnp`` compute them with. Only the trace sees
# these: the step itself runs torch's own ops.
def _silu(x):
    return x * torch.sigmoid(x)  # jax.nn.silu


def _silu_backward(dy, x):
    s = torch.sigmoid(x)
    return dy * (s + x * (s * (1 - s)))


def _softplus(x, beta=1, threshold=20):
    # jax.nn.softplus is logaddexp(x, 0), NaN-guarded
    delta = x - 0.0
    out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(delta != delta, x + 0.0, out)


def _softplus_backward(dy, x, beta=1, threshold=20):
    return dy * torch.sigmoid(x)


def _tanh_backward(dy, y):
    g = dy * (1 - y)  # JAX's tanh derivative: dy (1 - y) + dy (1 - y) y
    return g + g * y


def _relu_backward(dy, y, threshold):
    # jax.nn.relu's derivative: select(x > 0, g, 0)
    return torch.where(y > threshold, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))


def _hardtanh(x, min_val=-1.0, max_val=1.0):
    return torch.clamp(x, min_val, max_val)  # jax.nn.relu6: max, then min


def _hardtanh_backward(dy, x, min_val, max_val):
    # jax.nn.relu6's derivative: select((x > 0) & (x < 6), g, 0)
    keep = torch.logical_and(x > min_val, x < max_val)
    return torch.where(keep, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))


def _sigmoid_backward(dy, y):
    return dy * (y * (1 - y))  # lax.logistic's derivative


def _var(x, dim=None, *, correction=None, keepdim=False):
    # jnp.var: centred on the mean, squared, summed, divided by N - ddof
    dims = range(x.dim()) if dim is None else dim
    n = 1
    for d in dims:
        n *= x.shape[d]
    centred = x - x.mean(dim, keepdim=True)
    ddof = 1 if correction is None else correction
    return torch.sum(centred.square(), dim, keepdim=keepdim) / (n - ddof)


def _logsumexp(x, dim, keepdim=False):
    # jax.nn.logsumexp: the max held out of the gradient
    m = torch.amax(x, dim, keepdim=True).detach()
    out = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
    return out if keepdim else out.squeeze(dim)


def _tril(x, diagonal=0):
    # jnp.tri: iota rows + k >= iota columns, then a select
    rows = torch.arange(x.shape[-2], device=x.device).unsqueeze(-1) + diagonal
    cols = torch.arange(x.shape[-1], device=x.device)
    return torch.where(rows >= cols, x, torch.zeros((), dtype=x.dtype, device=x.device))


_aten = torch.ops.aten
_DECOMPOSE = {
    _aten.silu.default: _silu, _aten.silu_backward.default: _silu_backward,
    _aten.softplus.default: _softplus, _aten.softplus_backward.default: _softplus_backward,
    _aten.tanh_backward.default: _tanh_backward, _aten.logsumexp.default: _logsumexp,
    _aten.tril.default: _tril,
    _aten.threshold_backward.default: _relu_backward,
    _aten.hardtanh.default: _hardtanh, _aten.hardtanh_backward.default: _hardtanh_backward,
    _aten.sigmoid_backward.default: _sigmoid_backward, _aten.var.correction: _var,
}


def nsm_edges(gm: torch.fx.GraphModule, mult: float = 1.0) -> EdgeCounts:
    """Edge counts of a traced graph, one per use of a value by an op."""
    counts: EdgeCounts = defaultdict(float)
    env: Dict[torch.fx.Node, str] = {}
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = "input"
        elif node.op == "get_attr":
            env[node] = "const"
        elif node.op == "call_function":
            inputs = [a for a in tree_leaves((node.args, node.kwargs))
                      if isinstance(a, torch.fx.Node)]
            names = _node_names(node)
            if names is None:  # edges flow through to its consumers
                env[node] = env.get(inputs[0], "const") if inputs else "const"
                continue
            for a in inputs:
                src = env.get(a)
                if src and src not in ("input", "const"):
                    counts[(src, names[0])] += mult
            for src, dst in zip(names, names[1:]):
                counts[(src, dst)] += mult
            env[node] = names[-1]
    return dict(counts)


# ---------------------------------------------------------------------------
# Fixed-vocabulary featurization (a copy of the reference's)
# ---------------------------------------------------------------------------


class NSMFeaturizer:
    """Maps edge-count dicts to a fixed (V x V) matrix / flat vector.

    Featurization is vectorized: op->index resolution goes through a dict
    (rebuilt lazily whenever ``vocab`` is replaced, e.g. by ``fit`` or a
    predictor ``load``) and cell accumulation is a single NumPy
    scatter-add over all edges, so per-query cost is O(E) dict lookups
    instead of O(E*V) ``list.index`` calls.
    """

    def __init__(self, vocab=None, max_vocab: int = 28):
        self.vocab = list(vocab) if vocab else None
        self.max_vocab = max_vocab
        self._index: Optional[Dict[str, int]] = None
        self._index_vocab = None  # vocab contents the index was built from

    def fit(self, edge_dicts) -> "NSMFeaturizer":
        freq: Dict[str, float] = defaultdict(float)
        for d in edge_dicts:
            for (a, b), n in d.items():
                freq[a] += n
                freq[b] += n
        ops = sorted(freq, key=lambda k: -freq[k])[: self.max_vocab - 1]
        self.vocab = sorted(ops) + ["<other>"]
        return self

    def _op_index(self) -> Dict[str, int]:
        key = tuple(self.vocab)  # content-based: survives in-place edits
        if self._index is None or self._index_vocab != key:
            self._index = {op: i for i, op in enumerate(self.vocab)}
            self._index_vocab = key
        return self._index

    def _idx(self, op: str) -> int:
        return self._op_index().get(op, len(self.vocab) - 1)

    def matrix(self, edges: EdgeCounts) -> np.ndarray:
        v = len(self.vocab)
        m = np.zeros((v, v), np.float64)
        if not edges:
            return m
        idx = self._op_index()
        other = v - 1
        rows = np.fromiter((idx.get(a, other) for a, _ in edges),
                           np.intp, count=len(edges))
        cols = np.fromiter((idx.get(b, other) for _, b in edges),
                           np.intp, count=len(edges))
        vals = np.fromiter(edges.values(), np.float64, count=len(edges))
        np.add.at(m, (rows, cols), vals)
        return m

    def vector(self, edges: EdgeCounts, log_scale: bool = True) -> np.ndarray:
        m = self.matrix(edges)
        flat = m.reshape(-1)
        aug = np.concatenate([flat, m.sum(0), m.sum(1)])  # + in/out degrees
        return np.log1p(aug) if log_scale else aug

    def vectors(self, edge_dicts, log_scale: bool = True) -> np.ndarray:
        """One (N, dim) block for N edge dicts. Per-record loop: the
        vectorization lives inside ``matrix`` (the scatter-add)."""
        if not edge_dicts:
            return np.zeros((0, self.dim), np.float64)
        return np.stack([self.vector(e, log_scale=log_scale)
                         for e in edge_dicts])

    @property
    def dim(self) -> int:
        v = len(self.vocab)
        return v * v + 2 * v


# ``make_fx`` keeps module-level state (``torch.fx``'s patcher), so two
# traces that overlap in threads fail; they take turns on this lock.
TRACE_LOCK = threading.RLock()


def trace(fn: Callable, *example_args) -> torch.fx.GraphModule:
    """The aten graph of ``fn`` traced on fake tensors made from the example
    arguments (real, ``meta`` or fake tensors, in any pytree), with every
    kernel pinned to its plain version in the calling thread. Traces in
    several threads run one at a time (``TRACE_LOCK``)."""
    with TRACE_LOCK, use_impls(attention="plain", ssd="plain", norm="plain"):
        return make_fx(fn, decomposition_table=_DECOMPOSE,
                       tracing_mode="fake")(*example_args)


def nsm_of_fn(fn: Callable, *example_args) -> EdgeCounts:
    """NSM edges of ``fn`` traced at the given example arguments."""
    return nsm_edges(trace(fn, *example_args))
