"""Shared neural-net layers: norms, RoPE, gated MLP, embeddings.

Port of ``repro.models.layers``. Apply functions take the mapping of
parameters produced from the matching ``*_spec`` (a dict or an
``nn.ParameterDict``). Compute runs in the activation dtype; reductions that
need it (norm statistics, SiLU, loss) run in fp32, as in the reference.
Weights keep the JAX layout (``x @ w``), so carrying them across is slicing.

RMSNorm runs through either the plain PyTorch math (the reference's inline
``apply_norm``) or the hand-written CUDA RMSNorm kernels, forward and
backward (the reference's Pallas ``rmsnorm``, which no model path of the
reference calls). By default the kernels take tensors on the card and the
plain math tensors on the CPU; ``set_norm_impl`` pins one of them. On a
DTensor the kernels run on each rank's rows (``_rmsnorm_local``). LayerNorm
always runs plain.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.models.module import spec
from repro_torch.models.switch import ImplSwitch

_SWITCH = ImplSwitch("norm")  # None: the kernel on the card, plain on the CPU


def set_norm_impl(impl: Optional[str]) -> None:
    """Pin RMSNorm to ``"plain"`` or ``"cuda"``; ``None`` restores the default
    choice by device."""
    _SWITCH.set(impl)


def get_norm_impl() -> Optional[str]:
    """The impl in force in the calling thread (``models.api.use_impls`` pins
    it there alone)."""
    return _SWITCH.get()


def _use_kernel(x) -> bool:
    return _SWITCH.use_kernel(x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": spec((d,), ("embed",), "ones", dtype=torch.float32),
                "bias": spec((d,), ("embed",), "zeros", dtype=torch.float32)}
    return {"scale": spec((d,), ("embed",), "ones", dtype=torch.float32)}


def _rmsnorm_local(x, gain, eps: float, keep_features: bool = False):
    """The RMSNorm kernels on a DTensor: each rank runs them on its own rows
    (any count of them, even or not: the whole shape is carried over). A
    sharded or partial normalised dim, and the gain, are made whole first;
    the gain's gradient is then the sum of the ranks' parts over the mesh
    dims that split the rows. A row dim so short that a rank would hold
    none of it (the kernels launch on one row or more) is made whole, with
    a warning. With ``keep_features`` the output takes x's split of the
    normalised dim back (each rank keeps its columns: no collective), as
    the plain path leaves it (``_features_made_whole``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.kernels import ops as kops

    mesh, last = x.device_mesh, x.ndim - 1

    def filled(d):  # every rank keeps a row of dim d (DTensor splits as torch.chunk)
        k = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim % x.ndim == d)
        return -(-x.shape[d] // k) * (k - 1) < x.shape[d]

    rows = [p if p.is_shard() and p.dim % x.ndim != last and filled(p.dim % x.ndim)
            else Replicate() for p in x.placements]
    short = [p for p, r in zip(x.placements, rows) if p.is_shard() and p.dim % x.ndim != last
             and r.is_replicate()]
    if short:
        warnings.warn(f"RMSNorm of {tuple(x.shape)} {tuple(x.placements)}: rows made whole "
                      f"on every rank, a split would leave a rank none", stacklevel=2)
    features = [p if p.is_shard() and p.dim % x.ndim == last else r
                for p, r in zip(x.placements, rows)]
    if list(x.placements) != rows:
        x = x.redistribute(mesh, rows)
    if isinstance(gain, DTensor):
        whole = [Replicate()] * mesh.ndim
        if list(gain.placements) != whole:
            gain = gain.redistribute(mesh, whole)
        gain = gain.to_local(grad_placements=[Partial() if p.is_shard() else Replicate()
                                              for p in rows])
    y = kops.rmsnorm(x.to_local(grad_placements=rows), gain, eps)
    y = DTensor.from_local(y, mesh, rows, run_check=False, shape=x.shape, stride=x.stride())
    return y.redistribute(mesh, features) if keep_features and features != rows else y


def _split_on(t, dim: int) -> bool:
    """Whether ``t`` is a DTensor split over its dim ``dim``."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor) and any(p.is_shard() and p.dim % t.ndim == dim % t.ndim
                                          for p in t.placements)


def _features_made_whole(p, x) -> bool:
    """Whether a norm makes the split of ``x``'s normalised dim whole, on
    either path, before the projections that follow; else its output keeps
    the split. LayerNorm always: DTensor hands its centred output back
    partial. RMSNorm of (B, S, D) where S splits evenly over the ranks that
    split D: the projections then split their rows over those ranks
    (``sharding.sequence_split_product``), and a D-split input would meet
    weights split on the same mesh dim, where DTensor gathers the weights
    and leaves the products partial. Where S does not split over them (a
    decode step's one token) the projections contract their share of D,
    as GSPMD partitions them, and a whole input would repeat them on every
    rank of those dims."""
    if "bias" in p:
        return True
    if x.ndim != 3 or not _split_on(x, -1):
        return False
    n = math.prod(x.device_mesh.size(i) for i, pl in enumerate(x.placements)
                  if pl.is_shard(x.ndim - 1))
    return x.shape[1] % n == 0


def apply_norm(p, x, eps: float = 1e-6):
    # on a DTensor the residual stream is summed first where a projection
    # left it partial over the model shards (prefill constrains it once a
    # layer, after the norms), since the norm is not linear; under sequence
    # parallelism the norm runs on the sequence shards of the residual stream
    # and its output is gathered before the projections that follow
    # (Megatron's all-gather)
    return shd.whole_sequence(_norm(p, shd.reduce_partials(x), eps))


def _norm(p, x, eps: float):
    # on a DTensor split over the normalised dim (an untied embedding's
    # output in prefill and decode) the layout of the output is decided
    # first, the same on both paths (``_features_made_whole``)
    whole = _features_made_whole(p, x)
    if "bias" not in p and _use_kernel(x):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return _rmsnorm_local(x, p["scale"], eps, keep_features=not whole)
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, p["scale"], eps)
    dt = x.dtype
    xf = x.float()
    if whole:
        xf = shd.whole_dim(xf, -1)
    if "bias" in p:  # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # RMSNorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rotary_dims: Optional[int] = None,
                     device=None):
    rd = rotary_dims or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float, style: str = "full"):
    """x: (..., S, H, D). positions: broadcastable to (..., S) integer.

    style "full": rotate all D dims (Llama / Qwen / Phi).
    style "2d":   ChatGLM partial rotary, rotating only the first half of the
                  head dims and passing the second half through.
    """
    d = x.shape[-1]
    rd = d // 2 if style == "2d" else d
    inv = rope_frequencies(d, theta, rd, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, rd//2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, rd//2) broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rot, x[..., rd:].float()], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": spec((d, 2, f), ("embed", None, "mlp")),  # fused gate+up
        "wo": spec((f, d), ("mlp", "embed")),
    }


def apply_mlp(p, x):
    wi = p["wi"].to(x.dtype)
    d, _, f = wi.shape
    if _split_on(wi, 2):
        # a DTensor split over the hidden dim: gate and up apart (fusing
        # them would merge the split dim into a strided one DTensor cannot
        # multiply)
        g, u = x @ wi[:, 0], x @ wi[:, 1]
    else:
        gu = shd.sequence_split_product(x, wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
        g, u = gu[..., 0, :], gu[..., 1, :]
    h = F.silu(g.float()).to(x.dtype) * u
    return shd.whole_sequence_grad(shd.sequence_split_product(h, p["wo"].to(x.dtype)))


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def padded_vocab(v: int) -> int:
    """Vocab rows padded to a multiple of 256, as in the reference (whose
    tables shard evenly on any mesh axis that way)."""
    return -(-v // 256) * 256


def embed_spec(cfg):
    v, d = padded_vocab(cfg.vocab_size), cfg.d_model
    if cfg.tie_embeddings:
        return {"table": spec((v, d), ("vocab", "embed"), "embed", scale=0.02)}
    return {
        "table": spec((v, d), (None, "mlp"), "embed", scale=0.02),
        "unembed": spec((d, v), ("embed", "vocab"), "normal"),
    }


def embed_tokens(p, tokens, dtype):
    table = p["table"]
    if _vocab_dims(table):
        return _vocab_parallel_lookup(tokens.long(), table).to(dtype)
    return F.embedding(tokens.long(), table).to(dtype)


def _vocab_dims(table):
    """The mesh dims over which a DTensor table's rows (the vocab) are split."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return []
    return [i for i, p in enumerate(table.placements) if p.is_shard() and p.dim == 0]


def _vocab_parallel_lookup(tokens, table):
    """Embedding lookup in a vocab-sharded table (Megatron's vocab-parallel
    embedding): each rank looks up the tokens of its own rows, zeros the
    others, and the rows are summed across the vocab shards. DTensor's own
    lookup leaves a masked partial that it fails to reduce on a 2-D mesh; this
    sum adds one row to zeros, so it equals the plain lookup bit for bit."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, dims = table.device_mesh, _vocab_dims(table)
    tok_pl = tuple(Replicate() if i in dims else p for i, p in enumerate(tokens.placements))
    tab_pl = tuple(p if i in dims else Replicate() for i, p in enumerate(table.placements))
    out_pl = tuple(Partial() if i in dims else p for i, p in enumerate(tok_pl))

    def lookup(tok, tab):
        idx = tok - shd.shard_index(mesh, dims) * tab.shape[0]
        mine = (idx >= 0) & (idx < tab.shape[0])
        rows = F.embedding(torch.where(mine, idx, 0), tab)
        return rows * mine[..., None].to(rows.dtype)

    return shd.local_map(lookup, list(out_pl), (tok_pl, tab_pl), mesh)(tokens, table)


def unembed(p, x, softcap: float = 0.0, vocab: int = 0):
    """Logits (..., V) in fp32. On a mesh where no dim splits the weight
    (the "dp" scheme gathers it), the rows' sequence is split over the mesh
    dims that leave the batch whole (``sequence_split_product``), so no rank
    repeats another's logits; the softcap, the pad mask and the loss take
    the sequence-split logits as they are."""
    w = p["table"].T if "unembed" not in p else p["unembed"]
    logits = shd.sequence_split_product(x, w.to(x.dtype)).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if vocab and vocab < logits.shape[-1]:
        # mask padded vocab columns out of the softmax
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


def _gold(logits, labels):
    """The label's logit. On a DTensor, the one-hot masked sum on each rank's
    own rows and columns (``local_map``; a sum over the ranks of a vocab
    split): DTensor gathers the whole batch for ``gather``, and given the
    whole vocab's columns it may gather the logits' vocab to meet them (a
    (8, 4096, 163840) fp32 tensor on moonshot-v1-16b-a3b's train cell). It
    adds one logit to zeros, so it equals the gather bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    logits = shd.reduce_partials(logits)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    lab_pl = [Replicate() if i in vocab else p for i, p in enumerate(logits.placements)]
    out_pl = [Partial() if i in vocab else p for i, p in enumerate(logits.placements)]

    def gold(lg, lab):
        first = shd.shard_index(mesh, vocab) * lg.shape[-1]
        cols = first + torch.arange(lg.shape[-1], device=lg.device)
        return torch.where(lab[..., None] == cols, lg, 0.0).sum(-1)

    return shd.local_map(gold, out_pl, (list(logits.placements), lab_pl), mesh)(logits, labels)


def _gathered(t):
    """A DTensor of token losses made whole on every rank (B x S values, a
    small all-gather): the mean then sums in the unsharded order, and its
    gradient is split back to the token shards before it meets the vocab
    (DTensor would otherwise spread a replicated gradient over the whole
    (B, S, V) logits and copy a batch shard of it)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _logsumexp(logits):
    """``logsumexp`` over the vocab. On a DTensor split over the vocab it is
    written out (max, then the sum of exponentials), so each rank reduces
    its own columns and only the (..., 1) statistics are reduced across
    ranks, as GSPMD partitions it; DTensor's own ``logsumexp`` makes the
    vocab whole on every rank first (4 rows x 4096 x 128256 fp32 logits,
    8 GiB, on llama-3.2-vision-90b's train cell)."""
    if not _split_on(logits, -1):
        return torch.logsumexp(logits, dim=-1)
    # each statistic is reduced where it is made: DTensor left to itself
    # may scatter a partial one over the sequence and move the logits (and
    # their gradient) to a sequence split to meet it
    m = shd.reduce_partials(logits.amax(-1, keepdim=True)).detach()
    total = shd.reduce_partials(torch.exp(logits - m).sum(-1, keepdim=True))
    return (m + torch.log(total))[..., 0]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. logits (..., V), labels (...) int."""
    lse = _logsumexp(logits)
    gold = _gold(logits, labels.long())
    nll = _gathered(lse - gold)
    if mask is None:
        return nll.mean()
    mask = _gathered(mask.float())
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
