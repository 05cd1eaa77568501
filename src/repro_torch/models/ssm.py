"""Mamba2 (SSD — state-space duality) blocks: chunked prefill path + decode.

Port of ``repro.models.ssm``. The chunked SSD algorithm (arXiv:2405.21060)
splits the sequence into chunks of length Q: a quadratic attention-like
intra-chunk term plus a sequential inter-chunk state recurrence of length
L/Q. ``ssd_chunked_ref`` is the plain PyTorch version; the hand-written
CUDA kernel ``repro_torch.kernels.ssd_scan`` (the reference's Pallas
``"pallas"`` path) computes the same scan on the card. By default the
kernel takes tensors on the card and the plain path tensors on the CPU;
``set_ssd_impl`` pins one of them.

Projections are stored as separate tensors per semantic chunk (z, x, B, C,
dt), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (grad_in_layout, local_map, sequence_split_product,
                                              shard_index, split_idle, whole_sequence_grad)
from repro_torch.models.module import spec
from repro_torch.models.switch import ImplSwitch

_SWITCH = ImplSwitch("ssd")  # None: the kernel on the card, plain on the CPU


def set_ssd_impl(impl: Optional[str]) -> None:
    """Pin the scan to ``"plain"`` or ``"cuda"``; ``None`` restores the
    default choice by device."""
    _SWITCH.set(impl)


def get_ssd_impl() -> Optional[str]:
    """The impl in force in the calling thread (``models.api.use_impls`` pins
    it there alone)."""
    return _SWITCH.get()


def ssm_spec(cfg):
    d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv)
    return {
        "in_z": spec((d, di), ("embed", "mlp")),
        "in_x": spec((d, di), ("embed", "mlp")),
        "in_b": spec((d, n), ("embed", None)),
        "in_c": spec((d, n), ("embed", None)),
        "in_dt": spec((d, h), ("embed", "heads")),
        "conv_x": spec((w, di), (None, "mlp"), scale=0.5),
        "conv_b": spec((w, n), (None, None), scale=0.5),
        "conv_c": spec((w, n), (None, None), scale=0.5),
        "conv_bias_x": spec((di,), ("mlp",), "zeros"),
        "conv_bias_b": spec((n,), (None,), "zeros"),
        "conv_bias_c": spec((n,), (None,), "zeros"),
        "a_log": spec((h,), ("heads",), "zeros", dtype=torch.float32),
        "d_skip": spec((h,), ("heads",), "ones", dtype=torch.float32),
        "dt_bias": spec((h,), ("heads",), "zeros", dtype=torch.float32),
        "norm_scale": spec((di,), ("mlp",), "ones", dtype=torch.float32),
        "out": spec((di, d), ("mlp", "embed")),
    }


def _causal_conv(x, w, b, halo=None):
    """Depthwise causal conv. x (B,L,C), w (W,C), b (C,); ``halo`` (B,W-1,C)
    the positions before x's first (zeros where None)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _conv_per_shard(x, w, b)
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0)) if halo is None else torch.cat([halo, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):  # W is 4: unrolled multiply-adds, as in the reference
        out = out + xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _conv_per_shard(x, w, b):
    """The conv on DTensors, run on each rank's batch and channel shards
    (``local_map``): it mixes neighbouring positions of one channel only,
    so the batch and channel splits stay and the sequence is made whole
    (torch 2.11's DTensor cannot plan the redistribution ``F.pad`` asks for
    at full width on a (16, 16) mesh). ``apply_ssm`` hands x's channels
    over split where the scan's heads are (B's and C's few channels come
    split over the sequence, which is gathered)."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    xs, ws, bs = [], [], []
    for p in x.placements:
        d = p.dim % 3 if p.is_shard() else None
        x_pl, w_pl, b_pl = ((Shard(0), R, R) if d == 0 else
                            (Shard(2), Shard(1), Shard(0)) if d == 2 else (R, R, R))
        xs.append(x_pl)
        ws.append(w_pl)
        bs.append(b_pl)
    return local_map(_causal_conv, xs, (xs, ws, bs), x.device_mesh)(x, w, b)


def _conv_step(buf, x_t, w, b):
    """Single-token causal conv. buf (B,W-1,C) past inputs; x_t (B,C)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)  # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return y, window[:, 1:, :]


def _use_kernel(x) -> bool:
    return _SWITCH.use_kernel(x)


def ssd_chunked(xb, dt, a_neg, bmat, cmat, chunk: int):
    """Chunked SSD scan (fp32 decay math).

    xb (B,L,H,P) pre-scaled inputs (x*dt); dt (B,L,H); a_neg (H,) negative;
    bmat/cmat (B,L,N). Returns y (B,L,H,P), final state (B,H,N,P) fp32.
    """
    from torch.distributed.tensor import DTensor

    if isinstance(xb, DTensor):
        return _per_shard(xb, dt, a_neg, bmat, cmat, chunk)
    if _use_kernel(xb):
        from repro_torch.kernels import ops as kops
        return kops.ssd_scan(xb, dt, a_neg, bmat, cmat, chunk)
    return ssd_chunked_ref(xb, dt, a_neg, bmat, cmat, chunk)


def _per_shard(xb, dt, a_neg, bmat, cmat, chunk: int):
    """The scan on DTensors, run on each rank's batch and head shards
    (``local_map``): it is independent across both, and DTensor cannot
    multiply a batch and heads split over two mesh dims once they merge.
    Per mesh dim: the batch split (every input but ``a_neg`` on its dim 0),
    the heads split (``xb``/``dt`` on dim 2, ``a_neg`` on 0; B and C whole),
    or nothing split; the sequence is made whole. A mesh dim that splits
    neither the rows nor the heads splits the heads where they divide it
    (``split_idle``; ``apply_ssm`` hands them over split so already). The
    output and the state keep that layout: the caller takes them back."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    ins, outs = ([], [], [], [], []), ([], [])
    for p in split_idle(xb, 2):
        d = p.dim % 4 if p.is_shard() else None
        row = ((Shard(0), Shard(0), R, Shard(0), Shard(0)) if d == 0 else
               (Shard(2), Shard(2), Shard(0), R, R) if d == 2 else (R,) * 5)
        out = (Shard(0), Shard(0)) if d == 0 else (Shard(2), Shard(1)) if d == 2 else (R, R)
        for lst, pl in zip(ins + outs, row + out):
            lst.append(pl)
    return local_map(ssd_chunked, outs, ins + (None,), xb.device_mesh)(
        xb, dt, a_neg, bmat, cmat, chunk)


def ssd_chunked_ref(xb, dt, a_neg, bmat, cmat, chunk: int):
    """The plain version of the scan, written out as the reference's."""
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    if l % q:
        # pad to a chunk multiple: x=0 contributes nothing to outputs or
        # state, dt=0 makes the padded decay exactly 1 (state preserved)
        pad = q - l % q
        y, s = ssd_chunked_ref(F.pad(xb, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                               a_neg, F.pad(bmat, (0, 0, 0, pad)),
                               F.pad(cmat, (0, 0, 0, pad)), chunk)
        return y[:, :l], s
    nc = l // q
    dtype = xb.dtype

    loga = (dt.float() * a_neg).reshape(b, nc, q, h)  # <= 0
    xc = xb.reshape(b, nc, q, h, p).float()
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    cum = torch.cumsum(loga, dim=2)  # (B,C,Q,H) inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,Q,Q,H) t,s
    causal = torch.ones((q, q), dtype=torch.bool, device=xb.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)

    # Intra-chunk (quadratic) term.
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", cb[..., None] * decay, xc)

    # Per-chunk contribution to the carried state.
    w_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,C,Q,H) decay to chunk end
    s_chunk = torch.einsum("bcsn,bcshp->bchnp", bc, w_end[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,C,H) total chunk decay

    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=xb.device)
    s_prev = []
    for c in range(nc):  # the reference's lax.scan over chunks
        s_prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prev, dim=1)  # (B,C,H,N,P) state entering chunk

    # Inter-chunk term: y_t += C_t . (decay-from-chunk-start * S_prev)
    w_start = torch.exp(cum)  # (B,C,Q,H)
    cs = torch.einsum("bctn,bchnp->bcthp", cc, s_prev)  # C_t . S_prev
    y_inter = w_start[..., None] * cs

    y = (y_intra + y_inter).to(dtype).reshape(b, l, h, p)
    return y, s


def _padded(chunk: int, *ts):
    """The chunk length min(chunk, L) and the scan's inputs (B, L, ...)
    zero-padded to a multiple of it, as ``ssd_chunked_ref`` pads them."""
    l = ts[0].shape[1]
    q = min(chunk, l)
    pad = -l % q
    return q, [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t for t in ts]


def _chunk_cum(dt, a_neg, b, nc, q, h):
    return torch.cumsum((dt.float() * a_neg).reshape(b, nc, q, h), dim=2)  # (B,C,Q,H)


def ssd_states_ref(xb, dt, a_neg, bmat, chunk: int):
    """The scan's first call on a block of the sequence, plain: (states
    (B,C,H,N,P) entering each of its C chunks, decay (B,C,H) each chunk's
    total decay, final (B,H,N,P) the block's final state), all fp32 and from
    a zero state. With ``ssd_output_ref`` it computes ``ssd_chunked_ref``'s
    products once each: the chunk states here, C·Bᵀ, G·x and C·S_prev
    there."""
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    q, (xb, dt, bmat) = _padded(chunk, xb, dt, bmat)
    nc = xb.shape[1] // q
    cum = _chunk_cum(dt, a_neg, b, nc, q, h)
    xc = xb.reshape(b, nc, q, h, p).float()
    bc = bmat.reshape(b, nc, q, n).float()
    w_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,C,Q,H) decay to chunk end
    s_chunk = torch.einsum("bcsn,bcshp->bchnp", bc, w_end[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,C,H)
    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=xb.device)
    s_prev = []
    for c in range(nc):
        s_prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    return torch.stack(s_prev, dim=1), chunk_decay, s


def ssd_output_ref(xb, dt, a_neg, bmat, cmat, chunk: int, states, decay, final, s_in=None):
    """The scan's second call, plain: (y (B,L,H,P) in xb's dtype, the final
    state (B,H,N,P) fp32) of the block, from ``ssd_states_ref``'s results
    and the block's initial state ``s_in`` (B,H,N,P), or zero where None.
    ``s_in`` decayed to each chunk's start joins that chunk's entering state
    before C·S_prev, so it costs no product of its own."""
    b, l, h, p = xb.shape
    n = bmat.shape[-1]
    dtype = xb.dtype
    q, (xb, dt, bmat, cmat) = _padded(chunk, xb, dt, bmat, cmat)
    nc = xb.shape[1] // q
    cum = _chunk_cum(dt, a_neg, b, nc, q, h)
    xc = xb.reshape(b, nc, q, h, p).float()
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,Q,Q,H) t,s
    causal = torch.ones((q, q), dtype=torch.bool, device=xb.device).tril()
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    y_intra = torch.einsum("bctsh,bcshp->bcthp",
                           cb[..., None] * torch.where(causal[None, None, :, :, None],
                                                       torch.exp(seg), 0.0), xc)
    if s_in is not None:
        start = torch.cumprod(torch.cat([torch.ones_like(decay[:, :1]), decay[:, :-1]], 1), 1)
        states = states + start[..., None, None] * s_in[:, None]
        final = final + decay.prod(1)[..., None, None] * s_in
    cs = torch.einsum("bctn,bchnp->bcthp", cc, states)  # C_t . S_prev
    y = (y_intra + torch.exp(cum)[..., None] * cs).to(dtype).reshape(b, nc * q, h, p)
    return y[:, :l], final


def ssd_carry(finals, decays, upto: int):
    """The state entering block ``upto`` of a sequence cut into blocks, from
    each block's final state from zero ``finals`` (K,B,H,N,P) and its total
    decay ``decays`` (K,B,H): S_{k+1} = decay_k S_k + final_k from S_0 = 0.
    None for block 0."""
    s = None
    for j in range(upto):
        s = finals[j] if s is None else s * decays[j][..., None, None] + finals[j]
    return s


def ssd_states(xb, dt, a_neg, bmat, chunk: int):
    """The scan's first call on a block (``ssd_states_ref``), on the kernel
    where ``ssd_chunked`` would take it."""
    if _use_kernel(xb):
        from repro_torch.kernels import ops as kops
        return kops.ssd_states(xb, dt, a_neg, bmat, chunk)
    return ssd_states_ref(xb, dt, a_neg, bmat, chunk)


def ssd_output(xb, dt, a_neg, bmat, cmat, chunk: int, states, decay, final, s_in=None):
    """The scan's second call on a block (``ssd_output_ref``), on the kernel
    where ``ssd_chunked`` would take it."""
    if _use_kernel(xb):
        from repro_torch.kernels import ops as kops
        return kops.ssd_output(xb, dt, a_neg, bmat, cmat, chunk, states, decay, final, s_in)
    return ssd_output_ref(xb, dt, a_neg, bmat, cmat, chunk, states, decay, final, s_in)


def apply_ssm(p, cfg, x, return_cache: bool = False):
    """Full-sequence Mamba2 block. x (B,L,D) -> (y (B,L,D), cache_or_state)."""
    seq = _sequence_region(x, cfg.ssm_chunk)
    if seq is not None:
        out, cache = _apply_ssm_split(p, cfg, x, seq)
        return out, (cache if return_cache else cache["state"])
    b, l, d = x.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.ssm_conv
    # on a mesh, a projection whose weight is whole runs on token shards
    # (B and C always; z, x, dt and out under "dp"); one whose weight splits
    # over its features (z, x, dt and out under "sp") keeps its gradient in
    # layout (``_project``)
    z, xi_raw, bm_raw, cm_raw, dt_raw = (_project(x, p[k].to(x.dtype))
                                         for k in ("in_z", "in_x", "in_b", "in_c", "in_dt"))

    # the conv and the scan run on head shards: a mesh dim that splits the
    # tokens' sequence but neither rows nor heads (the idle "model" dim
    # under "dp") splits x's channels and dt's heads instead where the heads
    # divide it (``split_idle``; d_inner = H*P, so dt's layout splits x by
    # heads alike), by an all-to-all each; B and C (N channels) are made
    # whole in the conv
    heads = split_idle(dt_raw, 2) if hasattr(dt_raw, "placements") else None
    xi = F.silu(_causal_conv(_laid_out(xi_raw, heads), p["conv_x"],
                             p["conv_bias_x"]).float()).to(x.dtype)
    bm = F.silu(_causal_conv(bm_raw, p["conv_b"], p["conv_bias_b"]).float()).to(x.dtype)
    cm = F.silu(_causal_conv(cm_raw, p["conv_c"], p["conv_bias_c"]).float()).to(x.dtype)

    dt = F.softplus(_laid_out(dt_raw, heads).float() + p["dt_bias"])  # (B,L,H)
    a_neg = -torch.exp(p["a_log"])  # (H,)
    xh = xi.reshape(b, l, h, pdim)
    xb = (xh.float() * dt[..., None]).to(x.dtype)

    y, s_final = ssd_chunked(xb, dt, a_neg, bm, cm, cfg.ssm_chunk)
    y = y + (p["d_skip"][:, None] * xh.float()).to(x.dtype)
    y = y.reshape(b, l, cfg.d_inner)
    if hasattr(y, "placements"):
        # z's splits (the sequence's, from the heads by an all-to-all where
        # the region split them alone; a partial z keeps y's), and the state
        # without the region's own split
        y = _laid_out(y, [pz if pz.is_shard() else py
                          for py, pz in zip(y.placements, z.placements)])
        s_final = _laid_out(s_final, _state_layout(s_final, dt_raw))

    # Gated RMSNorm then output projection, per token.
    y = _gated_norm(y, z, p["norm_scale"])
    out = whole_sequence_grad(sequence_split_product(y, p["out"].to(x.dtype)))
    if return_cache:
        # copies, so the cache does not hold the whole (B,L,.) projections alive
        cache = {"state": s_final,
                 "conv_x": xi_raw[:, l - (w - 1):, :].clone(),
                 "conv_b": bm_raw[:, l - (w - 1):, :].clone(),
                 "conv_c": cm_raw[:, l - (w - 1):, :].clone()}
        return out, cache
    return out, s_final


def _sequence_region(x, chunk: int):
    """The mesh dims over which a prefill's Mamba2 block runs on sequence
    shards (``_apply_ssm_split``), or None. Where no gradient is tracked and
    the DTensor ``x`` (B,L,D) splits nothing but its rows (evenly) and its
    sequence, its sequence is split over every mesh dim of more than one
    rank that does not split its rows (the residual's own split under "sp";
    where x is whole there, a local slice), as long as each rank's block is
    a whole number of chunks. The block then moves its weights (~13 MB at
    mamba2-370m's widths) and small tensors between those ranks, where the
    head-split region gathers the residual's sequence and repeats C·Bᵀ on
    every rank."""
    from torch.distributed.tensor import DTensor

    if torch.is_grad_enabled() or not isinstance(x, DTensor) or x.ndim != 3:
        return None
    mesh = x.device_mesh
    dims = [p.dim % 3 if p.is_shard() else None for p in x.placements]
    if not set(dims) <= {None, 0, 1}:
        return None
    seq = [i for i, d in enumerate(dims) if d != 0 and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in seq)
    rows = math.prod(mesh.size(i) for i, d in enumerate(dims) if d == 0)
    if not seq or x.shape[0] % rows or x.shape[1] % (n * chunk):
        return None
    return seq


def sequence_layout(x, cfg):
    """The placements on which a prefill's Mamba2 block over ``x`` runs on
    sequence shards (``_sequence_region``), or None: its rows' split and
    the sequence split over the region's mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    seq = _sequence_region(x, cfg.ssm_chunk)
    if seq is None:
        return None
    return tuple(Shard(1) if i in seq else pl if pl.is_shard() else Replicate()
                 for i, pl in enumerate(x.placements))


def _apply_ssm_split(p, cfg, x, seq):
    """``apply_ssm`` on each rank's rows and block of the sequence (the
    sequence split over the mesh dims ``seq``), its weights made whole: the
    block runs ``_ssm_block`` on its local tensors, whose two exchanges are
    all-gathers over ``seq`` (the conv's last positions, the scan's final
    state and decay). The output keeps the region's layout; the cache (the whole
    sequence's, as the unsharded block returns it) splits the state's heads
    and ``conv_x``'s channels over ``seq`` where they divide evenly."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    n = math.prod(mesh.size(i) for i in seq)
    rows = [pl if pl.is_shard() and pl.dim % 3 == 0 else Replicate() for pl in x.placements]
    x = _laid_out(x, [Shard(1) if i in seq else pl for i, pl in enumerate(x.placements)])
    weights = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in p.items()}
    block = _ssm_block(weights, cfg, x.to_local(), shard_index(mesh, seq), n)
    (out, cache), = run_blocks([block], lambda sent: _gather_blocks(sent[0], mesh, seq))
    out = DTensor.from_local(out, mesh, x.placements, run_check=False, shape=x.shape,
                             stride=x.stride())

    def laid_out(name, dim=None):
        t = DTensor.from_local(cache[name], mesh, rows, run_check=False)
        if dim is None or t.shape[dim] % n:
            return t
        return _laid_out(t, [Shard(dim) if i in seq else pl for i, pl in enumerate(rows)])

    return out, {"state": laid_out("state", 1), "conv_x": laid_out("conv_x", 2),
                 "conv_b": laid_out("conv_b"), "conv_c": laid_out("conv_c")}


def _gather_blocks(t, mesh, dims):
    """Every rank's ``t`` over the mesh dims ``dims``, stacked (K, ...) in
    the order of their blocks of the sequence (``shard_index``): DTensor's
    all-gather of ``t`` declared split over ``dims`` along a new dim 0 (the
    other dims' ranks hold their own rows and gather nothing)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pls = [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(t[None].contiguous(), mesh, pls, run_check=False).full_tensor()


def run_blocks(blocks, gather):
    """Drive the block generators (``_ssm_block``) of one sequence in
    lockstep: at each exchange ``gather`` takes the list of what each sent
    and returns the stack of all blocks' (K, ...), sent back to each. One
    generator a rank on a mesh, ``gather`` an all-gather; or every block in
    one process (``apply_ssm_blocks``). Returns each block's result."""
    sent = [next(g) for g in blocks]
    results = [None] * len(blocks)
    while sent:
        got = gather(sent)
        sent = []
        for i, g in enumerate(blocks):
            try:
                sent.append(g.send(got))
            except StopIteration as stop:
                results[i] = stop.value
    return results


def apply_ssm_blocks(p, cfg, x, blocks: int):
    """``apply_ssm`` with cache on plain tensors, computed as a sequence
    split over ``blocks`` ranks computes it (``_ssm_block`` on each block,
    the exchanges stacked in this process): (y (B,L,D), cache). The
    sequence must cut into blocks of whole chunks."""
    b, l, _ = x.shape
    if l % (blocks * cfg.ssm_chunk):
        raise ValueError(f"{l} positions do not cut into {blocks} blocks of whole "
                         f"{cfg.ssm_chunk}-position chunks")
    parts = x.chunk(blocks, dim=1)
    res = run_blocks([_ssm_block(p, cfg, xk, k, blocks) for k, xk in enumerate(parts)],
                     lambda sent: torch.stack(sent))
    return torch.cat([y for y, _ in res], dim=1), res[-1][1]


def _ssm_block(p, cfg, x, k: int, blocks: int):
    """The Mamba2 block on block ``k`` of ``blocks`` of the sequence: x
    (B,L/blocks,D) and the weights ``p`` plain tensors, the weights whole.
    A generator: it yields what the blocks exchange and receives every
    block's, stacked (blocks, ...) in sequence order (``run_blocks``):
    first the conv inputs' last W-1 positions (the next block's halo), then
    its scan's final state and total decay from a zero state (the states
    call), from which it takes the state entering it (``ssd_carry``) for
    the output call. Returns (y (B,L/blocks,D), cache): the whole
    sequence's cache, as the unsharded block returns it."""
    b, l, _ = x.shape
    h, pdim, w, n, di = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv, cfg.ssm_state,
                         cfg.d_inner)
    z, xi_raw, bm_raw, cm_raw, dt_raw = (x @ p[name].to(x.dtype)
                                         for name in ("in_z", "in_x", "in_b", "in_c", "in_dt"))
    raw = torch.cat([xi_raw, bm_raw, cm_raw], dim=-1)  # one depthwise conv over all three
    tails = yield raw[:, l - (w - 1):]
    halo = tails[k - 1] if k else None
    conv = _causal_conv(raw, torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], 1),
                        torch.cat([p["conv_bias_x"], p["conv_bias_b"], p["conv_bias_c"]]), halo)
    conv = F.silu(conv.float()).to(x.dtype)
    xi, bm, cm = conv.split([di, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,L,H)
    a_neg = -torch.exp(p["a_log"])
    xh = xi.reshape(b, l, h, pdim)
    xb = (xh.float() * dt[..., None]).to(x.dtype)
    states, decay, final = ssd_states(xb, dt, a_neg, bm, cfg.ssm_chunk)
    pairs = yield torch.cat([final.reshape(b, h, n * pdim), decay.prod(1)[..., None]], -1)
    finals, decays = pairs[..., :-1].reshape(blocks, b, h, n, pdim), pairs[..., -1]
    y, _ = ssd_output(xb, dt, a_neg, bm, cm, cfg.ssm_chunk, states, decay, final,
                      ssd_carry(finals, decays, k))
    y = y + (p["d_skip"][:, None] * xh.float()).to(x.dtype)
    y = _gated_norm(y.reshape(b, l, di), z, p["norm_scale"])
    out = y @ p["out"].to(x.dtype)
    last = tails[-1]
    return out, {"state": ssd_carry(finals, decays, blocks),
                 "conv_x": last[..., :di].contiguous(), "conv_b": last[..., di:di + n].contiguous(),
                 "conv_c": last[..., di + n:].contiguous()}


def _project(x, w):
    """``x @ w``: on token shards where ``w`` is whole
    (``sequence_split_product``), else with its gradient kept in layout
    (``grad_in_layout``)."""
    if all(pl.is_replicate() for pl in getattr(w, "placements", ())):
        return sequence_split_product(x, w)
    return grad_in_layout(x @ w)


def _state_layout(s, dt):
    """The final state's (B,H,N,P) layout: its heads split only over the
    mesh dims that split the projection ``dt``'s."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if pl.is_shard(1) and not pd.is_shard(2) else pl
            for pl, pd in zip(s.placements, dt.placements)]


def _laid_out(t, pls):
    """The DTensor ``t`` redistributed to ``pls``; as it is where ``pls`` is
    None or its own."""
    if pls is None or tuple(t.placements) == tuple(pls):
        return t
    return t.redistribute(t.device_mesh, pls)


def _gated_norm(y, z, scale, eps: float = 1e-6):
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale).to(y.dtype)


def decode_ssm(p, cfg, x_t, cache):
    """Single-token Mamba2 step. x_t (B,1,D); cache {"state","conv_*"}."""
    b = x_t.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    xt = x_t[:, 0]
    z = xt @ p["in_z"].to(xt.dtype)
    xi = xt @ p["in_x"].to(xt.dtype)
    bm = xt @ p["in_b"].to(xt.dtype)
    cm = xt @ p["in_c"].to(xt.dtype)
    dt = xt @ p["in_dt"].to(xt.dtype)

    xi, conv_x = _conv_step(cache["conv_x"], xi, p["conv_x"], p["conv_bias_x"])
    bm, conv_b = _conv_step(cache["conv_b"], bm, p["conv_b"], p["conv_bias_b"])
    cm, conv_c = _conv_step(cache["conv_c"], cm, p["conv_c"], p["conv_bias_c"])
    xi = F.silu(xi.float()).to(xt.dtype)
    bm = F.silu(bm.float())
    cm = F.silu(cm.float())

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    a = torch.exp(dt * -torch.exp(p["a_log"]))  # (B,H) decay
    xh = xi.reshape(b, h, pdim).float()
    s = cache["state"]  # (B,H,N,P) fp32
    s = s * a[..., None, None] + torch.einsum("bn,bhp->bhnp", bm, xh * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", cm, s)
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(b, cfg.d_inner).to(x_t.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    out = (y @ p["out"].to(y.dtype))[:, None, :]
    new_cache = {"state": s, "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c}
    return out, new_cache


def ssm_cache_shape(cfg, batch: int):
    w, di, n = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    return {
        "state": (batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
        "conv_x": (batch, w - 1, di),
        "conv_b": (batch, w - 1, n),
        "conv_c": (batch, w - 1, n),
    }
