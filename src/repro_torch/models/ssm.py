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

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (grad_in_layout, local_map, sequence_split_product,
                                              split_idle, whole_sequence_grad)
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


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,L,C), w (W,C), b (C,)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _conv_per_shard(x, w, b)
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
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


def apply_ssm(p, cfg, x, return_cache: bool = False):
    """Full-sequence Mamba2 block. x (B,L,D) -> (y (B,L,D), cache_or_state)."""
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
