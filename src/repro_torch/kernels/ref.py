"""Plain PyTorch versions of the port's kernels: the oracles they are held
against, and the path a wrapper takes for tensors on the CPU."""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """q (BH,Sq,d), k/v (BH,Sk,d) -> (BH,Sq,d); fp32 softmax.

    Port of ``repro.kernels.ref.attention_ref``; the causal mask is aligned
    top-left (query i sees keys 0..i), as there, or with ``q_offset`` keys
    0..i + q_offset (a block of the queries that starts at that position).
    """
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= q_offset + torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_scan_ref(xb, dt, a_neg, bmat, cmat, chunk: int):
    """Same contract as the reference's ``kernels.ssd_scan.ssd_scan_bhlp``:
    xb (B,H,L,P), dt (B,H,L), bmat/cmat (B,L,N) -> y (B,H,L,P).

    Port of ``repro.kernels.ref.ssd_scan_ref``, through ``ssd_chunked_ref``.
    """
    from repro_torch.models.ssm import ssd_chunked_ref
    y, _ = ssd_chunked_ref(xb.transpose(1, 2), dt.transpose(1, 2), a_neg, bmat, cmat, chunk)
    return y.transpose(1, 2)


def rmsnorm_ref(x, gain, eps: float = 1e-6):
    """x (..., D), gain (D,) -> x * rsqrt(mean(x^2) + eps) * gain in x's dtype,
    fp32 statistics. Port of ``repro.kernels.ref.rmsnorm_ref``."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gain.float()).to(x.dtype)
