"""Model-facing entry points for the port's kernels.

Port of ``repro.kernels.ops``: adapt model-layout tensors to kernel
layouts. A tensor on the card goes to the hand-written kernel, which
launches or raises; a tensor on the CPU takes the kernel's plain version.
The kernels mask ragged lengths themselves, so no block size is picked here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Model layout: q (B,Sq,H,hd), k/v (B,Sk,KV,hd) with KV dividing H
    (grouped K/V, or pre-expanded with KV = H as the reference takes them);
    ``q_offset`` is the first query's position under the causal mask.

    On the card the kernel reads these tensors as they are: no transpose,
    no copy and no expansion of K/V. On the CPU, K/V are expanded to H
    heads and ``attention_ref`` runs in the (BH, S, hd) layout.
    """
    if q.is_cuda:
        return fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"{kv} KV heads do not divide {h} query heads")
    k, v = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, -1, hd) for t in (q, k, v))
    o = ref_lib.attention_ref(qf, kf, vf, causal, q_offset)
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def ssd_scan(xb, dt, a_neg, bmat, cmat, chunk: int):
    """Model layout: xb (B,L,H,P), dt (B,L,H), bmat/cmat (B,L,N).

    Returns (y (B,L,H,P), final_state (B,H,N,P) fp32) matching
    ``repro_torch.models.ssm.ssd_chunked_ref``. The kernel reads this layout
    and writes the final state itself, so no layout copy and no second pass
    is made (the reference transposes to (B,H,L,P) and rebuilds the state).
    """
    if xb.is_cuda:
        return ssd.ssd_scan_blhp(xb.contiguous(), dt.contiguous(), a_neg.contiguous(),
                                 bmat.contiguous(), cmat.contiguous(), chunk)
    if xb.device.type == "cpu":
        from repro_torch.models.ssm import ssd_chunked_ref
        return ssd_chunked_ref(xb, dt, a_neg, bmat, cmat, chunk)
    raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {xb.device}")


def ssd_states(xb, dt, a_neg, bmat, chunk: int):
    """The scan's first call on a block of the sequence (model layout):
    (states entering each chunk, each chunk's decay, the block's final
    state), from zero, matching ``repro_torch.models.ssm.ssd_states_ref``."""
    if xb.is_cuda:
        return ssd.ssd_states_blhp(xb.contiguous(), dt.contiguous(), a_neg.contiguous(),
                                   bmat.contiguous(), chunk)
    if xb.device.type == "cpu":
        from repro_torch.models.ssm import ssd_states_ref
        return ssd_states_ref(xb, dt, a_neg, bmat, chunk)
    raise ValueError(f"ssd_states runs on CUDA or CPU tensors, not {xb.device}")


def ssd_output(xb, dt, a_neg, bmat, cmat, chunk: int, states, decay, final, s_in=None):
    """The scan's second call: (y, final state) of the block from
    ``ssd_states``' results and the block's initial state ``s_in`` (or
    zero), matching ``repro_torch.models.ssm.ssd_output_ref``."""
    if xb.is_cuda:
        return ssd.ssd_output_blhp(xb.contiguous(), dt.contiguous(), a_neg.contiguous(),
                                   bmat.contiguous(), cmat.contiguous(), chunk, states, decay,
                                   final, None if s_in is None else s_in.contiguous())
    if xb.device.type == "cpu":
        from repro_torch.models.ssm import ssd_output_ref
        return ssd_output_ref(xb, dt, a_neg, bmat, cmat, chunk, states, decay, final, s_in)
    raise ValueError(f"ssd_output runs on CUDA or CPU tensors, not {xb.device}")


class _RMSNorm(torch.autograd.Function):
    """The RMSNorm kernels as one differentiable op. The forward saves the
    rows' rstd, so the backward kernel does not recompute it (and a remat
    recompute launches the forward kernel once more, not twice)."""

    @staticmethod
    def forward(ctx, x2, gain, eps):
        y, rstd = rn.rmsnorm_fwd(x2, gain, eps)
        ctx.save_for_backward(x2, gain, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gain, rstd = ctx.saved_tensors
        dx, dgain = rn.rmsnorm_bwd(x2, gain, rstd, dy.contiguous())
        return dx, dgain, None


def rmsnorm(x, gain, eps: float = 1e-6):
    """x (..., D) -> normalized, differentiable; flattens leading dims for the
    row kernels. On the card the forward and backward kernels run; on the
    CPU the plain ``rmsnorm_ref`` under autograd."""
    if x.is_cuda:
        shape = x.shape
        return _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), gain, eps).reshape(shape)
    if x.device.type == "cpu":
        return ref_lib.rmsnorm_ref(x, gain, eps)
    raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, not {x.device}")
