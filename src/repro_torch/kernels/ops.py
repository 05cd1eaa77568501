"""Model-facing entry points for the port's kernels.

Port of ``repro.kernels.ops``: adapt model-layout tensors to kernel
layouts. A tensor on the card goes to the hand-written kernel, which
launches or raises; a tensor on the CPU takes the kernel's plain version.
The kernel masks ragged lengths itself, so no block size is picked here.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels import ssd_scan as ssd


def flash_attention(q, k, v, causal: bool = True):
    """Model layout: q (B,Sq,H,hd), k/v (B,Sk,H,hd) (pre-expanded GQA)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, sq, hd)
    kf = k.transpose(1, 2).reshape(b * h, sk, hd)
    vf = v.transpose(1, 2).reshape(b * h, sk, hd)
    if q.is_cuda:
        o = fa.flash_attention_bhsd(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                                    causal=causal)
    elif q.device.type == "cpu":
        o = ref_lib.attention_ref(qf, kf, vf, causal)
    else:
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
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
