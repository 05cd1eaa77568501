"""Model-facing entry points for the port's kernels.

Port of ``repro.kernels.ops``: adapt model-layout tensors to kernel
layouts. A tensor on the card goes to the hand-written kernel, which
launches or raises; a tensor on the CPU takes the kernel's plain version.
The kernel masks ragged lengths itself, so no block size is picked here.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as ref_lib


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
