"""Comparison baselines from the paper's evaluation (§4.1).

Port of ``repro.core.baselines``.

- Shape inference [15]: memory = sizes of weights + inputs + outputs
  discoverable from the computation graph. The paper reports 46.8% MRE —
  it systematically underestimates because workspace/temporaries are
  invisible to shapes. Copied.
- MLP regressor [27, 29] (PerfNet-style): a small 4-layer MLP trained in
  PyTorch on the same features, full-batch Adam as in the reference. It runs
  on the card unless the caller asks for the CPU. Its initial weights are
  drawn from a ``torch.Generator`` seeded with ``seed``; ``jax.random``
  cannot be replayed, so ``fit`` also takes initial weights (the parity
  tests hand it the reference's).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.features import ProfileRecord


def shape_inference_memory(record: ProfileRecord) -> float:
    """Weights + input/output tensor bytes (fp32), per the [15] baseline."""
    params_bytes = record.params * 4.0
    if record.family == "cnn":
        io = record.batch_size * record.input_size ** 2 * record.channels * 4.0
    else:
        io = record.batch_size * record.input_size * record.channels * 4.0
    return params_bytes * 2.0 + io * 2.0  # params + grads, in + out


class MLPBaseline:
    """PerfNet-style 4-layer MLP regressor (fit in log space)."""

    def __init__(self, hidden=(64, 64, 32), lr: float = 1e-3,
                 epochs: int = 400, seed: int = 0, device="cuda"):
        self.hidden = hidden
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.device = torch.device(device)

    def _init(self, sizes) -> list:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return [(torch.randn((sizes[i], sizes[i + 1]), generator=gen, device=self.device)
                 * (1.0 / np.sqrt(sizes[i])),
                 torch.zeros((sizes[i + 1],), device=self.device))
                for i in range(len(sizes) - 1)]

    @staticmethod
    def _forward(params, a):
        for i, (w, b) in enumerate(params):
            a = a @ w + b
            if i < len(params) - 1:
                a = torch.relu(a)
        return a[:, 0]

    def fit(self, x: np.ndarray, y: np.ndarray,
            init: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None):
        """Fit on features ``x`` and targets ``y``; ``init`` gives the initial
        (weight, bias) of each layer in place of the seeded draw."""
        self.mu, self.sd = x.mean(0), x.std(0) + 1e-9
        xn = torch.as_tensor((x - self.mu) / self.sd, dtype=torch.float32, device=self.device)
        yl_raw = np.log(np.maximum(y, 1e-12))
        self.ymu, self.ysd = float(yl_raw.mean()), float(yl_raw.std() + 1e-9)
        yl = torch.as_tensor((yl_raw - self.ymu) / self.ysd, dtype=torch.float32,
                             device=self.device)
        sizes = [x.shape[1], *self.hidden, 1]
        if init is None:
            params = self._init(sizes)
        else:
            params = [tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=self.device)
                            for a in layer) for layer in init]
        leaves = [t for layer in params for t in layer]
        m = [torch.zeros_like(t) for t in leaves]
        v = [torch.zeros_like(t) for t in leaves]
        for step in range(1, self.epochs + 1):  # the reference counts from 1
            t = torch.tensor(float(step), device=self.device)
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                pairs = list(zip(leaves[0::2], leaves[1::2]))
                loss = torch.mean((self._forward(pairs, xn) - yl) ** 2)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                m = [0.9 * a + 0.1 * g for a, g in zip(m, grads)]
                v = [0.999 * a + 0.001 * g * g for a, g in zip(v, grads)]
                c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t  # in fp32, as the reference
                leaves = [p - self.lr * (mm / c1) / (torch.sqrt(vv / c2) + 1e-8)
                          for p, mm, vv in zip(leaves, m, v)]
        self.params = [(w.detach(), b.detach()) for w, b in zip(leaves[0::2], leaves[1::2])]
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        xn = torch.as_tensor((x - self.mu) / self.sd, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            z = self._forward(self.params, xn).double().cpu().numpy()
        return np.exp(np.minimum(z * self.ysd + self.ymu, 46.0))
