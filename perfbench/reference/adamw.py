"""The reference's training: AdamW written out plainly over float32
parameters, following a few steps from given weights and batches.

The update is AdamW with bias correction, the whole gradient clipped to a
global norm of ``grad_clip`` first, decoupled weight decay on every
parameter, and a learning rate that warms up linearly over
``warmup_steps`` and then decays on a cosine to ``min_lr_ratio`` of ``lr``
at ``decay_steps``. A step's gradient is the mean over blocks of
``row_block`` rows, each block's loss a mean over its tokens, so that a
large batch fits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch


def learning_rate(opt: Dict, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["decay_steps"] - opt["warmup_steps"])))
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def _gradients(loss_fn: Callable, cfg, params, tokens, labels, prec: str, row_block: int):
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    tree = dict(zip(names, leaves))
    blocks = range(0, tokens.shape[0], row_block)
    grads = [torch.zeros_like(t) for t in leaves]
    total = 0.0
    for r in blocks:
        with torch.enable_grad():
            loss = loss_fn(tree, cfg, tokens[r:r + row_block], labels[r:r + row_block], prec)
            parts = torch.autograd.grad(loss, leaves, allow_unused=True)
        for g, part in zip(grads, parts):
            if part is not None:
                g.add_(part)
        total += float(loss.detach())
    n = len(blocks)
    return {k: g / n for k, g in zip(names, grads)}, total / n


def follow(loss_fn: Callable, cfg, weights: Dict[str, torch.Tensor], batches: List[Dict],
           opt: Dict, prec: str, row_block: int, device) -> Dict:
    """Train from ``weights`` on ``batches`` ({"tokens", "labels"} arrays),
    one step each. Returns {"losses": [...], "grad_norms": {name: the first
    step's clipped gradient norm}, "change_norms": {name: the norm of the
    parameter's change over all steps}}."""
    params = {k: w.detach().float().clone() for k, w in weights.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, first = [], None
    for step, batch in enumerate(batches):
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        grads, loss = _gradients(loss_fn, cfg, params, tokens, labels, prec, row_block)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        clip = min(1.0, opt["grad_clip"] / (gnorm + 1e-9)) if opt["grad_clip"] else 1.0
        if first is None:
            first = {k: float(g.norm()) * clip for k, g in grads.items()}
        lr = learning_rate(opt, step)
        t = step + 1
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * clip
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / (1 - b1 ** t)) / ((v[k] / (1 - b2 ** t)).sqrt() + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
        del grads
    change = {k: float((p - weights[k].float()).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
