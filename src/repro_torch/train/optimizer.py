"""AdamW with mixed-precision state, for a flat dict of parameters.

Port of ``repro.train.optimizer``. Functional, as the reference: nothing is
updated in place; ``apply_updates`` returns new tensors. Flag-controlled
memory tricks, as there:
  - ``moment_dtype``: bf16 first/second moments;
  - ``keep_master``: fp32 master weights when compute params are bf16.

State layout (a dict of dicts keyed by parameter name):
  {"m": {name: t}, "v": {name: t}, "master": {name: t} or {}, "count": int32 []}
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16
    keep_master: bool = True        # fp32 master when params are low-precision


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_ratio``; fp32, on the
    step's device."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _mdt(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _needs_master(params: Params) -> bool:
    return any(p.dtype != torch.float32 for p in params.values())


def _count_device(params: Params):
    return next(iter(params.values())).device


def init_opt_state(cfg: OptConfig, params: Params) -> Dict[str, Any]:
    mdt = _mdt(cfg)
    state = {
        "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=_count_device(params)),
    }
    keep = cfg.keep_master and _needs_master(params)
    state["master"] = {k: p.float() for k, p in params.items()} if keep else {}
    return state


def opt_state_shapes(cfg: OptConfig, param_shapes: Params) -> Dict[str, Any]:
    """The optimizer state as ``meta`` tensors (shapes and dtypes, no data)."""
    mdt = _mdt(cfg)

    def meta(p, dt):
        return torch.empty(p.shape, dtype=dt, device="meta")
    state = {
        "m": {k: meta(p, mdt) for k, p in param_shapes.items()},
        "v": {k: meta(p, mdt) for k, p in param_shapes.items()},
        "count": torch.empty((), dtype=torch.int32, device="meta"),
    }
    keep = cfg.keep_master and _needs_master(param_shapes)
    state["master"] = {k: meta(p, torch.float32) for k, p in param_shapes.items()} if keep else {}
    return state


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Params, grads: Params, state: Dict[str, Any]):
    """One AdamW step. Returns (new_params, new_state, metrics). Each leaf is
    updated in fp32 and cast back to its parameter's dtype."""
    count = state["count"] + 1
    lr = schedule(cfg, state["count"])
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    mdt = _mdt(cfg)

    bc1 = 1 - cfg.beta1 ** count.float()
    bc2 = 1 - cfg.beta2 ** count.float()
    have_master = bool(state["master"])

    new_p, new_m, new_v, new_master = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m32 = state["m"][k].float() * cfg.beta1 + (1 - cfg.beta1) * g
        v32 = state["v"][k].float() * cfg.beta2 + (1 - cfg.beta2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        base = state["master"][k].float() if have_master else p.float()
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * base
        master = base - lr * step
        new_m[k] = m32.to(mdt)
        new_v[k] = v32.to(mdt)
        new_p[k] = master.to(p.dtype)
        new_master[k] = master

    new_state = {"m": new_m, "v": new_v, "count": count,
                 "master": new_master if have_master else {}}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
