"""Profiling harness (paper §2): measure (time, memory) for LM train steps.

Port of the LM part of ``repro.core.profiler``. For every configuration we
build the real training step (model forward + CE loss + backward + AdamW
update, ``repro_torch.train.step``), then record:

  time_s     — median of ``steps`` step times on the card, by CUDA events,
               after one warm-up step;
  mem_bytes  — the torch allocator's peak on the card over those steps
               (``torch.cuda.max_memory_allocated`` after a reset): the
               state, the step's outputs and its activations;
  flops      — ``torch.utils.flop_counter.FlopCounterMode`` over the step's
               aten graph (matrix products and convolutions, forward,
               backward and remat recompute), in place of the reference's
               HLO analysis, which also charges elementwise ops;
  nsm_edges  — NSM of the same graph (``repro_torch.core.nsm``).

The graph is traced by ``make_fx`` on fake tensors, with every kernel pinned
plain, so FLOPs and the NSM need no card. Time and memory come only from
the card: a measurement on the CPU raises rather than return a number that
is not the card's. As in the reference, the timed steps run on an all-zero
state and batch. The CNN zoo's profiling (``make_optimizer``,
``zoo_train_step``, ``profile_zoo``) comes with ROADMAP Queue A item 12.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import nsm as nsm_lib
from repro_torch.core.features import PLATFORM_TORCH_CUDA, ProfileRecord

# ---------------------------------------------------------------------------
# Generic step profiling
# ---------------------------------------------------------------------------


def trace_step(step_fn, args, device="cpu") -> Dict:
    """FLOPs and NSM edges of ``step_fn(*args)``, with ``args`` a pytree of
    tensors whose shapes and dtypes are taken (``meta`` tensors will do),
    traced on fake tensors placed on ``device``."""
    fake_mode = FakeTensorMode()
    with fake_mode:
        fake = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), args)
    gm = nsm_lib.trace(step_fn, *fake)
    with fake_mode, FlopCounterMode(display=False) as counter:
        gm(*fake)
    return {"flops": float(counter.get_total_flops()), "nsm_edges": nsm_lib.nsm_edges(gm)}


def time_step(step_fn, inputs, steps: int = 3) -> Dict:
    """Median time (s) of ``steps`` calls of ``step_fn(*inputs)`` on the card
    by CUDA events, after one warm-up call, and the peak allocated bytes over
    the timed calls (``inputs`` are tensors on the card)."""
    device = tree_leaves(inputs)[0].device
    out = step_fn(*inputs)
    torch.cuda.synchronize(device)
    del out
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(*inputs)
        end.record()
        end.synchronize()
        del out  # so the next step's outputs do not meet these in the peak
        times.append(start.elapsed_time(end) / 1e3)
    return {"time_s": float(statistics.median(times)),
            "mem_bytes": float(torch.cuda.max_memory_allocated(device))}


def zeros_like_specs(args, device="cuda"):
    """All-zero tensors on ``device`` of the shapes and dtypes in ``args``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), args)


def measure_step(step_fn, args, steps: int = 3, device="cuda") -> Dict:
    """Median step time (s) and peak allocated bytes of ``step_fn`` on the
    card, on all-zero inputs of ``args``' shapes; one warm-up step excluded."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_step times and measures on a CUDA card, not {device}")
    return time_step(step_fn, zeros_like_specs(args, device), steps)


def profile_step(step_fn, args, steps: int = 3, device="cuda") -> Dict:
    """Trace and measure ``step_fn(*args)``: the reference's ``profile_step``."""
    return {**trace_step(step_fn, args, device), **measure_step(step_fn, args, steps, device)}


# ---------------------------------------------------------------------------
# LM (StackModel) profiling
# ---------------------------------------------------------------------------


def lm_batch_specs(cfg, batch: int, seq: int) -> Dict:
    """``meta`` {tokens, labels[, patches, frames]} train-step inputs.

    Single source of truth for the modality conditionals, as in the
    reference (the port builds neither modality's layers yet).
    """
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    b = {"tokens": meta((batch, seq), torch.int32), "labels": meta((batch, seq), torch.int32)}
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    if cfg.cross_every:
        b["patches"] = meta((batch, cfg.vision_seq, cfg.d_model), dt)
    if cfg.is_encoder_decoder:
        b["frames"] = meta((batch, cfg.audio_seq, cfg.d_model), dt)
    return b


def lm_trace(cfg, batch: int, seq: int, lr: float = 1e-3):
    """(model, step_fn, state_specs, batch_specs) for one LM train step.

    The model is built on the ``meta`` device: the step takes every
    parameter from its state, so the same model serves a trace on fake
    tensors and steps on the card.
    """
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    model = build_model(cfg, device="meta")
    opt_cfg = opt_lib.OptConfig(lr=lr, keep_master=False)
    step = step_lib.make_train_step(model, opt_cfg)
    state_specs = step_lib.state_shapes(model, opt_cfg)
    return model, step, state_specs, lm_batch_specs(cfg, batch, seq)


def lm_record(cfg, model, batch: int, seq: int, *, flops, nsm_edges,
              lr: float = 1e-3, optimizer: str = "adamw",
              time_s: float = 0.0, mem_bytes: float = 0.0,
              platform: int = PLATFORM_TORCH_CUDA) -> ProfileRecord:
    """The canonical ModelConfig -> ProfileRecord field mapping."""
    return ProfileRecord(
        model_name=cfg.name, family=cfg.family, batch_size=batch,
        input_size=seq, channels=cfg.d_model, learning_rate=lr, epoch=1,
        optimizer=optimizer, layers=cfg.num_layers, flops=flops,
        params=model.param_count(), nsm_edges=nsm_edges,
        time_s=time_s, mem_bytes=mem_bytes, platform=platform)


def profile_lm(cfg, batch: int = 2, seq: int = 64, lr: float = 1e-3,
               optimizer: str = "adamw", steps: int = 3,
               platform: int = PLATFORM_TORCH_CUDA, device="cuda") -> ProfileRecord:
    """Profile one LM train step on the card into a ``ProfileRecord``."""
    model, step, state_specs, b = lm_trace(cfg, batch, seq, lr)
    meas = profile_step(step, (state_specs, b), steps=steps, device=device)
    return lm_record(cfg, model, batch, seq, flops=meas["flops"],
                     nsm_edges=meas["nsm_edges"], lr=lr, optimizer=optimizer,
                     time_s=meas["time_s"], mem_bytes=meas["mem_bytes"],
                     platform=platform)
