"""Profiling harness (paper §2): measure (time, memory) for train steps.

Port of ``repro.core.profiler``. For every configuration we build the real
training step (model forward + CE loss + backward + optimizer update: the
LMs' AdamW step, ``repro_torch.train.step``, or a zoo CNN's step with one of
the rig's four optimizers, ``zoo_train_step``), then record:

  time_s     — median of ``steps`` step times on the card, by CUDA events,
               after one warm-up step;
  mem_bytes  — the torch allocator's peak on the card over those steps
               (``torch.cuda.max_memory_allocated`` after a reset): the
               state, the step's outputs, its activations and the cuDNN
               workspaces taken through the caching allocator;
  flops      — ``torch.utils.flop_counter.FlopCounterMode`` over the step's
               aten graph (matrix products and convolutions, forward,
               backward and remat recompute), in place of the reference's
               HLO analysis, which also charges elementwise ops. A
               convolution's weight gradient is charged as one forward
               (``_conv_backward_flop``): torch's own formula charges a
               grouped convolution's ``groups`` times over;
  nsm_edges  — NSM of the same graph (``repro_torch.core.nsm``).

The graph is traced by ``make_fx`` on fake tensors, with every kernel pinned
plain, so FLOPs and the NSM need no card. Time and memory come only from
the card: a measurement on the CPU raises rather than return a number that
is not the card's (``profile_zoo_on_host`` measures the host, for a run
that asks for the CPU by name). As in the reference, the timed steps run
on an all-zero state and batch. ``profile_zoo`` profiles one of the 29 zoo
CNNs (``repro_torch.core.zoo``) this way, ``profile_lm`` one LM.

A corpus can make its records in two parts: ``TraceAhead`` runs the
traces (``trace_point``) in spawned worker processes while the card does
other work, and ``measure_point`` later runs only the timed steps on the
card; a ``CorpusPoint``'s record is then the one ``profile_zoo`` /
``profile_zoo_model`` / ``profile_lm`` give.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import statistics
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from repro_torch.core import nsm as nsm_lib
from repro_torch.core.features import PLATFORM_TORCH_CUDA, ProfileRecord
from repro_torch.core.zoo import ZooModel, build_zoo_model

Tensors = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Tiny optimizers for the profiling rig (the paper varies the optimizer)
# ---------------------------------------------------------------------------


def make_optimizer(kind: str, lr: float):
    """(init, update) of one of the rig's optimizers over ``{name: tensor}``,
    as the reference's: ``update(g, s, p) -> (new params, new state)``,
    nothing updated in place."""
    if kind == "sgd":
        def init(p):
            return {}

        def update(g, s, p):
            return {k: p[k] - lr * g[k] for k in p}, s
    elif kind == "momentum":
        def init(p):
            return {"m": {k: torch.zeros_like(v) for k, v in p.items()}}

        def update(g, s, p):
            m = {k: 0.9 * s["m"][k] + g[k] for k in p}
            return {k: p[k] - lr * m[k] for k in p}, {"m": m}
    elif kind in ("adam", "adamw"):
        def init(p):
            return {"m": {k: torch.zeros_like(v) for k, v in p.items()},
                    "v": {k: torch.zeros_like(v) for k, v in p.items()},
                    "t": torch.zeros((), dtype=torch.int32, device=next(iter(p.values())).device)}

        def update(g, s, p):
            t = s["t"] + 1
            m = {k: 0.9 * s["m"][k] + 0.1 * g[k] for k in p}
            v = {k: 0.999 * s["v"][k] + 0.001 * g[k] * g[k] for k in p}
            tf = t.to(torch.float32)

            def upd(pp, mm, vv):
                mh = mm / (1 - torch.pow(0.9, tf))
                vh = vv / (1 - torch.pow(0.999, tf))
                step = mh / (torch.sqrt(vh) + 1e-8)
                if kind == "adamw":
                    step = step + 0.01 * pp
                return pp - lr * step
            return {k: upd(p[k], m[k], v[k]) for k in p}, {"m": m, "v": v, "t": t}
    else:
        raise ValueError(kind)
    return init, update


def _softmax_ce(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)

# ---------------------------------------------------------------------------
# Generic step profiling
# ---------------------------------------------------------------------------


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape, **kwargs):
    """FLOPs of ``aten.convolution_backward``: the input gradient as a
    transposed convolution (torch's formula) and the weight gradient as one
    forward of the convolution, the products it makes. torch's formula
    convolves the input's channels as a batch against ``grad_out`` and so
    charges a grouped convolution's weight gradient ``groups`` times."""
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0], not transposed)
    if output_mask[1]:
        flops += conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return flops


def _traced(step_fn, args, device):
    """The aten graph of ``step_fn(*args)`` traced on fake tensors placed on
    ``device``, and its FLOPs."""
    fake_mode = FakeTensorMode()
    with fake_mode:
        fake = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), args)
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flop}
    with nsm_lib.TRACE_LOCK:  # one trace at a time, the FLOP count with it
        gm = nsm_lib.trace(step_fn, *fake)
        with fake_mode, FlopCounterMode(display=False, custom_mapping=mapping) as counter:
            gm(*fake)
    return gm, float(counter.get_total_flops())


def trace_step(step_fn, args, device="cpu") -> Dict:
    """FLOPs and NSM edges of ``step_fn(*args)``, with ``args`` a pytree of
    tensors whose shapes and dtypes are taken (``meta`` tensors will do),
    traced on fake tensors placed on ``device``."""
    gm, flops = _traced(step_fn, args, device)
    return {"flops": flops, "nsm_edges": nsm_lib.nsm_edges(gm)}


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
# Zoo (CNN) profiling
# ---------------------------------------------------------------------------


def zoo_train_step(model: ZooModel, optimizer: str, lr: float):
    """``(step, init_opt)``: ``step(params, opt_state, x, y)`` takes the loss's
    gradients by autograd and returns the optimizer's ``(params, state)``;
    ``x`` is an NCHW float32 batch, ``y`` int64 labels."""
    init_opt, update = make_optimizer(optimizer, lr)

    @torch.no_grad()
    def step(params: Tensors, opt_state, x, y):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = _softmax_ce(model.apply(leaves, x), y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return update(dict(zip(params, grads)), opt_state, params)

    return step, init_opt


def zoo_record(model: ZooModel, batch: int, image: int, *, flops, nsm_edges,
               lr: float = 0.1, optimizer: str = "sgd", epoch: int = 1,
               time_s: float = 0.0, mem_bytes: float = 0.0, family: str = "cnn",
               platform: int = PLATFORM_TORCH_CUDA) -> ProfileRecord:
    """The canonical ZooModel -> ProfileRecord field mapping."""
    return ProfileRecord(
        model_name=model.name, family=family, batch_size=batch, input_size=image,
        channels=model.cin, learning_rate=lr, epoch=epoch,
        optimizer=optimizer, layers=model.layer_count(), flops=flops,
        params=model.param_count(), nsm_edges=nsm_edges,
        time_s=time_s, mem_bytes=mem_bytes, platform=platform)


def zoo_step_args(model: ZooModel, batch: int, image: int, optimizer: str, lr: float):
    """``(step, args)``: the zoo step and its ``meta`` inputs (parameters,
    optimizer state, an NCHW batch and its labels)."""
    step, init_opt = zoo_train_step(model, optimizer, lr)
    params = model.param_shapes()
    x = torch.empty((batch, model.cin, image, image), device="meta")
    y = torch.empty((batch,), dtype=torch.int64, device="meta")
    return step, (params, init_opt(params), x, y)


def profile_zoo_model(model: ZooModel, batch: int = 16, image: int = 32, lr: float = 0.1,
                      optimizer: str = "sgd", epoch: int = 1, steps: int = 3,
                      family: str = "cnn", platform: int = PLATFORM_TORCH_CUDA,
                      device="cuda") -> ProfileRecord:
    """Profile one train step of a built zoo (or random) CNN on the card."""
    step, args = zoo_step_args(model, batch, image, optimizer, lr)
    meas = profile_step(step, args, steps=steps, device=device)
    return zoo_record(model, batch, image, flops=meas["flops"], nsm_edges=meas["nsm_edges"],
                      lr=lr, optimizer=optimizer, epoch=epoch, time_s=meas["time_s"],
                      mem_bytes=meas["mem_bytes"], family=family, platform=platform)


def profile_zoo_on_host(name: str, batch: int = 16, image: int = 32, lr: float = 0.1,
                        optimizer: str = "sgd", steps: int = 3) -> ProfileRecord:
    """``profile_zoo`` for a run that asks for the CPU (the examples'
    ``--device cpu``): the step's median wall-clock time over ``steps``
    calls on all-zero CPU inputs, after one warm-up call, and for memory the
    peak live bytes of its traced program (``analysis.hlo.live_bytes``; the
    host's allocator keeps no peak). These are the host's numbers, not the
    card's: a predictor fit on them is stored apart from one fit on the
    card's and never fit beside them."""
    from repro_torch.analysis.hlo import live_bytes

    model = build_zoo_model(name, 3, image)
    step, args = zoo_step_args(model, batch, image, optimizer, lr)
    gm, flops = _traced(step, args, "cpu")
    inputs = zeros_like_specs(args, "cpu")
    step(*inputs)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(*inputs)
        times.append(time.perf_counter() - t0)
    return zoo_record(model, batch, image, flops=flops, nsm_edges=nsm_lib.nsm_edges(gm),
                      lr=lr, optimizer=optimizer, epoch=1,
                      time_s=float(statistics.median(times)),
                      mem_bytes=float(live_bytes(gm)["peak"]))


def profile_zoo(name: str, batch: int = 16, image: int = 32,
                channels: int = 3, lr: float = 0.1,
                optimizer: str = "sgd", epoch: int = 1,
                steps: int = 3, platform: int = PLATFORM_TORCH_CUDA,
                device="cuda") -> ProfileRecord:
    """Profile one train step of the zoo network ``name`` on the card."""
    return profile_zoo_model(build_zoo_model(name, channels, image), batch, image, lr,
                             optimizer, epoch, steps, platform=platform, device=device)


# ---------------------------------------------------------------------------
# LM (StackModel) profiling
# ---------------------------------------------------------------------------


def lm_batch_specs(cfg, batch: int, seq: int) -> Dict:
    """``meta`` {tokens, labels[, patches, frames]} train-step inputs.

    Single source of truth for the modality conditionals, as in the
    reference: stub image ``patches`` for a cross-attention config, stub
    audio ``frames`` for an encoder-decoder one, in the activation dtype.
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


# ---------------------------------------------------------------------------
# A corpus traced ahead of its timing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorpusPoint:
    """One record of a corpus, as ``profile_zoo`` (``kind`` "zoo", ``model``
    a zoo net's name), ``profile_zoo_model`` of ``random_cnn`` (``"rand_cnn"``,
    its seed) or ``profile_lm`` (``"lm"``, a ``ModelConfig``) profile it at
    (``batch``, ``size``: the image's side or the sequence's length) with
    their default learning rates."""

    kind: str
    model: Any
    batch: int
    size: int
    optimizer: str = "sgd"


def point_step(point: CorpusPoint):
    """``(step, args, record)`` of ``point``: its step, the step's ``meta``
    inputs, and ``record(flops, nsm_edges, time_s, mem_bytes)`` building its
    ``ProfileRecord`` as the in-process profile does."""
    if point.kind == "lm":
        model, step, state, batch = lm_trace(point.model, point.batch, point.size)

        def record(**meas):
            return lm_record(point.model, model, point.batch, point.size, **meas)
        return step, (state, batch), record
    if point.kind == "zoo":
        model, family = build_zoo_model(point.model, 3, point.size), "cnn"
    elif point.kind == "rand_cnn":
        from repro_torch.core.randomgen import random_cnn
        model, family = random_cnn(point.model), "rand_cnn"
    else:
        raise ValueError(f"corpus point kind {point.kind!r}")
    step, args = zoo_step_args(model, point.batch, point.size, point.optimizer, 0.1)

    def record(**meas):
        return zoo_record(model, point.batch, point.size, optimizer=point.optimizer,
                          family=family, **meas)
    return step, args, record


def trace_point(point: CorpusPoint, device="cuda") -> Dict:
    """The host's part of ``point``'s record: its step's FLOPs and NSM edges
    traced on fake tensors of ``device`` (no kernel runs), and the seconds
    the trace took (``trace_s``)."""
    t0 = time.perf_counter()
    step, args, _ = point_step(point)
    return {**trace_step(step, args, device), "trace_s": time.perf_counter() - t0}


def measure_point(point: CorpusPoint, traced: Dict, steps: int = 3,
                  device="cuda") -> ProfileRecord:
    """The card's part of ``point``'s record, ``measure_step`` on zeros, built
    with the FLOPs and NSM edges of ``traced`` (``trace_point``) into the
    record the in-process profile gives."""
    step, args, record = point_step(point)
    meas = measure_step(step, args, steps, device)
    return record(flops=traced["flops"], nsm_edges=traced["nsm_edges"],
                  time_s=meas["time_s"], mem_bytes=meas["mem_bytes"])


def _trace_worker_start() -> None:
    torch.set_num_threads(1)  # the traces are host-bound, one a worker


class TraceAhead:
    """``trace_point`` of every one of ``points`` on fake tensors of
    ``device``, in ``workers`` spawned processes started here, while the
    caller does other work; ``results()`` waits for them, ends the
    processes and returns the traces in the points' order. A worker that
    fakes CUDA tensors opens a context on the card (fake tensors of a
    device need one) and launches nothing there."""

    def __init__(self, points, device="cuda", workers: int = 1):
        ctx = multiprocessing.get_context("spawn")
        self.workers = workers
        self._pool = ProcessPoolExecutor(workers, mp_context=ctx,
                                         initializer=_trace_worker_start)
        self._futures = [self._pool.submit(trace_point, p, device) for p in points]

    def results(self):
        try:
            return [f.result() for f in self._futures]
        finally:
            self._pool.shutdown(wait=True)
