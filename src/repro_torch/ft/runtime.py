"""Fault tolerance: retrying step runner, straggler detection, watchdog.

Port of ``repro.ft.runtime``. Straggler detection uses DNNAbacus as its
reference: if the cost predictor has been fit for this platform, a step
whose wall time exceeds ``straggler_factor x`` the *predicted* step time is
flagged (the paper's scheduling use-case, applied online). Without a
predictor the detector falls back to a running median.

A step's wall time ends when its outputs are ready on their device
(``block``): CUDA calls return before the card finishes, so without the wait
the time would be the host's enqueue, compared with a predicted device time.
Any ``Exception`` but ``StepFailure`` is retried, up to ``max_retries``; the
port's step is functional (nothing donated or updated in place), so a retried
step starts from the same state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FTConfig:
    max_retries: int = 2
    straggler_factor: float = 3.0
    watchdog_timeout_s: Optional[float] = None
    min_history: int = 5


class StepRunner:
    """Wraps a step callable with retries + timing + straggler flags."""

    def __init__(self, step_fn: Callable, cfg: FTConfig = FTConfig(),
                 predicted_step_s: Optional[float] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.step_fn = step_fn
        self.cfg = cfg
        self.predicted = predicted_step_s
        self.on_straggler = on_straggler
        self.history: List[float] = []
        self.retries = 0
        self.stragglers = 0

    def _reference_time(self) -> Optional[float]:
        if self.predicted is not None:
            return self.predicted
        if len(self.history) >= self.cfg.min_history:
            s = sorted(self.history[-50:])
            return s[len(s) // 2]
        return None

    def __call__(self, *args):
        last_err = None
        for attempt in range(self.cfg.max_retries + 1):
            t0 = time.perf_counter()
            try:
                out = self.step_fn(*args)
                out = block(out)
                dt = time.perf_counter() - t0
                ref = self._reference_time()
                if (ref is not None and dt > self.cfg.straggler_factor * ref):
                    self.stragglers += 1
                    if self.on_straggler:
                        self.on_straggler(len(self.history), dt)
                if (self.cfg.watchdog_timeout_s
                        and dt > self.cfg.watchdog_timeout_s):
                    raise StepFailure(
                        f"watchdog: step took {dt:.1f}s "
                        f"> {self.cfg.watchdog_timeout_s}s")
                self.history.append(dt)
                return out
            except StepFailure:
                raise
            except Exception as e:  # transient device/runtime errors
                last_err = e
                self.retries += 1
        raise StepFailure(
            f"step failed after {self.cfg.max_retries + 1} attempts") from last_err


def _devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def block(out):
    """Wait until ``out`` (a tree of tensors) is computed: synchronise each
    card that holds one of its tensors; nothing to wait for on the CPU."""
    for device in _devices(out, set()):
        torch.cuda.synchronize(device)
    return out


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault injection for tests: raises on listed calls."""

    fail_on_calls: tuple = ()
    exception: type = RuntimeError
    calls: int = 0

    def wrap(self, fn):
        def inner(*args):
            self.calls += 1
            if self.calls in self.fail_on_calls:
                raise self.exception(f"injected failure at call {self.calls}")
            return fn(*args)
        return inner
