"""Training loop: the step on the model's device, checkpoint/restart, fault
tolerance.

Port of ``repro.train.loop``. The loop is host-driven and restartable: all
state lives in the (atomic) checkpoint and the data stream is deterministic
in step, so a fresh ``Trainer`` over the same checkpoint directory resumes
where the last one stopped. ``run()`` returns the metrics history for tests
and benchmarks.

The step is the port's functional ``make_train_step``, called eagerly: no
``jit``, no donated buffers and no ``torch.compile``; the train state and the
batches live on the model's device. ``init_state`` draws from
``torch.Generator(device).manual_seed(seed)`` where the reference draws from
``jax.random.key(seed)``.

With a ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_host_mesh``) the state
is laid out by ``state_shardings`` (ZeRO-1 with ``zero``, as in the
reference) and the batches by ``batch_shardings``, as DTensors; the state is
drawn whole on every rank from the same seed and each rank keeps its part,
so it equals the unsharded state. ``zero`` has no effect without a mesh, as
in the reference. The reference saves the last step a second time after the
loop when it is a multiple of ``ckpt_every``; that identical write is skipped
here (ROADMAP Queue C).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.ft.runtime import FTConfig, StepRunner
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class LoopConfig:
    steps: int = 20
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 10
    log_every: int = 5
    ckpt_dir: Optional[str] = None
    seed: int = 0
    zero: bool = True
    accum: int = 1
    predicted_step_s: Optional[float] = None  # DNNAbacus admission/straggler


class Trainer:
    def __init__(self, model, opt_cfg: opt_lib.OptConfig, loop_cfg: LoopConfig,
                 mesh=None, rules: Optional[shd.ShardingRules] = None, source=None):
        self.model = model
        self.device = model.device
        self.opt_cfg = opt_cfg
        self.cfg = loop_cfg
        self.mesh = mesh
        self.rules = rules or shd.ShardingRules()
        self.metrics_log: List[Dict[str, Any]] = []
        self.source = source or SyntheticLM(
            model.cfg.vocab_size, loop_cfg.batch, loop_cfg.seq, loop_cfg.seed)
        self.step_fn = step_lib.make_train_step(model, opt_cfg, accum=loop_cfg.accum)
        if mesh is not None:
            self.state_sh = step_lib.state_shardings(model, opt_cfg, mesh, self.rules,
                                                     zero=loop_cfg.zero)
            self.batch_sh = step_lib.batch_shardings(mesh, self.source.batch_at(0), self.rules)
        else:
            self.state_sh = None
            self.batch_sh = None
        self.runner = StepRunner(self.step_fn, FTConfig(),
                                 predicted_step_s=loop_cfg.predicted_step_s)

    # -- state management -------------------------------------------------
    def init_state(self):
        gen = torch.Generator(self.device).manual_seed(self.cfg.seed)
        state = step_lib.init_state(self.model, self.opt_cfg, gen)
        if self.state_sh is not None:
            state = step_lib.distribute_state(state, self.state_sh)
        return state

    def restore_or_init(self):
        d = self.cfg.ckpt_dir
        if d:
            step = ckpt_lib.latest_step(d)
            if step is not None:
                like = step_lib.state_shapes(self.model, self.opt_cfg)
                state = ckpt_lib.restore(d, step, like, self.state_sh, device=self.device)
                return state, step
        return self.init_state(), 0

    # -- main loop ---------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> List[Dict[str, Any]]:
        """Train from the latest checkpoint (or a fresh state) up to ``steps``;
        the final state is kept as ``self.state``."""
        steps = steps if steps is not None else self.cfg.steps
        state, start = self.restore_or_init()
        loader = ShardedLoader(self.source, self.batch_sh, start_step=start, device=self.device)
        saved = None
        try:
            for i in range(start, steps):
                batch = next(loader)
                t0 = time.perf_counter()
                state, metrics = self.runner(state, batch)
                dt = time.perf_counter() - t0
                if i % self.cfg.log_every == 0 or i == steps - 1:
                    rec = {k: float(v) for k, v in metrics.items()}
                    rec.update(step=i, step_time_s=dt)
                    self.metrics_log.append(rec)
                if (self.cfg.ckpt_dir and self.cfg.ckpt_every
                        and (i + 1) % self.cfg.ckpt_every == 0):
                    ckpt_lib.save(self.cfg.ckpt_dir, i + 1, state)
                    saved = i + 1
            if self.cfg.ckpt_dir and saved != steps:
                ckpt_lib.save(self.cfg.ckpt_dir, steps, state)
        finally:
            loader.close()
        self.state = state
        return self.metrics_log

    def write_log(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.metrics_log:
                f.write(json.dumps(rec) + "\n")
