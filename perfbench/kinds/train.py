"""The train kind: the port's ``Trainer`` stepping through seeded batches.

Set-up draws the weights, builds the port's model over them and one
``Trainer`` (its ``make_train_step`` under ``StepRunner``, the mix's
optimizer settings, no checkpoint) whose ``source`` is the mix's batches;
the train state is the weights with the optimizer's state from the port's
``init_opt_state``. One ``ShardedLoader`` feeds every step. The first
``checked_steps`` steps go through the same ``Trainer.runner`` and loader
as the window's, warm every shape up, and are what is judged: their
losses, each parameter's norm of the optimizer's first moment after step
1 (the first gradient as the optimizer got it, clipped: m / (1 - beta1))
and of the fp32 master's change after the last of them, taken as the
steps run so that no copy of the state is held through the window. The window then steps on from that same state until
``seconds`` have passed; it ends with the synchronisation after its last
step, which ``StepRunner`` makes.

The reference follows the checked steps in float32 from the same weights
and batches (``reference/<family>.py``'s ``loss`` and
``reference/adamw.py``) and gives three numbers: ``loss_gap``, the worst
step's relative loss gap; ``grad_gap`` and ``change_gap``, the worst
leaf's gap between the program's and the reference's norm of the first
gradient and of the parameters' change over the checked steps, each over
the larger of the reference leaf's norm and the median leaf's. Leaves
whose reference gradient is under a thousandth of the median leaf's (their
change is weight decay and round-off alone) are left out of both.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench.lib import port, weights as weights_lib
from perfbench.lib.traffic import TrainSource
from perfbench.reference import adamw

SMALL_GRAD = 1e-3


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic_spec = ctx.config, ctx.traffic
        self.spans = {"loader_wait": []}
        self.undo = []  # what a planted fault restores

    def setup(self):
        from repro_torch.data.pipeline import ShardedLoader
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train.loop import LoopConfig, Trainer

        ctx, tr = self.ctx, self.traffic_spec
        t0 = time.perf_counter()
        self.weights = weights_lib.draw(ctx.reference.layout(self.cfg), ctx.seed, ctx.device,
                                        self.cfg["dtype"])
        weights_lib.synchronize(ctx.device)
        self.setup_split = {"weights_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.source = TrainSource(tr, ctx.seed)
        self.model = port.build(self.cfg, self.weights)
        self.opt_cfg = opt_lib.OptConfig(**tr["optimizer"])
        self.trainer = Trainer(self.model, self.opt_cfg,
                               LoopConfig(batch=tr["batch"], seq=tr["seq"], ckpt_dir=None),
                               source=self.source)
        params = {k: v for k, v in self.model.named_parameters()}
        self.state = {"params": params, "opt": opt_lib.init_opt_state(self.opt_cfg, params),
                      "step": torch.zeros((), dtype=torch.int32, device=ctx.device)}
        ctx.plant(self)
        self.loader = ShardedLoader(self.trainer.source, None, start_step=0, device=ctx.device)
        self.losses = []
        beta1 = tr["optimizer"]["beta1"]
        for s in range(tr["checked_steps"]):
            self.state, metrics = self.trainer.runner(self.state, next(self.loader))
            self.losses.append(float(metrics["loss"]))
            if s == 0:  # the first gradient as the optimizer got it, clipped
                self.grad_norms = {k: float(m.float().norm()) / (1 - beta1)
                                   for k, m in self.state["opt"]["m"].items()}
        # the fp32 master, or the parameters themselves where they are fp32
        last = self.state["opt"]["master"] or self.state["params"]
        self.change_norms = {k: float((m - self.weights[k].float()).norm())
                             for k, m in last.items()}
        self.setup_split["warmup_s"] = time.perf_counter() - t0

    def window(self, seconds: float):
        n = 0
        t0 = time.perf_counter()
        while True:
            w0 = time.perf_counter()
            batch = next(self.loader)
            self.spans["loader_wait"].append(time.perf_counter() - w0)
            self.state, _ = self.trainer.runner(self.state, batch)
            n += 1
            t_end = time.perf_counter()
            if t_end - t0 >= seconds:
                break
        elapsed = t_end - t0
        tokens = n * self.source.tokens_per_step()
        flops = n * self.ctx.model_flops.train_flops(self.cfg, self.source.batch, self.source.seq)
        return {"attempted": n, "failed": 0, "seconds": elapsed, "flops": flops,
                "spans": self.spans,
                "end_to_end": {"train_tokens_per_s": tokens / elapsed}}

    def traced(self, trace_fn):
        """Trace the checked-step count of steps after the window."""
        count = self.traffic_spec["checked_steps"]

        def stretch():
            for _ in range(count):
                self.state, _ = self.trainer.runner(self.state, next(self.loader))

        summary = trace_fn(stretch)
        summary.work = [(self.source.batch, self.source.seq)] * count
        return summary

    def release(self):
        """Free the program's state; keep only what is judged."""
        self.loader.close()
        self.loader = self.trainer = self.model = self.state = None
        for undo in self.undo:
            undo()

    # -- judging -------------------------------------------------------------
    def _reference(self, prec: str):
        tr = self.traffic_spec
        steps = [self.source.batch_at(s) for s in range(tr["checked_steps"])]
        return adamw.follow(self.ctx.reference.loss, self.cfg, self.weights, steps,
                            tr["optimizer"], prec, tr["row_block"], self.ctx.device)

    def judge(self, control: bool = False):
        ref = self._reference("fp32")
        prog = {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}
        out = compare(prog, ref)
        return out, (compare(self._reference("fp8"), ref) if control else None)


def compare(got, ref):
    """The three numbers of ``got`` (a program's or a control's readings)
    against the float32 reference's ``ref``."""
    loss_gap = _worst(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    gref = ref["grad_norms"]
    gmed = _median(gref.values())
    kept = [k for k, g in gref.items() if g >= SMALL_GRAD * gmed]

    def worst(name):
        r = ref[name]
        med = _median(r[k] for k in kept)
        return _worst(abs(got[name][k] - r[k]) / max(r[k], med) for k in kept)

    return {"loss_gap": loss_gap, "grad_gap": worst("grad_norms"),
            "change_gap": worst("change_norms")}


def _worst(values) -> float:
    """The largest reading, or inf where one is not a number: NaN never passes."""
    vals = list(values)
    return float("inf") if any(not math.isfinite(v) for v in vals) else max(vals)


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return (v[(n - 1) // 2] + v[n // 2]) / 2
