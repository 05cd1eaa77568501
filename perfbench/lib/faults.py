"""Faults planted in the program under a run, to show that the check of
its outputs catches them. Only the control runs (``calibrate.py``) and the
tests plant them.

prefill: ``unchanged`` (the model hands back the engine's previous cache
as the new one), ``half`` (the second half of the batch's rows is left
out and the first half's outputs stand in for them), ``token`` (the served
token is the next id). train: ``unchanged`` (the step returns the state
it was given), ``half`` (the step sees the first half of the batch's rows
only, its loss the mean over them), ``update`` (the optimizer's update of
the largest parameter of the first layer is doubled as it is produced).
"""

from __future__ import annotations

import torch

FAULTS = {"prefill": ("unchanged", "half", "token"), "train": ("unchanged", "half", "update")}


def applies(kind: str, name: str, batch: int) -> bool:
    return name in FAULTS[kind] and not (name == "half" and batch < 2)


def plant(name: str, run) -> None:
    kind = run.ctx.traffic["kind"]
    if name not in FAULTS[kind]:
        raise ValueError(f"fault {name!r} not in {FAULTS[kind]}")
    (_prefill if kind == "prefill" else _train)(name, run)


def _twice(t, rows):
    return torch.cat([t, t], dim=0)[:rows]


def _prefill(name, run):
    model, engine = run.model, run.engine
    inner = model.prefill
    if name == "unchanged":
        model.prefill = lambda batch: (inner(batch)[0], engine.cache)
    elif name == "half":
        def half(batch):
            rows = batch["tokens"].shape[0]
            logits, cache = inner({"tokens": batch["tokens"][:rows // 2]})
            return _twice(logits, rows), [{k: _twice(v, rows) for k, v in c.items()}
                                          for c in cache]
        model.prefill = half
    else:
        served = engine.prefill
        vocab = run.cfg["vocab_size"]
        engine.prefill = lambda batch: (served(batch) + 1) % vocab


def _train(name, run):
    real = run.trainer.runner
    if name == "unchanged":
        def unchanged(state, batch):
            return state, real(state, batch)[1]
        run.trainer.runner = unchanged
    elif name == "half":
        run.trainer.runner = lambda state, batch: real(
            state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    else:
        from repro_torch.train import optimizer as opt_lib
        apply = opt_lib.apply_updates

        layer0 = sorted(k for k in run.state["params"] if k.startswith("layers.0."))
        leaf = max(layer0, key=lambda k: run.state["params"][k].numel())

        def doubled(cfg, params, grads, state):
            new_p, new_state, metrics = apply(cfg, params, grads, state)
            old = state["master"][leaf]
            new_state["master"][leaf] = twice = old + 2 * (new_state["master"][leaf] - old)
            new_p[leaf] = twice.to(params[leaf].dtype)
            return new_p, new_state, metrics
        opt_lib.apply_updates = doubled
        run.undo.append(lambda: setattr(opt_lib, "apply_updates", apply))
