"""Serving: a minimal batched prefill + greedy decode engine.

Port of ``repro.serve.engine.DecodeEngine`` with the same semantics. The
model owns its parameters, so the engine takes none, and runs where the
model lives.

As in the reference, ``prefill`` replaces the engine's ``max_seq`` cache
with the cache the model returns, sized to the prompt; decode then writes
at ``pos`` = prompt length, outside that cache, so generated tokens never
enter a KV cache. Callers pad prompts by the number of steps plus one, as
the reference's tests and example do. An SSM layer's cache (state and conv
window) has no sequence axis, so every generated token does enter it.

``make_prefill_step`` and ``make_decode_step`` are the units the dry run's
``prefill_*`` / ``decode_*`` / ``long_*`` cells trace: the model's prefill,
or one new token against a cache of the stated length, as functions of the
parameters. ``param_shardings`` and ``cache_shardings`` give the reference's layouts of
the parameters and the decode cache on a mesh: the KV cache sharded
batch -> data and cache_seq -> model (the flash-decoding split).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.distributed import sharding as shd


class _Call(nn.Module):
    """``model.<method>(*args)`` as a module call, so that
    ``functional_call`` can hand the model a tree of parameters."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


def _with_params(model, method: str):
    call = _Call(model, method)

    def step(params, *args):
        with shd.replicate_plain_tensors(next(iter(params.values()))):
            return functional_call(call, {f"model.{k}": v for k, v in params.items()}, args)
    return step


def make_prefill_step(model):
    """``prefill_step(params, batch) -> (logits, cache)``: the model's prefill
    on the given parameters (a tree of tensors or DTensors)."""
    return _with_params(model, "prefill")


def make_decode_step(model):
    """``decode_step(params, cache, tokens, pos) -> (logits, cache)``."""
    return _with_params(model, "decode_step")


def param_shardings(model, mesh, rules: Optional[shd.ShardingRules] = None,
                    fsdp_params: bool = False):
    """{parameter name: NamedSharding} for serving on ``mesh``."""
    rules = rules or shd.ShardingRules()
    axes = model.param_axes()
    shapes = dict(model.named_parameters())
    if fsdp_params:  # giant models: params sharded over data axes too
        from repro_torch.distributed import zero as zero_lib
        axes = zero_lib.zero_axes(axes, shapes, mesh, rules)
        rules = zero_lib.zero_rules(rules)
    return shd.tree_shardings(mesh, axes, shapes, rules)


def cache_shardings(model, mesh, batch: int, seq: int,
                    rules: Optional[shd.ShardingRules] = None):
    """(shardings, shapes) of the decode cache: per layer, {name:
    NamedSharding} and {name: ``meta`` tensor}."""
    rules = rules or shd.ShardingRules()
    shapes = [{k: torch.empty(shp, dtype=dt, device="meta") for k, (shp, dt) in entry.items()}
              for entry in model.cache_spec(batch, seq)]
    return shd.tree_shardings(mesh, model.cache_axes(), shapes, rules), shapes


class DecodeEngine:
    """Holds the cache on the model's device and runs greedy decode with
    per-request positions."""

    def __init__(self, model, batch: int, max_seq: int):
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.cache = model.init_cache(batch, max_seq)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=model.device)

    def prefill(self, batch_inputs):
        logits, self.cache = self.model.prefill(batch_inputs)
        self.pos = torch.full((self.batch,), batch_inputs["tokens"].shape[1],
                              dtype=torch.int32, device=self.model.device)
        return torch.argmax(logits[:, -1], dim=-1)

    def step(self, tokens):
        logits, self.cache = self.model.decode_step(self.cache, tokens[:, None], self.pos)
        self.pos = self.pos + 1
        return torch.argmax(logits[:, -1], dim=-1)

    def generate(self, first_tokens, steps: int):
        toks = first_tokens
        out = [toks]
        for _ in range(steps):
            toks = self.step(toks)
            out.append(toks)
        return torch.stack(out, dim=1)
