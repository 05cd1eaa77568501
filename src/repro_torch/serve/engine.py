"""Serving: a minimal batched prefill + greedy decode engine.

Port of ``repro.serve.engine.DecodeEngine`` with the same semantics. The
model owns its parameters, so the engine takes none, and runs where the
model lives.

As in the reference, ``prefill`` replaces the engine's ``max_seq`` cache
with the cache the model returns, sized to the prompt; decode then writes
at ``pos`` = prompt length, outside that cache, so generated tokens never
enter it. Callers pad prompts by the number of steps plus one, as the
reference's tests and example do.
"""

from __future__ import annotations

import torch


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
