"""The prefill kind: one client's closed loop of prompt batches through the
port's ``DecodeEngine.prefill``.

Set-up draws the weights, builds the port's model over them, makes the
engine (its cache sized to the longest prompt) and runs one prefill of
every length the mix uses, longest first. The window then sends request
after request, each as soon as the previous one's first token is on the
host, until ``seconds`` have passed; the last request ends the window.
A request's time to first token runs from its issue until the first token
is on the host; the engine's host time runs until ``prefill`` returns.

Outputs are judged after the window: a sample of the requests it finished,
drawn from the seed (a reservoir of ``sample`` requests, and the first of
the longest length), each with its first token, its logits and the cache
every layer left. The reference runs each sampled prompt layer by layer and
gives three numbers: ``cache_err``, the worst layer's relative error of a
cache entry; ``logits_err``, the worst relative error of the last
position's logits; ``token_gap``, the widest gap by which the served first
token's reference logit lies below the reference's best.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench.lib import port, weights as weights_lib
from perfbench.lib.seeds import rng
from perfbench.lib.traffic import PrefillTraffic


def _finite(x: float) -> float:
    """A reading, or inf where it is not a number: NaN never passes."""
    return x if math.isfinite(x) else float("inf")


def _rel(a, b) -> float:
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    b = b.float()
    return _finite(float((a.float() - b).norm() / b.norm().clamp_min(1e-30)))


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic_spec = ctx.config, ctx.traffic
        self.kept = []  # sampled requests: dicts of prompt, first tokens, logits, cache
        self.longest = None
        self.spans = {"engine_host": []}

    # -- set-up --------------------------------------------------------------
    def setup(self):
        from repro_torch.serve.engine import DecodeEngine

        ctx = self.ctx
        t0 = time.perf_counter()
        self.weights = weights_lib.draw(ctx.reference.layout(self.cfg), ctx.seed, ctx.device,
                                        self.cfg["dtype"])
        weights_lib.synchronize(ctx.device)
        self.setup_split = {"weights_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.traffic = PrefillTraffic(self.traffic_spec, ctx.seed, ctx.device)
        self.model = port.build(self.cfg, self.weights)
        self.engine = DecodeEngine(self.model, self.traffic.batch, self.traffic.max_len)
        self._logits = None
        ctx.plant(self)
        prefill = self.model.prefill

        def kept_logits(batch):  # hands the engine the model's answer, keeping the logits
            logits, cache = prefill(batch)
            self._logits = logits
            return logits, cache

        self.model.prefill = kept_logits
        for n in sorted(set(self.traffic.lengths), reverse=True):
            self.engine.prefill({"tokens": self.traffic.pool[:, :n]}).tolist()
        self._logits = None
        self.setup_split["warmup_s"] = time.perf_counter() - t0
        self.sampler = rng(ctx.seed, "sample")
        self.next_request = 0

    # -- the window ----------------------------------------------------------
    def _request(self, i: int):
        prompt = self.traffic.prompt(i)
        t0 = time.perf_counter()
        tok = self.engine.prefill({"tokens": prompt})
        t1 = time.perf_counter()
        first = tok.tolist()
        t2 = time.perf_counter()
        return prompt, first, t1 - t0, t2 - t0

    def _keep(self, n_done: int, prompt, first):
        entry = {"prompt": prompt, "first": first, "logits": self._logits,
                 "cache": self.engine.cache}
        k = self.traffic_spec["sample"]
        if self.longest is None and prompt.shape[1] == self.traffic.max_len:
            self.longest = entry
        elif len(self.kept) < k:
            self.kept.append(entry)
        else:
            j = int(self.sampler.integers(0, n_done))
            if j < k:
                self.kept[j] = entry

    def window(self, seconds: float):
        ttft, tokens, n = [], 0, 0
        t0 = time.perf_counter()
        while True:
            prompt, first, host_s, ttft_s = self._request(self.next_request)
            t_end = time.perf_counter()
            self.next_request += 1
            n += 1
            tokens += prompt.numel()
            ttft.append(ttft_s)
            self.spans["engine_host"].append(host_s)
            self._keep(n, prompt, first)
            if t_end - t0 >= seconds:
                break
        elapsed = t_end - t0
        flops = sum(self.ctx.model_flops.prefill_flops(self.cfg, *self._shape(i))
                    for i in range(self.next_request - n, self.next_request))
        ttft_ms = sorted(t * 1e3 for t in ttft)
        # every request of a batch waits for the same first-token step
        per_request = [t for t in ttft_ms for _ in range(self.traffic.batch)]
        return {"attempted": n * self.traffic.batch, "failed": 0, "seconds": elapsed,
                "flops": flops, "spans": self.spans,
                "end_to_end": {"prefill_tokens_per_s": tokens / elapsed,
                               "ttft_ms_p95": _percentile(per_request, 95)}}

    def _shape(self, i: int):
        return self.traffic.batch, self.traffic.length(i)

    def traced(self, trace_fn):
        """Trace one cycle of the mix's lengths, the requests after the window."""
        start = self.next_request
        count = len(self.traffic.lengths)

        def stretch():
            for i in range(start, start + count):
                self._request(i)

        summary = trace_fn(stretch)
        self.next_request += count
        summary.work = [self._shape(i) for i in range(start, start + count)]
        return summary

    def release(self):
        """Free the program's state: the engine, its cache and the model."""
        self.engine = None
        self.model = None
        self._logits = None

    # -- judging -------------------------------------------------------------
    def judge(self, control: bool = False):
        """The numbers compared, from the program's kept outputs against the
        reference in float32; with ``control``, also the same numbers of the
        reference computed in float8 in the program's place."""
        ref = self.ctx.reference
        v = self.cfg["vocab_size"]
        prog = {"cache_err": 0.0, "logits_err": 0.0, "token_gap": 0.0}
        ctl = dict(prog)
        entries = self.kept + ([self.longest] if self.longest is not None else [])
        with torch.no_grad():
            for e in entries:
                walk = ref.prefill(self.weights, self.cfg, e["prompt"], "fp32")
                low = ref.prefill(self.weights, self.cfg, e["prompt"], "fp8") if control else None
                for kind, i, r in walk:
                    c = next(low)[2] if control else None
                    if kind == "layer":
                        for key, rv in r.items():
                            prog["cache_err"] = max(prog["cache_err"], _rel(e["cache"][i][key], rv))
                            if control:
                                ctl["cache_err"] = max(ctl["cache_err"], _rel(c[key], rv))
                        continue
                    got = e["logits"][:, -1, :v]
                    prog["logits_err"] = max(prog["logits_err"], _rel(got, r))
                    served = torch.tensor(e["first"], device=r.device)
                    prog["token_gap"] = max(prog["token_gap"], _gap(r, served))
                    if control:
                        ctl["logits_err"] = max(ctl["logits_err"], _rel(c, r))
                        ctl["token_gap"] = max(ctl["token_gap"], _gap(r, c.argmax(-1)))
        return prog, (ctl if control else None)


def _gap(ref_logits, tokens) -> float:
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return _finite(float((best - got).max()))


def _percentile(sorted_values, pct: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    if not sorted_values:
        return float("nan")
    k = (len(sorted_values) - 1) * pct / 100
    lo = int(k)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (k - lo)
