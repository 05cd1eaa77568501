"""The port's gateway server, admission, online refit and telemetry.

The reference's suites ``test_server``, ``test_online_refit`` and
``test_obs`` run against the port's copies, bound by
``_torch_parity.port_suite``: each test below that carries a suite's name
is that suite's test, run on ``repro_torch.serve`` and ``repro_torch.obs``.
Beside them: the H100 roofline floor is the reference's formula at the
datasheet's rates, and a shed query gets it; the kernels' impl switches
hold under threads (overlapping ``use_impls`` scopes leave them as found,
and a thread outside a scope keeps its own impl); and concurrent
``trace_query`` calls give the serial records.
"""

import dataclasses
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import port_suite, suite_tests  # noqa: E402

from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.features import record_to_json  # noqa: E402
from repro_torch.models import attention, layers, ssm  # noqa: E402
from repro_torch.models.api import use_impls  # noqa: E402
from repro_torch.serve import AbacusServer, PredictionService  # noqa: E402
from repro_torch.serve.prediction_service import trace_query  # noqa: E402

SERVER, REFIT, OBS = (port_suite(name) for name in
                      ("test_server", "test_online_refit", "test_obs"))
PS = port_suite("test_prediction_service")
globals().update(suite_tests(SERVER, REFIT, OBS))

GETTERS = (attention.get_attention_impl, ssm.get_ssd_impl, layers.get_norm_impl)


def _switches():
    return tuple(get() for get in GETTERS)


# -- the roofline floor at the H100's datasheet rates --------------------------


def _floor_cfgs():
    dots = types.SimpleNamespace(name="synthetic", dots=12.0)
    return [PS._fake_cfg("a"), dots, get_config("qwen2-0.5b"), get_config("mamba2-370m"),
            reduced_config(get_config("chatglm3-6b"))]


def test_floor_is_the_reference_formula_at_the_h100_rates(monkeypatch):
    """The port's floor equals the reference's with the reference's rates
    rebound to the H100 datasheet's; the FLOP estimate and MODEL_FLOPS need
    no rebinding."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989.4e12, 3.35e12)
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    for cfg in _floor_cfgs():
        for batch, seq in ((1, 32), (8, 2048)):
            assert roofline.flops_estimate(cfg, batch, seq) == \
                ref_roofline.flops_estimate(cfg, batch, seq)
            est = roofline.floor_estimate(cfg, batch, seq)
            assert est == ref_roofline.floor_estimate(cfg, batch, seq)
            assert est["degraded"] is True and est["model"] == "roofline-floor"
            assert est["time_s"] == max(est["flops"] / 989.4e12, est["memory_bytes"] / 3.35e12)
    shape = types.SimpleNamespace(global_batch=8, seq_len=2048, kind="train")
    cfg = get_config("qwen2-0.5b")
    assert roofline.model_flops(cfg, shape, 500, 400) == \
        ref_roofline.model_flops(cfg, shape, 500, 400) == 6.0 * 500 * 8 * 2048


def test_shed_query_is_answered_from_the_h100_floor():
    """With a shed watermark of 0 every query is shed at submit time and
    answered from the port's floor, stamped degraded, never traced."""
    calls = []
    svc = PredictionService(PS._abacus(), tracer=PS._counting_tracer(calls))
    with AbacusServer(svc, shed_watermark=0) as srv:
        cfg = get_config("qwen2-0.5b")
        est = srv.submit(cfg, 8, 2048).result(5)
    floor = roofline.floor_estimate(cfg, 8, 2048)
    assert {k: est[k] for k in floor} == floor
    assert est["admitted"] == (est["memory_bytes"] <= svc.hbm_budget)
    assert calls == [] and srv.stats()["overload"]["shed"] == 1


# -- the impl switches under threads -----------------------------------------


def test_overlapping_use_impls_scopes_in_threads_leave_the_switches_as_found():
    """Two threads' scopes overlap in crossed order (A enters, B enters, A
    leaves, B leaves): each sees its own pins throughout, and afterwards
    the switches are as found. Saving and restoring process globals left
    them at B's saved ``"plain"`` for good."""
    assert _switches() == (None, None, None)
    steps = [threading.Event() for _ in range(4)]
    seen, errors = {}, []

    def scope(name, enter_after, entered, leave_after, left, pins):
        try:
            if enter_after is not None:
                assert steps[enter_after].wait(10)
            with use_impls(**pins):
                seen[name, "in"] = _switches()
                steps[entered].set()
                if leave_after is not None:
                    assert steps[leave_after].wait(10)
                seen[name, "leaving"] = _switches()
            steps[left].set()
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    a = threading.Thread(target=scope, args=("a", None, 0, 1, 2,
                                             dict(attention="plain", ssd="plain", norm="plain")))
    b = threading.Thread(target=scope, args=("b", 0, 1, 2, 3, dict(norm="cuda")))
    a.start(), b.start()
    a.join(10), b.join(10)
    assert not errors, errors
    assert seen["a", "in"] == seen["a", "leaving"] == ("plain", "plain", "plain")
    assert seen["b", "in"] == seen["b", "leaving"] == (None, None, "cuda")
    assert _switches() == (None, None, None)


def test_a_thread_outside_a_scope_keeps_its_own_impl():
    """While a trace in another thread holds every kernel pinned plain, a
    card job in this thread still takes the kernel path, and the
    process-wide setting keeps its meaning here."""
    card = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def trace_like():
        with use_impls(attention="plain", ssd="plain", norm="plain"):
            seen["traced"] = (attention._use_kernel(card), ssm._use_kernel(card),
                              layers._use_kernel(card))
            inside.set()
            release.wait(10)

    t = threading.Thread(target=trace_like)
    t.start()
    try:
        assert inside.wait(10)
        assert _switches() == (None, None, None)
        assert attention._use_kernel(card) and ssm._use_kernel(card) and layers._use_kernel(card)
        layers.set_norm_impl("plain")
        try:
            assert not layers._use_kernel(card) and layers.get_norm_impl() == "plain"
        finally:
            layers.set_norm_impl(None)
    finally:
        release.set()
        t.join(10)
    assert seen["traced"] == (False, False, False)
    assert _switches() == (None, None, None)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recompute_in_another_thread_takes_the_forward_s_impls(remat):
    """A remat region is recomputed during the backward, which autograd runs
    on its own thread for card tensors, outside the forward's pins. Here the
    forward runs in a thread that pins RMSNorm plain, and the backward in
    this one, where the process-wide setting asks for the kernel (which
    refuses CPU tensors): the recompute takes the forward's plain path, and
    the gradients equal a one-thread run's."""
    import torch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")), remat=remat)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}

    def grads(loss):
        loss.backward()
        out = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        return out

    want = grads(model.loss(batch)[0])
    losses = []

    def forward():
        with use_impls(norm="plain"):
            losses.append(model.loss(batch)[0])
    layers.set_norm_impl("cuda")
    try:
        t = threading.Thread(target=forward)
        t.start()
        t.join(60)
        got = grads(losses[0])
    finally:
        layers.set_norm_impl(None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_concurrent_trace_queries_give_the_serial_records():
    """``trace_query`` from several threads at once (the gateway's trace
    pool) gives records identical to serial calls, and leaves the
    switches as found; the traces take turns on ``nsm.TRACE_LOCK``."""
    qwen, mamba = (reduced_config(get_config(a)) for a in ("qwen2-0.5b", "mamba2-370m"))
    points = [(qwen, 1, 16), (qwen, 2, 16), (mamba, 1, 16)]
    serial = [record_to_json(trace_query(*p)) for p in points]
    with ThreadPoolExecutor(len(points)) as pool:
        concurrent = list(pool.map(lambda p: record_to_json(trace_query(*p)), points))
    assert concurrent == serial
    assert _switches() == (None, None, None)


def test_gateway_trace_pool_resolves_cold_misses_like_serial_queries():
    """An ``AbacusServer`` with a pool of trace workers resolves a burst of
    distinct cold queries with the port's tracer: one trace per key, and
    the estimates of a serial service on the same predictor."""
    ab = PS._abacus()
    points = [(reduced_config(get_config("qwen2-0.5b")), b, 16) for b in (1, 2)]
    serial = PredictionService(ab)
    want = [serial.predict_one(*p) for p in points]
    svc = PredictionService(ab)
    with AbacusServer(svc, trace_workers=2) as srv:
        got = [f.result(120) for f in [srv.submit(*p) for p in points]]
    assert [(e["model"], e["admitted"]) for e in got] == [(e["model"], e["admitted"]) for e in want]
    for key in ("time_s", "memory_bytes"):  # one ensemble pass over the batch
        np.testing.assert_allclose([e[key] for e in got], [e[key] for e in want], rtol=1e-12)
    assert svc.stats.traces == len(points)
