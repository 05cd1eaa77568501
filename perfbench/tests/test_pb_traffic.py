"""Seeded traffic and weights: the same seed gives the same inputs, every
seed the same work in another order."""

import numpy as np
import pytest
import torch

from perfbench.lib import traffic, weights
from perfbench.lib.cell import Cell
from perfbench.lib.seeds import derive

SEEDS = (0, 7, 2**31 + 11, -5, 2**64 + 3)


def _prefill(seed, name="mamba2-370m.prefill-b16-1k8k"):
    return traffic.PrefillTraffic(Cell(name).traffic, seed, "cpu")


def test_lengths_span_the_mix():
    spec = Cell("chatglm3-6b.prefill-b1-1k8k").traffic["lengths"]
    lens = traffic.lengths(spec)
    assert len(lens) == 33 and lens[0] == 1024 and lens[-1] == 8192 and lens == sorted(lens)
    # a third in each band: [1024, 4096), [4096, 8192), and 8192 itself
    assert sum(n < 4096 for n in lens) == sum(4096 <= n < 8192 for n in lens) == 11
    assert lens.count(8192) == 11 and len(set(lens)) == 23
    assert lens[:3] == [1024, 1303, 1582] and lens[11:13] == [4096, 4468]


def test_log_uniform_lengths_span_their_range():
    lens = traffic.lengths({"dist": "log_uniform", "min": 1024, "max": 8192, "count": 4})
    assert lens == [1024, 2048, 4096, 8192]


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_traffic_repeats_exactly(seed):
    a, b = _prefill(seed), _prefill(seed)
    assert torch.equal(a.pool, b.pool)
    for i in (0, 5, 31, 32, 77):
        assert a.length(i) == b.length(i)
        assert torch.equal(a.prompt(i), b.prompt(i))


def test_every_seed_asks_for_the_same_work_in_another_order():
    want = traffic.lengths(Cell("mamba2-370m.prefill-b16-1k8k").traffic["lengths"])
    n = len(want)
    cycles = {s: [_prefill(s).length(i) for i in range(n)] for s in SEEDS}
    assert all(sorted(lens) == want for lens in cycles.values())
    assert len({tuple(v) for v in cycles.values()}) == len(SEEDS)
    t = _prefill(3)
    assert [t.length(i) for i in range(n)] != [t.length(i) for i in range(n, 2 * n)]


def test_prompts_have_their_shape_and_ids_below_the_vocabulary():
    t = _prefill(9)
    for i in range(40):
        p = t.prompt(i)
        assert p.shape == (16, t.length(i)) and p.dtype == torch.int32
        assert int(p.min()) >= 0 and int(p.max()) < 50277


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_and_every_row_differs(seed):
    spec = Cell.of("mamba2-370m", "train-b8s2k").traffic
    a, b = traffic.TrainSource(spec, seed), traffic.TrainSource(spec, seed)
    for step in (0, 1, 40):
        x, y = a.batch_at(step), b.batch_at(step)
        assert np.array_equal(x["tokens"], y["tokens"]) and np.array_equal(x["labels"], y["labels"])
        assert x["tokens"].shape == (8, 2048) and np.array_equal(x["tokens"][:, 1:],
                                                                 x["labels"][:, :-1])
        assert len({r.tobytes() for r in x["tokens"]}) == 8
    assert not np.array_equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])


def test_weights_repeat_exactly_and_follow_the_layout():
    layout = [("a", (3, 5), "model", 0.0, 0.5), ("b", (7,), "fp32", 1.0, 0.1),
              ("c", (2, 2, 3), "model", -1.0, 1.0)]
    w1 = weights.draw(layout, 123, "cpu", "bfloat16")
    w2 = weights.draw(layout, 123, "cpu", "bfloat16")
    w3 = weights.draw(layout, 124, "cpu", "bfloat16")
    for name, shape, kind, mean, std in layout:
        assert tuple(w1[name].shape) == shape and w1[name].is_contiguous()
        assert w1[name].dtype == (torch.bfloat16 if kind == "model" else torch.float32)
        start = w1[name].data_ptr() - w1[name].untyped_storage().data_ptr()
        assert start % weights.ALIGN_BYTES == 0
        assert torch.equal(w1[name], w2[name]) and not torch.equal(w1[name], w3[name])
    big = weights.draw([("x", (20000,), "fp32", 2.0, 3.0)], 1, "cpu", "bfloat16")["x"]
    assert abs(float(big.mean()) - 2.0) < 0.1 and abs(float(big.std()) - 3.0) < 0.1


def test_derived_seeds_are_distinct_and_in_range():
    vals = {derive(s, p) for s in SEEDS for p in ("weights", "token_pool", "order")}
    assert len(vals) == 3 * len(SEEDS)
    assert all(0 <= v < 2**63 for v in vals)
