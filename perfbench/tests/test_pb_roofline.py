"""Each roofline and model-FLOP count against a number worked by hand."""

import json

import pytest

from perfbench.lib.cell import ROOT
from perfbench.roofline import flash, model_glm, model_mamba2, peaks, rmsnorm, ssd


def _cfg(name):
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_flash_pairs_and_bound_by_hand():
    assert flash.pairs(4, 4) == 1 + 2 + 3 + 4
    assert flash.pairs(3, 8, 5) == 6 + 7 + 8
    assert flash.pairs(5, 3) == 1 + 2 + 3 + 3 + 3
    # (1, 4, 2 heads, 1 KV head, d 8): 640 FLOP, 384 bytes: the bytes bound
    assert flash.bound_s(1, 4, 4, 2, 1, 8) == pytest.approx(384 / peaks.HBM_BYTES_S)
    # chatglm3-6b at 8192: 4*128*32*(8192*8193/2) FLOP at 989 TFLOP/s
    assert flash.bound_s(1, 8192, 8192, 32, 2, 128) == pytest.approx(
        4 * 128 * 32 * 33_558_528 / 989e12)
    # PERF.md's kernel table: (8, 2081, 32 heads, 2 KV, d 128) bounds at 0.2871 ms
    assert flash.bound_s(8, 2081, 2081, 32, 2, 128) * 1e3 == pytest.approx(0.2871, abs=1e-4)


def test_ssd_flops_and_bound_by_hand():
    # (1, 4, 1 head, P 2, N 3, chunk 2): pairs 3 + 3; C B^T 2*6*3 = 36;
    # weighted 2*(6*2 + (8 - 2)*3*2) = 96
    assert ssd.flop_split(1, 4, 1, 2, 3, 2) == (36.0, 96.0)
    assert ssd.flops(1, 4, 1, 2, 3, 2) == 132.0
    # mamba2-370m's prefill shape (8, 2081, 32 heads, P 64, N 128, chunk 256):
    # 25.56 GFLOP at the bf16 peak (0.0258 ms) is under x, y, B, C in bf16 and
    # dt, A and the final state in float32 at the HBM rate: 155,423,872 B
    x = 2 * 8 * 2081 * 32 * 64
    bc = 2 * 8 * 2081 * 128
    moved = 2 * (x + bc) + 4 * (8 * 2081 * 32 + 32 + 8 * 32 * 128 * 64)
    assert moved == 155_423_872
    assert ssd.flops(8, 2081, 32, 64, 128, 256) / 989e12 < moved / 3.35e12
    assert ssd.bound_s(8, 2081, 32, 64, 128, 256) == pytest.approx(moved / 3.35e12)
    assert ssd.bound_s(8, 2081, 32, 64, 128, 256) * 1e3 == pytest.approx(0.0464, abs=1e-4)
    # a float32 scan counts every product at the FMA peak: compute-bound
    assert ssd.bound_s(1, 4096, 32, 64, 128, 256, dtype_bytes=4) == pytest.approx(
        ssd.flops(1, 4096, 32, 64, 128, 256) / 67e12)


def test_rmsnorm_bound_by_hand():
    fwd = (2 * 16384 * 1024 * 2 + 4 * 1024) / 3.35e12
    bwd = (3 * 16384 * 1024 * 2 + 8 * 1024) / 3.35e12
    assert rmsnorm.bound_s(16384, 1024) == pytest.approx(fwd)
    assert rmsnorm.bound_s(16384, 1024, backward=True) == pytest.approx(bwd)
    # PERF.md's table: (16384, 896) forward 0.0175 ms, backward 0.0263 ms
    assert rmsnorm.bound_s(16384, 896) * 1e3 == pytest.approx(0.0175, abs=1e-4)
    assert rmsnorm.bound_s(16384, 896, backward=True) * 1e3 == pytest.approx(0.0263, abs=1e-4)


def test_glm_model_flops_by_hand():
    cfg = _cfg("chatglm3-6b")
    proj = 4096 * 4096 + 2 * 4096 * 256 + 4096 * 4096 + 3 * 4096 * 13696
    assert proj == 203_948_032
    attn = 28 * 4 * 128 * 32 * (1024 * 1025 // 2)
    want = 2 * 28 * proj * 1024 + attn + 2 * 4096 * 65024
    assert model_glm.prefill_flops(cfg, 1, 1024) == pytest.approx(want)
    train = 3 * (2 * 28 * proj * 4 * 512 + 4 * 28 * 4 * 128 * 32 * (512 * 513 // 2)
                 + 2 * 4 * 512 * 4096 * 65024)
    assert model_glm.train_flops(cfg, 4, 512) == pytest.approx(train)
    assert model_glm.flash_calls(cfg, 1, 100) == [(1, 100, 100, 32, 2, 128)] * 28
    assert model_glm.norm_rows(cfg, 2, 10) == (57, 20, 4096)


def test_mamba2_model_flops_by_hand():
    cfg = _cfg("mamba2-370m")
    proj = 1024 * (2 * 2048 + 2 * 128 + 32) + 2048 * 1024
    assert proj == 6_586_368
    scan = 8_421_376 + 268_959_744  # ssd.flops(1, 256, 32, 64, 128, 256), worked by hand
    assert ssd.flops(1, 256, 32, 64, 128, 256) == scan
    want = 48 * (2 * proj * 256 + scan) + 2 * 1024 * 50280
    assert model_mamba2.prefill_flops(cfg, 1, 256) == pytest.approx(want)
    assert model_mamba2.train_flops(cfg, 1, 256) == pytest.approx(
        3 * (48 * (2 * proj * 256 + scan) + 2 * 256 * 1024 * 50280))
    assert model_mamba2.ssd_calls(cfg, 4, 300) == [(4, 300, 32, 64, 128, 256)] * 48
    assert model_mamba2.norm_rows(cfg, 8, 2048) == (49, 16384, 1024)
