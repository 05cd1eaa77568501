"""The SSD scan split over sequence blocks, as a sequence-split prefill runs
it, against the JAX reference on the whole sequence.

Each block runs the scan's first call (``ssd_states_ref``: each chunk's
entering state and decay and the block's final state, from zero), the
blocks' final states and total decays are carried into each block
(``ssd_carry``), and each block runs the second call (``ssd_output_ref``)
from that state. The chain's y and final state are held to the reference's
``repro.models.ssm.ssd_chunked`` at the reference's SSD tolerance, 2e-4 in
fp32, and to the port's one-call ``ssd_chunked_ref`` within 1e-5, at a
mamba2-like shape (N 128, chunk 256; heads and length cut) and a jamba-like
one (N 16, chunk 64), over 2 and 4 blocks with a ragged last block. Then
the whole Mamba2 block over sequence blocks (``apply_ssm_blocks``, the
region each rank runs on a mesh, its exchanges stacked in one process)
against the unsharded port and the reference. The kernel's two calls run
on the card only (``tests/test_torch_cuda_kernel.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import MODEL_TOL, TOL, both, close, randn, torch_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SSD_TOL = 2e-4  # the reference's SSD kernel tolerance (tests/test_kernels.py)

# (b, l, h, p, n, chunk) and the block boundaries: whole chunks but the last
SPLITS = {
    "mamba2-like-2": ((2, 1100, 4, 16, 128, 256), (0, 512, 1100)),
    "mamba2-like-4": ((2, 1100, 4, 16, 128, 256), (0, 256, 512, 768, 1100)),
    "jamba-like-2": ((2, 300, 4, 16, 16, 64), (0, 128, 300)),
    "jamba-like-4": ((2, 300, 4, 16, 16, 64), (0, 64, 128, 192, 300)),
}


def _inputs(b, l, h, p, n, seed=0):
    """The reference test's distributions, dt scaled down so the state
    carries across blocks; (jax arrays, torch tensors)."""
    dt = np.log1p(np.exp(randn(seed + 1, (b, l, h)) - 3.0)).astype(np.float32)
    arrays = [randn(seed, (b, l, h, p), 0.5), dt, -np.exp(randn(seed + 2, (h,), 0.3)),
              randn(seed + 3, (b, l, n), 0.5), randn(seed + 4, (b, l, n), 0.5)]
    pairs = [both(a.astype(np.float32)) for a in arrays]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _chain(args, cuts, chunk):
    xb, dt, a_neg, bm, cm = args
    spans = list(zip(cuts, cuts[1:]))
    first = [tssm.ssd_states_ref(xb[:, u:v], dt[:, u:v], a_neg, bm[:, u:v], chunk)
             for u, v in spans]
    finals = torch.stack([f for _, _, f in first])
    decays = torch.stack([d.prod(1) for _, d, _ in first])
    ys = []
    for k, ((u, v), res) in enumerate(zip(spans, first)):
        y, final = tssm.ssd_output_ref(xb[:, u:v], dt[:, u:v], a_neg, bm[:, u:v], cm[:, u:v],
                                       chunk, *res, tssm.ssd_carry(finals, decays, k))
        ys.append(y)
    return torch.cat(ys, 1), final, tssm.ssd_carry(finals, decays, len(spans))


@pytest.mark.parametrize("name", SPLITS)
def test_split_scan_equals_the_reference_on_the_whole_sequence(name):
    (b, l, h, p, n, chunk), cuts = SPLITS[name]
    jargs, targs = _inputs(b, l, h, p, n)
    y, final, carried = _chain(targs, cuts, chunk)
    yw, sw = jssm.ssd_chunked(*jargs, chunk)
    close(y, yw, SSD_TOL)
    close(final, sw, SSD_TOL)
    close(carried, sw, SSD_TOL)  # the carry over every block: the cache's state
    y1, s1 = tssm.ssd_chunked_ref(*targs, chunk)
    close(y, y1, TOL["float32"])
    close(final, s1, TOL["float32"])


def test_output_call_without_initial_state_equals_the_one_call_scan():
    (b, l, h, p, n, chunk), _ = SPLITS["mamba2-like-2"]
    _, (xb, dt, a_neg, bm, cm) = _inputs(b, l, h, p, n, seed=5)
    res = tssm.ssd_states_ref(xb, dt, a_neg, bm, chunk)
    y, s = tssm.ssd_output_ref(xb, dt, a_neg, bm, cm, chunk, *res)
    y1, s1 = tssm.ssd_chunked_ref(xb, dt, a_neg, bm, cm, chunk)
    assert torch.equal(s, s1) and s is res[2]
    close(y, y1, TOL["float32"])


@pytest.mark.parametrize("blocks", [2, 4])
def test_mamba2_block_over_sequence_blocks_equals_the_unsharded_and_reference(blocks):
    cfg = jax_reduced(jax_get_config("mamba2-370m"))
    from repro.models.module import init_params
    jp = init_params(jssm.ssm_spec(cfg), jax.random.key(3), jnp.float32)
    for i, k in enumerate(("a_log", "dt_bias", "conv_bias_x", "conv_bias_b", "conv_bias_c")):
        jp[k] = jnp.asarray(randn(40 + i, jp[k].shape, 0.3))
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    x = both(randn(11, (2, 4 * cfg.ssm_chunk, cfg.d_model)))
    with torch.no_grad():
        got, cache = tssm.apply_ssm_blocks(tp, torch_cfg(cfg), x[1], blocks)
        mine, mcache = tssm.apply_ssm(tp, torch_cfg(cfg), x[1], return_cache=True)
    want, wcache = jssm.apply_ssm(jp, cfg, x[0], return_cache=True)
    close(got, mine, TOL["float32"])
    close(got, want, MODEL_TOL)
    assert set(cache) == set(wcache)
    for k in cache:
        close(cache[k], mcache[k], TOL["float32"])
        close(cache[k], wcache[k], MODEL_TOL)


def test_blocks_must_be_whole_chunks():
    cfg = torch_cfg(jax_reduced(jax_get_config("mamba2-370m")))
    with pytest.raises(ValueError, match="whole"):
        tssm.apply_ssm_blocks({}, cfg, torch.zeros(1, 3 * cfg.ssm_chunk, cfg.d_model), 2)
