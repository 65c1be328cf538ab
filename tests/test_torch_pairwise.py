"""Port's all-pairs comparison (plain PyTorch on the CPU) vs the JAX
package: cumulative union counts and marginal histograms exactly, measures
within atol=1e-6, and the tiled all-pairs engine on a 40-sketch bank."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu.sketch.hll import HLL as JHLL
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("same", [False, True])
def test_pair_stats_exact(rng, same):
    p, kmin, kmax = 10, 3, 14
    a = rng.integers(kmin, kmax, size=(12, 1 << p)).astype(np.int32)
    b = a if same else rng.integers(kmin, kmax + 1,
                                    size=(20, 1 << p)).astype(np.int32)
    a[0, :5] = 2                      # below the window: counted nowhere
    want = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, False, kmin,
                          same)
    ta = torch.from_numpy(a).to(torch.int8)
    tb = ta if same else torch.from_numpy(b).to(torch.int8)
    got = pw.pair_stats(ta, tb, kmax, kmin, same)
    for key in ("cum_union", "hist_a", "hist_b"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("result_type", range(9))
def test_measures_match_jax(rng, result_type):
    tri = rng.uniform(0, 1e6, size=(64, 3)).astype(np.float32)
    tri[:4] = [[0, 0, 0], [5, 0, 0], [0, 0, 7], [3, 4, 0]]   # degenerate pairs
    ksinv = 1.0 / 21
    want = np.asarray(jpw.measure_from_triples(jnp.asarray(tri), result_type,
                                               ksinv))
    got = pw.measure_from_triples(torch.from_numpy(tri), result_type,
                                  ksinv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tile_windows_match_jax(rng):
    for _ in range(200):
        q = int(rng.integers(40, 60))
        tmin = int(rng.integers(0, q))
        tmax1 = int(rng.integers(tmin, q + 2))
        assert pw._tile_window(tmin, tmax1, q) == jpw._tile_window(tmin,
                                                                   tmax1, q)


def _bank(rng, n, p):
    """n sketches of overlapping random sets: a shared core plus a random
    range of a pool, so no pair is near-disjoint (there the Mash distance
    of float32 estimates is ill-conditioned), plus one empty sketch."""
    pool = rng.integers(0, 2 ** 63, 80000, dtype=np.uint64)
    out = []
    for i in range(n):
        lo = int(rng.integers(10000, 50000))
        size = int(rng.integers(100, 30000))
        h = JHLL(p)
        h.addh_np(np.concatenate([pool[:10000], pool[lo:lo + size]]))
        out.append(h.regs)
    out[3] = np.zeros(1 << p, np.uint8)
    return out


@pytest.mark.parametrize("estim,result_type", [
    (est.ERTL_MLE, pw.MASH_DIST), (est.ERTL_MLE, pw.JI),
    (est.ERTL_IMPROVED, pw.SIZES), (est.ORIGINAL, pw.FULL_MASH_DIST),
    (est.ERTL_MLE, pw.SYMMETRIC_CONTAINMENT_DIST),
])
def test_all_pairs_condensed_matches_jax(rng, estim, result_type):
    p, n, tile = 10, 40, 16            # 3 tile rows: diagonal + off-diagonal
    regs = _bank(rng, n, p)
    want = jpw.all_pairs_condensed([JHLL(p, estim, estim, r) for r in regs],
                                   result_type, 21, estim, estim, tile=tile)
    got = pw.all_pairs_condensed([HLL(p, estim, estim, r) for r in regs],
                                 result_type, 21, estim, estim, CPU,
                                 tile=tile)
    assert got.shape == want.shape == (n * (n - 1) // 2,)
    scale = 1.0 if result_type != pw.SIZES else float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale)


def test_joint_mle_is_refused(rng):
    """The joint path runs now (tests/test_torch_joint_*.py); what it
    refuses is a level window wider than its kernels hold."""
    regs = torch.zeros((2, 1 << 10), dtype=torch.int8)
    tile = pw.compare_tile(regs, regs, 10, pw.JI, 1 / 21, est.ERTL_MLE,
                           est.ERTL_JOINT_MLE, 7, 0)
    assert tile.shape == (2, 2)
    with pytest.raises(ValueError):
        pw.compare_tile(regs, regs, 10, pw.JI, 1 / 21, est.ERTL_MLE,
                        est.ERTL_JOINT_MLE, 66, 0)
