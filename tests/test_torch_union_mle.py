"""Port's union-MLE triples (plain PyTorch on the CPU) vs the JAX Pallas
kernel `pallas_union_triples` in interpret mode, with the JAX package's
own kernel bar: rtol=2e-4, atol=5e-2 on triples, atol=2e-6 on Jaccard;
at every window width, MLE by the complement chain (the form both kernels
run) within 2e-6 of each pair's union, and its estimates within rtol 5e-6
of the JAX package's K-first form.

The CUDA kernel (csrc/union_mle.cu) runs only on a card; the smoke script
at the repo root holds it to the plain version tested here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu.ops.pallas_mle import pallas_union_triples
from dashing_tpu.sketch import estimators as jest
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.ops import union_mle
from dashing_tpu_torch.sketch import estimators as est

torch.set_num_threads(1)

P = 10
NA, NB = 8, 128          # the Pallas kernel's block grid (ba=8, 128 lanes)


def _bank(rng, n, lo, hi, saturated, p=P):
    regs = rng.integers(lo, hi + 1, size=(n, 1 << p)).astype(np.int32)
    regs[0] = lo                       # all registers at the window floor
    if saturated:
        # a few registers at q+1 in every other row (the top bin)
        regs[1::2, :3] = 64 - p + 1
    return regs


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
@pytest.mark.parametrize("kmin,K,hi", [
    (0, 12, 11),    # bin 0 in the window (sigma, small-range branch), empty rows
    (4, 12, 15),    # interior window
    (0, 56, 12),    # window reaching q+1 = 55 (tau, saturated registers)
])
def test_triples_match_pallas_kernel(rng, method, kmin, K, hi):
    kmax = kmin + K - 1
    sat = kmax == 64 - P + 1
    a = _bank(rng, NA, kmin, hi, sat)
    b = _bank(rng, NB, kmin, hi, sat)
    stats = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, False, kmin)
    c_a = np.array(jest.estimate_windowed(stats["hist_a"], P, kmin, method))
    c_b = np.array(jest.estimate_windowed(stats["hist_b"], P, kmin, method))
    cumT = np.moveaxis(np.asarray(stats["cum_union"]), -1, 0).copy()
    want = np.asarray(pallas_union_triples(
        jnp.asarray(cumT), jnp.asarray(c_a), jnp.asarray(c_b), p=P,
        kmin=kmin, method=method, ba=NA, interpret=True))
    got = union_mle.union_triples(torch.from_numpy(cumT),
                                  torch.from_numpy(c_a),
                                  torch.from_numpy(c_b), p=P, kmin=kmin,
                                  method=method).numpy()
    assert got.shape == want.shape == (3, NA, NB)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-2)
    with np.errstate(invalid="ignore"):
        ji_w = want[2] / np.maximum(want.sum(0), 1e-30)
        ji_g = got[2] / np.maximum(got.sum(0), 1e-30)
    np.testing.assert_allclose(ji_g, ji_w, atol=2e-6)


# Every bucketed window width a compare takes (pairwise._K_BUCKETS up to
# 58; 66 cannot occur, a window ends at q+1 <= 61) and the widest clipped
# one, 62 levels at p=4: (p, kmin, K, highest register of the bank).
CHAIN_WINDOWS = [
    (10, 4, 8, 9),       # interior
    (10, 0, 16, 11),     # bin 0 in the window
    (10, 8, 24, 20),     # interior, unions of ~3e6
    (10, 2, 32, 14),     # the width of the measured compare tiles
    (10, 12, 44, 25),    # kmin > 0 reaching q+1 = 55, unions of ~5e7
    (8, 0, 58, 12),      # 0..q+1 at p=8
    (4, 0, 62, 12),      # 0..q+1 at p=4, clipped below its bucket of 66
]
UNION_RTOL = 2e-6        # triple error over the pair's union (~17 ulps)


def _hist(rng, p, kmin, K, hi, n=64):
    """(n, K) windowed histograms of banks in [kmin, hi], with a row at
    the window floor, saturated registers when the window reaches q+1,
    and an empty row when it holds bin 0."""
    kmax = kmin + K - 1
    regs = rng.integers(kmin, hi + 1, size=(n, 1 << p))
    regs[3] = kmin
    if kmax == 64 - p + 1:
        regs[1::3, :3] = kmax
        regs[5] = kmax
    return np.stack([np.bincount(r - kmin, minlength=K)
                     for r in regs]).astype(np.float32)


@pytest.mark.parametrize("p,kmin,K,hi", CHAIN_WINDOWS)
def test_chain_estimates_match_jax_kfirst(rng, p, kmin, K, hi):
    """The union MLE's chain form against the JAX package's K-first form
    (the TPU kernel's `_mle_dlogl12_chain`) on the same histograms.  JAX
    seeds the chain with a Taylor/exp-1 stand-in for expm1 and sums levels
    in XLA's order; the two agree within rtol 5e-6 (2e-6 measured)."""
    hist = _hist(rng, p, kmin, K, hi)
    want = np.asarray(jest.mle_estimate_windowed(
        jnp.asarray(hist.T.copy()), p, kmin, kfirst=True))
    got = est.mle_estimate_windowed_chain(torch.from_numpy(hist), p,
                                          kmin).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=5e-6)
    if kmin == 0:
        assert got[3] == 0.0                 # all mass in bin 0: empty
    if kmin + K - 1 == 64 - p + 1:
        assert got[5] == np.inf              # all mass in the top bin


@pytest.mark.parametrize("p,kmin,K,hi", CHAIN_WINDOWS)
def test_chain_triples_match_pallas_kernel(rng, p, kmin, K, hi):
    """MLE triples (the plain version of the union-MLE kernel, chain form)
    vs `pallas_union_triples` in interpret mode at every window width.
    A triple is a difference of union estimates, so its error is bounded
    against the pair's union: within UNION_RTOL of it (1.0e-6 measured).
    The entry-wise bar of test_triples_match_pallas_kernel fails here at
    unions of 1e6 and more, for the direct form as for the chain."""
    kmax = kmin + K - 1
    sat = kmax == 64 - p + 1
    a = _bank(rng, NA, kmin, hi, sat, p)
    b = _bank(rng, NB, kmin, hi, sat, p)
    stats = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, False, kmin)
    c_a = np.array(jest.estimate_windowed(stats["hist_a"], p, kmin,
                                          est.ERTL_MLE))
    c_b = np.array(jest.estimate_windowed(stats["hist_b"], p, kmin,
                                          est.ERTL_MLE))
    cumT = np.moveaxis(np.asarray(stats["cum_union"]), -1, 0).copy()
    want = np.asarray(pallas_union_triples(
        jnp.asarray(cumT), jnp.asarray(c_a), jnp.asarray(c_b), p=p,
        kmin=kmin, method=est.ERTL_MLE, ba=NA, interpret=True))
    got = union_mle.union_triples(torch.from_numpy(cumT),
                                  torch.from_numpy(c_a),
                                  torch.from_numpy(c_b), p=p, kmin=kmin,
                                  method=est.ERTL_MLE).numpy()
    assert got.shape == want.shape == (3, NA, NB)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    union = want.sum(0)
    fin = np.isfinite(union)
    assert fin.sum() > NA * NB // 2
    err = np.abs(got - want)[:, fin]
    assert (err <= UNION_RTOL * union[fin]).all(), (err / union[fin]).max()
    ji_w = want[2][fin] / np.maximum(union[fin], 1e-30)
    ji_g = got[2][fin] / np.maximum(got.sum(0)[fin], 1e-30)
    np.testing.assert_allclose(ji_g, ji_w, atol=2e-6)


@pytest.mark.parametrize("kmin,K,hi", [(0, 12, 11), (4, 12, 15),
                                       (0, 56, 12)])
def test_row_estimates_keep_direct_form(rng, kmin, K, hi):
    """The marginals and -o sizes keep the direct MLE (an expm1 per level,
    as the JAX package estimates marginals); only the union estimate of
    the union-MLE kernel takes the chain."""
    hist = torch.from_numpy(_hist(rng, P, kmin, K, hi))
    rows = union_mle.estimate_rows_plain(hist, p=P, kmin=kmin,
                                         method=est.ERTL_MLE)
    assert torch.equal(rows, est.mle_estimate_windowed(hist, P, kmin))
    assert torch.equal(union_mle.estimate_rows(hist, p=P, kmin=kmin,
                                               method=est.ERTL_MLE), rows)


@pytest.mark.parametrize("same", [True, False])
def test_compare_marginals_take_the_chain(rng, same):
    """A compare tile's marginals come from the union estimate's own form
    (the chain), so a pair beside an empty sketch shares exactly 0 and two
    identical sketches exactly all: the JAX package's CPU route (direct
    form throughout) gives the same, while direct marginals beside chain
    unions would leave last-bit remainders (Mash ~0.7, not 1, against an
    empty sketch)."""
    kmin, K = 0, 16
    a = _bank(rng, 6, 0, 11, False)
    a[0] = 0                                   # an empty sketch
    a[2] = a[1]                                # two identical sketches
    b = a if same else np.concatenate([a[1:], _bank(rng, 5, 0, 11, False)])
    st = pw.pair_stats(torch.from_numpy(a).to(torch.int8),
                       torch.from_numpy(b).to(torch.int8), kmin + K - 1,
                       kmin, same=same)
    tri = pw.triples_from_stats(st, P, est.ERTL_MLE, est.ERTL_MLE, kmin)
    c = union_mle.estimate_rows(st["hist_a"], p=P, kmin=kmin,
                                method=est.ERTL_MLE, chain=True)
    assert torch.equal(tri[0, :, 2], torch.zeros(b.shape[0]))
    j = 2 if same else 1                       # b's copy of a[1]
    assert torch.equal(tri[1, j], torch.stack([torch.tensor(0.0),
                                               torch.tensor(0.0), c[1]]))
    assert not torch.equal(c, union_mle.estimate_rows(
        st["hist_a"], p=P, kmin=kmin, method=est.ERTL_MLE))


def test_empty_histograms_give_zero_union():
    """A pair whose histogram holds no mass (zero-register padding) has
    c_u = 0 under MLE, not inf (full first, empty last)."""
    cum = torch.zeros((8, 2, 3))
    z = torch.zeros(2), torch.zeros(3)
    tri = union_mle.union_triples(cum, *z, p=P, kmin=0, method=est.ERTL_MLE)
    assert torch.equal(tri, torch.zeros((3, 2, 3)))


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
def test_full_estimates_match_jax(rng, method):
    """Single-sketch estimates (HLL.report, the -o sizes) on full
    histograms, including an empty and a nearly saturated sketch."""
    q = 64 - P
    hists = np.zeros((6, q + 2), np.float32)
    for i, card in enumerate([0, 50, 5000, 2e5, 5e7]):
        regs = np.zeros(1 << P, np.int64)
        if card:
            h = rng.integers(0, 2 ** 63, int(min(card, 2e5)), dtype=np.uint64)
            rank = np.minimum(rng.geometric(0.5, h.size) + int(np.log2(
                max(card / 2e5, 1))), q + 1)
            np.maximum.at(regs, (h % (1 << P)).astype(np.int64), rank)
        hists[i] = np.bincount(regs, minlength=q + 2)
    hists[5, q + 1] = (1 << P) - 3
    hists[5, 20] = 3
    want = np.asarray(jest.estimate(jnp.asarray(hists), P, method))
    got = est.estimate(torch.from_numpy(hists), P, method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
@pytest.mark.parametrize("kmin,K,hi", [(0, 12, 11), (4, 12, 15), (0, 56, 12)])
def test_row_estimates_match_jax(rng, method, kmin, K, hi):
    """The marginal cardinalities of a compare tile: the row-estimate
    wrapper (plain version on the CPU) vs the JAX windowed estimator."""
    kmax = kmin + K - 1
    a = _bank(rng, 16, kmin, hi, kmax == 64 - P + 1)
    stats = jpw.pair_stats(jnp.asarray(a), jnp.asarray(a), kmax, False, kmin)
    hist = np.array(stats["hist_a"])
    want = np.asarray(jest.estimate_windowed(jnp.asarray(hist), P, kmin,
                                             method))
    got = union_mle.estimate_rows(torch.from_numpy(hist), p=P, kmin=kmin,
                                  method=method).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
def test_full_row_estimates_equal_report(rng, method):
    """`dist -o` sizes come from estimate_rows on full histograms with the
    full-histogram Newton count: the same numbers HLL.report gives."""
    q = 64 - P
    regs = rng.integers(0, 12, size=(5, 1 << P))
    regs[0] = 0
    hists = np.stack([np.bincount(r, minlength=q + 2) for r in regs])
    hists = torch.from_numpy(hists.astype(np.float32))
    got = union_mle.estimate_rows(hists, p=P, kmin=0, method=method,
                                  iters=est.FULL_MLE_ITERS)
    assert torch.equal(got, est.estimate(hists, P, method))


# The row-estimate kernel's main-path shapes, plain version against the
# JAX package's row estimators: (form, p, kmin, K, highest register,
# Newton steps, rows).  K = 66, the widest bucket, holds no window (q+2 <=
# 62): K = 61 and 62 run its instantiation.
ROW_SHAPES = [
    ("direct", 16, 0, 50, 14, 24, 16),   # config 2's -o sizes, HLL.report
    ("direct", 16, 0, 24, 11, 12, 16),   # readfilt's batches
    ("chain", 6, 2, 58, 20, 12, 16),     # 2..q+1 at p=6
    ("chain", 5, 0, 61, 12, 12, 16),     # 0..q+1 at p=5
    ("chain", 4, 0, 62, 12, 12, 16),     # 0..q+1 at p=4
    ("direct", 16, 0, 24, 11, 12, 1),    # readfilt's reference: one row
    ("chain", 14, 0, 32, 12, 12, 1),     # a one-row compare's marginal
]


@pytest.mark.parametrize("form,p,kmin,K,hi,iters,n", ROW_SHAPES)
def test_row_estimates_match_jax_at_kernel_shapes(rng, form, p, kmin, K, hi,
                                                  iters, n):
    """estimate_rows' plain version (what the row-estimate kernel equals
    bit for bit on a card) against the JAX package's windowed estimators
    on CPU JAX: the direct form against `mle_estimate_windowed` (XLA's
    K-last form) within the row bar rtol 1e-5, the chain against its
    K-first form within rtol 5e-6 (test_chain_estimates_match_jax_kfirst)."""
    hist = _hist(rng, p, kmin, K, hi, n=max(n, 8))[:n]
    chain = form == "chain"
    got = union_mle.estimate_rows(torch.from_numpy(hist), p=p, kmin=kmin,
                                  method=est.ERTL_MLE, iters=iters,
                                  chain=chain).numpy()
    if chain:
        want = np.asarray(jest.mle_estimate_windowed(
            jnp.asarray(hist.T.copy()), p, kmin, iters=iters, kfirst=True))
    else:
        want = np.asarray(jest.mle_estimate_windowed(
            jnp.asarray(hist), p, kmin, iters=iters))
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin],
                               rtol=5e-6 if chain else 1e-5)


def test_row_lanes_pick_and_refuse():
    """The kernel's form by row count: an MLE a warp a row up to 1,024
    rows, 8 lanes a row above; ORIGINAL and ERTL_IMPROVED a thread a row.
    The form is the wrapper's own choice (estimate_rows takes no lanes),
    and the launch it goes through never runs a CPU tensor."""
    assert [union_mle.row_lanes(n, est.ERTL_MLE)
            for n in (1, 1024, 1025, 8192, 131072)] == [32, 32, 8, 8, 8]
    assert union_mle.row_lanes(100, est.ORIGINAL) == 1
    assert union_mle.row_lanes(100, est.ERTL_IMPROVED) == 1
    hist = torch.from_numpy(_hist(np.random.default_rng(3), P, 0, 12, 11))
    with pytest.raises(TypeError):
        union_mle.estimate_rows(hist, p=P, kmin=0, method=est.ERTL_MLE,
                                lanes=8)
    with pytest.raises(ValueError):
        union_mle._launch_rows(hist, p=P, kmin=0, method=est.ERTL_MLE,
                               iters=12, chain=False, lanes=8)


def test_union_kernel_refuses_bad_windows():
    cum = torch.zeros((67, 1, 1))
    z = torch.zeros(1)
    with pytest.raises(ValueError):
        union_mle.union_triples(cum, z, z, p=P, kmin=0, method=est.ERTL_MLE)
    with pytest.raises(ValueError):
        union_mle.union_triples(torch.zeros((12, 1, 1)), z, z, p=P, kmin=50,
                                method=est.ERTL_MLE)
    with pytest.raises(ValueError):
        union_mle.union_triples(torch.zeros((12, 1, 1)), z, z, p=P, kmin=0,
                                method=est.ERTL_JOINT_MLE)
    with pytest.raises(ValueError):
        union_mle.estimate_rows(torch.zeros((2, 12)), p=P, kmin=50,
                                method=est.ERTL_MLE)
    with pytest.raises(TypeError):
        union_mle.estimate_rows(torch.zeros(12), p=P, kmin=0,
                                method=est.ERTL_MLE)
