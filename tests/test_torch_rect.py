"""The port's query x reference engines (plain PyTorch on the CPU) against
the JAX package on the same numpy-seeded sketches: rect_pairs over every
asymmetric measure and the symmetric ones, rect_triples (triples at
rtol=2e-4 atol=5e-2), with the joint MLE too; the orientation on queries
that are strict subsets of references; ref_blocks' zero columns; the
streaming k-NN (nn_topk) on tie-heavy banks, indices equal to the JAX
package's and values within 2e-6; pad_nn_candidates and full_square.
Last, a property of the port alone: on near-disjoint p = 14 pairs the
joint MLE's Jaccard moves by more than 2e-6 under a one-ulp change of
its marginals only where it flips between its Newton result and start."""
import numpy as np
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu.sketch.hll import HLL as JHLL
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

CPU = torch.device("cpu")
P, K = 10, 21
TRI_RTOL, TRI_ATOL = 2e-4, 5e-2
MEASURE_ATOL = 2e-6


def _regs(pool, parts, p=P):
    h = JHLL(p)
    vals = np.concatenate([pool[lo:hi] for lo, hi in parts])
    if vals.size:
        h.addh_np(vals)
    return h.regs


def _overlapping(rng, n, p=P):
    """n sketches of a shared core plus a random range of a pool (no pair
    near-disjoint: there the Mash distance of float32 estimates is
    ill-conditioned)."""
    pool = rng.integers(0, 2 ** 63, 60000, dtype=np.uint64)
    out = []
    for _ in range(n):
        lo = int(rng.integers(6000, 40000))
        out.append(_regs(pool, [(0, 6000), (lo, lo + int(rng.integers(
            200, 15000)))], p))
    return out


def _tie_bank(rng, n, p=P):
    """A bank with exact ties: each of three sketches appears three times
    (Jaccard exactly 1 and Mash exactly -0.0 among the copies); the rest
    overlap a shared core, so no other pair is near-disjoint (there the
    float32 estimates of shared are noise in both packages; disjoint and
    empty sketches are held by test_nn_topk_tie_order_matches_jax)."""
    pool = rng.integers(0, 2 ** 63, 80000, dtype=np.uint64)
    out = []
    for _ in range(n):
        lo = int(rng.integers(5000, 60000))
        out.append(_regs(pool, [(0, 5000), (lo, lo + int(rng.integers(
            300, 20000)))], p))
    for copy_of, at in ((0, (9, 21)), (1, (14, 30)), (2, (5, 26))):
        for j in at:
            out[j] = out[copy_of].copy()
    return out


def _both(regs, estim=est.ERTL_MLE, jestim=est.ERTL_MLE, p=P):
    return ([JHLL(p, estim, jestim, r) for r in regs],
            [HLL(p, estim, jestim, r) for r in regs])


def _close(got, want, result_type):
    if result_type == pw.SIZES:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=MEASURE_ATOL)


@pytest.fixture(scope="module")
def qr_bank():
    """40 references and 23 queries; queries 0-5 are strict subsets of
    references 0-5 (half the core and a fifth of the rest), the rest
    overlap the shared core, so no pair is near-disjoint."""
    rng = np.random.default_rng(0xDA5)
    pool = rng.integers(0, 2 ** 63, 60000, dtype=np.uint64)
    refs = []
    for i in range(40):
        lo = 6000 + 800 * i
        refs.append(_regs(pool, [(0, 6000), (lo, lo + int(rng.integers(
            2000, 15000)))]))
    queries = [_regs(pool, [(0, 3000), (6000 + 800 * i, 6000 + 800 * i
                                          + 400)]) for i in range(6)]
    for _ in range(17):
        lo = int(rng.integers(6000, 40000))
        queries.append(_regs(pool, [(0, 6000), (lo, lo + int(rng.integers(
            200, 15000)))]))
    return refs, queries


@pytest.fixture(scope="module")
def jax_triples(qr_bank):
    """The JAX package's rect_triples of the bank: MLE in 16-wide tiles
    (ragged on both axes), the joint MLE in one tile."""
    refs, queries = qr_bank
    out = {}
    for jestim, tile in ((est.ERTL_MLE, 16), (est.ERTL_JOINT_MLE, 64)):
        jref, _ = _both(refs, jestim=jestim)
        jq, _ = _both(queries, jestim=jestim)
        out[jestim] = jpw.rect_triples(jref, jq, est.ERTL_MLE, jestim,
                                       tile=tile)
    return out


def _port(qr_bank, jestim, estim=est.ERTL_MLE):
    refs, queries = qr_bank
    return _both(refs, estim, jestim)[1], _both(queries, estim, jestim)[1]


def test_rect_pairs_matches_jax(qr_bank):
    """jpw.rect_pairs itself (Mash, MLE), 40 x 23 in 16-wide tiles."""
    refs, queries = qr_bank
    jref, tref = _both(refs)
    jq, tq = _both(queries)
    want = jpw.rect_pairs(jref, jq, pw.MASH_DIST, K, est.ERTL_MLE,
                          est.ERTL_MLE, tile=16)
    got = pw.rect_pairs(tref, tq, pw.MASH_DIST, K, est.ERTL_MLE,
                        est.ERTL_MLE, CPU, tile=16)
    assert got.shape == want.shape == (23, 40) and got.dtype == np.float32
    assert np.isfinite(got).all()
    _close(got, want, pw.MASH_DIST)


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
@pytest.mark.parametrize("result_type", [
    pw.JI, pw.SIZES, pw.CONTAINMENT_INDEX, pw.CONTAINMENT_DIST,
    pw.FULL_CONTAINMENT_DIST, pw.SYMMETRIC_CONTAINMENT_INDEX])
def test_rect_measures_match_jax(qr_bank, jax_triples, result_type, jestim):
    """Every measure of the port's rect_pairs against the JAX package's
    measure of its own rect_triples (same tiles, same windows)."""
    import jax.numpy as jnp
    tref, tq = _port(qr_bank, jestim)
    tile = 16 if jestim == est.ERTL_MLE else 64
    got = pw.rect_pairs(tref, tq, result_type, K, est.ERTL_MLE, jestim, CPU,
                        tile=tile)
    want = np.asarray(jpw.measure_from_triples(
        jnp.asarray(jax_triples[jestim]), result_type, 1.0 / K))
    assert got.shape == (23, 40) and np.isfinite(got).all()
    _close(got, want, result_type)


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_rect_triples_match_jax_and_orientation(qr_bank, jax_triples,
                                                jestim):
    """Triples at rtol=2e-4 atol=5e-2, their Jaccard at 2e-6.  Queries 0-5
    are strict subsets of references 0-5: the reference is the lhs, so
    onlyREF (t0) holds about four fifths of it and onlyQUERY (t1) little;
    swapping the roles transposes each pair's triples."""
    tref, tq = _port(qr_bank, jestim)
    tile = 16 if jestim == est.ERTL_MLE else 64
    got = pw.rect_triples(tref, tq, est.ERTL_MLE, jestim, CPU, tile=tile)
    want = jax_triples[jestim]
    assert got.shape == want.shape == (23, 40, 3)
    np.testing.assert_allclose(got, want, rtol=TRI_RTOL, atol=TRI_ATOL)
    ji = [t[..., 2] / t.sum(-1) for t in (got, want)]
    np.testing.assert_allclose(ji[0], ji[1], atol=MEASURE_ATOL)
    sub = got[np.arange(6), np.arange(6)]
    assert (sub[:, 0] > 5 * sub[:, 1] + 100).all(), sub
    swapped = pw.rect_triples(tq, tref, est.ERTL_MLE, jestim, CPU, tile=tile)
    np.testing.assert_allclose(swapped[:, :, [1, 0, 2]].transpose(1, 0, 2),
                               got, rtol=TRI_RTOL, atol=TRI_ATOL)
    if jestim == est.ERTL_MLE:     # the union path: exactly the transpose
        np.testing.assert_array_equal(
            swapped[:, :, [1, 0, 2]].transpose(1, 0, 2), got)


def test_rect_ref_blocks_zero_elsewhere(qr_bank):
    """ref_blocks filters the reference tile starts: the owned columns
    equal the full compare's, every other column is zero."""
    tref, tq = _port(qr_bank, est.ERTL_MLE)
    full = pw.rect_pairs(tref, tq, pw.JI, K, est.ERTL_MLE, est.ERTL_MLE, CPU,
                         tile=8)
    got = pw.rect_pairs(tref, tq, pw.JI, K, est.ERTL_MLE, est.ERTL_MLE, CPU,
                        tile=8, ref_blocks=[32, 8])
    owned = np.zeros(40, bool)
    owned[8:16] = owned[32:] = True
    np.testing.assert_array_equal(got[:, owned], full[:, owned])
    assert not got[:, ~owned].any()
    tri = pw.rect_triples(tref, tq, est.ERTL_MLE, est.ERTL_MLE, CPU, tile=8,
                          ref_blocks=[16])
    assert not tri[:, :16].any() and not tri[:, 24:].any()
    assert (tri[6:, 16:24, 2] > 0).all()


# Near-disjoint pairs carry the cancellation of c_a + c_b - c_u into a
# distance: values of distances are held at the `dist` CLI cases' rtol.
NN_RTOL = {pw.JI: 0.0, pw.MASH_DIST: 1e-4, pw.CONTAINMENT_DIST: 1e-4}


@pytest.mark.parametrize("result_type,tile", [(pw.JI, 16), (pw.MASH_DIST, 64)])
def test_nn_topk_all_pairs_matches_jax(rng, result_type, tile):
    """All-pairs mode (queries are the reference list, self excluded) on
    the tie bank: one tile, and several with a ragged tail."""
    regs = _tie_bank(rng, 40)
    jsk, tsk = _both(regs)
    nn = 6
    want = jpw.nn_topk(jsk, jsk, result_type, K, est.ERTL_MLE, est.ERTL_MLE,
                       nn, exclude_self=True, tile=tile)
    got = pw.nn_topk(tsk, tsk, result_type, K, est.ERTL_MLE, est.ERTL_MLE,
                     nn, exclude_self=True, device=CPU, tile=tile)
    assert got[0].shape == got[1].shape == (40, nn)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=NN_RTOL[result_type],
                               atol=MEASURE_ATOL)
    assert (got[1] != np.arange(40)[:, None]).all()
    # exact ties were present: copies first, in ascending reference order
    assert list(got[1][0, :2]) == [9, 21] and list(got[1][9, :2]) == [0, 21]


@pytest.mark.parametrize("result_type,tile", [
    (pw.JI, 64), (pw.MASH_DIST, 16), (pw.CONTAINMENT_DIST, 16)])
def test_nn_topk_query_mode_matches_jax(rng, result_type, tile):
    """Query x reference mode: nothing excluded, copies of references among
    the queries (their own copy first), nn clamped to the references."""
    regs = _tie_bank(rng, 44)
    jref, tref = _both(regs[:31])
    qregs = regs[31:] + [regs[4].copy(), regs[0].copy()]
    jq, tq = _both(qregs)
    for nn in (3, 40):
        want = jpw.nn_topk(jref, jq, result_type, K, est.ERTL_MLE,
                           est.ERTL_MLE, nn, exclude_self=False, tile=tile)
        got = pw.nn_topk(tref, tq, result_type, K, est.ERTL_MLE,
                         est.ERTL_MLE, nn, exclude_self=False, device=CPU,
                         tile=tile)
        assert got[1].shape == (15, min(nn, 31))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0],
                                   rtol=NN_RTOL[result_type],
                                   atol=MEASURE_ATOL)
    assert got[1][13, 0] == 4 and got[1][14, 0] == 0


def _indexed(n):
    """n sketch pairs whose first register holds their index."""
    regs = np.zeros((n, 1 << P), np.uint8)
    regs[:, 0] = np.arange(n)
    return _both(list(regs))


@pytest.mark.parametrize("sim", [True, False])
@pytest.mark.parametrize("tile", [64, 8])
def test_nn_topk_tie_order_matches_jax(rng, monkeypatch, sim, tile):
    """The selection and merge alone, on values with the ties of disjoint
    and identical sets (Jaccard 0 and 1, Mash 1.0 and -0.0, +0.0 beside
    -0.0): both packages' tile compare is replaced by slices of one fixed
    matrix, indexed by the first register of each sketch; indices and
    values (signs of zeros included) must be equal, in all-pairs mode
    (self excluded) and query mode, over all reference tiles and over a
    share of them (ref_blocks)."""
    import jax.numpy as jnp
    n = 37
    mat = rng.choice(np.array([0.0, -0.0, 1.0, 0.5, 0.25], np.float32),
                     size=(n, n))
    mat[5, 9] = mat[9, 5] = np.float32(0.3)

    def jax_tile(a, b, *args, **kwargs):
        return jnp.asarray(mat[np.asarray(a)[:, 0]][:, np.asarray(b)[:, 0]])

    def port_tile(a, b, *args, **kwargs):
        return torch.from_numpy(mat[a[:, 0].numpy()][:, b[:, 0].numpy()])

    monkeypatch.setattr(jpw, "compare_tile_async", jax_tile)
    monkeypatch.setattr(pw, "compare_tile", port_tile)
    jsk, tsk = _indexed(n)
    rt = pw.JI if sim else pw.MASH_DIST
    for refs, queries, excl in ((slice(None), None, True),
                                (slice(0, 29), slice(29, None), False)):
        jr, tr = jsk[refs], tsk[refs]
        jq, tq = ((jr, tr) if queries is None
                  else (jsk[queries], tsk[queries]))
        for nn in (5, 40):
            want = jpw.nn_topk(jr, jq, rt, K, est.ERTL_MLE, est.ERTL_MLE, nn,
                               exclude_self=excl, tile=tile)
            got = pw.nn_topk(tr, tq, rt, K, est.ERTL_MLE, est.ERTL_MLE, nn,
                             exclude_self=excl, device=CPU, tile=tile)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(np.signbit(got[0]),
                                          np.signbit(want[0]))
    # a share of the reference tiles (global ids, padded with (worst, -1)
    # where the share holds fewer than nn references)
    for blocks in [[0]] + ([[tile, 3 * tile]] if 3 * tile < n else []):
        want = jpw.nn_topk(jsk, jsk, rt, K, est.ERTL_MLE, est.ERTL_MLE, 12,
                           exclude_self=True, tile=tile, ref_blocks=blocks)
        got = pw.nn_topk(tsk, tsk, rt, K, est.ERTL_MLE, est.ERTL_MLE, 12,
                         exclude_self=True, device=CPU, tile=tile,
                         ref_blocks=blocks)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].shape == (n, 12)


@pytest.mark.parametrize("sim", [True, False])
def test_tile_topk_matches_lax_top_k(rng, sim):
    """The device top-k alone against the JAX package's: exact ties, both
    signed zeros, the ±inf self sentinel and a ragged tile padded with
    (worst, -1)."""
    import jax.numpy as jnp
    vals = rng.choice(np.array([0.0, -0.0, 1.0, 0.25, 0.5], np.float32),
                      size=(9, 6))
    vals[2, 3] = np.float32(0.3)
    for nn in (4, 12):
        want = jpw._device_tile_topk(jnp.asarray(vals), 3, 2, nn, sim, True)
        got = pw.tile_topk(torch.from_numpy(vals), 3, 2, nn, sim, True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(np.signbit(got[0].numpy()),
                                      np.signbit(np.asarray(want[0])))


def test_pad_nn_candidates():
    v = np.array([[0.5, 0.2]], np.float32)
    i = np.array([[3, 7]], np.int64)
    for fn in (pw.pad_nn_candidates, jpw.pad_nn_candidates):
        pv, pi = fn(v, i, 4, -np.inf)
        np.testing.assert_array_equal(
            pv, np.array([[0.5, 0.2, -np.inf, -np.inf]], np.float32))
        np.testing.assert_array_equal(pi, [[3, 7, -1, -1]])
        same = fn(v, i, 2, np.inf)
        assert same[0] is v and same[1] is i


def test_full_square_matches_jax(rng):
    """An asymmetric measure: every tile of the grid; the square's
    transpose is the port's rect_pairs of the bank against itself."""
    regs = _overlapping(rng, 21)
    jsk, tsk = _both(regs)
    want = jpw.full_square(jsk, pw.CONTAINMENT_DIST, K, est.ERTL_MLE,
                           est.ERTL_MLE, tile=8)
    got = pw.full_square(tsk, pw.CONTAINMENT_DIST, K, est.ERTL_MLE,
                         est.ERTL_MLE, CPU, tile=8)
    assert got.shape == (21, 21) and (np.diag(got) == 0).all()
    _close(got, want, pw.CONTAINMENT_DIST)
    rect = pw.rect_pairs(tsk, tsk, pw.CONTAINMENT_DIST, K, est.ERTL_MLE,
                         est.ERTL_MLE, CPU, tile=8)
    off = ~np.eye(21, dtype=bool)
    np.testing.assert_array_equal(got.T[off], rect[off])


def test_full_square_mirrors_symmetric_tiles(rng):
    """A symmetric measure: the upper tiles mirrored, equal to the
    condensed all-pairs vector bit for bit."""
    regs = _overlapping(rng, 21)
    _, tsk = _both(regs)
    got = pw.full_square(tsk, pw.JI, K, est.ERTL_MLE, est.ERTL_MLE, CPU,
                         tile=8)
    cond = pw.all_pairs_condensed(tsk, pw.JI, K, est.ERTL_MLE, est.ERTL_MLE,
                                  CPU, tile=8)
    assert (np.diag(got) == 0).all()
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(got[np.triu_indices(21, 1)], cond)


def _sampled_regs(rng, n, p):
    """p-bit HLL registers of n distinct random items, drawn from their
    distribution: per bucket a Poisson(n / 2^p) count and the largest of
    that many geometric ranks, by its inverse CDF."""
    m = 1 << p
    c = rng.poisson(n / m, m)
    u = rng.random(m)
    r = np.ceil(-np.log2(1.0 - u ** (1.0 / np.maximum(c, 1))))
    return np.where(c > 0, np.clip(r, 1, 64 - p + 1), 0).astype(np.int32)


def test_joint_mle_one_ulp_moves_only_the_branch():
    """K5's plain version on two banks of near-disjoint p = 14 sketches of
    33 thousand to 4 million items (the shape of the card's -J -Q corner):
    it keeps its Newton result only if the result's log-likelihood is not
    below the start's.  Moving both sides' marginal estimates by one ulp
    flips that choice for some pairs, and only those move Jaccard by more
    than 2e-6 (where the Newton solve moved far from its start, by ~1e-5)."""
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import union_mle as um
    p = 14
    rng = np.random.default_rng(1)
    size = lambda: float(np.exp(rng.uniform(np.log(3e4), np.log(4e6))))
    shared = [_sampled_regs(rng, float(np.exp(rng.uniform(np.log(1e2),
                                                          np.log(1e5)))), p)
              for _ in range(64)]
    a = np.stack([np.maximum(_sampled_regs(rng, size(), p), shared[i])
                  for i in range(48)])
    b = np.stack([np.maximum(_sampled_regs(rng, size(), p), shared[j])
                  for j in range(64)])
    kmax, kmin = pw._pair_window(pw._block_minmax(a, 48, 64)[0],
                                 pw._block_minmax(b, 64, 64)[0], 64 - p)
    st = pw.pair_stats(pw._device_regs(a, CPU), pw._device_regs(b, CPU),
                       kmax, kmin, joint=True)
    args = ([st[k].permute(2, 0, 1).contiguous()
             for k in ("eq", "gt_a", "gt_b")]
            + [st["hist_a"].T.contiguous(), st["hist_b"].T.contiguous()]
            + [um.estimate_rows(st[h], p=p, kmin=kmin, method=est.ERTL_MLE)
               for h in ("hist_a", "hist_b")])
    nudged = args[:5] + [torch.nextafter(args[5], torch.tensor(np.inf)),
                         torch.nextafter(args[6], torch.tensor(0.0))]

    def solve(x):
        tri = jm.joint_triples_plain(*x, p=p, kmin=kmin)
        start = jm.joint_triples_plain(*x, p=p, kmin=kmin, iters=0)
        t = tri.double()
        return (t[2] / t.sum(0)).numpy(), ~(tri == start).all(0).numpy()

    (ji, kept), (ji_n, kept_n) = solve(args), solve(nudged)
    flip = kept != kept_n
    err = np.abs(ji_n - ji)
    assert (ji < 1e-2).mean() > 0.9 and flip.any()
    assert err[~flip].max() <= 2e-6
    assert err[flip].max() > 2e-6
