"""The port's sparse read-vs-reference engine and `readfilt` against the
JAX package, on the CPU.

The sparse statistics (sketch/sparse.py: an int64 key sort, the run ends,
the reference gather and scatter-added 0/1 indicators) must equal the
JAX package's bit for bit, full and level-windowed, at p = 10, 12, 25 and
26 (where only an int64 key holds the bucket).  The joint MLE given the
union's MLE as its start (K5's plain version with c_u) must equal the JAX
package's K-first form, the one its Pallas kernel runs, at the JAX
package's sparse bar (rtol 1e-5, atol 1e-3), and `pallas_joint_mle` in
interpret mode given the same c_u at the kernel bar of
test_torch_joint_mle.py.

End to end the two packages part by more than rounding, and this file
states by how much.  The joint MLE keeps its Newton result only if its
float32 log-likelihood is not below its start's (the JAX package's
guard).  Seeded by the union's MLE, as here, the start lies near the
optimum, so the two likelihoods often tie within rounding and the guard
can decide differently in the two packages ("a flip"): one returns its
start, the other the Newton result.  Every comparison finds each side's
start (its engine rerun with no Newton step) and holds
  - rows where both sides made the same choice: onlyRead and shared
    within READ_ATOL of the read's own count (onlyRead + shared), onlyRef
    within REF_RTOL, the containment index CI = shared / (onlyRead +
    shared) within CI_ATOL (the starts differ by an ulp of c_u - c_b: XLA
    sums the cardinality estimates in a tree, the port level by level);
  - rows where exactly one side returned its start: at most FLIP_SHARE of
    a record set (BANK_FLIP_SHARE of a 24-row sparse bank), rounded up,
    CI within FLIP_CI_ATOL.
Flip shares read on this file's data and on four other seeds (1-4): at
most 3 of 24 rows of a sparse bank at p 10-16, 6 of 120 records of a CLI
run, 6 of 130 records of the batch test; FLIP_SHARE and BANK_FLIP_SHARE
are twice those.  The CI moved by a flip is data-dependent: within
FLIP_CI_ATOL here, 0.33 on one row of seed 2's p = 16 bank.
At p = 25 a Newton step's gain is below the rounding of the
log-likelihood (a sum over 2^25 registers), the guard decides by
rounding in both packages (3-11 of 24 rows flip) and every row is held
to the flip bars.  Given one and the same start, K5's plain version
equals the JAX package's K-first form (what its Pallas kernel runs) at
the JAX package's sparse bar, rtol 1e-5 / atol 1e-3, wherever the guard
decided alike.  The CLI's numbers (printed with six decimals, as the JAX
CLI prints them) are its engine's, so they cannot match the JAX CLI's
byte for byte; its output is held byte for byte to the JAX CLI's
emission of the port's own numbers, and the numbers to the bars above.
Against a 5 Mbp reference (test_readfilt_5mbp_witness) a third of the
reads flip and a few percent move further than 1e-3 on the same branch:
the float32 solve does not converge there in either package.
"""
import contextlib
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashing_tpu import pipeline as jpipe
from dashing_tpu.cli import main as jmain
from dashing_tpu.ops.pallas_jmle import pallas_joint_mle
from dashing_tpu.sketch import estimators as jest
from dashing_tpu.sketch import hll as jhll
from dashing_tpu.sketch import sparse as jsparse
from dashing_tpu.sketch.hll import HLL as JHLL
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.hashes import clz64_np
from dashing_tpu_torch.ops import joint_mle as jm
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch import sparse
from dashing_tpu_torch.sketch.hll import HLL, ertl_joint

torch.set_num_threads(1)
CPU = torch.device("cpu")

READ_ATOL = 1e-2     # onlyRead and shared, a share of the read's count
REF_RTOL = 1e-4      # onlyRef
CI_ATOL = 1e-2       # containment index, rows decided alike
# rows whose Newton result only one side kept, at most (module docstring):
# of a record set or a CLI run's records, and of the 24-row sparse banks
FLIP_SHARE, BANK_FLIP_SHARE = 0.1, 0.25
FLIP_CI_ATOL = 5e-2  # their containment index, and every CLI number's
JI_ATOL = 2e-6
FOREIGN_KEPT_MAX = 0.2   # chip_smoke.py's RF_FOREIGN_MAX
# test_readfilt_5mbp_witness, measured on its data: 29 pairs, 0.0256, 1
WITNESS_FAR, WITNESS_CI_MAX, WITNESS_KEPT_DIFFER = 45, 0.05, 3


def _idx_rank(hashes, p):
    h = np.asarray(hashes, np.uint64)
    idx = (h >> np.uint64(64 - p)).astype(np.int32)
    rest = (h << np.uint64(p)) | np.uint64(1 << (p - 1))
    return idx, (clz64_np(rest) + 1).astype(np.int32)


def _queries(rng, pool, p, B=24, L=96):
    """B queries of 20..L hashes, a growing share of them drawn from the
    reference's pool, padded with rank 0 (one row all padding)."""
    idx = np.zeros((B, L), np.int32)
    rank = np.zeros((B, L), np.int32)
    for r in range(1, B):
        n = int(rng.integers(20, L + 1))
        k = n * r // B
        h = np.concatenate([rng.choice(pool, k),
                            rng.integers(0, 2 ** 63, n - k, dtype=np.uint64)])
        idx[r, :n], rank[r, :n] = _idx_rank(h, p)
    return idx, rank


def _reference(rng, p, n):
    pool = rng.integers(0, 2 ** 63, n, dtype=np.uint64) << np.uint64(1)
    ref = JHLL(p)
    ref.add_np(pool)
    return pool, ref


def _both(fn_j, fn_t, idx, rank, regs, hist, p, kb):
    want = fn_j(jnp.asarray(idx), jnp.asarray(rank), jnp.asarray(regs),
                jnp.asarray(hist), p, kb)
    got = fn_t(torch.from_numpy(idx), torch.from_numpy(rank),
               torch.from_numpy(regs), torch.from_numpy(hist), p, kb)
    return want, got


@pytest.mark.parametrize("p,n_ref,windowed", [
    (10, 4000, False), (10, 4000, True), (12, 20000, False),
    (12, 20000, True), (25, 300000, False), (25, 300000, True)])
def test_sparse_stats_bitwise_jax(rng, p, n_ref, windowed):
    pool, ref = _reference(rng, p, n_ref)
    idx, rank = _queries(rng, pool, p)
    regs = ref.regs.astype(np.int32)
    hist = ref.histogram()
    kb = 0
    if windowed:
        kb = sparse.level_window_bins(max(int(rank.max()), int(regs.max())),
                                      64 - p)
        assert kb < 64 - p + 2
        hist = hist[:kb].copy()
    want, got = _both(jsparse.sparse_pair_stats, sparse.sparse_pair_stats,
                      idx, rank, regs, hist, p, kb)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_sparse_stats_p26_int64_key(rng):
    """At p = 26 a bucket << 6 passes 2^31: buckets at both ends of the
    register file, duplicates with several ranks, against a reference
    with registers set at some of them."""
    p = 26
    m = 1 << p
    regs = np.zeros(m, np.int32)
    hot = np.concatenate([np.arange(40), m - 1 - np.arange(40),
                          rng.integers(0, m, 200)])
    regs[hot] = rng.integers(1, 12, hot.size)
    hist = np.bincount(regs, minlength=64 - p + 2).astype(np.float32)
    B, L = 6, 64
    idx = rng.choice(hot, (B, L)).astype(np.int32)
    idx[:, ::7] = rng.integers(0, m, (B, 10))      # buckets off the reference
    rank = rng.integers(0, 14, (B, L)).astype(np.int32)
    assert idx.max() >= m - 40 and (idx.astype(np.int64) << 6).max() > 2 ** 31
    want, got = _both(jsparse.sparse_pair_stats, sparse.sparse_pair_stats,
                      idx, rank, regs, hist, p, 0)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_sparse_stats_equal_dense_pair_statistics(rng):
    """The sparse statistics are the dense pair statistics of the query's
    registers (the port's pair_statistics, itself equal to the JAX
    package's)."""
    p = 10
    pool, ref = _reference(rng, p, 4000)
    idx, rank = _queries(rng, pool, p, B=6)
    regs = torch.from_numpy(ref.regs.astype(np.int32))
    st = sparse.sparse_pair_stats(torch.from_numpy(idx),
                                  torch.from_numpy(rank), regs,
                                  torch.from_numpy(ref.histogram()), p)
    for r in range(6):
        q = np.zeros(1 << p, np.int32)
        np.maximum.at(q, idx[r], rank[r])
        dense = est.pair_statistics(torch.from_numpy(q), regs, 64 - p)
        want = jest.pair_statistics(jnp.asarray(q), jnp.asarray(regs.numpy()),
                                    64 - p)
        for key in sparse.STAT_KEYS:
            np.testing.assert_array_equal(st[key][r].numpy(),
                                          dense[key].numpy(), err_msg=key)
            np.testing.assert_array_equal(dense[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)


def _ci(t):
    d = t[:, 0] + t[:, 2]
    return np.where(d > 0, t[:, 2] / np.maximum(d, 1e-300), 0.0)


def _assert_triples_close(got, want, flip=None, flip_share=FLIP_SHARE):
    """(n, 3) triples against the JAX package's; `flip` marks the rows
    whose Newton result only one side kept, at most `flip_share` of them
    (None: not known, every row held to the flip bars)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    own = np.maximum(want[:, 0] + want[:, 2], 1.0)
    ci_err = np.abs(_ci(got) - _ci(want))
    if flip is None:
        read_atol, ref_rtol, ci_atol = 5 * READ_ATOL, 10 * REF_RTOL, \
            FLIP_CI_ATOL
        flip = np.zeros(len(got), bool)
    else:
        read_atol, ref_rtol, ci_atol = READ_ATOL, REF_RTOL, CI_ATOL
    assert flip.sum() <= np.ceil(flip_share * len(got)), flip.sum()
    assert (ci_err[flip] <= FLIP_CI_ATOL).all(), ci_err[flip].max()
    ok = ~flip
    for c in (0, 2):
        np.testing.assert_array_less(
            np.abs(got[ok, c] - want[ok, c]), read_atol * own[ok] + 1e-3)
    np.testing.assert_allclose(got[ok, 1], want[ok, 1], rtol=ref_rtol)
    np.testing.assert_array_less(ci_err[ok], ci_atol + 1e-12)


def _flips(got, got_start, want, want_start):
    """Rows where exactly one side returned its start."""
    return ((np.asarray(got) == np.asarray(got_start)).all(1)
            ^ (np.asarray(want) == np.asarray(want_start)).all(1))


def _jax_cards(st, p):
    return (jest.mle_estimate_windowed(st["hist_a"], p, 0),
            jest.mle_estimate_windowed(st["hist_b"][0], p, 0),
            jest.mle_estimate_windowed(st["hist_u"], p, 0))


def _jax_start(c_a, c_b, c_u):
    """The JAX package's start from its cardinalities, as it returns it."""
    la, lb, lx = (jnp.exp(jnp.log(jnp.maximum(x, 1e-3)))
                  for x in (c_u - c_b, c_u - c_a, c_a + c_b - c_u))
    la = jnp.where(c_a <= 0, 0.0, la)
    lx = jnp.where((c_a <= 0) | (c_b <= 0), 0.0, lx)
    lb = jnp.where(c_b <= 0, 0.0, lb)
    return np.stack([np.broadcast_to(np.asarray(t), c_a.shape)
                     for t in (la, lb, lx)], 1)


def _port_start(idx, rank, regs, hist, p, kb):
    """The port's start (K5's plain version, 0 Newton steps) from its own
    cardinalities (sparse.triples_kfirst's)."""
    t = torch.from_numpy
    st = sparse.stats_kfirst(t(idx), t(rank), t(regs), t(hist), p, kb)
    mle = lambda h: est.mle_estimate_windowed(h.contiguous(), p, 0)  # noqa
    return jm.joint_triples_plain(
        st["eq"][:, :, None], st["gt_a"][:, :, None], st["gt_b"][:, :, None],
        st["hist_a"], t(hist)[:, None], mle(st["hist_a"].T),
        mle(t(hist)[None]), mle(st["hist_u"].T)[:, None], p=p, kmin=0,
        iters=0)[:, :, 0].T.numpy()


@pytest.mark.parametrize("p,n_ref,windowed", [
    (10, 4000, True), (12, 20000, False), (14, 60000, True),
    (16, 200000, True), (25, 300000, True)])
def test_sparse_triples_vs_jax(rng, p, n_ref, windowed):
    pool, ref = _reference(rng, p, n_ref)
    idx, rank = _queries(rng, pool, p)
    regs = ref.regs.astype(np.int32)
    hist = ref.histogram()
    kb = 64 - p + 2
    if windowed:
        kb = sparse.level_window_bins(max(int(rank.max()), int(regs.max())),
                                      64 - p)
        hist = hist[:kb].copy()
    want, got = _both(jsparse.sparse_joint_triples,
                      sparse.sparse_joint_triples, idx, rank, regs, hist, p,
                      kb)
    want, got = np.asarray(want), got.numpy()
    st = jsparse.sparse_pair_stats(jnp.asarray(idx), jnp.asarray(rank),
                                   jnp.asarray(regs), jnp.asarray(hist), p,
                                   kb)
    cards = _jax_cards(st, p)
    flip = _flips(got, _port_start(idx, rank, regs, hist, p, kb), want,
                  _jax_start(*cards))
    # at p = 25 the log-likelihoods are sums over 2^25 registers: a Newton
    # step's gain is below their rounding, so the guard decides by
    # rounding in either package (about half the rows flip), and every
    # row is held to the flip bars
    _assert_triples_close(got, want, flip if p < 25 else None,
                          BANK_FLIP_SHARE)
    assert (got[0, [0, 2]] == 0).all()          # the all-padding row
    # given the JAX package's own cardinalities, the solve (K5's plain
    # version with c_u) equals the JAX package's K-first form at its
    # sparse bar wherever the guard decided alike
    c_a, c_b, c_u = cards
    kf = {key: jnp.asarray(st[key]).T[:, :, None]
          for key in ("eq", "gt_a", "gt_b", "lt_a", "lt_b")}
    solve = lambda it: np.stack([np.asarray(x)[:, 0] for x in  # noqa: E731
                                 jest.joint_mle_core(
                                     kf, (c_a[:, None], c_b, c_u[:, None]),
                                     float(1 << p), 64 - p, 0, it,
                                     kfirst=True)], 1)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    port = lambda it: jm.joint_triples_plain(  # noqa: E731
        t(kf["eq"]), t(kf["gt_a"]), t(kf["gt_b"]), t(st["hist_a"]).T,
        t(hist)[:, None], t(c_a), t(c_b).reshape(1), t(c_u)[:, None], p=p,
        kmin=0, iters=it)[:, :, 0].T.numpy()
    want_k, got_k = solve(jest.jmle_iters(p)), port(None)
    flip = _flips(got_k, port(0), want_k, solve(0))
    if p < 25:
        assert flip.sum() <= BANK_FLIP_SHARE * len(got_k)
        np.testing.assert_allclose(got_k[~flip], want_k[~flip], rtol=1e-5,
                                   atol=1e-3)
    else:
        # and the counts of bin 0 pass 2^24: the kernel's derived lt_a =
        # (ha - eq) - gt_a rounds where the JAX package's direct count
        # does not
        _assert_triples_close(got_k, want_k, flip_share=BANK_FLIP_SHARE)


def test_k5_plain_with_c_u_vs_pallas_interpret(rng):
    """K5's plain version given c_u (the union's direct MLE, not the
    IMPROVED seed it derives without one) against the TPU kernel in
    interpret mode given the same c_u, at the kernel bar of
    test_torch_joint_mle.py."""
    p, kmin, K = 12, 0, 24
    m = 1 << p

    def bank(rows, shift):
        # geometric register profiles; one shared set maxed into every
        # row, so every pair overlaps (test_torch_joint_mle.py's banks)
        return np.clip(rng.geometric(0.5, size=(rows, m)) - 1 - shift, 0,
                       K - 2)
    common = bank(1, 0)
    a, b = np.maximum(bank(8, 2), common), np.maximum(bank(128, 2), common)
    from dashing_tpu_torch.ops import pairwise as pw
    st = pw.pair_stats(torch.from_numpy(a).to(torch.int8),
                       torch.from_numpy(b).to(torch.int8), K - 1, 0,
                       joint=True)
    kf = [st[key].permute(2, 0, 1).contiguous()
          for key in ("eq", "gt_a", "gt_b")]
    ha, hb = st["hist_a"].T.contiguous(), st["hist_b"].T.contiguous()
    c_a = est.mle_estimate_windowed(st["hist_a"], p, 0)
    c_b = est.mle_estimate_windowed(st["hist_b"], p, 0)
    c_u = est.mle_estimate_windowed(kf[0].permute(1, 2, 0) + kf[1].permute(
        1, 2, 0) + kf[2].permute(1, 2, 0), p, 0)
    want = np.asarray(pallas_joint_mle(
        *(jnp.asarray(t.numpy()) for t in kf + [ha, hb, c_a, c_b, c_u]),
        p=p, kmin=kmin, iters=jest.jmle_iters(p), ba=8, interpret=True))
    got = jm.joint_triples(*kf, ha, hb, c_a, c_b, c_u, p=p,
                           kmin=kmin).numpy()
    assert got.shape == want.shape == (3, 8, 128)
    # pairs whose Newton result only one side kept (see the module
    # docstring): at most one in a hundred, each the port's start or the
    # TPU kernel's (both start from the same c_u)
    start = jm.joint_triples_plain(*kf, ha, hb, c_a, c_b, c_u, p=p,
                                   kmin=kmin, iters=0).numpy()
    flat = lambda x: x.reshape(3, -1).T  # noqa: E731
    flip = (flat(got) == flat(start)).all(1) ^ (
        np.abs(flat(want) - flat(start)) <= 1e-6 * flat(start)).all(1)
    assert flip.sum() <= 0.01 * flip.size
    ok = ~flip
    np.testing.assert_allclose(flat(got)[ok], flat(want)[ok], rtol=2e-4,
                               atol=5e-2)
    ji = [x[:, 2] / x.sum(1) for x in (flat(got), flat(want))]
    np.testing.assert_allclose(ji[0][ok], ji[1][ok], atol=JI_ATOL)
    np.testing.assert_allclose(ji[0], ji[1], atol=FLIP_CI_ATOL)
    with pytest.raises(ValueError):
        jm.joint_triples(*kf, ha, hb, c_a, c_b, c_u[:4], p=p, kmin=kmin)


def test_sparse_empty_query_and_p_guard(rng):
    p = 8
    pool, jref = _reference(rng, p, 500)
    ref = HLL(p, regs=jref.regs)
    a, b, x = sparse.SparseHLL(p).pair_query(ref, device=CPU)
    assert a == 0.0 and x == 0.0 and b > 0
    want = jsparse.SparseHLL(p).pair_query(jref)
    np.testing.assert_allclose(b, want[1], rtol=1e-5)
    for bad in (3, 27, 30):
        with pytest.raises(ValueError):
            sparse.SparseHLL(bad)
    s = sparse.SparseHLL.from_hashes(pool[:100], p)
    js = jsparse.SparseHLL.from_hashes(pool[:100], p)
    np.testing.assert_array_equal(s.idx, js.idx)
    np.testing.assert_array_equal(s.to_dense().regs, js.to_dense().regs)
    _assert_triples_close(np.array([s.pair_query(ref, device=CPU)]),
                          np.array([js.pair_query(jref)]))


def _genome_sketches(rng, p, n_bases=60000):
    """Two related sets: 60 kbp random genome and a copy with 40 % of it
    replaced, as HLLs of both packages (hashes of their 21-mers)."""
    g = rng.integers(0, 4, n_bases)
    g2 = g.copy()
    g2[: n_bases * 2 // 5] = rng.integers(0, 4, n_bases * 2 // 5)
    out = []
    for s in (g, g2):
        km = np.lib.stride_tricks.sliding_window_view(s, 21) @ (
            4 ** np.arange(21, dtype=np.int64))
        out.append(km.astype(np.uint64))
    return out


@pytest.mark.parametrize("p", [8, 10, 12, 14])
def test_full_set_comparison_vs_jax(rng, p):
    """ertl_joint (K4's joint form on a 1 x 1 tile, the direct-MLE
    cardinalities, K5 given c_u) and the inclusion-exclusion branch,
    against the JAX package, on two related sets."""
    ka, kb = _genome_sketches(rng, p)
    ja, jb = JHLL(p), JHLL(p)
    ja.addh_np(ka)
    jb.addh_np(kb)
    ta, tb = HLL(p, regs=ja.regs), HLL(p, regs=jb.regs)
    want = np.asarray(jest.joint_mle(
        jest.pair_statistics(jnp.asarray(ja.regs.astype(np.int32)),
                             jnp.asarray(jb.regs.astype(np.int32)), 64 - p),
        p))
    from dashing_tpu.sketch.hll import ertl_joint as jertl
    np.testing.assert_allclose(np.asarray(jertl(ja, jb)), want, rtol=1e-6)
    got = np.asarray(ertl_joint(ta, tb, CPU))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-2)
    assert abs(got[2] / got.sum() - want[2] / want.sum()) <= JI_ATOL * 10
    assert ta.jestim == est.ERTL_MLE            # restored
    # the inclusion-exclusion branch (jestim MLE) and its measures
    for method in (est.ERTL_MLE, est.ERTL_IMPROVED, est.ORIGINAL):
        ja.estim = ja.jestim = ta.estim = ta.jestim = method
        w = np.asarray(ja.full_set_comparison(jb))
        g = np.asarray(ta.full_set_comparison(tb, CPU))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)
    for fn in ("jaccard_index", "containment_index"):
        np.testing.assert_allclose(getattr(ta, fn)(tb, CPU),
                                   getattr(ja, fn)(jb),
                                   atol=1e-6)
    np.testing.assert_allclose(ta.intersection_size(tb, CPU),
                               ja.intersection_size(jb), rtol=1e-5)


def _read_set(rng, tmp, n_pairs=120, length=100, width=0):
    """A 6 kbp reference (sketched by the JAX CLI, k 15, S 12) and read
    pairs: two thirds cut from it at 0-3 % substitutions, one third
    random; returns (hll path, mate 1 path, mate 2 path)."""
    ref = rng.integers(0, 4, 6000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp / "ref.fa"
    fa.write_bytes(b">r\n" + lut[ref].tobytes() + b"\n")
    assert jmain.main(["sketch", "-k", "15", "-S", "12", str(fa)]) == 0

    def read(i):
        if i % 3 == 0:
            return lut[rng.integers(0, 4, length)]
        s = int(rng.integers(0, ref.size - length))
        r = ref[s:s + length].copy()
        hit = rng.random(length) < 0.01 * (i % 4)
        r[hit] = (r[hit] + 1) & 3
        return lut[r]

    paths = (tmp / "r1.fq", tmp / "r2.fq")
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2:
        for i in range(n_pairs):
            f1.write(b"@p%d/1 c%d\n%s\n+\n%s\n" % (
                i, i, read(i).tobytes(), b"I" * length))
            f2.write(b"@p%d/2\n%s\n+\n%s\n" % (
                i, read(i + 1).tobytes(), b"J" * length))
    return str(fa) + ".w.15.spacing.12.hll", *map(str, paths)


_NUM = re.compile(r"\d+\.\d{6}")


@functools.partial(jax.jit, static_argnames=("p", "kbins"))
def _jax_sparse_start(idx, rank, ref_regs, ref_hist, p, kbins=0):
    """The JAX package's sparse_joint_triples returning each row's start:
    the same statistics and cardinalities, no Newton step."""
    stats = jsparse.sparse_pair_stats(idx, rank, ref_regs, ref_hist, p,
                                      kbins)
    c_b = jest.mle_estimate_windowed(stats["hist_b"][0], p, 0)

    def one(st):
        cards = (jest.mle_estimate_windowed(st["hist_a"], p, 0), c_b,
                 jest.mle_estimate_windowed(st["hist_u"], p, 0))
        return jest.joint_mle(st, p, iters=0, cards=cards)
    return jax.vmap(one)(stats)


def _jax_ertl_start(a, b):
    """The JAX package's ertl_joint returning its start."""
    stats = jest.pair_statistics(jnp.asarray(a.regs.astype(np.int32)),
                                 jnp.asarray(b.regs.astype(np.int32)), a.q)
    return tuple(float(x) for x in
                 np.asarray(jest.joint_mle(stats, a.p, iters=0)))


@contextlib.contextmanager
def _engines_return_starts():
    """Both packages' readfilt engines (the sparse batches, and ertl_joint
    for records above MAX_RECORD_WIDTH) return each record's start, the
    inclusion-exclusion point their joint MLE starts from, in place of
    its triple."""
    start = functools.partial(jm.joint_triples_plain, iters=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "joint_triples", start)
        mp.setattr(sparse, "joint_triples", start)
        mp.setattr(jsparse, "sparse_joint_triples", _jax_sparse_start)
        mp.setattr(jhll, "ertl_joint", _jax_ertl_start)
        yield


def _records_both(seqs, k, ref, p, **kw):
    """Each package's records_joint_triples of `seqs` against the JHLL
    `ref`, and each one's starts: (port, port start, JAX, JAX start)."""
    regs, hist = ref.regs.astype(np.int32), ref.histogram()

    def port():
        return pipeline.records_joint_triples(
            seqs, pipeline.SketchParams(k=k), torch.from_numpy(regs),
            torch.from_numpy(hist), p, CPU, **kw)

    def jax_():
        return np.asarray(jpipe.records_joint_triples(
            seqs, jpipe.SketchParams(k=k), regs, hist, p))
    got, want = port(), jax_()
    with _engines_return_starts():
        return got, port(), want, jax_()


def _cli_out(capsys, fn, argv, tag):
    """Run `readfilt argv` through one CLI: (output, stderr).  An -o path
    gets the suffix `tag`, and its file is the output."""
    argv = list(argv)
    path = None
    if "-o" in argv:
        path = argv[argv.index("-o") + 1] + tag
        argv[argv.index("-o") + 1] = path
    capsys.readouterr()
    assert fn(["readfilt"] + argv) == 0
    cap = capsys.readouterr()
    return (open(path).read() if path else cap.out), cap.err


def _run_both(capsys, argv):
    """readfilt through both CLIs.  Returns, per package (JAX, port): its
    output and stderr, the records its engine compared in order, their
    triples and their starts (the engine rerun on the same batches under
    _engines_return_starts)."""
    runs = []
    for fn, pipe, tag in ((jmain.main, jpipe, ".jax"),
                          (tmain.main, pipeline, ".port")):
        real, calls = pipe.records_joint_triples, []

        def record(seqs, *a, real=real, calls=calls, **kw):
            out = np.asarray(real(seqs, *a, **kw))
            calls.append((list(seqs), a, kw, out))
            return out
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pipe, "records_joint_triples", record)
            out, err = _cli_out(capsys, fn, argv, tag)
        with _engines_return_starts():
            starts = [np.asarray(real(c[0], *c[1], **c[2])) for c in calls]
        cat = lambda xs: (np.concatenate(xs) if xs  # noqa: E731
                          else np.zeros((0, 3)))
        runs.append(dict(out=out, err=err, tri=cat([c[3] for c in calls]),
                         start=cat(starts),
                         seqs=[x for c in calls for x in c[0]]))
    return runs


def _jax_cli_given(capsys, argv, seqs, tri):
    """The JAX CLI's output and stderr when its engine returns `tri` for
    `seqs`, in order: its emission of those numbers."""
    pos = [0]

    def given(batch, *a, **kw):
        i = pos[0]
        pos[0] += len(batch)
        assert list(batch) == seqs[i:pos[0]]
        return tri[i:pos[0]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "records_joint_triples", given)
        out = _cli_out(capsys, jmain.main, argv, ".given")
    assert pos[0] == len(seqs)
    return out


def _check_readfilt(capsys, argv):
    """readfilt through both CLIs: both engines compared the same records,
    their triples agree at the module's bars with each side's start known,
    the two outputs are the same lines apart from the numbers, and the
    port's output and warnings are byte for byte the JAX CLI's emission
    of the port's numbers (its engine given them).  Returns the port's
    output and stderr."""
    jx, pt = _run_both(capsys, argv)
    assert pt["seqs"] == jx["seqs"]
    flip = _flips(pt["tri"], pt["start"], jx["tri"], jx["start"])
    _assert_triples_close(pt["tri"], jx["tri"], flip)
    jl, tl = jx["out"].splitlines(), pt["out"].splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    out, err = _jax_cli_given(capsys, argv, pt["seqs"], pt["tri"])
    assert out == pt["out"]
    # each CLI names its own package in its version line
    drop = re.compile(r"^dashing_tpu(_torch)? version: .*\n", re.M)
    assert drop.sub("", err) == drop.sub("", pt["err"])
    return pt["out"], pt["err"]


def test_readfilt_single_paired_fasta_vs_jax_cli(rng, tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    hll, r1, r2 = _read_set(rng, tmp_path)
    for argv in (["-k", "15", "-s", hll, "-f", "0.5", r1],
                 ["-k", "15", "-s", hll, "-f", "0.3", r1, r2],
                 ["-k", "15", "-s", hll, "-f", "0.0", "-C", r1, r2]):
        out, _ = _check_readfilt(capsys, argv)
        assert out.count("\n") > 40
    # FASTA reads, a FASTA mate 1 with a FASTQ mate 2 (the pair goes out
    # as FASTA), and -o
    fa = tmp_path / "reads.fa"
    with open(r1) as src, open(fa, "w") as dst:
        lines = src.read().splitlines()
        for i in range(0, len(lines), 4):
            dst.write(">" + lines[i][1:] + " note\n" + lines[i + 1] + "\n")
    for argv in (["-k", "15", "-s", hll, "-f", "0.3", str(fa)],
                 ["-k", "15", "-s", hll, "-f", "0.3", str(fa), r2]):
        out, _ = _check_readfilt(capsys, argv)
        assert out.startswith(">") and "+\n" not in out
    out, _ = _check_readfilt(capsys, ["-k", "15", "-s", hll, "-o",
                                      str(tmp_path / "kept"), r1, r2])
    assert out.startswith("@p") and capsys.readouterr().out == ""


def test_readfilt_mismatched_mates_and_wide_record(rng, tmp_path, capsys,
                                                   monkeypatch):
    """Mates of unequal counts stop at the shorter file with the JAX CLI's
    warning; a record wider than MAX_RECORD_WIDTH (patched to 1024 in both
    packages) takes ertl_joint against the dense reference; reads shorter
    than k and empty ones give CI 0."""
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(pipeline, "MAX_RECORD_WIDTH", 1024)
    monkeypatch.setattr(jpipe, "MAX_RECORD_WIDTH", 1024)
    hll, r1, r2 = _read_set(rng, tmp_path, n_pairs=30)
    short = tmp_path / "short.fq"
    with open(r2) as src:
        short.write_text("".join(src.readlines()[:4 * 20]))
    out, err = _check_readfilt(capsys, ["-k", "15", "-s", hll, "-f", "0.3",
                                        r1, str(short)])
    assert "Warning: mismatched numbers of reads between paired-end " \
        "files" in err
    assert "@p20/" not in out and "@p0/1" in out
    ref = open(tmp_path / "ref.fa").read().split("\n")[1]
    fa = tmp_path / "mixed.fa"
    fa.write_text(f">wide a\n{ref[:3000]}\n>read b\n{ref[100:250]}\n"
                  f">tiny\nACGTA\n>empty\n\n>foreign\n{'ACGT' * 40}\n")
    out, _ = _check_readfilt(capsys, ["-k", "15", "-s", hll, "-f", "0.0",
                                      str(fa)])
    lines = out.splitlines()
    assert lines[0].startswith(">wide a|") and len(lines) == 10
    assert float(lines[0].rsplit("|", 1)[1]) > 0.95
    assert lines[4] == ">tiny |0.000000" and lines[6] == ">empty |0.000000"


def test_records_joint_triples_batch_independent(rng, tmp_path):
    """The triples do not depend on how the records are batched (the
    level window follows each batch's largest rank; the port batches by
    length): batches of 5, 64 and 4,096 records within the JAX package's
    windowed-vs-full bar, CI within 1e-6."""
    hll, r1, r2 = _read_set(rng, tmp_path, n_pairs=90)
    from dashing_tpu_torch.io import fasta
    seqs = [rec[2] for rec in fasta.iter_records_full(r1)]
    seqs += [s[: 20 + 7 * i] for i, s in enumerate(seqs[:40])]
    ref = HLL.read(hll)
    cpu = torch.device("cpu")
    params = pipeline.SketchParams(k=15)
    regs = torch.from_numpy(ref.regs.astype(np.int32))
    hist = torch.from_numpy(ref.histogram())
    outs = [pipeline.records_joint_triples(seqs, params, regs, hist, 12, cpu,
                                           batch=b) for b in (5, 64, 4096)]
    scale = np.abs(outs[-1]).max()
    for o in outs[:2]:
        np.testing.assert_allclose(o, outs[-1], rtol=1e-4, atol=2e-6 * scale)
        ci = [t[:, 2] / np.maximum(t[:, 0] + t[:, 2], 1e-300)
              for t in (o, outs[-1])]
        np.testing.assert_allclose(ci[0], ci[1], atol=1e-6)
    got, got_start, want, want_start = _records_both(
        seqs, 15, ref, 12, batch=4096)
    np.testing.assert_array_equal(got, outs[-1])
    _assert_triples_close(got, want, _flips(got, got_start, want,
                                            want_start))


def test_reference_cardinality_once_a_window(rng, tmp_path, monkeypatch):
    """records_joint_triples estimates the reference's cardinality once a
    level window: with one `ref_card` (sparse.reference_cardinalities)
    over several calls (as readfilt passes it, batch after batch) the
    triples equal bit for bit those of c_b estimated again in every batch
    (triples_kfirst given no c_b), and the row estimates number 2 a batch
    (c_a, c_u) plus 1 a window."""
    hll, r1, _ = _read_set(rng, tmp_path, n_pairs=90)
    from dashing_tpu_torch.io import fasta
    seqs = [rec[2] for rec in fasta.iter_records_full(r1)]
    seqs += [s[: 20 + 7 * i] for i, s in enumerate(seqs[:40])]
    ref = HLL.read(hll)
    args = (pipeline.SketchParams(k=15),
            torch.from_numpy(ref.regs.astype(np.int32)),
            torch.from_numpy(ref.histogram()), 12, CPU)
    rows, windows = [], []
    real_rows, real_tk = sparse.estimate_rows, sparse.triples_kfirst

    def counted_rows(h, **kw):
        rows.append(h.shape[0])
        return real_rows(h, **kw)

    def counted_tk(st, hist, p, c_b=None):
        windows.append(st["eq"].shape[0])
        return real_tk(st, hist, p, c_b)
    monkeypatch.setattr(sparse, "estimate_rows", counted_rows)
    monkeypatch.setattr(sparse, "triples_kfirst", counted_tk)
    chunks = [seqs[:50], seqs[50:100], seqs[100:]]
    card = sparse.reference_cardinalities(args[2], 12)
    got = [pipeline.records_joint_triples(c, *args, batch=16, ref_card=card)
           for c in chunks]
    batches, cards = len(windows), len(set(windows))
    assert 1 <= cards < batches
    assert len(rows) == 2 * batches + cards
    assert rows.count(1) == cards
    with monkeypatch.context() as mp:         # c_b in every batch
        mp.setattr(sparse, "triples_kfirst",
                   lambda st, hist, p, c_b=None: counted_tk(st, hist, p))
        want = [pipeline.records_joint_triples(c, *args, batch=16)
                for c in chunks]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_readfilt_keys_route_equals_encoder_route(rng, tmp_path,
                                                  monkeypatch):
    """The keys of K2's plain version and those of the PyTorch encoders
    (the route of p = 26 and of the other encodings) give the same
    triples."""
    hll, r1, _ = _read_set(rng, tmp_path, n_pairs=40)
    from dashing_tpu_torch.io import fasta
    seqs = [rec[2] for rec in fasta.iter_records_full(r1)]
    ref = HLL.read(hll)
    args = (seqs, pipeline.SketchParams(k=15),
            torch.from_numpy(ref.regs.astype(np.int32)),
            torch.from_numpy(ref.histogram()), 12, torch.device("cpu"))
    keys = pipeline.records_joint_triples(*args)
    monkeypatch.setattr(pipeline, "encode_hash_keys", None)
    monkeypatch.setattr(pipeline, "packed_ok", lambda *a: False)
    np.testing.assert_array_equal(pipeline.records_joint_triples(*args), keys)


def test_readfilt_refusals(tmp_path, monkeypatch, capsys):
    """No reads or no -s: usage and 1; a CUDA request without a card
    exits rather than run on the CPU."""
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    assert tmain.main(["readfilt", "x.fq"]) == 1
    assert "readfilt -s ref.hll" in capsys.readouterr().err
    if not torch.cuda.is_available():
        monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cuda")
        with pytest.raises(SystemExit):
            tmain.main(["readfilt", "-s", "ref.hll", "x.fq"])


def test_comparisons_default_to_the_cli_device(rng, monkeypatch):
    """HLL.full_set_comparison and its measures, ertl_joint and
    SparseHLL.pair_query run on DASHING_TPU_TORCH_DEVICE (default cuda)
    unless the caller names a device: the CPU only when asked for."""
    p = 8
    pool, jref = _reference(rng, p, 500)
    a, b = HLL(p, regs=jref.regs), HLL.from_numpy(
        np.maximum(jref.regs, 1), p)
    s = sparse.SparseHLL.from_hashes(pool[:50], p)
    calls = (lambda: a.full_set_comparison(b), lambda: a.jaccard_index(b),
             lambda: a.containment_index(b), lambda: a.intersection_size(b),
             lambda: ertl_joint(a, b), lambda: s.pair_query(a))
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    want = [c() for c in calls]
    assert want[4] == ertl_joint(a, b, CPU) and want[5] == s.pair_query(
        a, device=CPU)
    if not torch.cuda.is_available():
        for env in ("cuda", ""):
            monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", env)
            for c in calls:
                with pytest.raises(RuntimeError, match="cuda"):
                    c()


WITNESS_PAIRS = 400


def test_readfilt_5mbp_witness(rng):
    """The JAX package is the witness for what e2e (l) of chip_smoke.py
    sees on the card.  Reads against a 5 Mbp genome's k = 21, p = 16
    sketch: WITNESS_PAIRS pairs of 2 x 150 bases from 400-base fragments
    joined by N x 20 as readfilt joins mates, even ones cut from the
    genome at 0.5 % substitutions, odd ones from a foreign 5 Mbp genome.
    A foreign read's k-mers land in buckets whose reference registers
    (the largest rank of ~76 k-mers) are mostly at least as high as their
    own, so their containment index is not near 0 in either package, and
    the joint MLE's start and its float32 guard part the two packages'
    triples (module docstring).  Held: in both packages at least 0.8 of
    the genome's pairs kept at -f 0.5 and at most FOREIGN_KEPT_MAX of the
    foreign ones (chip_smoke.py's bar), the kept shares within 0.02 of
    each other, and, between the packages, at most WITNESS_FAR pairs
    further than 1e-3 apart in CI where both took the same branch, none
    further than WITNESS_CI_MAX, and at most WITNESS_KEPT_DIFFER pairs
    kept by one package only."""
    G, L, INS = 5_000_000, 150, 400
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    foreign = rng.integers(0, 4, G).astype(np.uint8)
    regs = pipeline.sketch_joined_hll(lut[genome], pipeline.SketchParams(
        k=21), 16, CPU)
    ref = JHLL(16, regs=regs)
    seqs = []
    for i in range(WITNESS_PAIRS):
        src = genome if i % 2 == 0 else foreign
        s = int(rng.integers(0, G - INS))
        mates = [src[s:s + L].copy(), 3 - src[s + INS - 1 - np.arange(L)]]
        for m in mates:
            hit = rng.random(L) < 0.005
            m[hit] = (m[hit] + rng.integers(1, 4, hit.sum())) & 3
        seqs.append(lut[mates[0]].tobytes() + b"N" * 20
                    + lut[mates[1]].tobytes())
    got, got_start, want, want_start = _records_both(seqs, 21, ref, 16)
    assert np.isfinite(got).all()
    flip = _flips(got, got_start, want, want_start)
    ci_t, ci_j = _ci(got), _ci(want)
    kept = {name: [(c[h::2] >= 0.5).mean() for h in (0, 1)]
            for name, c in (("port", ci_t), ("jax", ci_j))}
    err = np.abs(ci_t - ci_j)
    far = int(((err > 1e-3) & ~flip).sum())
    differ = int(((ci_t >= 0.5) != (ci_j >= 0.5)).sum())
    print(f"kept (genome, foreign) {kept}; flips {int(flip.sum())}; "
          f"same branch further than 1e-3 {far}, max {err[~flip].max()}; "
          f"max {err.max()}; kept by one only {differ}")
    for share in kept.values():
        assert share[0] >= 0.8 and share[1] <= FOREIGN_KEPT_MAX
    assert np.abs(np.subtract(*kept.values())).max() <= 0.02
    assert far <= WITNESS_FAR and err[~flip].max() <= WITNESS_CI_MAX
    assert differ <= WITNESS_KEPT_DIFFER
