"""Port's joint-MLE triples (kernel K5's plain version, on the CPU) vs both
JAX routes, the XLA vmap solve `_xla_jmle_triples` and the Pallas kernel
`pallas_joint_mle` in interpret mode, at the JAX package's own kernel bar:
rtol=2e-4, atol=5e-2 on triples, atol=2e-6 on Jaccard, non-finite entries
in the same places.

The CUDA kernel (csrc/joint_mle.cu) runs only on a card; the smoke script
at the repo root holds it to the plain version tested here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu.sketch.hll import HLL as JHLL
from dashing_tpu_torch.ops import joint_mle as jm
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

RTOL, ATOL, JI_ATOL = 2e-4, 5e-2, 2e-6


def _overlapping_bank(rng, n, p, kmin, kmax):
    """Geometric register profiles confined to the window: one shared set
    maxed into every row, each row's own set a quarter of its size, so
    that every pair overlaps (a near-disjoint pair's Jaccard is
    ill-conditioned in float32, even between the JAX package's own two
    routes)."""
    def geo(rows, shift):
        g = rng.geometric(0.5, size=(rows, 1 << p)) - 1 + kmin - shift
        return np.clip(g, kmin, max(kmin, kmax - 1))
    return np.maximum(geo(n, 2), geo(1, 0)).astype(np.int32)


def _assert_triples_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    with np.errstate(invalid="ignore", divide="ignore"):
        ji_w = want[..., 2] / np.maximum(want.sum(-1), 1e-30)
        ji_g = got[..., 2] / np.maximum(got.sum(-1), 1e-30)
    ok = np.isfinite(ji_w)
    np.testing.assert_array_equal(np.isfinite(ji_g), ok)
    np.testing.assert_allclose(ji_g[ok], ji_w[ok], atol=JI_ATOL)


@pytest.mark.parametrize("p,kmin,K", [
    (10, 0, 16),     # bin 0 in the window; an empty and a duplicated row
    (12, 4, 16),     # interior window, 8 Newton steps
    (10, 44, 12),    # window reaching q+1 = 55, saturated registers
])
def test_joint_triples_match_jax(rng, monkeypatch, p, kmin, K):
    kmax = kmin + K - 1
    a = _overlapping_bank(rng, 8, p, kmin, kmax)
    b = _overlapping_bank(rng, 21, p, kmin, kmax)
    b[3] = kmin                          # all registers at the floor
    b[4] = a[1]                          # identical sets: la = lb ~ 0
    if kmax == 64 - p + 1:
        a[1::2, :5] = kmax               # a few registers in the top bin
        b[2] = kmax                      # fully saturated: inf / nan
    stats = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, True, kmin)
    want_xla = np.asarray(jpw._xla_jmle_triples(stats, p, kmin))
    monkeypatch.setenv("DASHING_TPU_PALLAS_JMLE", "interpret")
    want_pallas = np.asarray(jpw._pallas_jmle_triples(stats, p, kmin))

    tst = pw.pair_stats(torch.from_numpy(a).to(torch.int8),
                        torch.from_numpy(b).to(torch.int8), kmax, kmin,
                        joint=True)
    got = pw.triples_from_stats(tst, p, est.ERTL_MLE, est.ERTL_JOINT_MLE,
                                kmin).numpy()
    assert got.shape == (8, 21, 3)
    _assert_triples_close(got, want_xla)
    _assert_triples_close(got, want_pallas)
    if kmin == 0:
        assert (got[:, 3, 1:] == 0).all()        # empty B: lb = lx = 0


def test_joint_triples_wrapper_layout(rng):
    """The K5 wrapper on its own: K-first in, (3, na, nb) out, the Newton
    count of jmle_iters(p), refusals of what it cannot take."""
    p, kmin, K = 10, 0, 8
    a = _overlapping_bank(rng, 5, p, kmin, kmin + K - 1)
    st = pw.pair_stats(torch.from_numpy(a).to(torch.int8),
                       torch.from_numpy(a).to(torch.int8), kmin + K - 1, kmin,
                       same=True, joint=True)
    args = [st[key].permute(2, 0, 1) for key in ("eq", "gt_a", "gt_b")]
    args += [st["hist_a"].T, st["hist_b"].T]
    c = est.mle_estimate_windowed(st["hist_a"], p, kmin)
    tri = jm.joint_triples(*args, c, c, p=p, kmin=kmin)
    assert tri.shape == (3, 5, 5) and torch.isfinite(tri).all()
    stats = {"eq": args[0], "gt_a": args[1], "gt_b": args[2],
             "lt_a": args[3][:, :, None] - args[0] - args[1],
             "lt_b": args[4][:, None, :] - args[0] - args[2]}
    c_u = est.improved_estimate_windowed(
        (args[0] + args[1] + args[2]).permute(1, 2, 0), p, kmin)
    ten = est.joint_mle_core(stats, (c[:, None], c[None, :], c_u),
                             float(1 << p), 64 - p, kmin, 10)
    assert est.jmle_iters(p) == 10 and est.jmle_iters(12) == 8
    assert torch.equal(tri, torch.stack(ten))
    with pytest.raises(ValueError):
        jm.joint_triples(*args, c, c, p=p, kmin=50)
    with pytest.raises(ValueError):
        jm.joint_triples(*args, c[:4], c, p=p, kmin=kmin)
    with pytest.raises(TypeError):
        jm.joint_triples(*args, c.double(), c, p=p, kmin=kmin)


def test_solve3_sym_matches_jax(rng):
    """The 3x3 adjugate solve, its determinant floor included: a tiny
    negative determinant stays negative (+-1e-30), as the JAX package
    pins it."""
    from dashing_tpu.sketch import estimators as jest
    H = rng.normal(size=(3, 3, 64)).astype(np.float32)
    H = H + H.transpose(1, 0, 2)
    H[:, :, :4] = 1e-12                          # det ~ 0: the floor
    H[0, 0, 1] = -1e-12
    g = rng.normal(size=(3, 64)).astype(np.float32)
    want = np.asarray(jest._solve3_sym(jnp.asarray(H), jnp.asarray(g)))
    Ht = {(i, j): torch.from_numpy(H[i, j]) for i in range(3)
          for j in range(3)}
    got = np.stack([x.numpy() for x in est._solve3_sym(
        Ht, [torch.from_numpy(g[i]) for i in range(3)])])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()


def _hll_bank(rng, n, p):
    pool = rng.integers(0, 2 ** 63, 60000, dtype=np.uint64)
    out = []
    for _ in range(n):
        lo = int(rng.integers(8000, 40000))
        h = JHLL(p)
        h.addh_np(np.concatenate([pool[:8000],
                                  pool[lo:lo + int(rng.integers(100, 20000))]]))
        out.append(h.regs)
    return out


@pytest.mark.parametrize("result_type", [pw.MASH_DIST, pw.JI])
def test_all_pairs_joint_matches_jax(rng, result_type):
    """The tiled engine on the -J path: two diagonal tiles and one
    off-diagonal tile, against the JAX engine."""
    p, n, tile = 10, 30, 16
    regs = _hll_bank(rng, n, p)
    J, M = est.ERTL_JOINT_MLE, est.ERTL_MLE
    want = jpw.all_pairs_condensed([JHLL(p, M, J, r) for r in regs],
                                   result_type, 21, M, J, tile=tile)
    got = pw.all_pairs_condensed([HLL(p, M, J, r) for r in regs],
                                 result_type, 21, M, J, torch.device("cpu"),
                                 tile=tile)
    assert got.shape == want.shape == (n * (n - 1) // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
