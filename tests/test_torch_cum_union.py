"""The X-only form of kernel K4 (`cum_union_counts`, the main path's
cumulative union counts) on the CPU: its plain version exactly equal to
the JAX package's `pair_stats(joint=False)["cum_union"]`, moved K-first,
over windows with kmin > 0, one level, the widest bucket (66 levels),
ragged and same-bank tiles; the wrapper's refusals; and `pair_stats`
returning a view of the K-first counts.

The CUDA kernel (csrc/joint_stats.cu) runs only on a card; the smoke script
at the repo root and tests/test_torch_cuda_kernels.py hold it to the plain
version tested here, bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu_torch.ops import joint_stats as js
from dashing_tpu_torch.ops import pairwise as pw

torch.set_num_threads(1)


def _bank(rng, n, p, lo, hi):
    """Register rows lo + Geometric(1/2) - 1, clipped to hi."""
    g = rng.geometric(0.5, size=(n, 1 << p)) - 1 + lo
    return np.minimum(g, hi).astype(np.int32)


@pytest.mark.parametrize("p,na,nb,kmin,K,same", [
    (10, 12, 20, 3, 12, False),    # kmin > 0, ragged
    (10, 16, 16, 0, 1, True),      # one level
    (8, 9, 14, 0, 66, False),      # the widest bucket, past every register
    (11, 30, 30, 5, 24, True),     # kmin > 0 on a diagonal tile
    (12, 7, 33, 40, 8, False),     # a high window, registers below it
    (4, 5, 5, 0, 62, True),        # m = 16, the window 0..q+1
])
def test_cum_union_plain_matches_jax(rng, p, na, nb, kmin, K, same):
    kmax = kmin + K - 1
    q = 64 - p
    a = _bank(rng, na, p, max(kmin - 2, 0), min(kmax, q + 1))
    b = a if same else _bank(rng, nb, p, max(kmin - 2, 0), min(kmax, q + 1))
    a[0, :3] = 0                       # registers at 0 and at q+1
    a[-1, -2:] = q + 1
    want = np.asarray(jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax,
                                     False, kmin, same)["cum_union"])
    ta = torch.from_numpy(a).to(torch.int8)
    tb = ta if same else torch.from_numpy(b).to(torch.int8)
    got = js.cum_union_counts_plain(ta, tb, kmin=kmin, kmax=kmax)
    assert got.shape == (K, na, nb) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, -1, 0))


@pytest.mark.parametrize("same", [False, True])
def test_pair_stats_reads_the_kfirst_counts(rng, same):
    """pair_stats(joint=False) returns a K-last view of the K-first
    counts (no stack-and-copy), equal to the JAX package's."""
    p, kmin, kmax = 10, 2, 17
    a = _bank(rng, 11, p, kmin, kmax)
    b = a if same else _bank(rng, 6, p, kmin, kmax)
    want = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, False, kmin,
                          same)
    ta = torch.from_numpy(a).to(torch.int8)
    tb = ta if same else torch.from_numpy(b).to(torch.int8)
    got = pw.pair_stats(ta, tb, kmax, kmin, same)
    assert got["cum_union"].permute(2, 0, 1).is_contiguous()
    for key in ("cum_union", "hist_a", "hist_b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("kmin,kmax", [(-1, 4), (0, 65), (5, 4), (30, 96)])
def test_cum_union_refuses_bad_windows(kmin, kmax):
    a = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        js.cum_union_counts(a, a, kmin=kmin, kmax=kmax)


def test_cum_union_refuses_bad_inputs():
    a = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(TypeError):                       # wrong dtype
        js.cum_union_counts(a.to(torch.int32), a, kmin=0, kmax=7)
    with pytest.raises(ValueError):                      # mixed devices
        js.cum_union_counts(a, a.to("meta"), kmin=0, kmax=7)
    with pytest.raises(ValueError):                      # widths differ
        js.cum_union_counts(a, torch.zeros((2, 32), dtype=torch.int8),
                            kmin=0, kmax=7)
    with pytest.raises(ValueError):                      # not a matrix
        js.cum_union_counts(a[0], a, kmin=0, kmax=7)
