"""Port's joint pair statistics (kernel K4's plain version, on the CPU) vs
the JAX package: exactly equal to `pair_stats(joint=True)` (the XLA
indicator matmuls) and to the Pallas kernel `pallas_pair_stats` in
interpret mode, on same-bank tiles, distinct ragged tiles and windows with
kmin > 0.

The CUDA kernel (csrc/joint_stats.cu) runs only on a card; the smoke script
at the repo root holds it to the plain version tested here, bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops import pairwise as jpw
from dashing_tpu.ops.pallas_stats import pallas_pair_stats
from dashing_tpu_torch.ops import joint_stats as js
from dashing_tpu_torch.ops import pairwise as pw

torch.set_num_threads(1)

KEYS = ("cum_union", "eq", "gt_a", "gt_b")


def _geo_bank(rng, n, p, kmin, top):
    """Realistic register rows: kmin + Geometric(1/2), clipped to top."""
    g = rng.geometric(0.5, size=(n, 1 << p)) - 1 + kmin
    return np.minimum(g, top).astype(np.int32)


def _kfirst(want, key):
    return np.moveaxis(np.asarray(want[key]), -1, 0)


@pytest.mark.parametrize("p,na,nb,kmin,K,same", [
    (10, 24, 24, 0, 16, True),     # same bank: the Z = Y^T cut
    (10, 13, 29, 0, 16, False),    # distinct, ragged
    (12, 17, 40, 5, 24, False),    # kmin > 0
    (11, 30, 30, 3, 8, True),      # kmin > 0 on a diagonal tile
])
def test_joint_stats_match_jax(rng, p, na, nb, kmin, K, same):
    kmax = kmin + K - 1
    a = _geo_bank(rng, na, p, kmin, kmax)
    b = a if same else _geo_bank(rng, nb, p, kmin, kmax)
    a[0] = kmin                        # every register at the window floor
    want = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, True, kmin,
                          same)
    ta = torch.from_numpy(a).to(torch.int8)
    tb = ta if same else torch.from_numpy(b).to(torch.int8)
    got = js.joint_pair_stats(ta, tb, kmin=kmin, kmax=kmax, same=same)
    for key in KEYS:
        assert got[key].shape == (K, na, nb) and got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), _kfirst(want, key),
                                      err_msg=key)
    # through the compare engine's entry: K-last views plus marginals
    full = pw.pair_stats(ta, tb, kmax, kmin, same, joint=True)
    for key in KEYS + ("hist_a", "hist_b"):
        np.testing.assert_array_equal(full[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_registers_below_the_window_match_xla(rng):
    """X[kmin-1] is counted, as the XLA path counts it: registers below the
    window shift eq and gt by the pairs that share them."""
    p, kmin, kmax = 10, 4, 15
    a = _geo_bank(rng, 9, p, kmin, kmax)
    b = _geo_bank(rng, 14, p, kmin, kmax)
    a[1, :40] = 1
    b[2, 10:60] = 2
    want = jpw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, True, kmin)
    got = js.joint_pair_stats(torch.from_numpy(a).to(torch.int8),
                              torch.from_numpy(b).to(torch.int8),
                              kmin=kmin, kmax=kmax)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), _kfirst(want, key),
                                      err_msg=key)


@pytest.mark.parametrize("na,nb,kmin,K,same", [
    (32, 128, 0, 16, False),    # the Pallas block grid itself
    (19, 45, 6, 16, False),     # ragged: the Pallas side pads, the port not
    (40, 40, 3, 16, True),      # one bank on both sides, kmin > 0
])
def test_joint_stats_match_pallas_kernel(rng, na, nb, kmin, K, same):
    p, ba = 11, 32
    kmax = kmin + K - 1
    a = _geo_bank(rng, na, p, kmin, kmax)
    b = a if same else _geo_bank(rng, nb, p, kmin, kmax)
    a8 = jnp.pad(jnp.asarray(a, jnp.int8), ((0, (-na) % ba), (0, 0)),
                 constant_values=kmin)
    b8 = jnp.pad(jnp.asarray(b, jnp.int8), ((0, (-nb) % 128), (0, 0)),
                 constant_values=kmin)
    want = pallas_pair_stats(a8, b8, kmin=kmin, kmax=kmax, ba=ba, slab=2048,
                             interpret=True)
    ta = torch.from_numpy(a).to(torch.int8)
    got = js.joint_pair_stats(ta, ta if same else
                              torch.from_numpy(b).to(torch.int8),
                              kmin=kmin, kmax=kmax, same=same)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(),
                                      _kfirst(want, key)[:, :na, :nb],
                                      err_msg=key)


def test_joint_stats_refuse_bad_inputs():
    a = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(TypeError):
        js.joint_pair_stats(a.to(torch.int32), a, kmin=0, kmax=7)
    with pytest.raises(ValueError):
        js.joint_pair_stats(a, a, kmin=0, kmax=66)        # 67 levels
    with pytest.raises(ValueError):
        js.joint_pair_stats(a, torch.zeros((2, 32), dtype=torch.int8),
                            kmin=0, kmax=7)
