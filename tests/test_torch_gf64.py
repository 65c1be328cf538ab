"""The carry-less multiplication hash of the port (`hashes.gf64_mul`,
`clhash` on int64 tensors, `gf64_mul_np`, `clhash_np`) against the JAX
package's device and numpy forms on the CPU: equal bit for bit on 256
random pairs and on arange(2^13) at seed 11, and the field laws of
GF(2^64) (identity, commutativity, distributivity over XOR)."""
import numpy as np
import pytest
import torch

from dashing_tpu import hashes as jhashes
from dashing_tpu import u64
from dashing_tpu_torch import hashes

torch.set_num_threads(1)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.fixture()
def rng():
    return np.random.default_rng(11)


def test_gf64_mul_equals_jax(rng):
    """256 random pairs (top bits set in about half), a scalar right-hand
    side broadcast, and the products by 0 and by all ones."""
    a = rng.integers(0, 2**64, 256, dtype=np.uint64)
    b = rng.integers(0, 2**64, 256, dtype=np.uint64)
    want = jhashes.gf64_mul_np(a, b)
    np.testing.assert_array_equal(
        u64.to_np(jhashes.gf64_mul(u64.from_np(a), u64.from_np(b))), want)
    np.testing.assert_array_equal(_u(hashes.gf64_mul(_t(a), _t(b))), want)
    np.testing.assert_array_equal(hashes.gf64_mul_np(a, b), want)
    for c in (np.uint64(0), np.uint64(0xFFFFFFFFFFFFFFFF), b[7]):
        want_c = jhashes.gf64_mul_np(a, c)
        np.testing.assert_array_equal(
            _u(hashes.gf64_mul(_t(a), int(np.asarray(c).view(np.int64)))),
            want_c)
        np.testing.assert_array_equal(hashes.gf64_mul_np(a, c), want_c)


@pytest.mark.parametrize("seed", [0, 11, 0x7FFFFFFF])
def test_clhash_equals_jax(seed):
    """arange(2^13) through clhash: the port's tensor and numpy forms
    against the JAX package's device and numpy forms."""
    x = np.arange(1 << 13, dtype=np.uint64)
    want = jhashes.clhash_np(x, seed)
    np.testing.assert_array_equal(
        u64.to_np(jhashes.clhash(u64.from_np(x), seed)), want)
    np.testing.assert_array_equal(_u(hashes.clhash(_t(x), seed)), want)
    np.testing.assert_array_equal(hashes.clhash_np(x, seed), want)
    assert np.unique(want).size == want.size        # a bijection


def test_gf64_field_laws(rng):
    a, b, c = (rng.integers(0, 2**64, 64, dtype=np.uint64) for _ in range(3))
    ta, tb, tc = _t(a), _t(b), _t(c)
    np.testing.assert_array_equal(_u(hashes.gf64_mul(ta, 1)), a)
    np.testing.assert_array_equal(hashes.gf64_mul_np(a, np.uint64(1)), a)
    np.testing.assert_array_equal(_u(hashes.gf64_mul(ta, tb)),
                                  _u(hashes.gf64_mul(tb, ta)))
    np.testing.assert_array_equal(
        _u(hashes.gf64_mul(ta ^ tb, tc)),
        _u(hashes.gf64_mul(ta, tc) ^ hashes.gf64_mul(tb, tc)))
    np.testing.assert_array_equal(
        hashes.gf64_mul_np(a ^ b, c),
        hashes.gf64_mul_np(a, c) ^ hashes.gf64_mul_np(b, c))
