"""The port's batched set-sketch compare engines
(dashing_tpu_torch/sketch/batch_compare.py) against the JAX package's on
the CPU: the same sketches (built in each package from the same
numpy-seeded values) give bitwise equal float64 triples, with and without
the B-axis tiling of a tiny DASHING_TPU_HOST_TILE_MB; and each triple is
the pair's own full_set_comparison (mirrors tests/test_batch_compare.py
and the saturated-Bloom case of tests/test_review_r5.py)."""
import io

import numpy as np
import pytest
import torch

from dashing_tpu.sketch import batch_compare as jbc
from dashing_tpu.sketch import setsketches as jss
from dashing_tpu_torch.cli import core
from dashing_tpu_torch.sketch import batch_compare as tbc
from dashing_tpu_torch.sketch import setsketches as tss

CASES = [
    ("BBitMinHash", dict(p=8, b=16)),
    ("BBitMinHash", dict(p=9, b=8)),
    ("CountingBBitMinHash", dict(p=8, b=16)),
    ("BloomFilter", dict(nbits_log2=13, nhashes=2)),
    ("BottomK", dict(kk=128)),
    ("CountingBottomK", dict(kk=96)),
]


def _mk(name, kwargs, rng, n=9, base_n=4000):
    """n sketches in each package: growing overlaps with a shared base,
    the last near-empty, the counting forms with repeats."""
    base = rng.integers(0, 2 ** 62, base_n, dtype=np.uint64)
    js, ts = [], []
    for i in range(n):
        if i == n - 1:
            vals = rng.integers(0, 2 ** 62, 7, dtype=np.uint64)
        else:
            vals = np.concatenate(
                [base[: 1000 + 300 * i],
                 rng.integers(0, 2 ** 62, 200 * i + 50, dtype=np.uint64)])
        if name.startswith("Counting"):
            vals = np.concatenate([vals, vals[: vals.size // 3]])
        for pkg, out in ((jss, js), (tss, ts)):
            s = getattr(pkg, name)(**kwargs)
            s.addh_np(vals)
            s.finalize()
            out.append(s)
    return js, ts


@pytest.mark.parametrize("name,kwargs", CASES)
def test_engines_equal_jax(name, kwargs, monkeypatch):
    js, ts = _mk(name, kwargs, np.random.default_rng(len(name)))
    assert tbc.supports(ts)
    for a, b in ((slice(None), slice(None)), (slice(0, 5), slice(3, 9)),
                 (slice(2, 3), slice(None))):
        want = jbc.batch_triples(js[a], js[b])
        got = tbc.batch_triples(ts[a], ts[b])
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        # B-axis tiles of 16 sketches at the smallest budget
        monkeypatch.setenv("DASHING_TPU_HOST_TILE_MB", "0.000001")
        np.testing.assert_array_equal(tbc.batch_triples(ts[a], ts[b]), want)
        monkeypatch.delenv("DASHING_TPU_HOST_TILE_MB")
    n = len(ts)
    rect = tbc.batch_triples(ts, ts)
    for i in range(n):
        for j in range(n):
            np.testing.assert_allclose(
                rect[i, j], np.asarray(ts[i].full_set_comparison(ts[j])),
                rtol=1e-12, atol=1e-9, err_msg=f"{name} pair ({i},{j})")


def test_b_axis_tiling_past_sixteen(monkeypatch):
    """40 Bloom filters: the tiny budget cuts B into tiles of 16, bitwise
    the untiled triples and the JAX package's tiled ones."""
    rng = np.random.default_rng(4)
    js, ts = [], []
    for _ in range(40):
        v = rng.integers(0, 2 ** 63, 200, dtype=np.uint64)
        for pkg, out in ((jss, js), (tss, ts)):
            s = pkg.BloomFilter(nbits_log2=10, nhashes=3)
            s.addh_np(v)
            out.append(s)
    want = tbc.batch_triples(ts, ts)
    monkeypatch.setenv("DASHING_TPU_HOST_TILE_MB", "0.000001")
    got = tbc.batch_triples(ts, ts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jbc.batch_triples(js, js))


def test_saturated_bloom_matches_per_pair_and_jax():
    """A saturated filter reports inf: its shared component is 0.0 (the
    per-pair max(0.0, nan)), never NaN, and the cardinality TSV prints
    inf."""
    rng = np.random.default_rng(9)
    v = rng.integers(0, 2 ** 63, 5, dtype=np.uint64)
    sk = {}
    for pkg in (jss, tss):
        full = pkg.BloomFilter(nbits_log2=6, nhashes=2)
        full.bits = np.full_like(full.bits, np.uint64(0xFFFFFFFFFFFFFFFF))
        normal = pkg.BloomFilter(nbits_log2=6, nhashes=2)
        normal.addh_np(v)
        sk[pkg] = [full, normal]
    full, normal = sk[tss]
    tri = tbc.batch_triples(sk[tss], sk[tss])
    per_pair = np.array([[full.full_set_comparison(full),
                          full.full_set_comparison(normal)],
                         [normal.full_set_comparison(full),
                          normal.full_set_comparison(normal)]])
    assert np.array_equal(tri, per_pair), (tri, per_pair)
    assert np.array_equal(tri, jbc.batch_triples(sk[jss], sk[jss]))
    buf = io.StringIO()
    core.emit_cardinalities(buf, ["a", "b"], [full, normal],
                            torch.device("cpu"))
    assert "a\tinf" in buf.getvalue()


def test_check_compatible_rejects_mixed_geometry():
    """The JAX CLI's messages, word for word."""
    from dashing_tpu.cli import core as jcore
    for mixed in ([tss.BBitMinHash(p=8, b=8), tss.BBitMinHash(p=8, b=16)],
                  [tss.BloomFilter(nbits_log2=10, nhashes=3),
                   tss.BloomFilter(nbits_log2=12, nhashes=3)],
                  [tss.BloomFilter(nbits_log2=10, nhashes=3),
                   tss.BloomFilter(nbits_log2=10, nhashes=2)],
                  [tss.BottomK(64), tss.BottomK(128)],
                  [tss.BBitMinHash(p=8), tss.BBitMinHash(p=9)],
                  [tss.BottomK(64), tss.CountingBottomK(64)]):
        with pytest.raises(SystemExit) as got:
            core.check_compatible(mixed)
        twins = [getattr(jss, type(s).__name__).__new__(
            getattr(jss, type(s).__name__)) for s in mixed]
        for t, s in zip(twins, mixed):
            t.__dict__.update(vars(s))
        with pytest.raises(SystemExit) as want:
            jcore.check_compatible(twins)
        assert str(got.value) == str(want.value)
