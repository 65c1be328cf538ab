"""The ASCII-tile route's encoders: the port (PyTorch on the CPU) against
the JAX package and the oracles.

Spaced seeds (-s), minimizer windows (-w), canonical on and off, and the
rolling hashes (ntHash, cyclic) at k up to 70 are bitwise equal to JAX's
`encode_tile` / `rolling_hash_tile` at valid lanes, with equal validity,
and to `encode_oracle` / `rolling_hash_oracle`.

Entropy minimizers (-g): the port scores a k-mer by a table of its base
composition (ops/encode.entropy_table), held here against the JAX formula
evaluated op by op on the CPU for every composition.  JAX's jitted
`encode_tile` rounds that float32 formula differently where XLA fuses it
into the sliding min, so the two packages may pick different k-mers where
two scores lie within one quantization step; the port is held bitwise to
an oracle of its own definition and to JAX up to such near-ties.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.hashes import wang_hash_np as jax_wang_hash_np
from dashing_tpu.ops import encode as jenc
from dashing_tpu.ops import rolling as jroll
from dashing_tpu_torch import hashes, pipeline
from dashing_tpu_torch.ops import encode as tenc
from dashing_tpu_torch.ops import rolling as troll

torch.set_num_threads(1)


def _u64(hilo) -> np.ndarray:
    hi, lo = (np.asarray(x).astype(np.uint64) for x in hilo)
    return (hi << np.uint64(32)) | lo


def _tile(rng, R=8, C=400, bad=0.04):
    """ACGT in both cases, an N run, scattered N and IUPAC bytes (a
    fraction `bad` of all bytes)."""
    tile = rng.choice(np.frombuffer(b"ACGTacgtNR", np.uint8), size=(R, C),
                      p=[(0.92 - bad) / 4] * 4 + [0.02] * 4 + [bad / 2] * 2)
    tile[0, 30:75] = ord("N")
    return tile


def _assert_same(jout, tout):
    """Equal validity, bitwise equal values at valid lanes."""
    jk, jv = _u64(jout[0]), np.asarray(jout[1])
    tk, tv = tout[0].numpy().view(np.uint64), tout[1].numpy()
    assert tk.shape == jk.shape and jv.any()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tk[jv], jk[jv])


def _shape(k, w, spacing):
    sp = tenc.Spacer(k, w, tenc.parse_spacing(spacing, k))
    return sp, dict(k=k, w=sp.w, positions=tuple(sp.positions), span=sp.c)


def test_wang_hash_np_and_rotl(rng):
    x = rng.integers(0, 2 ** 64, 4096, dtype=np.uint64)
    x[:3] = [0, 2 ** 64 - 1, 2 ** 63]
    np.testing.assert_array_equal(hashes.wang_hash_np(x), jax_wang_hash_np(x))
    t = torch.from_numpy(x.view(np.int64))
    for n in (0, 1, 5, 31, 63, 64, 70, 127):
        m = n % 64
        want = x if m == 0 else ((x << np.uint64(m))
                                 | (x >> np.uint64(64 - m)))
        np.testing.assert_array_equal(
            hashes.rotl(t, n).numpy().view(np.uint64), want)


@pytest.mark.parametrize("kind", ["nthash", "cyclic"])
@pytest.mark.parametrize("k", [1, 33, 70])
def test_rolling_tables_match_jax(kind, k):
    np.testing.assert_array_equal(troll.NT_SEEDS, jroll.NT_SEEDS)
    np.testing.assert_array_equal(troll.CYCLIC_SEEDS, jroll.CYCLIC_SEEDS)
    for got, want in zip(troll._tables(k, kind), jroll._tables(k, kind)):
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("k,w,spacing,canon", [
    (21, 0, "", True),          # contiguous k-mers, no window
    (21, 0, "", False),
    (21, 0, "1x4", True),       # spaced seed: span 25
    (9, 0, "2,0,3", False),     # asymmetric seed, canonicalization off
    (9, 0, "2,0,3", True),      # rc of the packed value, not the rc strand
    (21, 40, "", True),         # minimizer windows of 20 k-mers
    (21, 40, "", False),
    (32, 48, "", False),        # k = 32: all-T aliases the sentinel
    (15, 30, "1x3", True),      # spaced seed with a window
])
def test_encode_tile_matches_jax(rng, k, w, spacing, canon):
    tile = _tile(rng)
    _, kw = _shape(k, w, spacing)
    want = jenc.encode_tile(jnp.asarray(tile), canon=canon, **kw)
    got = tenc.encode_tile(torch.from_numpy(tile), canon=canon, **kw)
    _assert_same(want, got)


@pytest.mark.parametrize("k,w,spacing,canon", [
    (5, 0, "", True), (11, 0, "1,0,2", True), (11, 0, "1,0,2", False),
    (7, 16, "", True), (6, 14, "0,2", False),
])
def test_encode_tile_matches_oracle(rng, k, w, spacing, canon):
    """One record per row: the valid outputs in order equal encode_oracle."""
    sp, kw = _shape(k, w, spacing)
    tile = _tile(rng, R=3, C=250, bad=0.02)
    km, valid = tenc.encode_tile(torch.from_numpy(tile), canon=canon, **kw)
    for r in range(tile.shape[0]):
        want = tenc.encode_oracle(tile[r].tobytes(), sp, canon)
        got = km[r][valid[r]].numpy().view(np.uint64)
        assert want.size > 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            want, jenc.encode_oracle(tile[r].tobytes(), jenc.Spacer(
                k, w, jenc.parse_spacing(spacing, k)), canon))


@pytest.mark.parametrize("k", range(1, 33))
def test_entropy_table_matches_jax_formula(k):
    """Every composition's score equals the JAX package's float32 formula
    (ops/encode.py:303-312 of the JAX package) evaluated by jnp on the
    CPU."""
    n = np.arange(k + 1)
    a, c, g = np.meshgrid(n, n, n, indexing="ij")
    t = k - a - c - g
    ok = t >= 0
    counts = [x[ok].astype(np.float32) for x in (a, c, g, t)]
    ent = jnp.zeros(counts[0].shape, jnp.float32)
    for b in range(4):
        pr = jnp.asarray(counts[b]) / float(k)
        ent = ent - jnp.where(pr > 0, pr * jnp.log2(jnp.maximum(pr, 1e-9)),
                              0.0)
    want = np.asarray(jnp.minimum((ent * (2.0 ** 18)).astype(jnp.uint32),
                                  (1 << 20) - 1))
    table = tenc.entropy_table(k).reshape(k + 1, k + 1, k + 1)
    np.testing.assert_array_equal(table[ok], want.astype(np.int64))
    assert (table[~ok] == 0).all()


def _entropy_oracle(tile, sp, canon):
    """Per row and window: the value of the lowest-scored valid k-mer
    (leftmost on ties), None where the window holds an invalid k-mer."""
    km, valid = tenc.encode_tile(torch.from_numpy(tile), k=sp.k, w=sp.c,
                                 positions=tuple(sp.positions), span=sp.c,
                                 canon=canon)
    km, valid = km.numpy().view(np.uint64), valid.numpy()
    lut = tenc._CODE_LUT[tile].astype(np.int64)
    lut[lut == 255] = 0
    W = km.shape[1]
    cnt = [sum((lut[:, p:p + W] == b) for p in sp.positions) for b in range(3)]
    k1 = sp.k + 1
    score = tenc.entropy_table(sp.k)[(cnt[0] * k1 + cnt[1]) * k1 + cnt[2]]
    win = sp.w - sp.c + 1
    out = np.zeros((tile.shape[0], W - win + 1), np.uint64)
    ok = np.zeros(out.shape, bool)
    for r in range(tile.shape[0]):
        for i in range(out.shape[1]):
            if valid[r, i:i + win].all():
                j = i + int(np.argmin(score[r, i:i + win]))
                out[r, i], ok[r, i] = km[r, j], True
    return out, ok, km, score


@pytest.mark.parametrize("k,w,spacing,canon", [
    (31, 50, "", True), (21, 40, "", False), (15, 30, "1x3", True),
])
def test_entropy_minimizers(rng, k, w, spacing, canon):
    sp, kw = _shape(k, w, spacing)
    tile = _tile(rng, R=8, C=900, bad=0.01)
    got, gvalid = tenc.encode_tile(torch.from_numpy(tile), canon=canon,
                                   entropy=True, **kw)
    got, gvalid = got.numpy().view(np.uint64), gvalid.numpy()
    want, ok, km, score = _entropy_oracle(tile, sp, canon)
    np.testing.assert_array_equal(gvalid, ok)
    np.testing.assert_array_equal(got[ok], want[ok])
    # against JAX: same validity; any other pick is a near-tie (its score
    # within one quantization step of the window's lowest)
    (jh, jl), jvalid = jenc.encode_tile(jnp.asarray(tile), canon=canon,
                                        entropy=True, **kw)
    jk = _u64((jh, jl))
    np.testing.assert_array_equal(np.asarray(jvalid), ok)
    win = sp.w - sp.c + 1
    diff = np.argwhere((jk != got) & ok)
    assert len(diff) <= 1e-3 * ok.sum() + 2, (len(diff), ok.sum())
    for r, i in diff:
        s = score[r, i:i + win]
        picks = np.flatnonzero(km[r, i:i + win] == jk[r, i])
        assert picks.size and s[picks].min() <= s.min() + 1, (r, i)


@pytest.mark.parametrize("kind,k,canon,w", [
    ("nthash", 21, True, 0), ("nthash", 40, True, 60),
    ("nthash", 64, False, 0), ("nthash", 70, True, 0),
    ("cyclic", 21, False, 30), ("cyclic", 40, True, 0),
    ("cyclic", 64, True, 80), ("cyclic", 70, False, 0),
])
def test_rolling_hash_matches_jax_and_oracle(rng, kind, k, canon, w):
    tile = _tile(rng, R=4, C=330, bad=0.002)
    want = jroll.rolling_hash_tile(jnp.asarray(tile), k=k, kind=kind,
                                   canon=canon, w=w)
    got = troll.rolling_hash_tile(torch.from_numpy(tile), k=k, kind=kind,
                                  canon=canon, w=w)
    _assert_same(want, got)
    h, valid = got
    for r in (0, 1):
        seq = tile[r].tobytes()
        oracle = troll.rolling_hash_oracle(seq, k, kind, canon, w)
        np.testing.assert_array_equal(
            h[r][valid[r]].numpy().view(np.uint64), oracle)
        np.testing.assert_array_equal(
            oracle, jroll.rolling_hash_oracle(seq, k, kind, canon, w))


def test_sliding_min_is_unsigned(rng):
    x = rng.integers(0, 2 ** 64, (3, 50), dtype=np.uint64)
    x[:, ::7] = 2 ** 64 - 1                   # the sentinel
    t = torch.from_numpy(x.view(np.int64))
    for win in range(1, 12):
        got = tenc.sliding_min(t, win).numpy().view(np.uint64)
        want = np.stack([x[:, i:i + win].min(axis=1)
                         for i in range(50 - win + 1)], axis=1)
        np.testing.assert_array_equal(got, want)
    v = torch.from_numpy(rng.random((2, 40)) > 0.1)
    for win in (1, 3, 9):
        want = np.stack([v.numpy()[:, i:i + win].all(axis=1)
                         for i in range(40 - win + 1)], axis=1)
        np.testing.assert_array_equal(
            tenc.full_window_valid(v, win).numpy(), want)


@pytest.mark.parametrize("params,p,packed", [
    (dict(k=31), 14, True),
    (dict(k=31), 31, True),                  # K1 covers p <= 31
    (dict(k=31), 1, False),
    (dict(k=21, canon=False), 10, True),
    (dict(k=21, spacing="1x4"), 10, False),
    (dict(k=21, w=40), 10, False),
    (dict(k=21, entropy=True), 10, False),
    (dict(k=21, rehash=False), 10, False),
    (dict(k=40, encoding="nthash"), 10, False),
    (dict(k=31, encoding="cyclic"), 10, False),
])
def test_route_choice(params, p, packed):
    sp_params = pipeline.SketchParams(**params)
    sp = pipeline.check_supported(sp_params)
    assert pipeline.packed_ok(sp_params, sp, p) is packed


def test_check_supported_refuses_bad_shapes():
    with pytest.raises(ValueError):
        pipeline.check_supported(pipeline.SketchParams(k=33))
    with pytest.raises(ValueError):
        pipeline.check_supported(pipeline.SketchParams(
            k=21, spacing="1x2", encoding="nthash"))
    with pytest.raises(ValueError):
        pipeline.check_supported(pipeline.SketchParams(encoding="rk2"))


def test_entropy_without_window_equals_packed_route(rng):
    """Entropy scoring without a window picks every k-mer: the ASCII route
    (encode_tile with entropy, WangHash, register max) gives the packed
    route's registers for the same tiles."""
    tiles = [_tile(rng), _tile(rng)]
    dev = torch.device("cpu")
    got = pipeline.sketch_chunk_stream(
        tiles, pipeline.SketchParams(k=21, entropy=True), 10, dev, False)
    want = pipeline.sketch_chunk_stream(
        tiles, pipeline.SketchParams(k=21), 10, dev, True)
    assert int((want > 0).sum()) > 0
    assert torch.equal(got, want)
