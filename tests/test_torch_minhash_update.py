"""The set sketches' device routes on CPU tensors: the b-bit MinHash
scatter-min and the bottom-k merge (dashing_tpu_torch/ops/minhash_update.py)
bitwise equal to their plain numpy versions (np.minimum.at, np.union1d)
on hashes with the top bit set, zero, the all-ones EMPTY value, heavy
duplication and invalid lanes, p = 4..20 (p = 26, past the JAX route's
refusal, runs on the card in test_torch_cuda_kernels.py); and
`sketch_file_bbmh_mins` / `sketch_file_bottomk_values` bitwise equal to
the JAX package's on the same FASTA and to the host `addh_np` route, the
b-bit sketch's est_cardinality_ included."""
import dataclasses

import numpy as np
import pytest
import torch

from dashing_tpu import pipeline as jpl
from dashing_tpu.sketch.setsketches import BBitMinHash as JBBitMinHash
from dashing_tpu.sketch.setsketches import BottomK as JBottomK
from dashing_tpu_torch import pipeline as tpl
from dashing_tpu_torch.ops import minhash_update as mu
from dashing_tpu_torch.sketch.setsketches import BBitMinHash, BottomK

torch.set_num_threads(1)
CPU = torch.device("cpu")
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _hashes(rng, n):
    """uint64 hashes: uniform, a block with the top bit set, zero, all
    ones, and 1 << 63."""
    h = rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True)
    h[: n // 4] |= np.uint64(1 << 63)
    h[5] = 0
    h[6] = ALL_ONES
    h[7] = np.uint64(1 << 63)
    return h


def _t(h):
    return torch.from_numpy(h.view(np.int64).copy())


def _run_bbmh(tiles, p):
    bank = mu.empty_bank(p, CPU)
    want = np.full(1 << p, ALL_ONES, np.uint64)
    for h, valid in tiles:
        mu.bbmh_update(bank, _t(h), torch.from_numpy(valid), p)
        mu.bbmh_update_np(want, h, valid, p)
    return mu.to_numpy(bank), want


def _run_bottomk(tiles, kk):
    run = mu.empty_values(CPU)
    want = np.zeros(0, np.uint64)
    for h, valid in tiles:
        run = mu.bottomk_update(run, _t(h), torch.from_numpy(valid), kk)
        want = mu.bottomk_update_np(want, h, valid, kk)
    return mu.to_numpy(run), want


@pytest.mark.parametrize("p", [4, 8, 12, 15, 20])
def test_scatter_min_equals_plain(p):
    """Three tiles of (rows, width) hashes with a third of the lanes
    invalid; the plain version is what BBitMinHash.add_np inserts."""
    rng = np.random.default_rng(p)
    tiles = []
    for _ in range(3):
        h = _hashes(rng, 64 * 512).reshape(64, 512)
        valid = rng.random(h.shape) > 0.33
        valid[0, :8] = True
        tiles.append((h, valid))
    got, want = _run_bbmh(tiles, p)
    np.testing.assert_array_equal(got, want)
    sk = BBitMinHash(p)
    for h, valid in tiles:
        sk.add_np(h[valid])
    np.testing.assert_array_equal(got, sk.mins)
    assert (got == ALL_ONES).any() == (p >= 15)     # some buckets empty


@pytest.mark.parametrize("kk", [1, 7, 128, 5000])
def test_bottomk_equals_plain(kk):
    rng = np.random.default_rng(kk)
    tiles = []
    for _ in range(3):
        h = _hashes(rng, 32 * 256).reshape(32, 256)
        valid = rng.random(h.shape) > 0.25
        valid[0, 5:8] = True          # zero, all ones and 1 << 63 count
        tiles.append((h, valid))
    got, want = _run_bottomk(tiles, kk)
    np.testing.assert_array_equal(got, want)
    assert got.size == min(kk, np.unique(np.concatenate(
        [h[v] for h, v in tiles])).size)
    sk = BottomK(kk)
    for h, valid in tiles:
        sk.add_np(h[valid])
    np.testing.assert_array_equal(got, sk.values)


def test_all_ones_hash_is_kept():
    """A genuine all-ones hash (the JAX device route's padding value,
    which that route drops) is a bottom-k value here, as on the host
    route; in the b-bit bank its value h << p (low p bits zero) is not
    EMPTY, on both routes."""
    h = np.array([ALL_ONES, 3, ALL_ONES], np.uint64)[None]
    valid = np.array([[True, False, True]])
    got, want = _run_bottomk([(h, valid)], 4)
    assert got.tolist() == want.tolist() == [int(ALL_ONES)]
    got, want = _run_bbmh([(h, valid)], 6)
    np.testing.assert_array_equal(got, want)
    assert got[63] == ALL_ONES << np.uint64(6)


def test_every_kmer_repeated_1000_times():
    """Each of 300 distinct hashes 1,000 times over the tiles (the input
    the JAX candidate route needs its coverage fallback for): the
    per-tile deduplication keeps the bottom-k exact."""
    rng = np.random.default_rng(11)
    distinct = _hashes(rng, 300)
    reps = rng.permutation(np.repeat(distinct, 1000))
    tiles = [(t.reshape(100, -1), np.ones((100, t.size // 100), bool))
             for t in np.split(reps, 3)]
    for kk in (64, 300, 1000):
        got, want = _run_bottomk(tiles, kk)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.unique(distinct)[:kk])
    got, want = _run_bbmh(tiles, 10)
    np.testing.assert_array_equal(got, want)


def _rand_fasta(tmp_path, rng, n=4000, name="dev.fa"):
    fa = tmp_path / name
    bases = rng.choice(list("ACGTACGTN"), size=n)     # with Ns
    fa.write_text(">a\n" + "".join(bases[:n // 2]) + "\n>b\n"
                  + "".join(bases[n // 2:]) + "\n")
    return str(fa)


@pytest.mark.parametrize("enc,w", [("bonsai", 0), ("bonsai", 31),
                                   ("nthash", 0)])
def test_file_bbmh_mins_equal_jax(tmp_path, enc, w):
    """The port's device route against the JAX package's device route
    and against the host route (file_raw_kmers, addh_np), est_cardinality_
    included (tests/test_extra_sketches.py's witness, p = 8 and 14)."""
    path = _rand_fasta(tmp_path, np.random.default_rng(5))
    k = 17 if enc == "bonsai" else 33
    for p in (8, 14):
        jmins = jpl.sketch_file_bbmh_mins(path, jpl.SketchParams(
            k=k, w=w, encoding=enc), p)
        params = tpl.SketchParams(k=k, w=w, encoding=enc)
        mins = tpl.sketch_file_bbmh_mins(path, params, p, CPU)
        np.testing.assert_array_equal(mins, jmins)
        host = BBitMinHash(p=p, b=16)
        host.addh_np(tpl.file_raw_kmers(path, params, CPU))
        np.testing.assert_array_equal(mins, host.mins)
        dev, jdev = BBitMinHash(p=p, mins=mins), JBBitMinHash(p=p, mins=jmins)
        for sk in (dev, jdev, host):
            sk.finalize()
        assert dev.est_cardinality_ == host.est_cardinality_ \
            == jdev.est_cardinality_


@pytest.mark.parametrize("kk", [16, 128, 4096])
def test_file_bottomk_values_equal_jax(tmp_path, kk):
    path = _rand_fasta(tmp_path, np.random.default_rng(6), n=6000)
    jvals = jpl.sketch_file_bottomk_values(path, jpl.SketchParams(k=21), kk)
    params = tpl.SketchParams(k=21)
    vals = tpl.sketch_file_bottomk_values(path, params, kk, CPU)
    np.testing.assert_array_equal(vals, jvals)
    host = BottomK(kk)
    host.addh_np(tpl.file_raw_kmers(path, params, CPU))
    host.finalize()
    np.testing.assert_array_equal(vals, host.values)
    jhost = JBottomK(kk)
    jhost.addh_np(jpl.file_raw_kmers(path, jpl.SketchParams(k=21)))
    jhost.finalize()
    np.testing.assert_array_equal(vals, jhost.values)


def test_routes_over_prefetched_tiles_and_filter(tmp_path):
    """A prefetched tile source gives the same bank; a count-min filtered
    file returns None (the caller's host route); an empty file gives an
    all-EMPTY bank and no values."""
    path = _rand_fasta(tmp_path, np.random.default_rng(8), n=3000)
    params = tpl.SketchParams(k=15)
    sp = params.spacer()
    tiles = lambda: tpl._joined_tiles(tpl._read_joined(path, sp.halo),  # noqa
                                      sp.halo)
    np.testing.assert_array_equal(
        tpl.sketch_file_bbmh_mins(path, params, 9, CPU, tiles),
        tpl.sketch_file_bbmh_mins(path, params, 9, CPU))
    np.testing.assert_array_equal(
        tpl.sketch_file_bottomk_values(path, params, 64, CPU, tiles),
        tpl.sketch_file_bottomk_values(path, params, 64, CPU))
    filt = dataclasses.replace(params, use_counting_filter=True, min_count=2)
    assert tpl.sketch_file_bbmh_mins(path, filt, 9, CPU) is None
    assert tpl.sketch_file_bottomk_values(path, filt, 64, CPU) is None
    empty = tmp_path / "empty.fa"
    empty.write_text(">e\nNNNN\n")
    assert (tpl.sketch_file_bbmh_mins(str(empty), params, 9, CPU)
            == ALL_ONES).all()
    assert tpl.sketch_file_bottomk_values(str(empty), params, 64,
                                          CPU).size == 0
