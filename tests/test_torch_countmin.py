"""Count-min filtered sketching in the port against the JAX package on the
CPU: the count-min arithmetic (ops/countmin.py `indices`, and
`pipeline._cm_add`, `_cm_query`) exactly equal, the admitted k-mer set
equal, and filtered registers bitwise equal to JAX `sketch_file_hll` for FASTA and FASTQ, whole and
streamed, with every tile's hashes cached between the passes, none, or
some.  The count-min kernels' side on the CPU: their routing rule
(`countmin.takes`), their plain versions over whole tiles against the
JAX chain, their range checks, and their route's glue
(`_count_filtered_kernels`) on CPU tensors, one card or three, with
pass 1's tiles kept for pass 2 or not.  Also the
streamed files' read-ahead thread and no CPU fallback
(test_torch_heavykeeper.py holds the HeavyKeeper swap).  The card-only
checks (the filtered path on `cuda` against `cpu`, tables of 2^28
counters) carry the `cuda` marker and skip without a card;
tests/test_torch_cuda_kernels.py holds the kernels to their plain
versions on the card."""
import gzip
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashing_tpu import pipeline as jpipe
from dashing_tpu import u64
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import countmin
from dashing_tpu_torch.cli import main as tmain

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = (1337, 0, -1)
LUT = np.frombuffer(b"ACGT", np.uint8)


def _hashes(rng, n):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)


@pytest.mark.parametrize("size_log2", [1, 12, 20, 32])
def test_cm_indices_equal_jax(size_log2):
    """Every row's counter index, for nh 1 to 8 and seeds 1337, 0, -1
    (rows from 2 on take a constant above 2^32; seed -1 one at or above
    2^63).  At size_log2 = 32 the JAX index is an int32 that wraps: its
    uint32 pattern is the port's index."""
    h = _hashes(np.random.default_rng(size_log2), 3000)
    th = torch.from_numpy(h.view(np.int64))
    for seed in SEEDS:
        want = np.asarray(jpipe._cm_indices(u64.from_np(h), 8, size_log2,
                                            seed)).astype(np.int64)
        if size_log2 == 32:
            want &= 0xFFFFFFFF
        for nh in range(1, 9):
            got = countmin.indices(th, nh, size_log2, seed).numpy()
            assert got.shape == (nh, h.size)
            np.testing.assert_array_equal(got, want[:nh], err_msg=str(
                (nh, seed)))
            assert got.min() >= 0 and got.max() < (1 << size_log2)


@pytest.mark.parametrize("nh,size_log2,seed", [
    (1, 1, 1337), (4, 12, 0), (8, 20, -1), (3, 16, 1337)])
def test_cm_add_query_equal_jax(nh, size_log2, seed):
    """Counts after two batches (a quarter of the lanes invalid, repeated
    hashes) and the queried minimum over the rows, exactly equal."""
    rng = np.random.default_rng(nh * 100 + size_log2)
    pool = _hashes(rng, 500)
    counts_j = np.zeros((nh, 1 << size_log2), np.int32)
    counts_t = torch.zeros((nh, 1 << size_log2), dtype=torch.int32)
    for _ in range(2):
        h = pool[rng.integers(0, pool.size, (6, 700))]
        valid = rng.random(h.shape) > 0.25
        counts_j = np.asarray(jpipe._cm_add(
            counts_j, u64.from_np(h), valid, nh, size_log2, seed))
        pipeline._cm_add(counts_t, torch.from_numpy(h.view(np.int64)),
                         torch.from_numpy(valid), nh, size_log2, seed)
        np.testing.assert_array_equal(counts_t.numpy(), counts_j)
    q = pool[rng.integers(0, pool.size, (3, 400))]
    want = np.asarray(jpipe._cm_query(counts_j, u64.from_np(q), nh,
                                      size_log2, seed))
    got = pipeline._cm_query(counts_t, torch.from_numpy(q.view(np.int64)),
                             nh, size_log2, seed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want.max() >= 2


@pytest.mark.parametrize("size_log2", [0, 33, -1])
def test_cm_size_out_of_range(size_log2):
    h = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="size_log2"):
        countmin.indices(h, 2, size_log2, 1337)
    params = pipeline.SketchParams(k=5, use_counting_filter=True,
                                   min_count=2, cm_size_log2=size_log2)
    tile = np.frombuffer(b"ACGTACGTACGTACGT", np.uint8)[None]
    with pytest.raises(ValueError, match="size_log2"):
        next(pipeline._count_filtered_tiles(lambda: iter([tile]), params,
                                            params.spacer(), CPU))


def _rand_seq(rng, n):
    return LUT[rng.integers(0, 4, n)].tobytes()


def test_admitted_set_equal_jax(tmp_path):
    """The repeated-region fixture of the JAX package's count-filter test
    (tests/test_io_pipeline.py test_count_filter): the filtered raw k-mers
    equal JAX's as multisets, every repeated k-mer is kept and the
    unique region's are (nearly all) dropped."""
    rng = np.random.default_rng(0xDA5)
    core, uniq = _rand_seq(rng, 400), _rand_seq(rng, 400)
    path = tmp_path / "g.fa"
    path.write_bytes(b">c\n" + core * 3 + uniq + b"\n")
    kw = dict(k=21, min_count=2, use_counting_filter=True)
    want = np.sort(jpipe.file_raw_kmers(str(path), jpipe.SketchParams(**kw)))
    got = np.sort(pipeline.file_raw_kmers(str(path),
                                          pipeline.SketchParams(**kw), CPU))
    np.testing.assert_array_equal(got, want)
    plain = pipeline.file_raw_kmers(str(path), pipeline.SketchParams(k=21),
                                    CPU)
    # the windows inside the three copies of the core, in file order
    assert np.isin(plain[:len(core) * 3 - 20], got).all()
    assert np.unique(got).size < np.unique(plain).size
    # the hashed form filters the same windows
    hashed = pipeline.file_kmer_hashes(str(path), pipeline.SketchParams(**kw),
                                       CPU)
    np.testing.assert_array_equal(
        np.sort(hashed), np.sort(jpipe.file_kmer_hashes(
            str(path), jpipe.SketchParams(**kw))))


def _fasta(rng, path):
    """Several records with repeats (so a threshold of 2 admits part of
    them), N runs, a lowercase record; gzipped."""
    rep = _rand_seq(rng, 3000)
    recs = [rep + _rand_seq(rng, 30000), _rand_seq(rng, 20000) + rep,
            (rep + _rand_seq(rng, 8000)).lower(), _rand_seq(rng, 25000)]
    recs[3] = recs[3][:500] + b"N" * 80 + recs[3][580:]
    body = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(recs))
    path.write_bytes(gzip.compress(body))


def _fastq(rng, path, reads=1500, glen=20000, err=0.005):
    """Reads of 100 bases from one genome at ~7x, half reverse-complemented,
    with substitution errors: the error k-mers are what the filter drops."""
    g = rng.integers(0, 4, glen).astype(np.uint8)
    starts = rng.integers(0, glen - 100, reads)
    codes = g[starts[:, None] + np.arange(100)]
    flip = rng.random(reads) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    hit = rng.random(codes.shape) < err
    codes[hit] = (codes[hit] + rng.integers(1, 4, hit.sum())) & 3
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, LUT[c].tobytes(),
                                                      b"I" * 100)
                              for i, c in enumerate(codes)))


# (file format, SketchParams of both packages, p)
FILTERED = {
    "fasta": (dict(k=21, use_counting_filter=True, min_count=2,
                   cm_size_log2=14, cm_nhashes=3, cm_seed=-1), 12),
    "fastq": (dict(k=31, use_counting_filter=True, min_count=3), 12),
}


@pytest.fixture(scope="module")
def filtered_files(tmp_path_factory):
    """Each format's file and the JAX package's filtered and plain
    registers for it."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("cm")
    out = {}
    for fmt, (kw, p) in FILTERED.items():
        path = root / ("g.fa.gz" if fmt == "fasta" else "reads.fq")
        (_fasta if fmt == "fasta" else _fastq)(rng, path)
        jp = jpipe.SketchParams(**kw)
        out[fmt] = (str(path), jpipe.sketch_file_hll(str(path), jp, p),
                    jpipe.sketch_file_hll(
                        str(path), jpipe.SketchParams(k=kw["k"]), p))
    return out


@pytest.mark.parametrize("fmt", sorted(FILTERED))
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("budget", ["none", "some", "all"])
def test_filtered_registers_equal_jax(filtered_files, monkeypatch, fmt,
                                      streamed, budget):
    """Bitwise equal to JAX `sketch_file_hll`.  Streamed: the threshold at
    0 and 4-row windows, so the file runs through the read-ahead thread in
    several tiles; the hash-cache budget at 0 (pass 2 hashes every tile
    again), two tiles' worth, or unbounded."""
    path, want, plain = filtered_files[fmt]
    kw, p = FILTERED[fmt]
    if streamed:
        monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
        monkeypatch.setattr(pipeline, "MAX_ROWS", 4)
    sp = pipeline.SketchParams(**kw).spacer()
    tiles = list(pipeline.InputFile(0, path, sp).tiles())
    assert len(tiles) >= (3 if streamed else 1)
    cost = {"none": 0, "some": 2 * tiles[0].size * 9, "all": 1 << 62}
    monkeypatch.setattr(pipeline, "_CM_HASH_CACHE_BYTES", cost[budget])
    got = pipeline.sketch_file_hll(path, pipeline.SketchParams(**kw), p, CPU)
    np.testing.assert_array_equal(got, want)
    assert (got <= plain).all() and got.sum() < plain.sum()


@pytest.mark.parametrize("fmt", sorted(FILTERED))
@pytest.mark.parametrize("cards", [1, 3])
@pytest.mark.parametrize("budget", ["none", "some", "all"])
def test_kernel_route_equal_jax(filtered_files, monkeypatch, fmt, cards,
                                budget):
    """The count-min kernels' route (`_count_filtered_kernels`) on CPU
    tensors, where each pass runs the wrappers' plain versions, gives JAX
    `sketch_file_hll`'s registers, streamed in 4-row tiles on one card
    or in 1-row tiles round-robin over three (so that two tiles a card
    keep some but not all), with each card's keep budget at 0, two
    tiles' bytes, or unbounded.  Pass 1 uploads each tile once; pass 2
    uploads only the tiles not kept (`cm_rehashed_tiles`), and calls
    `tiles()` again only where some tile was not kept."""
    path, want, _ = filtered_files[fmt]
    kw, p = FILTERED[fmt]
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 4 if cards == 1 else 1)
    params = pipeline.SketchParams(**kw)
    sp = pipeline.check_supported(params)
    assert countmin.takes(p, **pipeline._encode_kw(params, sp))
    src = pipeline.InputFile(0, path, sp)
    tiles = list(src.tiles())
    assert len(tiles) >= 3 * cards and tiles[-1].nbytes <= tiles[0].nbytes
    cost = {"none": 0, "some": 2 * tiles[0].nbytes, "all": 1 << 62}
    monkeypatch.setattr(pipeline, "_CM_KEEP_BYTES", cost[budget])
    kept = {"none": 0, "all": len(tiles),
            "some": sum(min(2, len(tiles[c::cards])) for c in range(cards))
            }[budget]
    calls = []

    def counted():
        calls.append(1)
        return src.tiles()

    t0, r0 = pipeline.cm_tiles, pipeline.cm_rehashed_tiles
    u0 = pipeline.chunk_uploads
    regs = pipeline._count_filtered_kernels(counted, params, sp, p,
                                            (CPU,) * cards)
    np.testing.assert_array_equal(pipeline.registers_to_numpy(regs), want)
    assert pipeline.cm_tiles - t0 == len(tiles)
    assert 0 < kept < len(tiles) or budget != "some"
    assert pipeline.cm_rehashed_tiles - r0 == len(tiles) - kept
    assert pipeline.chunk_uploads - u0 == len(tiles) + len(tiles) - kept
    assert len(calls) == (1 if kept == len(tiles) else 2)


def test_filter_threshold_one_is_plain(filtered_files):
    """A threshold of 1 admits every k-mer: the plain registers."""
    path, _, plain = filtered_files["fastq"]
    got = pipeline.sketch_file_hll(
        path, pipeline.SketchParams(k=31, use_counting_filter=True,
                                    min_count=1), 12, CPU)
    np.testing.assert_array_equal(got, plain)


def _readahead_threads():
    return [t for t in threading.enumerate() if t.name == "dtt-readahead"]


def _wait_gone(deadline_s=5.0):
    t0 = time.time()
    while _readahead_threads() and time.time() - t0 < deadline_s:
        time.sleep(0.01)
    return not _readahead_threads()


def test_readahead_delivers_producer_exception():
    def gen():
        yield 1
        yield 2
        raise OSError("truncated gzip member")

    got = []
    with pytest.raises(OSError, match="truncated"):
        for item in pipeline._readahead(gen()):
            got.append(item)
    assert got == [1, 2]
    assert _wait_gone()


def test_readahead_early_exit_stops_producer():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = pipeline._readahead(endless(), depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert _wait_gone() and closed.wait(5.0)
    assert list(pipeline._readahead(iter(range(7)))) == list(range(7))


def test_no_cpu_fallback(filtered_files, tmp_path, monkeypatch):
    """Without a card, asking for cuda raises at every new entry point
    that touches the device; the file tools never create a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = filtered_files["fastq"][0]
    params = pipeline.SketchParams(k=31, use_counting_filter=True,
                                   min_count=2)
    for fn in (lambda: pipeline.sketch_file_hll(path, params, 12, "cuda"),
               lambda: pipeline.file_kmer_hashes(path, params, "cuda"),
               lambda: pipeline.file_raw_kmers(path, params, "cuda")):
        with pytest.raises(RuntimeError, match="is_available"):
            fn()
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cuda")
    for argv in (["sketch", "-b", "-n", "2", "-P", str(tmp_path)],
                 ["sketch", "-f", "-n", "2", "-P", str(tmp_path)],
                 ["dist", "-y", "-c", "2"], ["hll"], ["card"], ["cardcmp"]):
        with pytest.raises(SystemExit, match="is_available"):
            tmain.main(argv + ["-k", "31", "-S", "12", path])
    assert not list(tmp_path.iterdir())
    # the host tools run with cuda asked for and no card
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    sk = str(tmp_path / "s.hll")
    assert tmain.main(["sketch", "-k", "31", "-S", "12", "-o", sk, path]) == 0
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cuda")
    assert tmain.main(["union", "-o", str(tmp_path / "u.hll"), sk, sk]) == 0
    assert tmain.main(["fold", "-p", "10", "-o", str(tmp_path / "f.hll"),
                       str(tmp_path / "u.hll")]) == 0
    assert tmain.main(["view", "--header", str(tmp_path / "f.hll")]) == 0


# encoder arguments, and whether the count-min kernels take them at p = 16
TAKES = [
    (dict(k=31), True),                      # the read-set cell's
    (dict(k=21, canon=False), True),
    (dict(k=1), True),
    (dict(k=32), True),
    (dict(k=31, spacing="1x4"), False),      # -s
    (dict(k=31, w=50, entropy=True), False), # -g
    (dict(k=31, w=50), False),               # -w > k
    (dict(k=31, encoding="nthash"), False),
    (dict(k=31, encoding="cyclic"), False),
    (dict(k=31, rehash=False), False),
]


@pytest.mark.parametrize("kw,taken", TAKES)
def test_countmin_takes(kw, taken):
    """The routing rule takes exact contiguous k-mers with WangHash and no
    window, whatever the filter's geometry, and nothing else."""
    params = pipeline.SketchParams(use_counting_filter=True, min_count=2,
                                   cm_size_log2=28, **kw)
    ekw = pipeline._encode_kw(params, pipeline.check_supported(params))
    assert countmin.takes(16, **ekw) is taken
    for p in (1, 31):
        assert countmin.takes(p, **ekw) is taken
    for p in (0, 32):
        assert not countmin.takes(p, **ekw)


def _reads_tiles(rng, n, rows, C, k):
    """n (rows, C) uint8 tiles cut from one stream of 100-base reads of a
    3,000-base genome (so k-mers repeat), half lowercase, joined by k - 1
    zero bytes, with N runs and bytes >= 0x80."""
    genome = rng.integers(0, 4, 3000)
    out = []
    for _ in range(n):
        reads = []
        while sum(map(len, reads)) < rows * C:
            s = int(rng.integers(0, 2900))
            r = LUT[genome[s:s + 100]].tobytes()
            reads.append(r.lower() if rng.random() < 0.5 else r)
        flat = np.frombuffer((b"\x00" * (k - 1)).join(reads), np.uint8)
        tile = flat[:rows * C].copy().reshape(rows, C)
        tile[rng.random(tile.shape) < 2e-3] = ord("N")
        tile[rng.random(tile.shape) < 1e-3] = 0xC1
        out.append(tile)
    return out


@pytest.mark.parametrize("k,canon,nh,size_log2,seed,min_count,p", [
    (31, True, 4, 12, 1337, 2, 12),
    (21, False, 3, 10, -1, 3, 10),
    (1, True, 1, 1, 0, 2, 4),
    (32, True, 5, 14, 1337, 2, 16),
])
def test_plain_passes_equal_jax(rng, k, canon, nh, size_log2, seed,
                                min_count, p):
    """The plain versions of both passes over three tiles: the table after
    pass 1 equals the JAX package's `_tile_to_hashes` and `_cm_add`, and
    the registers after pass 2 its `_cm_query` >= min_count and register
    fold."""
    from dashing_tpu.ops.hll_update import update_registers as j_update
    tiles = _reads_tiles(rng, 3, 6, 700, k)
    params = jpipe.SketchParams(k=k, canon=canon)
    jkw = jpipe._encode_kw(params, params.spacer())
    hashed = [jpipe._tile_to_hashes(jnp.asarray(t), **jkw) for t in tiles]
    counts_j = jnp.zeros((nh, 1 << size_log2), jnp.int32)
    for h, valid in hashed:
        counts_j = jpipe._cm_add(counts_j, h, valid, nh, size_log2, seed)
    regs_j = jnp.zeros(1 << p, jnp.int32)
    for h, valid in hashed:
        est = jpipe._cm_query(counts_j, h, nh, size_log2, seed)
        regs_j = j_update(regs_j, h, valid & (est >= min_count), p)
    cm = dict(k=k, canon=canon, nh=nh, size_log2=size_log2, seed=seed)
    counts = torch.zeros((nh, 1 << size_log2), dtype=torch.int32)
    for t in tiles:
        countmin.ascii_cm_add(torch.from_numpy(t), counts, **cm)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    regs = torch.zeros(1 << p, dtype=torch.int32)
    for t in tiles:
        countmin.ascii_cm_admit(torch.from_numpy(t), counts, regs,
                                min_count=min_count, p=p, **cm)
    np.testing.assert_array_equal(regs.numpy(), np.asarray(regs_j))
    assert int(np.asarray(regs_j).astype(bool).sum()) > 0


def test_plain_passes_narrow_tile():
    """A tile narrower than k has no window: both passes leave their
    outputs as they are."""
    tile = torch.full((3, 20), ord("A"), dtype=torch.uint8)
    counts = torch.zeros((2, 1 << 8), dtype=torch.int32)
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    cm = dict(k=21, nh=2, size_log2=8, seed=1337)
    countmin.ascii_cm_add(tile, counts, **cm)
    countmin.ascii_cm_admit(tile, counts, regs, min_count=1, p=10, **cm)
    assert not counts.any() and not regs.any()


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=33), dict(nh=0), dict(size_log2=0),
    dict(size_log2=33), dict(p=0), dict(p=32)])
def test_wrappers_reject_out_of_range(bad):
    """Both wrappers raise outside the kernels' range, on the CPU too (the
    range is checked before the shapes)."""
    kw = dict(k=21, nh=2, size_log2=8, seed=1337, p=10)
    kw.update(bad)
    p = kw.pop("p")
    tile = torch.full((2, 40), ord("A"), dtype=torch.uint8)
    counts = torch.zeros((2, 1 << 8), dtype=torch.int32)
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        countmin.ascii_cm_admit(tile, counts, regs, min_count=2, p=p, **kw)
    if "p" not in bad:
        with pytest.raises(ValueError):
            countmin.ascii_cm_add(tile, counts, **kw)
    assert not counts.any() and not regs.any()


def test_cpu_filter_keeps_the_pair_route(filtered_files, monkeypatch):
    """On the CPU a filter the kernels would take still runs the pair
    generator (hashes cached between the passes, `_cm_query` and the
    register fold called through the pipeline module) and launches
    nothing."""
    path = filtered_files["fastq"][0]
    seen = []
    real = pipeline._cm_query
    monkeypatch.setattr(pipeline, "_cm_query",
                        lambda *a: seen.append(1) or real(*a))
    before = countmin.add_launches, countmin.admit_launches
    params = pipeline.SketchParams(k=31, use_counting_filter=True,
                                   min_count=3)
    got = pipeline.sketch_file_hll(path, params, 12, CPU)
    np.testing.assert_array_equal(got, filtered_files["fastq"][1])
    assert seen and (countmin.add_launches,
                     countmin.admit_launches) == before


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size_log2", [20, 28])
def test_filtered_cuda_equals_cpu(filtered_files, monkeypatch, cuda,
                                  size_log2):
    """The filtered path on the card, at the 256-row chunk size of the
    streamed route, bitwise equal to the CPU run; 2^28 counters a row is
    the geometry of the smoke run's config 3 (4 GiB of counts)."""
    path = filtered_files["fastq"][0]
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    params = pipeline.SketchParams(k=31, use_counting_filter=True,
                                   min_count=2, cm_size_log2=size_log2)
    want = pipeline.sketch_file_hll(path, params, 14, CPU)
    got = pipeline.sketch_file_hll(path, params, 14, cuda)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.sort(pipeline.file_raw_kmers(path, params, cuda)),
        np.sort(pipeline.file_raw_kmers(path, params, CPU)))


@pytest.mark.cuda
@pytest.mark.parametrize("nh,size_log2,seed", [(4, 28, 1337), (8, 20, -1),
                                               (1, 32, 0)])
def test_cm_ops_cuda_equal_cpu(cuda, nh, size_log2, seed):
    """The count-min's indices, counts and queries on the card equal the
    CPU's, at 2^28 counters a row and on a 256 x 8222 tile's worth of
    hashes (indices alone at 2^32, whose table would be 16 GiB a row)."""
    rng = np.random.default_rng(size_log2)
    h = torch.from_numpy(_hashes(rng, 256 * 8192).view(np.int64))
    h[::3] = h[1::3][:h[::3].numel()]                    # repeats
    valid = torch.from_numpy(rng.random(h.numel()) > 0.1)
    idx = countmin.indices(h, nh, size_log2, seed)
    np.testing.assert_array_equal(
        countmin.indices(h.to(cuda), nh, size_log2, seed).cpu().numpy(),
        idx.numpy())
    if size_log2 > 28:
        return
    counts = torch.zeros((nh, 1 << size_log2), dtype=torch.int32)
    counts_d = counts.to(cuda)
    pipeline._cm_add(counts, h, valid, nh, size_log2, seed)
    pipeline._cm_add(counts_d, h.to(cuda), valid.to(cuda), nh, size_log2,
                     seed)
    assert torch.equal(counts_d.cpu(), counts)
    assert torch.equal(
        pipeline._cm_query(counts_d, h.to(cuda), nh, size_log2, seed).cpu(),
        pipeline._cm_query(counts, h, nh, size_log2, seed))
