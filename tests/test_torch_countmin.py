"""Count-min filtered sketching in the port against the JAX package on the
CPU: the count-min arithmetic (`_cm_indices`, `_cm_add`, `_cm_query`)
exactly equal, the admitted k-mer set equal, and filtered registers
bitwise equal to JAX `sketch_file_hll` for FASTA and FASTQ, whole and
streamed, with every tile's hashes cached between the passes, none, or
some.  Also the streamed files' read-ahead thread and no CPU fallback
(test_torch_heavykeeper.py holds the HeavyKeeper swap).  The card-only
checks (the filtered path on `cuda` against `cpu`, tables of 2^28
counters) carry the `cuda` marker and skip without a card."""
import gzip
import threading
import time

import numpy as np
import pytest
import torch

from dashing_tpu import pipeline as jpipe
from dashing_tpu import u64
from dashing_tpu_torch import pipeline
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
            got = pipeline._cm_indices(th, nh, size_log2, seed).numpy()
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
        pipeline._cm_indices(h, 2, size_log2, 1337)
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
    idx = pipeline._cm_indices(h, nh, size_log2, seed)
    np.testing.assert_array_equal(
        pipeline._cm_indices(h.to(cuda), nh, size_log2, seed).cpu().numpy(),
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
