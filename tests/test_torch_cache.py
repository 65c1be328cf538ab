"""The sketch cache and the sketch engine around it on the CPU: `dist -W`
cache files named and filled as the JAX CLI's, `sketch -c` skipping cached
files, the joined-bytes cache, the device rows mkdist parks, and the
bounded window of jobs in flight (pipeline.sketch_hll_files)."""
import gzip
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py keeps JAX on the CPU)

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import core
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat

torch.set_num_threads(1)
K, S = 17, 11


def _fasta(path, rng, n, anc=None, rate=0.0):
    """n bases in two records: random, or the first n of `anc` with
    substitutions at `rate`."""
    codes = rng.integers(0, 4, n) if anc is None else anc[:n].copy()
    hit = np.flatnonzero(rng.random(n) < rate)
    codes[hit] = (codes[hit] + 1) & 3
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    half = n // 2
    path.write_bytes(b">a x\n" + seq[:half].tobytes() + b"\n>b\n"
                     + seq[half:].tobytes() + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four small FASTAs and one of two row chunks (a multi-chunk file),
    all copies of one ancestor (no pair near-disjoint: there the two
    packages' estimates part by rounding)."""
    rng = np.random.default_rng(0xCAC)
    root = tmp_path_factory.mktemp("cache")
    n_big = pipeline.MAX_ROWS * pipeline.CONTENT + 5000
    anc = rng.integers(0, 4, n_big)
    out = [_fasta(root / f"f{i}.fa", rng, int(rng.integers(6000, 9000)),
                  anc, 0.005 * i) for i in range(4)]
    out.append(_fasta(root / "big.fa", rng, n_big, anc, 0.01))
    return out


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")


def _members(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def test_cache_files_match_jax_cli(files, tmp_path, cpu_env):
    """dist -W -P: the same cache file names as the JAX CLI's, the same
    sketch bytes inside (the gzip headers carry a time), and the same
    matrix; a second port run loads every sketch and writes the same
    matrix bytes."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["dist", "-k", str(K), "-S", str(S), "-M", "-b", "-W"]
    mats = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        out = str(tmp_path / f"{tag}.bin")
        assert fn(args + ["-P", str(tmp_path / tag), "-O", out] + files) == 0
        mats[tag] = out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for nm in names:
        assert (_members(tmp_path / "port" / nm)
                == _members(tmp_path / "jax" / nm)), nm
    np.testing.assert_allclose(distmat.read_binary(mats["port"])[1],
                               distmat.read_binary(mats["jax"])[1],
                               rtol=1e-4, atol=1e-6)
    # the second run: every sketch from the cache, no sketching at all
    again = str(tmp_path / "again.bin")
    calls = []
    orig = pipeline.sketch_hll_files
    pipeline.sketch_hll_files = lambda todo, *a, **kw: (
        calls.append(len(todo)) or orig(todo, *a, **kw))
    try:
        assert tmain.main(args + ["-P", str(tmp_path / "port"), "-O", again]
                          + files) == 0
    finally:
        pipeline.sketch_hll_files = orig
    assert calls == [0]
    assert open(again, "rb").read() == open(mats["port"], "rb").read()


def test_sketch_skip_cached(files, tmp_path, cpu_env, monkeypatch):
    """sketch -c leaves an existing sketch file alone and sketches the
    rest; with -o it reads the cached one into the stream, as the JAX
    CLI does."""
    monkeypatch.chdir(tmp_path)
    base = ["sketch", "-k", str(K), "-S", str(S), "-P", "p"]
    os.mkdir("p")
    assert tmain.main(base + files[:2]) == 0
    cached = sorted(os.listdir("p"))
    stamps = [os.stat(os.path.join("p", n)).st_mtime_ns for n in cached]
    seen = []
    orig = core.device_hll_run
    monkeypatch.setattr(core, "device_hll_run", lambda todo, *a, **kw: (
        seen.append([i for i, _ in todo]) or orig(todo, *a, **kw)))
    assert tmain.main(base + ["-c", "--avoid-sorting"] + files[:3]) == 0
    assert seen == [[2]]
    assert [os.stat(os.path.join("p", n)).st_mtime_ns
            for n in cached] == stamps
    assert len(os.listdir("p")) == 3
    outs = []
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        out = f"{tag}.stream"
        assert fn(base + ["-c", "--avoid-sorting", "-o", out]
                  + files[:3]) == 0
        outs.append(_members(out))
    assert outs[0] == outs[1]


def test_join_cache(files, monkeypatch):
    """On, a path's join is read once, at the widest separator, shared
    read-only and dropped when the file changes; off, nothing is kept."""
    reads = []
    real = pipeline._read_joined_uncached
    monkeypatch.setattr(pipeline, "_read_joined_uncached",
                        lambda path, sep: reads.append(sep)
                        or real(path, sep))
    pipeline.set_join_cache(True)
    try:
        a = pipeline._read_joined(files[0], 20)
        b = pipeline._read_joined(files[0], 30)
        assert a is b and not a.flags.writeable
        assert reads == [pipeline._CACHE_SEP]
        np.testing.assert_array_equal(
            a[a != 0], real(files[0], 20)[real(files[0], 20) != 0])
        os.utime(files[0], ns=(1, 1))               # a rewritten file
        pipeline._read_joined(files[0], 20)
        assert reads == [pipeline._CACHE_SEP] * 2
        monkeypatch.setenv("DASHING_TPU_JOIN_CACHE_MB", "0.000001")
        pipeline._read_joined(files[1], 20)
        assert files[1] not in pipeline._join_cache
        assert not pipeline.should_stream(files[1])
    finally:
        pipeline.set_join_cache(False)
    assert not pipeline._join_cache
    # the same registers through the cache as without it
    params = pipeline.SketchParams(k=K)
    plain = pipeline.sketch_file_hll(files[2], params, S, "cpu")
    pipeline.set_join_cache(True)
    try:
        cached = pipeline.sketch_file_hll(files[2], params, S, "cpu")
    finally:
        pipeline.set_join_cache(False)
    np.testing.assert_array_equal(cached, plain)


def test_device_rows(monkeypatch):
    rows = [torch.full((1 << 10,), i, dtype=torch.int8) for i in range(3)]
    monkeypatch.setenv("DASHING_TPU_DEVICE_BANK_MB", "0.0025")  # two rows
    try:
        for i, r in enumerate(rows):
            pipeline.device_rows_put(f"f{i}", r)
        assert pipeline.device_rows_get("f1") is rows[1]
        assert pipeline.device_rows_get("f2") is None
    finally:
        pipeline.device_rows_clear()
    assert pipeline.device_rows_get("f0") is None


def test_compare_stacks_parked_rows(files, cpu_env):
    """Sketches that carry device rows are stacked, not uploaded: the
    compare is the same bit for bit."""
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    opts = core.CommonOpts(k=K, sketch_size=S)
    cpu = torch.device("cpu")
    sk = core.sketch_paths(files[:4], opts, cpu)
    want = pw.all_pairs_condensed(sk, pw.MASH_DIST, K, est.ERTL_MLE,
                                  est.ERTL_MLE, cpu)
    regs = pw._stack_regs(sk)
    for s in sk:
        s.dev_regs = torch.from_numpy(np.minimum(s.regs, 127)
                                      .astype(np.int8))
    assert torch.equal(pw._device_regs_for(sk, regs, cpu),
                       pw._device_regs(regs, cpu))
    got = pw.all_pairs_condensed(sk, pw.MASH_DIST, K, est.ERTL_MLE,
                                 est.ERTL_MLE, cpu)
    np.testing.assert_array_equal(got, want)


def test_window_and_batches(tmp_path, monkeypatch):
    """70 single-chunk files at p = 12: two launches (64 files, then 6),
    and the first job is pulled only after the second is queued (more
    than window_cap = 64 files in flight, strictly); a multi-chunk file
    and an empty one go alone; every file's registers equal its sketch
    alone."""
    rng = np.random.default_rng(7)
    paths = [_fasta(tmp_path / f"s{i}.fa", rng, 400) for i in range(70)]
    (tmp_path / "empty.fa").write_bytes(b">e\n\n")
    paths.insert(3, str(tmp_path / "empty.fa"))
    paths.insert(40, _fasta(tmp_path / "two.fa", rng,
                            pipeline.MAX_ROWS * pipeline.CONTENT + 100))
    events = []
    batch = pipeline.sketch_small_batch_async
    monkeypatch.setattr(pipeline, "sketch_small_batch_async",
                        lambda chunks, *a, **kw: events.append(
                            ("batch", len(chunks))) or batch(chunks, *a, **kw))
    pull = pipeline.registers_to_numpy
    monkeypatch.setattr(pipeline, "registers_to_numpy",
                        lambda r: events.append(("pull", r.dim()))
                        or pull(r))
    opts = core.CommonOpts(k=15, sketch_size=12)
    got = {}
    core.device_hll_run(list(enumerate(paths)), opts, got.__setitem__,
                        torch.device("cpu"))
    assert sorted(got) == list(range(72))
    # 39 files, flush at the multi-chunk file, which folds alone; 31 more
    assert events == [("batch", 39), ("batch", 31), ("pull", 2),
                      ("pull", 1), ("pull", 2)]
    assert not got[3].any()
    params = pipeline.SketchParams(k=15)
    for i in (0, 39, 40, 71):
        np.testing.assert_array_equal(
            got[i], pipeline.sketch_file_hll(paths[i], params, 12, "cpu"))
