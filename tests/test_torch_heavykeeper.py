"""The HeavyKeeper count filter (DASHING_TPU_USE_HK=1) of the port against
the JAX package on the CPU.

The class: its native form (dashing_tpu_torch/native/hk.cpp) and its
pure-Python form equal to each other and to the JAX class on the same
key streams (`add_np`, then `query_np`), the clamp and fallback notes
word for word.  The filter: HeavyKeeper's state depends on the order of
insertion, so the filtered registers are held bitwise to the JAX
package's on a multi-record FASTA, a FASTQ and a streamed file (the
port's STREAM_THRESHOLD patched to 0 and 2-row windows; the JAX
package's DASHING_TPU_STREAM=1), with the hash cache between the passes
empty, two tiles or unbounded; through the CLI (`sketch -b -n 2`, `dist
-y`), a set sketch (`-8 -y`) and the exact hash sets (`-y`)."""
import gzip
import os

import numpy as np
import pytest
import torch

from dashing_tpu import pipeline as jpipe
from dashing_tpu.cli import main as jmain
from dashing_tpu.io import native as jnative
from dashing_tpu.sketch.heavykeeper import HeavyKeeper as JHeavyKeeper
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import native as tnative
from dashing_tpu_torch.sketch.heavykeeper import HeavyKeeper

torch.set_num_threads(1)
CPU = torch.device("cpu")
LUT = np.frombuffer(b"ACGT", np.uint8)


def _keys(seed, n, distinct):
    """A skewed key stream: a few heavy keys among many light ones, the
    top bit set on some."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 64, distinct, dtype=np.uint64,
                        endpoint=False)
    return pool[np.minimum(rng.zipf(1.3, n) - 1, distinct - 1)], pool


@pytest.mark.parametrize("nrows,size_log2,seed", [
    (1, 3, 1337), (4, 6, 0), (3, 8, 2 ** 64 - 1), (6, 5, 99)])
def test_forms_equal_jax(nrows, size_log2, seed):
    """Two add batches then one query: the port's native and Python forms
    and the JAX package's, equal; small tables, so the decay (and its
    draws from the xorshift stream) runs often."""
    stream, pool = _keys(nrows * 10 + size_log2, 4000, 600)
    forms = [HeavyKeeper(nrows, size_log2, seed),
             HeavyKeeper(nrows, size_log2, seed, force_python=True),
             JHeavyKeeper(nrows, size_log2, seed)]
    assert forms[0].native and not forms[1].native and forms[2].native
    for hk in forms:
        hk.add_np(stream[:1500])
        hk.add_np(stream[1500:])
        hk.add_np(np.zeros(0, np.uint64))
    got = [hk.query_np(pool) for hk in forms]
    assert got[0].dtype == np.uint32 and got[0].max() > 50
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_array_equal(got[1], got[2])
    assert forms[0].query_np(np.zeros(0, np.uint64)).size == 0


@pytest.mark.parametrize("geometry", [(0, 0), (100, 3), (-5, 5), (1, 0)])
def test_notes_word_for_word(capfd, monkeypatch, geometry):
    """The clamp note, and without a native library the fallback note,
    as the JAX class prints them; the clamped geometry equal.  (A clamp
    to the 2^27-slot bound is left out: its table takes 1 GiB.)"""
    capfd.readouterr()
    t = HeavyKeeper(*geometry)
    got = capfd.readouterr().err
    j = JHeavyKeeper(*geometry)
    assert got == capfd.readouterr().err
    assert got.startswith("note: HeavyKeeper geometry clamped to nrows=")
    assert (t.nrows, t.size_log2) == (j.nrows, j.size_log2)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    t = HeavyKeeper(2, 4)
    got = capfd.readouterr().err
    JHeavyKeeper(2, 4)
    assert got == capfd.readouterr().err and "pure-Python fallback" in got
    assert not t.native


def _rand_seq(rng, n):
    return LUT[rng.integers(0, 4, n)].tobytes()


def _fasta(rng, path):
    """Records with a repeated block (a threshold of 2 keeps part of
    them), a run of N, a lowercase record; gzipped."""
    rep = _rand_seq(rng, 2000)
    recs = [rep + _rand_seq(rng, 12000), _rand_seq(rng, 9000) + rep,
            (rep + _rand_seq(rng, 4000)).lower(), _rand_seq(rng, 10000)]
    recs[3] = recs[3][:500] + b"N" * 80 + recs[3][580:]
    body = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(recs))
    path.write_bytes(gzip.compress(body))


def _fastq(rng, path, reads=1200, glen=15000, err=0.005):
    """100-base reads of one genome at 8x, half reverse-complemented, with
    substitution errors."""
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


# small tables, so HeavyKeeper evicts (its counts then depend on order)
FILTERED = {
    "fasta": dict(k=21, use_counting_filter=True, min_count=2,
                  cm_size_log2=13, cm_nhashes=3, cm_seed=7),
    "fastq": dict(k=31, use_counting_filter=True, min_count=3,
                  cm_size_log2=12, cm_nhashes=2),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0x4B)
    root = tmp_path_factory.mktemp("hk")
    out = {}
    for fmt in FILTERED:
        path = root / ("g.fa.gz" if fmt == "fasta" else "reads.fq")
        (_fasta if fmt == "fasta" else _fastq)(rng, path)
        out[fmt] = str(path)
    return out


@pytest.mark.parametrize("fmt", sorted(FILTERED))
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("budget", ["none", "some", "all"])
def test_hk_registers_equal_jax(files, monkeypatch, fmt, streamed, budget):
    """Filtered registers bitwise equal to JAX `sketch_file_hll` under
    DASHING_TPU_USE_HK=1 (whole or streamed in each package), and unlike
    the count-min's at these small tables; the admitted raw k-mers equal
    in order."""
    path, kw = files[fmt], FILTERED[fmt]
    monkeypatch.setenv("DASHING_TPU_USE_HK", "1")
    if streamed:
        monkeypatch.setenv("DASHING_TPU_STREAM", "1")
        monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
        monkeypatch.setattr(pipeline, "MAX_ROWS", 2)
    sp = pipeline.SketchParams(**kw).spacer()
    tiles = list(pipeline.InputFile(0, path, sp).tiles())
    assert len(tiles) >= (3 if streamed else 1)
    cost = {"none": 0, "some": 2 * tiles[0].size * 9, "all": 1 << 62}
    monkeypatch.setattr(pipeline, "_CM_HASH_CACHE_BYTES", cost[budget])
    want = jpipe.sketch_file_hll(path, jpipe.SketchParams(**kw), 12)
    got = pipeline.sketch_file_hll(path, pipeline.SketchParams(**kw), 12,
                                   CPU)
    np.testing.assert_array_equal(got, want)
    plain = pipeline.sketch_file_hll(path, pipeline.SketchParams(k=kw["k"]),
                                     12, CPU)
    assert (got <= plain).all() and 0 < got.sum() < plain.sum()
    if budget == "some":
        np.testing.assert_array_equal(
            pipeline.file_raw_kmers(path, pipeline.SketchParams(**kw), CPU),
            jpipe.file_raw_kmers(path, jpipe.SketchParams(**kw)))
        monkeypatch.delenv("DASHING_TPU_USE_HK")
        cm = pipeline.sketch_file_hll(path, pipeline.SketchParams(**kw), 12,
                                      CPU)
        assert not np.array_equal(cm, got)


@pytest.fixture()
def cli_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DASHING_TPU_USE_HK", "1")
    monkeypatch.chdir(tmp_path)


def _unzip(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("stype", ["hll", "bbmh", "khset"])
def test_hk_cli_matches_jax(files, cli_env, monkeypatch, stype, streamed):
    """`sketch -b -n 2 -q 13 -H 3` streams (HLL, `-8`, the exact hash
    sets) equal to the JAX CLI's once decompressed, and `dist -y -c 2`'s
    matrix and sizes (`-W` cache files equal too)."""
    if streamed:
        monkeypatch.setenv("DASHING_TPU_STREAM", "1")
        monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
        monkeypatch.setattr(pipeline, "MAX_ROWS", 2)
    inputs = [files["fasta"], files["fastq"]]
    flag = {"hll": [], "bbmh": ["-8"], "khset": ["--use-full-khash-sets"]}
    base = ["-k", "21", "-S", "12"] + flag[stype]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["sketch"] + base + ["-b", "-n", "2", "-q", "13", "-H",
                                       "3", "-o", f"{who}.sk"] + inputs) == 0
        os.mkdir(f"c_{who}")
        assert fn(["dist"] + base + ["-y", "-c", "2", "-t", "13", "-W",
                                     "-P", f"c_{who}", "-O", f"{who}.d",
                                     "-o", f"{who}.s"] + inputs) == 0
    assert _unzip("port.sk") == _unzip("jax.sk")
    assert open("port.d").read() == open("jax.d").read()
    assert open("port.s").read() == open("jax.s").read()
    names = sorted(os.listdir("c_jax"))
    assert names == sorted(os.listdir("c_port")) and len(names) == 2
    for nm in names:
        assert _unzip(f"c_port/{nm}") == _unzip(f"c_jax/{nm}")
