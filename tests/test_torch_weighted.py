"""Weighted Jaccard on HLL (`--wj`, `--wj-exact`) in the port against the
JAX package, on the CPU: the labelled elements of the host functions and
of the device labelling bitwise (as multisets), sketch files of `sketch
--wj-exact` and `--wj` record for record, `dist --wj-exact -M` at rtol
1e-4, the -W cache names, the device route's registers equal to the host
route's, and the flags' parse (test_torch_weighted_types.py holds every
other sketch type to the JAX CLI)."""
import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dashing_tpu import u64
from dashing_tpu.cli import main as jmain
from dashing_tpu.io import distmat
from dashing_tpu.sketch import weighted as jw
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import core
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.sketch import weighted as tw
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

K, S = 15, 10


def _stream(rng, n=6000):
    """A k-mer stream with multiplicities 1-40, values across the whole
    64-bit range (the top bit set on some), and -1 (all ones) among them."""
    vals = rng.integers(0, 2 ** 64 - 1, 300, dtype=np.uint64)
    vals[:3] = [0, np.uint64(2 ** 64 - 1), np.uint64(2 ** 63)]
    return rng.choice(vals, n, p=rng.dirichlet(np.ones(300)))


def test_host_labels_equal_jax(rng):
    kmers = _stream(rng)
    np.testing.assert_array_equal(tw.occurrence_expand(kmers),
                                  jw.occurrence_expand(kmers))
    np.testing.assert_array_equal(tw.occurrence_expand(kmers, 3),
                                  jw.occurrence_expand(kmers, 3))
    for size, nh, seed in ((22, 10, 1337), (8, 3, 0), (12, 1, 5)):
        got = tw.cm_estimated_counts(kmers, size, nh, seed)
        want = jw.cm_estimated_counts(kmers, size, nh, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for exact in (True, False):
        np.testing.assert_array_equal(
            tw.weighted_elements(kmers, exact, 10, 4, 7),
            jw.weighted_elements(kmers, exact, 10, 4, 7))
    assert tw.occurrence_expand(np.zeros(0, np.uint64)).size == 0


def test_device_labels_equal_jax(rng):
    """occurrence_labels_device (int64, sorted by signed value) against
    the JAX package's device form (u64 pairs, sorted by unsigned value)
    and the host form: the same valid labels as multisets; invalid lanes
    masked, all-ones values among the valid ones."""
    kmers = _stream(rng, 3000).reshape(30, 100)
    valid = rng.random(kmers.shape) < 0.8
    h = torch.from_numpy(kmers.view(np.int64).copy())
    lab, sv = tw.occurrence_labels_device(h, torch.from_numpy(valid))
    assert lab.shape == sv.shape == (3000,) and int(sv.sum()) == valid.sum()
    got = np.sort(lab[sv].numpy().view(np.uint64))
    jlab, jsv = jw.occurrence_labels_device(u64.from_np(kmers),
                                            jnp.asarray(valid))
    want = np.sort(u64.to_np(jlab)[np.asarray(jsv)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  np.sort(jw.occurrence_expand(kmers[valid])))
    empty, esv = tw.occurrence_labels_device(h, torch.zeros_like(
        torch.from_numpy(valid)))
    assert not esv.any() and empty.shape == (3000,)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Three FASTQ read sets of one 4 kbp genome at different depths (so
    multiplicities differ), one with N runs, one gzipped."""
    rng = np.random.default_rng(0xDA5)
    root = tmp_path_factory.mktemp("wj")
    lut = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 4000)
    paths = []
    for i, n in enumerate((300, 500, 800)):
        recs = []
        for r in range(n):
            s = int(rng.integers(0, g.size - 80))
            seq = lut[g[s:s + 80]].copy()
            if i == 1 and r % 50 == 0:
                seq[30:40] = ord("N")
            recs.append(b"@r%d\n%s\n+\n%s\n" % (r, seq.tobytes(), b"I" * 80))
        body = b"".join(recs)
        path = root / (f"s{i}.fq.gz" if i == 2 else f"s{i}.fq")
        path.write_bytes(gzip.compress(body) if i == 2 else body)
        paths.append(str(path))
    return paths


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")


def _records(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("flags", [["--wj-exact"], ["--wj"],
                                   ["--wj", "--wj-cm-sketch-size", "12",
                                    "--wj-cm-nhashes", "3"],
                                   ["--wj-exact", "-b", "-n", "2"]])
def test_sketch_files_equal_jax(reads, tmp_path, cpu_env, flags):
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.makedirs(tmp_path / tag)
        assert fn(["sketch", "-k", str(K), "-S", str(S), "-P",
                   str(tmp_path / tag) + "/"] + flags + reads) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    assert all(n.endswith(f".spacing.{S}.hll") for n in names)
    for nm in names:
        assert _records(tmp_path / "port" / nm) == \
            _records(tmp_path / "jax" / nm), nm


def test_dist_wj_exact_equals_jax(reads, tmp_path, cpu_env):
    mats = {}
    for flag in ("--wj-exact", "--wj"):
        for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
            out = str(tmp_path / f"{tag}{flag}.bin")
            assert fn(["dist", "-k", str(K), "-S", str(S), flag, "-M", "-b",
                       "-O", out] + reads) == 0
            mats[tag, flag] = distmat.read_binary(out)
        (nj, mj), (nt, mt) = mats["jax", flag], mats["port", flag]
        assert nj == nt == 3 and np.isfinite(mt).all()
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-7)
    # the weights change the answer: depth differs, the sets do not
    assert not np.allclose(mats["port", "--wj-exact"][1], 0.0)


def test_wj_cache_names_and_reuse(reads, tmp_path, cpu_env, monkeypatch):
    """-W writes `.wj.exact.hll` / `.wj.hll` beside the inputs, with the
    JAX CLI's names and registers; a second run loads them."""
    o = core.CommonOpts(k=K, sketch_size=S, exact_weighted=True,
                        prefix=str(tmp_path))
    assert core._cache_fname(reads[0], o).endswith(
        f".w.{K}.spacing.{S}.wj.exact.hll")
    assert core._cache_fname(reads[0], o, wj_ext=False).endswith(
        f".spacing.{S}.hll")
    o.exact_weighted, o.weighted_jaccard = False, True
    assert core._cache_fname(reads[0], o).endswith(".wj.hll")
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.makedirs(tmp_path / tag)
        assert fn(["dist", "-k", str(K), "-S", str(S), "--wj-exact", "-W",
                   "-P", str(tmp_path / tag), "-O",
                   str(tmp_path / f"{tag}.tsv")] + reads) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3
    assert all(n.endswith(".wj.exact.hll") for n in names)
    for nm in names:
        assert _records(tmp_path / "port" / nm) == \
            _records(tmp_path / "jax" / nm)
    # the second run reads the cache: no file is sketched
    monkeypatch.setattr(core, "weighted_registers", None)
    assert tmain.main(["dist", "-k", str(K), "-S", str(S), "--wj-exact",
                       "-W", "-P", str(tmp_path / "port"), "-O",
                       str(tmp_path / "again.tsv")] + reads) == 0
    assert (tmp_path / "again.tsv").read_text() == \
        (tmp_path / "port.tsv").read_text()


def test_device_route_equals_host_route(reads, monkeypatch):
    """sketch_file_wj_hll (the labelling on the device) equals the host
    route bitwise; past the memory bound it declines (None) before any
    launch, and a count-min filtered file always takes the host route."""
    cpu = torch.device("cpu")
    params = pipeline.SketchParams(k=K)
    o = core.CommonOpts(k=K, sketch_size=S, exact_weighted=True)
    host = {}
    for path in reads:
        dev = pipeline.sketch_file_wj_hll(path, params, S, cpu)
        raw = pipeline.file_raw_kmers(path, params, cpu)
        h = HLL(S)
        h.add_np(tw.weighted_elements(raw, exact=True))
        host[path] = h.regs
        np.testing.assert_array_equal(dev, h.regs)
        assert dev.any()
        np.testing.assert_array_equal(
            core.weighted_registers(path, None, o, params, cpu), h.regs)
    assert pipeline.wj_device_fits(10 ** 12, cpu)
    filt = pipeline.SketchParams(k=K, use_counting_filter=True, min_count=2)
    assert pipeline.sketch_file_wj_hll(reads[0], filt, S, cpu) is None
    monkeypatch.setattr(pipeline, "wj_device_fits", lambda n, d: False)
    assert pipeline.sketch_file_wj_hll(reads[0], params, S, cpu) is None
    np.testing.assert_array_equal(
        core.weighted_registers(reads[0], None, o, params, cpu),
        host[reads[0]])


def test_weighted_refusals(reads, tmp_path, cpu_env):
    """--wj parses; the weighted sketches of the other families, refused
    until they were ported, run (a finite matrix of the two files); and
    mkdist leaves weighted sketches to its per-k passes."""
    o = core.CommonOpts()
    for flag, val in (("--wj", ""), ("--wj-exact", ""),
                      ("--wj-cm-sketch-size", "16"),
                      ("--wj-cm-nhashes", "4")):
        assert core.parse_common(o, flag, val)
    assert o.weighted and o.exact_weighted and o.wj_cmsize == 16 \
        and o.wj_nhashes == 4
    for extra in (["--use-full-khash-sets"], ["--use-bb-minhash"], ["-8"],
                  ["--use-range-minhash"]):
        out = str(tmp_path / "w.out")
        assert tmain.main(["dist", "-k", str(K), "--wj", "-b", "-O", out]
                          + extra + reads[:2]) == 0
        n, mat = distmat.read_binary(out)
        assert n == 2 and mat.shape == (1,) and 0 < mat[0] <= 1
    assert tmain._mkdist_presketch(["-k", "15", "--wj-exact"] + reads,
                                   [15, 17], torch.device("cpu")) == \
        (None, None)
