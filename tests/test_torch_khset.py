"""The exact k-mer hash sets (--use-full-khash-sets and its aliases, `.khs`
files) of the port against the JAX package on the CPU.

The class: keys bitwise (uint64 values with the top bit set, which an
int64 sort would order first), `write_record` bytes, the triples and
every measure exactly, the union and `+=`, a file with repeated keys.
The CLI: `sketch` files and `-o` streams equal once decompressed (a gzip
header carries a write time), `dist`/`cmp` matrices exactly (the
triples are integer counts; rtol 1e-6 for the float32 measure) under
JI, `-M`, containment and sizes, `-o` sizes byte for byte, `-Q`,
`--nearest-neighbors` ids exactly, `-W` twice, `-y`, `union -H`, `view`,
`view --header`, `sketch_by_seq` + `dist_by_seq -K` with and without
`-q`, and `mkdist` (per k: no fused presketch)."""
import gzip
import io
import os
import shutil

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu.sketch.khset import KSet as JKSet
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat
from dashing_tpu_torch.sketch.khset import KSet

torch.set_num_threads(1)

K = 21
LUT = np.frombuffer(b"ACGT", np.uint8)
ALIASES = ["--use-full-khash-sets", "--use-full-hash-sets",
           "--use-hash-sets", "--hash-sets", "--use-full-sets"]
MEASURES = {"ji": [], "mash": ["-M"], "sizes": ["-Z"],
            "containment_index": ["--containment-index"],
            "sym_containment_dist": ["--symmetric-containment-dist"]}


def _values(seed, n, top):
    """n uint64 values drawn from a pool of n // 2 (so half repeat), a
    share `top` of them at or above 2^63."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 63, max(n // 2, 1), dtype=np.uint64)
    hi = rng.random(pool.size) < top
    pool[hi] |= np.uint64(1 << 63)
    return pool[rng.integers(0, pool.size, n)]


@pytest.mark.parametrize("seed,n,top", [(1, 0, 0.0), (2, 1, 1.0),
                                        (3, 2000, 0.5), (4, 5000, 0.1)])
def test_kset_equal_jax(seed, n, top):
    a_vals, b_vals = _values(seed, n, top), _values(seed + 100, n, top)
    b_vals = np.concatenate([b_vals, a_vals[: n // 3]])   # overlap
    ta, tb = KSet.from_values(a_vals), KSet.from_values(b_vals)
    ja, jb = JKSet.from_values(a_vals), JKSet.from_values(b_vals)
    assert ta.keys.dtype == np.uint64
    np.testing.assert_array_equal(ta.keys, ja.keys)
    assert (np.diff(ta.keys.astype(np.float64)) > 0).all() or n < 2
    for t, j in ((ta, ja), (tb, jb)):
        tbuf, jbuf = io.BytesIO(), io.BytesIO()
        t.write_record(tbuf)
        j.write_record(jbuf)
        assert tbuf.getvalue() == jbuf.getvalue()
        back = KSet.read_record(io.BytesIO(jbuf.getvalue()))
        np.testing.assert_array_equal(back.keys, j.keys)
    assert ta.full_set_comparison(tb) == ja.full_set_comparison(jb)
    assert tb.full_set_comparison(ta) == jb.full_set_comparison(ja)
    for fn in ("jaccard_index", "containment_index", "union_size",
               "intersection_size"):
        assert getattr(ta, fn)(tb) == getattr(ja, fn)(jb), fn
    assert ta.report() == ja.report() == float(np.unique(a_vals).size)
    np.testing.assert_array_equal(ta.union(tb).keys, ja.union(jb).keys)
    ta += tb
    ja += jb
    np.testing.assert_array_equal(ta.keys, ja.keys)
    grow = KSet()
    grow.addh_np(b_vals)
    grow.finalize()
    np.testing.assert_array_equal(grow.keys, jb.keys)


def test_repeated_keys_give_ji_at_most_one():
    """A constructor or a file with repeated keys holds each key once:
    JI 0.5, not the 2.0 of an intersection assuming unique keys."""
    a = KSet(np.array([5, 5, 7], np.uint64))
    b = KSet(np.array([5], np.uint64))
    assert a.keys.size == 2 and a.jaccard_index(b) == 0.5
    raw = (np.uint64(4).tobytes()
           + np.array([9, 2, 9, 2], "<u8").tobytes())
    got = KSet.read_record(io.BytesIO(raw))
    want = JKSet.read_record(io.BytesIO(raw))
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.keys, np.array([2, 9], np.uint64))
    with pytest.raises(EOFError):
        KSet.read_record(io.BytesIO(raw[:20]))


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """4 FASTAs of 8-14 kbp from one ancestor at planted substitution
    rates, two records each, one gzipped, one with a run of N and a
    lowercase record; then a byte copy of genome 1."""
    rng = np.random.default_rng(0x4B5)
    root = tmp_path_factory.mktemp("khs")
    anc = rng.integers(0, 4, 14000, dtype=np.uint8)
    out = []
    for i, rate in enumerate((0.0, 0.01, 0.02, 0.04)):
        g = anc[:int(rng.integers(8000, 14000))].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
        seq = LUT[g].tobytes()
        if i == 3:
            seq = seq[:500] + b"N" * 200 + seq[700:]
        cut = len(seq) // 2
        body = b">g%d_a\n%s\n>g%d_b\n%s\n" % (
            i, seq[:cut], i, seq[cut:].lower() if i == 1 else seq[cut:])
        path = root / (f"g{i}.fa.gz" if i == 2 else f"g{i}.fa")
        path.write_bytes(gzip.compress(body) if i == 2 else body)
        out.append(str(path))
    copy = root / "copy_of_g1.fa"
    shutil.copyfile(out[1], copy)
    return out + [str(copy)]


@pytest.fixture()
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)


def _unzip(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def _mat(path, symmetric):
    raw = open(path, "rb").read()
    if symmetric:
        n = int.from_bytes(raw[1:9], "little")
        assert raw[0] == 0 and len(raw) == 9 + 2 * n * (n - 1)
        raw = raw[9:]
    return np.frombuffer(raw, "<f4")


def _both(args, tag=""):
    out = {}
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        d, s = f"{who}{tag}.out", f"{who}{tag}.sizes"
        assert fn(list(args) + ["-O", d, "-o", s]) == 0, who
        out[who] = d, s
    return out


def _exact(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sketch_files_equal_jax(genomes, cpu_env):
    """`sketch -P` files (named .khs), a `-o` stream with its labels, and
    a count-min filtered stream (`-b -n 2`) equal to the JAX CLI's; the
    keys are the distinct raw k-mers (k = 32 uses the top bit)."""
    flags = ["sketch", "-k", str(K), "--use-full-khash-sets"]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(who)
        assert fn(flags + ["-P", who] + genomes) == 0
        assert fn(flags + ["-o", f"{who}.stream"] + genomes) == 0
        assert fn(flags + ["-b", "-n", "2", "-o", f"{who}.filt"]
                  + genomes[:2]) == 0
        assert fn(["sketch", "-k", "32", "--use-full-khash-sets", "-o",
                   f"{who}.k32"] + genomes[:2]) == 0
    names = sorted(os.listdir("jax"))
    assert names == sorted(os.listdir("port")) and len(names) == 5
    assert all(nm.endswith(".khs") for nm in names)
    for nm in names:
        assert _unzip(f"port/{nm}") == _unzip(f"jax/{nm}"), nm
    for suffix in (".stream", ".stream.labels.gz", ".filt", ".k32"):
        assert _unzip("port" + suffix) == _unzip("jax" + suffix), suffix
    with gzip.open("port.k32", "rb") as fp:
        keys = KSet.read_record(fp).keys
    assert keys.size > 1000 and (keys >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("measure", sorted(MEASURES))
def test_dist_presketched_matches_jax(genomes, cpu_env, measure):
    """`dist -H -b` over `.khs` files under each measure (`cmp` for
    Mash), exact; the asymmetric one as query x reference rows."""
    sym = measure != "containment_index"
    os.mkdir("sk")
    assert tmain.main(["sketch", "-k", str(K), "--use-full-khash-sets",
                       "-P", "sk"] + genomes) == 0
    files = [os.path.join("sk", n) for n in sorted(os.listdir("sk"))]
    cmd = "cmp" if measure == "mash" else "dist"
    out = _both([cmd, "-k", str(K), "-H", "-b", "--use-full-khash-sets"]
                + MEASURES[measure] + files)
    got, want = (_mat(out[w][0], sym) for w in ("port", "jax"))
    _exact(got, want)
    assert open(out["port"][1]).read() == open(out["jax"][1]).read()


@pytest.mark.parametrize("alias", ALIASES)
def test_dist_from_fasta_matches_jax(genomes, cpu_env, alias):
    """`dist -b` sketching the FASTAs under each alias: the copy of genome
    1 at JI exactly 1, the matrix and `-o` sizes equal to the JAX CLI's;
    one alias also `-T` text, `-W` twice and `-y -c 2`."""
    base = ["dist", "-k", str(K), alias]
    out = _both(base + ["-b"] + genomes)
    got, want = (_mat(out[w][0], True) for w in ("port", "jax"))
    _exact(got, want)
    assert open(out["port"][1]).read() == open(out["jax"][1]).read()
    names = [ln.split("\t")[0] for ln in open(out["port"][1])][1:]
    i, j = sorted((names.index(genomes[1]), names.index(genomes[4])))
    n = len(names)
    assert got[i * (2 * n - i - 1) // 2 + j - i - 1] == 1.0
    if alias != ALIASES[0]:
        return
    text = _both(base + ["-T"] + genomes, ".T")
    assert open(text["port"][0]).read() == open(text["jax"][0]).read()
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(f"c_{who}")
        for run in (1, 2):
            assert fn(base + ["-b", "-W", "-P", f"c_{who}", "-O",
                              f"{who}.W{run}"] + genomes[:3]) == 0
    assert sorted(os.listdir("c_port")) == sorted(os.listdir("c_jax"))
    for nm in os.listdir("c_port"):
        assert nm.endswith(".khs")
        assert _unzip(f"c_port/{nm}") == _unzip(f"c_jax/{nm}")
    assert open("port.W1", "rb").read() == open("port.W2", "rb").read()
    _exact(_mat("port.W2", True), _mat("jax.W2", True))
    filt = _both(base + ["-b", "-y", "-c", "2"] + genomes[:3], ".y")
    _exact(*(_mat(filt[w][0], True) for w in ("port", "jax")))
    assert open(filt["port"][1]).read() == open(filt["jax"][1]).read()


def test_query_and_nearest_neighbors_match_jax(genomes, tmp_path, cpu_env):
    """`dist -Q` (TSV and binary with the .labels sidecar), the stream of
    `sketch -o` under `dist -H`, and `--nearest-neighbors 2` with and
    without -Q: ids and values equal, the copy finds genome 1 at JI 1."""
    q = tmp_path / "q.txt"
    q.write_text(genomes[4] + "\n" + genomes[3] + "\n")
    base = ["dist", "-k", str(K), "--avoid-sorting", "--use-full-khash-sets"]
    rect = _both(base + ["-Q", str(q)] + genomes[:4], ".Q")
    assert open(rect["port"][0]).read() == open(rect["jax"][0]).read()
    rows = [ln.split("\t") for ln in open(rect["port"][0]).read()
            .splitlines() if not ln.startswith("#")]
    assert float(rows[0][2]) == 1.0
    rb = _both(base + ["-Q", str(q), "-b", "--containment-index"]
               + genomes[:4], ".Qb")
    _exact(*(_mat(rb[w][0], False) for w in ("port", "jax")))
    assert (open(rb["port"][0] + ".labels").read()
            == open(rb["jax"][0] + ".labels").read())
    for extra in (genomes, ["-Q", str(q)] + genomes[:4]):
        nn = _both(base + ["--nearest-neighbors", "2"] + extra, ".nn")
        assert open(nn["port"][0]).read() == open(nn["jax"][0]).read()
    assert tmain.main(["sketch", "-k", str(K), "--use-full-khash-sets",
                       "-o", "all.khs"] + genomes) == 0
    st = _both(["dist", "-H", "-b", "--use-full-khash-sets", "all.khs"],
               ".H")
    _exact(*(_mat(st[w][0], True) for w in ("port", "jax")))


def test_union_view_card_match_jax(genomes, cpu_env, capsys):
    """`union -H` of three `.khs` files is the union of their keys, equal
    to the JAX CLI's; `view` and `view --header` byte for byte; `card`
    the key counts."""
    os.mkdir("sk")
    assert tmain.main(["sketch", "-k", str(K), "--use-full-khash-sets",
                       "-P", "sk"] + genomes[:3]) == 0
    files = [os.path.join("sk", n) for n in sorted(os.listdir("sk"))]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["union", "-H", "-o", f"{who}.u"] + files) == 0
    assert _unzip("port.u") == _unzip("jax.u")
    want = np.unique(np.concatenate([KSet.read(f).keys for f in files]))
    np.testing.assert_array_equal(KSet.read("port.u").keys, want)
    for argv in (["view"] + files[:2], ["view", "--header"] + files):
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0] and outs[1].count("\n") >= len(files) - 1
    outs = []
    for fn in (jmain.main, tmain.main):
        assert fn(["card", "-k", str(K), "--use-full-khash-sets"]
                  + genomes[:3]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[1].count("\n") == 4


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A FASTA of 12 records (pieces of two related sequences) and one of
    4 query records."""
    rng = np.random.default_rng(0x4B6)
    root = tmp_path_factory.mktemp("khsrecs")
    anc = rng.integers(0, 4, 4000).astype(np.uint8)
    other = anc.copy()
    hit = np.flatnonzero(rng.random(other.size) < 0.02)
    other[hit] = (other[hit] + 1) & 3
    paths = []
    for name, n in (("recs.fa", 12), ("q.fa", 4)):
        body = b""
        for i in range(n):
            src = LUT[(anc, other)[i % 2]]
            s0 = int(rng.integers(0, 600))
            seq = src[s0:s0 + int(rng.integers(2000, 3000))].tobytes()
            body += b">%s%d x\n%s\n" % (name[0].encode(), i, seq)
        (root / name).write_bytes(body)
        paths.append(str(root / name))
    return paths


def test_by_seq_matches_jax(records, cpu_env):
    """`sketch_by_seq --use-full-khash-sets` (and `-b -n 2`): streams and
    .names equal; `dist_by_seq -K` all pairs, Mash, and with -q,
    exactly."""
    fa, qa = records
    flags = ["-k", str(K), "--use-full-khash-sets"]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["sketch_by_seq"] + flags + ["-o", f"{who}.sbs", fa]) == 0
        assert fn(["sbs"] + flags + ["-o", f"{who}.q.sbs", qa]) == 0
        assert fn(["sbs"] + flags + ["-b", "-n", "2", "-o", f"{who}.f.sbs",
                                     fa]) == 0
    for suffix in (".sbs", ".q.sbs", ".f.sbs"):
        assert _unzip("port" + suffix) == _unzip("jax" + suffix)
        assert (open("port" + suffix + ".names").read()
                == open("jax" + suffix + ".names").read())
    for extra, sym in ((["-b"], True), (["-b", "-M"], True),
                       (["-b", "-q", "{}.q.sbs"], False)):
        mats = {}
        for who, fn in (("jax", jmain.main), ("port", tmain.main)):
            args = [a.format(who) for a in extra]
            assert fn(["dist_by_seq", "-K", "-n", f"{who}.sbs.names", "-o",
                       f"{who}.dbs"] + args + [f"{who}.sbs"]) == 0
            mats[who] = _mat(f"{who}.dbs", sym)
        _exact(mats["port"], mats["jax"])
        assert mats["port"].size == (66 if sym else 48)


def test_mkdist_matches_jax(genomes, cpu_env):
    """mkdist under the flag: no fused presketch (the per-k passes sketch
    the sets); the flattened matrices exactly."""
    assert tmain._mkdist_presketch(["--use-full-khash-sets"] + genomes,
                                   [15, 17], torch.device("cpu")) \
        == (None, None)
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["mkdist", "--multik", f"{who}mk,15,19,2",
                   "--use-full-khash-sets"] + genomes[:3]) == 0
    (tn, tk, tv), (jn, jk, jv) = (distmat.read_flattened(f"{w}mk.bin")
                                  for w in ("port", "jax"))
    assert tn == jn == 3 and list(tk) == list(jk) == [15, 17]
    _exact(np.asarray(tv), np.asarray(jv))
