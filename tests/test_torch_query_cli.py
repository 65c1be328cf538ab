"""The port's CLI query/reference modes on the CPU against the JAX CLI:
`dist -Q` as TSV rows and as headerless float32 rows with the `.labels`
sidecar, the three asymmetric measures with and without -Q (the note,
the aliased query half that sketches each file once), `-J -Q`, and
`--nearest-neighbors` as TSV and binary with the "Only reporting" clamp.
Names, headers, labels, shapes and neighbour ids must be the JAX CLI's
byte for byte; values agree at rtol 1e-4 (the port estimates a tile's
marginals and unions by the complement chain, the JAX package's CPU path
by the direct form), as the `dist` cases of test_torch_slice.py do."""
import gzip
import shutil

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain

torch.set_num_threads(1)

K, S = 21, 12
RTOL, ATOL = 1e-4, 1e-6
RATES = (0.0, 0.01, 0.02, 0.04, 0.06)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """5 FASTAs of 15-30 kbp from one ancestor at planted substitution
    rates (no pair near-disjoint), several records each, one gzipped;
    then a byte copy of genome 1 under another name."""
    rng = np.random.default_rng(0xDA5)
    root = tmp_path_factory.mktemp("qgenomes")
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, 30000, dtype=np.uint8)
    out = []
    for i, rate in enumerate(RATES):
        g = anc[:int(rng.integers(15000, 30000))].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
        seq = lut[g]
        cuts = np.linspace(0, seq.size, 3).astype(int)
        body = b"".join(b">g%d_r%d\n%s\n" % (i, r, seq[cuts[r]:cuts[r + 1]]
                                              .tobytes()) for r in range(2))
        path = root / (f"g{i}.fa.gz" if i == 2 else f"g{i}.fa")
        path.write_bytes(gzip.compress(body) if i == 2 else body)
        out.append(str(path))
    copy = root / "copy_of_g1.fa"
    shutil.copyfile(out[1], copy)
    return out + [str(copy)]


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")


def _qfile(tmp_path, paths):
    q = tmp_path / "q.txt"
    q.write_text("".join(p + "\n" for p in paths))
    return str(q)


def _run_both(tmp_path, args, binary=False):
    """Run the JAX CLI and the port with -O/-o into tmp_path; returns
    {tag: (dists path, sizes path)}."""
    out = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        d = str(tmp_path / f"{tag}.{'bin' if binary else 'tsv'}")
        s = str(tmp_path / f"{tag}.sizes")
        assert fn(args + ["-O", d, "-o", s]) == 0
        out[tag] = d, s
    return out


def _split_tsv(path):
    """(names, values) of a TSV of rows 'name\\tv...' (headers skipped)."""
    names, vals = [], []
    for line in open(path).read().splitlines():
        if line.startswith("#"):          # the -o header
            continue
        f = line.split("\t")
        names.append(f[0])
        vals.append([float(v) for v in f[1:]])
    return names, np.array(vals)


def _check_sizes(out):
    (jn, jv), (tn, tv) = (_split_tsv(out[t][1]) for t in ("jax", "port"))
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1.0)


def test_query_tsv_matches_jax_cli(genomes, tmp_path, cpu_env):
    """-Q rows: one TSV row a query named by its path, one column a
    reference, and -o sizes of references then queries."""
    q = _qfile(tmp_path, [genomes[4], genomes[5], genomes[0]])
    out = _run_both(tmp_path, ["dist", "-k", str(K), "-S", str(S), "-M",
                               "-Q", q] + genomes[:4])
    (jn, jv), (tn, tv) = (_split_tsv(out[t][0]) for t in ("jax", "port"))
    assert tn == jn and len(tn) == 3 and tv.shape == (3, 4)
    assert np.isfinite(tv).all()
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    _check_sizes(out)
    assert len(open(out["port"][1]).read().splitlines()) == 1 + 7


@pytest.mark.parametrize("extra", [[], ["-J"]])
def test_query_binary_matches_jax_cli(genomes, tmp_path, cpu_env, extra):
    """-Q -b: headerless float32 (nq, nr) rows and the .labels of every
    name; with -J the joint MLE on query x reference tiles."""
    q = _qfile(tmp_path, [genomes[5], genomes[3]])
    out = _run_both(tmp_path, ["dist", "-k", str(K), "-S", str(S), "-M",
                               "-b", "-Q", q] + extra + genomes[:5],
                    binary=True)
    mats = {t: np.fromfile(out[t][0], np.float32) for t in out}
    assert mats["port"].shape == mats["jax"].shape == (2 * 5,)
    assert np.isfinite(mats["port"]).all()
    np.testing.assert_allclose(mats["port"], mats["jax"], rtol=RTOL,
                               atol=ATOL)
    labels = [open(out[t][0] + ".labels", "rb").read() for t in out]
    assert labels[0] == labels[1] and labels[1].count(b"\n") == 7


ASYMMETRIC = ["--containment-index", "--containment-dist",
              "--full-containment-dist"]


@pytest.mark.parametrize("flag", ASYMMETRIC)
def test_asymmetric_with_queries_matches_jax_cli(genomes, tmp_path, cpu_env,
                                                 flag):
    """Each containment measure with -Q, binary and TSV: the copy of
    genome 1 among the queries is contained in genome 1 wholly."""
    q = _qfile(tmp_path, [genomes[5], genomes[4]])
    base = ["dist", "-k", str(K), "-S", str(S), flag, "-Q", q] + genomes[:4]
    b = _run_both(tmp_path, base + ["-b"], binary=True)
    mats = {t: np.fromfile(b[t][0], np.float32).reshape(2, 4) for t in b}
    np.testing.assert_allclose(mats["port"], mats["jax"], rtol=RTOL,
                               atol=ATOL)
    labels = open(b["port"][0] + ".labels").read().splitlines()
    row = labels[4:].index(genomes[5])      # queries sort by size too
    self_val = mats["port"][row, labels.index(genomes[1])]
    if flag == "--containment-index":
        assert self_val == pytest.approx(1.0, abs=1e-5)
    else:
        assert self_val == pytest.approx(0.0, abs=1e-5)
    t = _run_both(tmp_path, base)
    (jn, jv), (tn, tv) = (_split_tsv(t[x][0]) for x in ("jax", "port"))
    assert tn == jn == labels[4:]
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv, mats["port"], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("flag", ASYMMETRIC)
def test_asymmetric_without_queries_matches_jax_cli(genomes, tmp_path,
                                                    cpu_env, capfd, flag,
                                                    monkeypatch):
    """No -Q: the note, then every reference as a query through the
    aliased half, each file sketched once; an (n, n) rect whose diagonal
    is each sketch against itself; .labels names twice."""
    calls = []              # files sketched, one by one or a batch a call
    real = pipeline.sketch_hll_async
    monkeypatch.setattr(pipeline, "sketch_hll_async",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batched = pipeline.sketch_small_batch_async
    monkeypatch.setattr(pipeline, "sketch_small_batch_async",
                        lambda chunks, *a, **kw: calls.extend([1] * len(chunks))
                        or batched(chunks, *a, **kw))
    args = ["dist", "-k", str(K), "-S", str(S), flag, "-b"] + genomes[:5]
    capfd.readouterr()
    out = _run_both(tmp_path, args, binary=True)
    err = capfd.readouterr().err
    note = ("Note: No query files provided, but an asymmetric distance was "
            "requested. Switching to a query/reference format with all "
            "references as queries.")
    assert err.count(note) == 2
    assert len(calls) == 5
    mats = {t: np.fromfile(out[t][0], np.float32).reshape(5, 5) for t in out}
    np.testing.assert_allclose(mats["port"], mats["jax"], rtol=RTOL,
                               atol=ATOL)
    diag = np.diag(mats["port"])
    want = 1.0 if flag == "--containment-index" else 0.0
    np.testing.assert_allclose(diag, want, atol=1e-6)
    labels = [open(out[t][0] + ".labels", "rb").read() for t in out]
    assert labels[0] == labels[1] and labels[1].count(b"\n") == 10
    _check_sizes(out)


def _nn_binary(path):
    raw = open(path, "rb").read()
    n, nn = np.frombuffer(raw[:8], "<u4")
    rec = np.frombuffer(raw[8:], dtype=[("v", "<f4"), ("i", "<u4")])
    assert rec.shape == (n * nn,)
    return int(n), int(nn), rec["v"].reshape(n, nn), rec["i"].reshape(n, nn)


def _nn_tsv(path):
    """(header, names, ids, values) of the NN TSV."""
    lines = open(path).read().splitlines()
    names, ids, vals = [], [], []
    for line in lines[1:]:
        f = line.split("\t")
        names.append(f[0])
        ids.append([int(x.split(":")[0]) for x in f[1:]])
        vals.append([float(x.split(":")[1]) for x in f[1:]])
    return lines[0], names, np.array(ids), np.array(vals)


@pytest.mark.parametrize("nn,extra", [("1", []), ("2", ["-M"]),
                                      ("2", ["--containment-dist"])])
def test_nearest_neighbors_matches_jax_cli(genomes, tmp_path, cpu_env, nn,
                                           extra):
    """All-pairs NN as TSV and binary: ids equal to the JAX CLI's, values
    at rtol 1e-4.  Symmetric measures exclude each sketch itself, so the
    copy of genome 1 is genome 1's nearest neighbour and the other way
    round; an asymmetric one switches to query/reference with every
    sketch a query, nothing excluded, so genome 1 and its copy (both at
    distance -0.0) lead both rows in index order."""
    base = ["dist", "-k", str(K), "-S", str(S), "--nearest-neighbors", nn,
            "--avoid-sorting"] + extra + genomes
    t = _run_both(tmp_path, base)
    (jh, jn, ji, jv), (th, tn, ti, tv) = (_nn_tsv(t[x][0])
                                          for x in ("jax", "port"))
    assert th == jh == "#File\tNeighbor ID:distance\t..."
    assert tn == jn == genomes and ti.shape == (6, int(nn))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    if extra == ["--containment-dist"]:
        assert list(ti[1]) == list(ti[5]) == [1, 5]
    else:
        assert ti[1, 0] == 5 and ti[5, 0] == 1
        assert (ti != np.arange(6)[:, None]).all()
    b = _run_both(tmp_path, base + ["-b"], binary=True)
    (jn_, jk, jv2, ji2), (tn_, tk, tv2, ti2) = (_nn_binary(b[x][0])
                                                for x in ("jax", "port"))
    assert (tn_, tk) == (jn_, jk) == (6, int(nn))
    np.testing.assert_array_equal(ti2, ji2)
    np.testing.assert_array_equal(ti2, ti)
    np.testing.assert_allclose(tv2, jv2, rtol=RTOL, atol=ATOL)
    _check_sizes(b)


def test_nearest_neighbors_with_queries_and_clamp(genomes, tmp_path, cpu_env,
                                                  capfd):
    """NN with -Q: the queries' rows against the references only (nothing
    excluded: the copy of genome 1 finds genome 1 first), and more
    neighbours asked than references clamped with the JAX CLI's note."""
    q = _qfile(tmp_path, [genomes[5], genomes[4]])
    base = ["dist", "-k", str(K), "-S", str(S), "--avoid-sorting", "-Q", q,
            "--nearest-neighbors", "9"] + genomes[:4]
    capfd.readouterr()
    t = _run_both(tmp_path, base)
    err = capfd.readouterr().err
    note = ("Only reporting 4 rather than 9 neighbors due to their being "
            "only that many sets.")
    assert err.count(note) == 2
    (jh, jn, ji, jv), (th, tn, ti, tv) = (_nn_tsv(t[x][0])
                                          for x in ("jax", "port"))
    assert tn == jn == [genomes[5], genomes[4]] and ti.shape == (2, 4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert ti[0, 0] == 1 and tv[0, 0] == pytest.approx(1.0, abs=1e-6)
    b = _run_both(tmp_path, base + ["-b"], binary=True)
    (jn_, jk, jv2, ji2), (tn_, tk, tv2, ti2) = (_nn_binary(b[x][0])
                                                for x in ("jax", "port"))
    assert (tn_, tk) == (jn_, jk) == (2, 4)
    np.testing.assert_array_equal(ti2, ji2)
    np.testing.assert_allclose(tv2, jv2, rtol=RTOL, atol=ATOL)
    # all-pairs: at most n - 1 others exist, but the clamp counts n
    capfd.readouterr()
    assert tmain.main(["dist", "-k", str(K), "-S", str(S),
                       "--nearest-neighbors", "8", "-O",
                       str(tmp_path / "all.tsv")] + genomes[:3]) == 0
    assert "Only reporting 3 rather than 8" in capfd.readouterr().err
    _, names, ids, vals = _nn_tsv(str(tmp_path / "all.tsv"))
    assert ids.shape == (3, 3) and (ids[:, -1] == np.arange(3)).all()
    assert np.isneginf(vals[:, -1]).all()
