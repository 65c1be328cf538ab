"""Per-record sketching and its compares on the CPU against the JAX CLI:
`sketch_by_seq`/`sbs` streams and .names byte for byte (decompressed),
`-b -n 2` (exact within-record counts) too; `dist_by_seq`/`cmp_by_seq`
values, symmetric and with -q, and `panel`'s best matches and values at
rtol 1e-4 (the bar of test_torch_slice.test_dist_matches_jax_cli); every
family letter of `dist_by_seq` reading its stream; and the new subcommands
run with jax and the JAX package blocked."""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py keeps JAX on the CPU)

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 15, 10
LUT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A multi-record FASTA of 40 records (1500-3000 bases: pieces of four
    related genomes, so records overlap; one empty, one all N, one
    lowercase), a second FASTA of 12 query records, and three genome
    files with a sketch database of them."""
    rng = np.random.default_rng(0x5B5)
    root = tmp_path_factory.mktemp("byseq")
    anc = rng.integers(0, 4, 6000).astype(np.uint8)
    genomes = []
    for rate in (0.0, 0.01, 0.02, 0.05):
        g = anc.copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size)) & 3
        genomes.append(LUT[g])

    def records(n, tag):
        out = []
        for i in range(n):
            g = genomes[i % 4]
            # every two records share 1,000 bases or more: no pair is
            # near-disjoint (there the two packages' estimates part by
            # rounding)
            start = int(rng.integers(0, 500))
            seq = g[start:start + int(rng.integers(1500, 3000))].copy()
            out.append((b"%s%d desc %d" % (tag, i, i), seq.tobytes()))
        return out

    recs = records(40, b"r")
    recs[5] = (b"empty", b"")
    recs[9] = (b"alln", b"N" * 300)
    recs[12] = (recs[12][0], recs[12][1].lower())
    fa = root / "recs.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % r for r in recs))
    qa = root / "queries.fa"
    qa.write_bytes(b"".join(b">%s\n%s\n" % r for r in records(12, b"q")))
    gpaths = []
    for i, g in enumerate(genomes[:3]):
        path = root / f"g{i}.fa"
        path.write_bytes(b">g%d\n%s\n" % (i, g.tobytes()))
        gpaths.append(str(path))
    return str(fa), str(qa), gpaths


@pytest.fixture()
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)


def _stream(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("cmd, extra", [
    ("sketch_by_seq", []), ("sbs", ["-b", "-n", "2"]),
    ("sbs", ["-w", "25"]), ("sbs", ["--use-nthash", "-k", "35"]),
])
def test_sbs_matches_jax_cli(data, cpu_env, cmd, extra):
    fa = data[0]
    for tag, fn in (("j", jmain.main), ("t", tmain.main)):
        assert fn([cmd, "-k", str(K), "-S", str(S), "-o", f"{tag}.sbs"]
                  + extra + [fa]) == 0
    assert _stream("t.sbs") == _stream("j.sbs")
    assert len(_stream("t.sbs")) == 40 * (16 + (1 << S))
    names = open("t.sbs.names").read()
    assert names == open("j.sbs.names").read()
    assert names.startswith("#k=") and names.count("\n") == 41


def _tsv(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()
            if not line.startswith("#")]
    return [r[0] for r in rows], np.array(
        [[np.nan if v == "-" else float(v) for v in r[1:]] for r in rows])


def test_dist_by_seq_matches_jax_cli(data, cpu_env):
    fa, qa, _ = data
    for tag, fn in (("j", jmain.main), ("t", tmain.main)):
        for src, out in ((fa, f"{tag}.sbs"), (qa, f"{tag}.q.sbs")):
            assert fn(["sbs", "-k", str(K), "-S", str(S), "-o", out,
                       src]) == 0
    runs = {"tsv": ["-M"], "bin": ["-b"], "rect": ["-q", "{}.q.sbs",
                                                   "--containment-index"],
            "rectbin": ["-q", "{}.q.sbs", "-b", "-M"],
            "phylip": ["-U", "-J"]}
    for name, extra in runs.items():
        outs = {}
        for tag, fn, cmd in (("j", jmain.main, "dist_by_seq"),
                             ("t", tmain.main, "cmp_by_seq")):
            out = f"{tag}.{name}"
            args = [a.format(tag) for a in extra]
            assert fn([cmd, "-n", f"{tag}.sbs.names", "-o", out] + args
                      + [f"{tag}.sbs"]) == 0
            outs[tag] = out
        if name == "bin":
            (nj, mj), (nt, mt) = (distmat.read_binary(outs[t])
                                  for t in "jt")
            assert nj == nt == 40
        elif name == "rectbin":
            mj, mt = (np.fromfile(outs[t], np.float32) for t in "jt")
            assert mt.shape == (12 * 40,)
        elif name == "phylip":
            tj, tt = (open(outs[t]).read().split() for t in "jt")
            assert tj[0] == tt[0] == "40"
            mj = np.array([float(v) for v in tj[1:] if v[0].isdigit()])
            mt = np.array([float(v) for v in tt[1:] if v[0].isdigit()])
        else:
            (lj, mj), (lt, mt) = (_tsv(outs[t]) for t in "jt")
            assert lj == lt
        assert mt.shape == mj.shape and np.isfinite(mt[~np.isnan(mt)]).all()
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flag", ["-B", "-S", "-8", "-K", "-r"])
def test_dist_by_seq_refuses_other_families(data, cpu_env, flag):
    """Each family letter, refused until its family was ported, reads its
    family's stream (test_torch_setsketch_cli.py and test_torch_khset.py
    hold the values to the JAX CLI); all but -K fail on an HLL stream's
    magic, as the JAX CLI does (a `.khs` record has no magic: both CLIs
    read an HLL stream's magic as a key count and stop on it)."""
    fa, _, _ = data
    type_flag = {"-B": "--use-bloom-filter", "-r": "--use-range-minhash",
                 "-K": "--use-full-khash-sets"}.get(flag, "-8")
    assert tmain.main(["sbs", "-k", str(K), "-S", str(S), type_flag, "-o",
                       "t.sbs", fa]) == 0
    assert tmain.main(["sbs", "-k", str(K), "-S", str(S), "-o", "h.sbs",
                       fa]) == 0
    assert tmain.main(["dist_by_seq", flag, "-b", "-n", "t.sbs.names", "-o",
                       "t.dbs", "t.sbs"]) == 0
    n, mat = distmat.read_binary("t.dbs")
    assert n == 40 and mat.shape == (40 * 39 // 2,)
    assert np.isfinite(mat).all()
    if flag == "-K":
        return
    with pytest.raises(SystemExit, match="bad sketch magic"):
        tmain.main(["dist_by_seq", flag, "-n", "h.sbs.names", "h.sbs"])


def test_panel_matches_jax_cli(data, cpu_env):
    """Each genome's best match is itself (containment 1), the JAX CLI's
    rows at rtol 1e-4; records of the genomes as queries too."""
    fa, _, gpaths = data
    assert tmain.main(["sketch", "-k", str(K), "-S", "12", "-o", "db.gz"]
                      + gpaths) == 0
    with open("q.txt", "w") as fp:
        fp.write("\n".join(gpaths + [fa]) + "\n")
    rows = {}
    for tag, fn in (("j", jmain.main), ("t", tmain.main)):
        assert fn(["panel", "-k", str(K), "-F", "-o", f"{tag}.panel",
                   "db.gz", "q.txt"]) == 0
        lines = open(f"{tag}.panel").read().splitlines()
        assert lines[0] == "#Query\tBestMatch\tContainment\tJaccard"
        rows[tag] = [line.split("\t") for line in lines[1:]]
    assert [r[:2] for r in rows["t"]] == [r[:2] for r in rows["j"]]
    vals = {t: np.array([[float(v) for v in r[2:]] for r in rows[t]])
            for t in rows}
    np.testing.assert_allclose(vals["t"], vals["j"], rtol=1e-4, atol=1e-6)
    for path, r in zip(gpaths, rows["t"]):
        assert r[1] == path and float(r[2]) == pytest.approx(1.0, abs=1e-5)


_BLOCKED_RUN = r"""
import importlib.abc, os, sys
BLOCKED = ("jax", "jaxlib", "dashing_tpu")   # dashing_tpu_torch stays
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import blocked: {name}")
        return None

sys.meta_path.insert(0, NoJax())
import dashing_tpu_torch.background  # noqa: F401
from dashing_tpu_torch.cli.main import main
fa, genomes = sys.argv[1], sys.argv[2:]
rc = main(["mkdist", "--multik", "mk,13,21,4", "-S", "10",
           "--jukes-cantor"] + genomes)
rc |= main(["sketch_by_seq", "-k", "15", "-S", "10", "-o", "r.sbs", fa])
rc |= main(["dist_by_seq", "-n", "r.sbs.names", "-o", "r.tsv", "r.sbs"])
rc |= main(["sketch", "-k", "15", "-S", "10", "-o", "db.gz"] + genomes)
rc |= main(["panel", "-k", "15", "-o", "p.txt", "db.gz", genomes[0]])
rc |= main(["dist", "-k", "15", "-S", "10", "-W", "-o", "s.txt", "-O",
            "d.txt"] + genomes)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert rc == 0 and not leaked, (rc, leaked)
assert os.path.getsize("mk.jcd") > 9 and os.path.getsize("r.tsv") > 0
print("NOJAX-OK")
"""


def test_new_subcommands_never_import_jax(data, tmp_path):
    env = dict(os.environ, DASHING_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, data[0]] + data[2],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NOJAX-OK" in res.stdout
