"""The port's CLI on the set sketches (-8/--use-bb-minhash with -B,
--use-counting-bb-minhash, --use-range-minhash,
--use-counting-range-minhash, --use-bloom-filter) against the JAX CLI on
the CPU, over small related genomes: `sketch` files and `-o` streams
equal once decompressed (a gzip header carries a write time), `dist`/`cmp`
matrices of every family and measure at rtol 1e-4 (atol 2e-6 for
Jaccard, 1e-6 else; the triples are the same float64 numpy arithmetic,
only the float32 measure is each package's own), `-o` sizes exactly,
`-Q`, `--nearest-neighbors` (ids exactly), `-W`, `-y`, `union -r/-b`,
`view` and `view --header`, `card`, `mkdist`, `sketch_by_seq` and
`dist_by_seq -B -S -8 -r`; and the type-mismatch and mixed-geometry
messages word for word."""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat

torch.set_num_threads(1)

K, S = 21, 12
RATES = (0.0, 0.01, 0.02, 0.04)
LUT = np.frombuffer(b"ACGT", np.uint8)

FAMILIES = {
    "bbmh": ["-8"],
    "bbmh8": ["-8", "-B", "8"],
    "bbmh64": ["--use-bb-minhash", "--bbits", "64"],
    "cbbmh": ["--use-counting-bb-minhash"],
    "rmh": ["--use-range-minhash"],
    "crmh": ["--use-counting-range-minhash"],
    "bf": ["--use-bloom-filter"],
}
MEASURES = {
    "mash": ["-M"], "ji": [], "sizes": ["-Z"],
    "full_mash": ["--full-mash-dist"],
    "full_containment": ["--full-containment-dist"],
    "containment_index": ["--containment-index"],
    "containment_dist": ["--containment-dist"],
    "sym_containment_index": ["--symmetric-containment-index"],
    "sym_containment_dist": ["--symmetric-containment-dist"],
}
ASYMMETRIC = ("full_containment", "containment_index", "containment_dist")


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """4 FASTAs of 12-20 kbp from one ancestor at planted substitution
    rates (no pair near-disjoint), two records each, one gzipped, one
    with a run of N; then a byte copy of genome 1 under another name."""
    rng = np.random.default_rng(0x5E7)
    root = tmp_path_factory.mktemp("setgenomes")
    anc = rng.integers(0, 4, 20000, dtype=np.uint8)
    out = []
    for i, rate in enumerate(RATES):
        g = anc[:int(rng.integers(12000, 20000))].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
        seq = LUT[g]
        if i == 3:
            seq[500:700] = ord("N")
        cut = seq.size // 2
        body = b">g%d_a\n%s\n>g%d_b\n%s\n" % (i, seq[:cut].tobytes(), i,
                                              seq[cut:].tobytes())
        path = root / (f"g{i}.fa.gz" if i == 2 else f"g{i}.fa")
        path.write_bytes(gzip.compress(body) if i == 2 else body)
        out.append(str(path))
    copy = root / "copy_of_g1.fa"
    shutil.copyfile(out[1], copy)
    return out + [str(copy)]


@pytest.fixture(scope="module")
def sketched(genomes, tmp_path_factory):
    """Each family's sketch files of the genomes, written by the port
    (test_sketch_files_equal_jax holds them to the JAX CLI's), in the
    genomes' order."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
        for fam, flags in FAMILIES.items():
            d = tmp_path_factory.mktemp(f"sk_{fam}")
            assert tmain.main(["sketch", "-k", str(K), "-S", str(S), "-P",
                               str(d)] + flags + genomes) == 0
            names = os.listdir(d)
            out[fam] = [str(d / next(n for n in names
                                     if n.startswith(os.path.basename(g))))
                        for g in genomes]
    return out


@pytest.fixture()
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)


def _unzip(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def _mat(path, symmetric):
    """A `dist -b` output as float32: the condensed vector (its 9-byte
    header checked) or the headerless query x reference rows."""
    raw = open(path, "rb").read()
    if symmetric:
        n = int.from_bytes(raw[1:9], "little")
        assert raw[0] == 0 and len(raw) == 9 + 2 * n * (n - 1)
        raw = raw[9:]
    return np.frombuffer(raw, "<f4")


def _both(args, tag=""):
    """Run `args` through the JAX CLI and the port with -O/-o; returns
    {"jax"/"port": (dists path, sizes path)}."""
    out = {}
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        d, s = f"{who}{tag}.out", f"{who}{tag}.sizes"
        assert fn(list(args) + ["-O", d, "-o", s]) == 0, who
        out[who] = d, s
    return out


def _close(got, want, measure):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=2e-6 if measure == "ji" else 1e-6)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_sketch_files_equal_jax(genomes, tmp_path, cpu_env, fam):
    """`sketch -P` file names and records, one `sketch -o` stream with its
    labels, and a count-min filtered stream (`-b -n 2`, the host route)
    equal to the JAX CLI's."""
    flags = ["sketch", "-k", str(K), "-S", str(S)] + FAMILIES[fam]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(who)
        assert fn(flags + ["-P", who] + genomes) == 0
        assert fn(flags + ["-o", f"{who}.stream"] + genomes) == 0
        assert fn(flags + ["-b", "-n", "2", "-o", f"{who}.filt"]
                  + genomes[:2]) == 0
    assert _unzip("port.filt") == _unzip("jax.filt")
    names = sorted(os.listdir("jax"))
    assert names == sorted(os.listdir("port")) and len(names) == 5
    for nm in names:
        assert _unzip(f"port/{nm}") == _unzip(f"jax/{nm}"), nm
    assert _unzip("port.stream") == _unzip("jax.stream")
    assert (_unzip("port.stream.labels.gz")
            == _unzip("jax.stream.labels.gz"))


@pytest.mark.parametrize("measure", sorted(MEASURES))
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_dist_presketched_matches_jax(sketched, cpu_env, fam, measure):
    """`dist -H -b` over each family's files under every measure (the
    asymmetric ones switch to query x reference rows with the JAX CLI's
    note); `cmp` for one measure."""
    sym = measure not in ASYMMETRIC
    cmd = "cmp" if measure == "mash" else "dist"
    out = _both([cmd, "-k", str(K), "-H", "-b"] + FAMILIES[fam]
                + MEASURES[measure] + sketched[fam])
    got, want = (_mat(out[w][0], sym) for w in ("port", "jax"))
    _close(got, want, measure)
    assert open(out["port"][1]).read() == open(out["jax"][1]).read()
    if measure == "ji":           # genome 1 and its byte copy: pair (1, 4)
        assert got[6] == 1.0


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_dist_from_fasta_matches_jax(genomes, cpu_env, fam):
    """`dist -M -b` sketching the FASTAs (sorted by size, as both CLIs
    do), `-T` text, `-W` twice (its cache files named as the JAX CLI
    names them; the second run loads them), and `-y -c 2` (the host
    route for every family)."""
    base = ["dist", "-k", str(K), "-S", str(S), "-M"] + FAMILIES[fam]
    out = _both(base + ["-b"] + genomes)
    _close(*(_mat(out[w][0], True) for w in ("port", "jax")), "mash")
    assert open(out["port"][1]).read() == open(out["jax"][1]).read()
    text = _both(base + ["-T"] + genomes, ".T")
    jt, tt = (open(text[w][0]).read().splitlines() for w in ("jax", "port"))
    assert tt[0] == jt[0] and [r.split("\t")[0] for r in tt] == \
        [r.split("\t")[0] for r in jt]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(f"c_{who}")
        for run in (1, 2):
            assert fn(base + ["-b", "-W", "-P", f"c_{who}", "-O",
                              f"{who}.W{run}"] + genomes[:3]) == 0
    assert sorted(os.listdir("c_port")) == sorted(os.listdir("c_jax"))
    for nm in os.listdir("c_port"):
        assert _unzip(f"c_port/{nm}") == _unzip(f"c_jax/{nm}")
    assert open("port.W1", "rb").read() == open("port.W2", "rb").read()
    _close(_mat("port.W2", True), _mat("jax.W2", True), "mash")
    filt = _both(base + ["-b", "-y", "-c", "2"] + genomes[:3], ".y")
    _close(*(_mat(filt[w][0], True) for w in ("port", "jax")), "mash")


@pytest.mark.parametrize("fam", ["bbmh", "rmh", "bf"])
def test_query_and_nearest_neighbors_match_jax(genomes, tmp_path, cpu_env,
                                               fam):
    """`dist -Q` (TSV and binary with the .labels sidecar) and
    `--nearest-neighbors 2` with and without -Q: the byte copy of genome 1
    finds genome 1 at Jaccard 1."""
    q = tmp_path / "q.txt"
    q.write_text(genomes[4] + "\n" + genomes[3] + "\n")
    base = ["dist", "-k", str(K), "-S", str(S), "--avoid-sorting"] \
        + FAMILIES[fam]
    rect = _both(base + ["-Q", str(q)] + genomes[:4], ".Q")
    rows = {w: [l.split("\t") for l in open(rect[w][0]).read().splitlines()]
            for w in rect}
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    tv, jv = (np.array([[float(v) for v in r[1:]] for r in rows[w]
                        if not r[0].startswith("#")]) for w in ("port", "jax"))
    _close(tv, jv, "ji")
    assert tv[0, 1] == 1.0
    rb = _both(base + ["-Q", str(q), "-b", "-M"] + genomes[:4], ".Qb")
    _close(*(_mat(rb[w][0], False) for w in ("port", "jax")), "mash")
    assert (open(rb["port"][0] + ".labels").read()
            == open(rb["jax"][0] + ".labels").read())
    for extra in (genomes, ["-Q", str(q)] + genomes[:4]):
        nn = _both(base + ["--nearest-neighbors", "2"] + extra, ".nn")
        tl, jl = (open(nn[w][0]).read().splitlines() for w in ("port", "jax"))
        assert tl[0] == jl[0] == "#File\tNeighbor ID:distance\t..."
        for a, b in zip(tl[1:], jl[1:]):
            fa, fb = a.split("\t"), b.split("\t")
            assert fa[0] == fb[0]
            assert [x.split(":")[0] for x in fa[1:]] == \
                [x.split(":")[0] for x in fb[1:]]
            _close(np.array([float(x.split(":")[1]) for x in fa[1:]]),
                   np.array([float(x.split(":")[1]) for x in fb[1:]]), "ji")
        if extra[0] == "-Q":
            assert tl[1].split("\t")[1].split(":")[0] == "1"
        else:
            assert tl[2].split("\t")[1].split(":")[0] == "4"


def test_union_view_fold_card_match_jax(sketched, genomes, cpu_env, capsys):
    """union -r and union -b x (to a file and gzipped to stdout), view of
    every family and view --header byte for byte; card and cardcmp under
    each type flag; fold of a set sketch stops with the JAX CLI's
    message."""
    for flag, fam in ((["-r"], "rmh"), (["-b", "x"], "bf")):
        for who, fn in (("jax", jmain.main), ("port", tmain.main)):
            assert fn(["union", "-o", f"{who}.u"] + flag + sketched[fam]) \
                == 0
        assert _unzip("port.u") == _unzip("jax.u")
    files = [sketched[f][0] for f in sorted(FAMILIES)]
    for argv in (["view"] + files, ["view", "--header"] + files):
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0] and outs[1].count("\n") >= len(files)
    for fam in ("bbmh", "rmh", "cbbmh", "crmh", "bf"):
        for cmd in ("card", "cardcmp"):
            outs = []
            for fn in (jmain.main, tmain.main):
                assert fn([cmd, "-k", str(K), "-S", str(S)] + FAMILIES[fam]
                          + genomes[:3]) == 0
                outs.append(capsys.readouterr().out)
            assert outs[1] == outs[0] and outs[1].count("\n") == 4
    msgs = []
    for fn in (jmain.main, tmain.main):
        with pytest.raises(SystemExit) as e:
            fn(["fold", "-o", "f.out", sketched["bbmh"][0]])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "no precision fold" in msgs[1]
    with pytest.raises(SystemExit, match="mixed sketch types"):
        tmain.main(["union", "-o", "m.u", sketched["bbmh"][0],
                    sketched["rmh"][0]])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A FASTA of 16 records (pieces of two related sequences, so every
    pair shares k-mers; one lowercase) and one of 5 query records."""
    rng = np.random.default_rng(0x5B6)
    root = tmp_path_factory.mktemp("setrecs")
    anc = rng.integers(0, 4, 5000).astype(np.uint8)
    other = anc.copy()
    hit = np.flatnonzero(rng.random(other.size) < 0.02)
    other[hit] = (other[hit] + 1) & 3
    paths = []
    for name, n in (("recs.fa", 16), ("q.fa", 5)):
        body = b""
        for i in range(n):
            src = LUT[(anc, other)[i % 2]]
            s0 = int(rng.integers(0, 800))
            seq = src[s0:s0 + int(rng.integers(2500, 4000))].tobytes()
            body += b">%s%d x\n%s\n" % (name[0].encode(), i,
                                        seq.lower() if i == 3 else seq)
        (root / name).write_bytes(body)
        paths.append(str(root / name))
    return paths


@pytest.mark.parametrize("letter,fam", [("-8", "bbmh"), ("-S", "bbmh"),
                                        ("-r", "rmh"), ("-B", "bf")])
def test_by_seq_matches_jax(records, cpu_env, letter, fam):
    """`sketch_by_seq` under the type flag (and `-b -n 2`): streams and
    .names equal; `dist_by_seq` with the type letter, all pairs and with
    -q, at rtol 1e-4."""
    fa, qa = records
    flags = ["-k", str(K), "-S", "10"] + FAMILIES[fam]
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
            assert fn(["dist_by_seq", letter, "-n", f"{who}.sbs.names", "-o",
                       f"{who}.dbs"] + args + [f"{who}.sbs"]) == 0
            mats[who] = _mat(f"{who}.dbs", sym)
        _close(mats["port"], mats["jax"], "mash" if "-M" in extra else "ji")


def test_mkdist_with_type_matches_jax(genomes, cpu_env):
    """mkdist under -8: no fused presketch (the per-k passes sketch); the
    flattened matrices at rtol 1e-4."""
    assert tmain._mkdist_presketch(["-8"] + genomes, [15, 17],
                                   torch.device("cpu")) == (None, None)
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["mkdist", "--multik", f"{who}mk,15,19,2", "-S", str(S),
                   "-8"] + genomes[:3]) == 0
    (tn, tk, tv), (jn, jk, jv) = (distmat.read_flattened(f"{w}mk.bin")
                                  for w in ("port", "jax"))
    assert tn == jn == 3 and list(tk) == list(jk) == [15, 17]
    _close(tv, jv, "ji")


def test_messages_word_for_word(sketched, cpu_env, capfd):
    """A file of another type than an explicit flag asks for stops the
    run; under the default type it loads with a note; mixed -B widths and
    mixed families stop with the JAX CLI's messages."""
    cases = [
        ["dist", "-H", "--use-bloom-filter"] + sketched["bbmh"][:2],
        ["dist", "-H"] + sketched["bbmh"][:2] + sketched["bbmh8"][:1],
        ["dist", "-H"] + sketched["rmh"][:2] + sketched["crmh"][:1],
        ["dist", "-H", "-8"] + sketched["bbmh"][:1] + sketched["cbbmh"][:1],
    ]
    for argv in cases:
        msgs = []
        for fn in (jmain.main, tmain.main):
            with pytest.raises(SystemExit) as e:
                fn(argv + ["-O", "x.out"])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], argv
    capfd.readouterr()
    for fn in (jmain.main, tmain.main):
        assert fn(["dist", "-H", "-O", "n.out"] + sketched["bbmh"][:2]) == 0
    err = [l for l in capfd.readouterr().err.splitlines()
           if l.startswith("Note:")]
    assert len(err) == 4 and err[:2] == err[2:]
    assert "is a .bmh sketch; loading as bbmh (requested hll)" in err[0]
