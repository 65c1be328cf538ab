"""The port's CLI on the wide HLL, HyperMinHash and SuperMinHash types
(--use-wide-hll, --use-hyperminhash, --use-superminhash with -B) against
the JAX CLI on the CPU, over small related genomes: `sketch` files and
`-o` streams equal once decompressed, `dist`/`cmp` matrices at rtol 1e-4
(atol 2e-6 for Jaccard, 1e-6 else), `-o` sizes byte for byte, `-Q`,
`--nearest-neighbors` (ids exactly), `-W` twice, `union`, `fold`, `view`
and `view --header`, `card`, `mkdist`, `sketch_by_seq` and `dist_by_seq`;
DTPUSMH1 files (the densified MinHash) read, and a stale DTPUSMH1 `-W`
cache rebuilt with the JAX CLI's note; the mixed-geometry messages word
for word; SuperMinHash at -B 64 stopping by name where the JAX CLI dies.

The wide HLL takes the HLL engine: its registers, built on the device
route, equal the JAX CLI's host route (raw k-mers into WideHLL.addh_np)
under k31, -s, -w, --use-nthash and a count-min filter, and the port's own
`.hll` registers; its `dist -M`/`-J` matrices are the port's HLL
matrices bit for bit."""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu.sketch import extra as jx
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat
from dashing_tpu_torch.sketch.extra import WideHLL
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

K, S = 21, 12
RATES = (0.0, 0.01, 0.02, 0.04)
LUT = np.frombuffer(b"ACGT", np.uint8)

FAMILIES = {
    "whll": ["--use-wide-hll"],
    "hmh": ["--use-hyperminhash"],
    "hmh8": ["--use-hyperminhash", "-B", "8"],
    "smh": ["--use-superminhash"],
    "smh32": ["--use-superminhash", "--bbits", "32"],
}
MEASURES = {"mash": ["-M"], "ji": [], "sizes": ["-Z"],
            "containment_index": ["--containment-index"],
            "joint": ["-J", "-M"]}
ASYMMETRIC = ("containment_index",)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """4 FASTAs of 12-20 kbp from one ancestor at planted substitution
    rates (no pair near-disjoint), two records each, one gzipped, one
    with a run of N; then a byte copy of genome 1 under another name."""
    rng = np.random.default_rng(0xE71)
    root = tmp_path_factory.mktemp("extragenomes")
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


def _sizes_equal(port, jax_):
    """`-o` sizes: the JAX CLI's bytes (the integer part of each
    cardinality)."""
    assert open(port).read() == open(jax_).read()


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_sketch_files_equal_jax(genomes, tmp_path, cpu_env, fam):
    """`sketch -P` file names and records, one `sketch -o` stream with its
    labels, and a count-min filtered stream (`-b -n 2`) equal to the JAX
    CLI's; the wide HLL's registers (the HLL engine) equal the JAX CLI's
    host route."""
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


WIDE_ENCODINGS = {
    "k31": ["-k", "31"],
    "spaced": ["-k", "15", "-s", "1x4"],
    "window": ["-k", "21", "-w", "40"],
    "nthash": ["-k", "40", "--use-nthash"],
    "countmin": ["-k", "21", "-b", "-n", "2"],
}


@pytest.mark.parametrize("enc", sorted(WIDE_ENCODINGS))
def test_wide_device_route_equals_jax_host_route(genomes, cpu_env, enc):
    """The wide HLL's registers from the port's HLL engine (K1 packed,
    banked K1 for small files, the ASCII-tile encoders for -s/-w/rolling
    hashes, the count-min filtered route) bitwise equal to the JAX CLI's
    host route (file_raw_kmers + WideHLL.addh_np), and to the port's own
    HLL registers of the same file, widened."""
    flags = ["sketch", "-S", "10"] + WIDE_ENCODINGS[enc]
    inputs = genomes[:4]
    if enc == "countmin":
        # two related genomes a file, so that -n 2 admits their shared
        # k-mers
        inputs = []
        for i in range(3):
            body = b"".join(_unzip(g) if g.endswith(".gz")
                            else open(g, "rb").read()
                            for g in genomes[i:i + 2])
            inputs.append(f"pair{i}.fa")
            open(inputs[-1], "wb").write(body)
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(flags + ["--use-wide-hll", "-o", f"{who}.w"]
                  + inputs) == 0
    assert tmain.main(flags + ["-o", "port.h"] + inputs) == 0
    assert _unzip("port.w") == _unzip("jax.w")
    with gzip.open("port.w", "rb") as fw, gzip.open("port.h", "rb") as fh:
        for _ in inputs:
            w, h = WideHLL.read_record(fw), HLL.read_record(fh)
            assert w.regs.dtype == np.uint16 and w.regs.any()
            np.testing.assert_array_equal(w.regs, h.regs.astype(np.uint16))


def test_wide_matrices_are_the_hll_matrices(genomes, cpu_env):
    """`dist --use-wide-hll -M` and `-J` matrices and sizes: the port's
    `dist -M`/`-J` over the same files, bit for bit (the HLL engine and
    kernels); and the `-W` cache files are `.whll` records."""
    base = ["dist", "-k", str(K), "-S", str(S), "-b"]
    for extra in (["-M"], ["-J", "-M"], ["--containment-index"]):
        for tag, flags in (("w", ["--use-wide-hll"]), ("h", [])):
            assert tmain.main(base + extra + flags + ["-O", f"{tag}.bin",
                                                      "-o", f"{tag}.sz"]
                              + genomes) == 0
        assert open("w.bin", "rb").read() == open("h.bin", "rb").read()
        assert open("w.sz").read() == open("h.sz").read()
    os.mkdir("c")
    assert tmain.main(base + ["--use-wide-hll", "-W", "-P", "c", "-O",
                              "c.bin"] + genomes[:2]) == 0
    names = sorted(os.listdir("c"))
    assert len(names) == 2 and all(n.endswith(".whll") for n in names)
    assert isinstance(WideHLL.read(os.path.join("c", names[0])), WideHLL)


@pytest.mark.parametrize("measure", sorted(MEASURES))
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_dist_presketched_matches_jax(sketched, cpu_env, fam, measure):
    """`dist -H -b` over each family's files (the asymmetric measure
    switches to query x reference rows with the JAX CLI's note); `cmp`
    for one measure; -J on every type (only the wide HLL has a joint
    MLE: the others ignore it, as in the JAX CLI)."""
    sym = measure not in ASYMMETRIC
    cmd = "cmp" if measure == "mash" else "dist"
    out = _both([cmd, "-k", str(K), "-H", "-b"] + FAMILIES[fam]
                + MEASURES[measure] + sketched[fam])
    got, want = (_mat(out[w][0], sym) for w in ("port", "jax"))
    _close(got, want, measure)
    _sizes_equal(out["port"][1], out["jax"][1])
    if measure == "ji":           # genome 1 and its byte copy: pair (1, 4)
        assert got[6] == 1.0


@pytest.mark.parametrize("fam", ["whll", "hmh", "smh"])
def test_dist_from_fasta_matches_jax(genomes, cpu_env, fam):
    """`dist -M -b` sketching the FASTAs, `-W` twice (cache files named
    and written as the JAX CLI's; the second run loads them), and `-y -c
    2`."""
    base = ["dist", "-k", str(K), "-S", str(S), "-M"] + FAMILIES[fam]
    out = _both(base + ["-b"] + genomes)
    _close(*(_mat(out[w][0], True) for w in ("port", "jax")), "mash")
    _sizes_equal(out["port"][1], out["jax"][1])
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


@pytest.mark.parametrize("fam", ["whll", "hmh", "smh"])
def test_query_and_nearest_neighbors_match_jax(genomes, tmp_path, cpu_env,
                                               fam):
    """`dist -Q` (TSV, and binary with -M and the .labels sidecar) and
    `--nearest-neighbors 2` with and without -Q (the wide HLL through the
    host k-NN, as in the JAX CLI): ids exactly, the byte copy of genome 1
    finding genome 1 at Jaccard 1."""
    q = tmp_path / "q.txt"
    q.write_text(genomes[4] + "\n" + genomes[3] + "\n")
    base = ["dist", "-k", str(K), "-S", "10", "--avoid-sorting"] \
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
    """union of .whll, .hmh and .bbs files (to a file and gzipped to
    stdout), view of every type and view --header byte for byte; fold of
    a .whll; card and cardcmp under each type flag; fold of a set sketch
    stops with the JAX CLI's message."""
    for fam in ("whll", "hmh", "smh"):
        for who, fn in (("jax", jmain.main), ("port", tmain.main)):
            assert fn(["union", "-o", f"{who}.u"] + sketched[fam][:3]) == 0
        assert _unzip("port.u") == _unzip("jax.u")
    files = [sketched[f][0] for f in sorted(FAMILIES)]
    for argv in (["view"] + files, ["view", "--header"] + files):
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0] and outs[1].count("\n") >= len(files)
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["fold", "-o", f"{who}.f", "-p", "9",
                   sketched["whll"][0]]) == 0
        assert fn(["fold", "-o", f"{who}.f1", sketched["whll"][1]]) == 0
    assert _unzip("port.f") == _unzip("jax.f")
    assert _unzip("port.f1") == _unzip("jax.f1")
    for fam in ("whll", "hmh", "smh"):
        for cmd in ("card", "cardcmp"):
            outs = []
            for fn in (jmain.main, tmain.main):
                assert fn([cmd, "-k", str(K), "-S", str(S)] + FAMILIES[fam]
                          + genomes[:3]) == 0
                outs.append(capsys.readouterr().out)
            if fam != "smh":     # each package's float32 MLE
                t, j = (np.array([float(l.split("\t")[1])
                                  for l in o.splitlines()[1:]])
                        for o in outs[::-1])
                np.testing.assert_allclose(t, j, rtol=1e-5)
            else:
                assert outs[1] == outs[0]
            assert outs[1].count("\n") == 4
    msgs = []
    for fn in (jmain.main, tmain.main):
        with pytest.raises(SystemExit) as e:
            fn(["fold", "-o", "f.out", sketched["hmh"][0]])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "no precision fold" in msgs[1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A FASTA of 12 records (pieces of two related sequences, so every
    pair shares k-mers)."""
    rng = np.random.default_rng(0xE72)
    root = tmp_path_factory.mktemp("extrarecs")
    anc = rng.integers(0, 4, 5000).astype(np.uint8)
    other = anc.copy()
    hit = np.flatnonzero(rng.random(other.size) < 0.02)
    other[hit] = (other[hit] + 1) & 3
    body = b""
    for i in range(12):
        src = LUT[(anc, other)[i % 2]]
        s0 = int(rng.integers(0, 800))
        body += b">r%d x\n%s\n" % (i, src[s0:s0 + int(rng.integers(
            2500, 4000))].tobytes())
    (root / "recs.fa").write_bytes(body)
    return str(root / "recs.fa")


@pytest.mark.parametrize("fam", ["whll", "hmh", "smh"])
def test_by_seq_matches_jax(records, cpu_env, fam):
    """`sketch_by_seq` under the type flag (and `-b -n 2`): streams and
    .names equal.  dist_by_seq has no letter for these types in either
    CLI, so its read of such a stream stops with the same message."""
    flags = ["-k", str(K), "-S", "10"] + FAMILIES[fam]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["sketch_by_seq"] + flags + ["-o", f"{who}.sbs",
                                               records]) == 0
        assert fn(["sbs"] + flags + ["-b", "-n", "2", "-o", f"{who}.f.sbs",
                                     records]) == 0
    for suffix in (".sbs", ".f.sbs"):
        assert _unzip("port" + suffix) == _unzip("jax" + suffix)
        assert (open("port" + suffix + ".names").read()
                == open("jax" + suffix + ".names").read())
    msgs = []
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        with pytest.raises(SystemExit) as e:
            fn(["dist_by_seq", "-n", f"{who}.sbs.names", "-o",
                f"{who}.dbs", f"{who}.sbs"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "bad HLL magic" in msgs[1]


def test_mkdist_with_type_matches_jax(genomes, cpu_env):
    """mkdist under --use-wide-hll: no fused presketch (the per-k passes
    sketch, as in the JAX CLI); the flattened matrices at rtol 1e-4."""
    assert tmain._mkdist_presketch(["--use-wide-hll"] + genomes, [15, 17],
                                   torch.device("cpu")) == (None, None)
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["mkdist", "--multik", f"{who}mk,15,19,2", "-S", str(S),
                   "--use-wide-hll"] + genomes[:3]) == 0
    (tn, tk, tv), (jn, jk, jv) = (distmat.read_flattened(f"{w}mk.bin")
                                  for w in ("port", "jax"))
    assert tn == jn == 3 and list(tk) == list(jk) == [15, 17]
    _close(tv, jv, "ji")


def test_densified_files_and_stale_cache(genomes, cpu_env, capfd):
    """A DTPUSMH1 file (JAX DensifiedMinHash) loads under
    --use-superminhash and compares as in the JAX CLI; under -W such a
    cache file is rebuilt and overwritten in the DTPUSMH2 format, with the
    JAX CLI's note word for word."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 2 ** 62, 3000, dtype=np.uint64)
    files = []
    for i in range(3):
        sk = jx.DensifiedMinHash(10, 16)
        sk.addh_np(base[:2000 + 400 * i])
        sk.write(f"d{i}.bbs")
        files.append(f"d{i}.bbs")
    out = _both(["dist", "-k", str(K), "-H", "-M", "-b",
                 "--use-superminhash"] + files)
    _close(*(_mat(out[w][0], True) for w in ("port", "jax")), "mash")
    assert open(out["port"][1]).read() == open(out["jax"][1]).read()
    for argv in (["view", files[0]], ["view", "--header", files[0]]):
        capfd.readouterr()
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(list(argv)) == 0
            outs.append(capfd.readouterr().out)
        assert outs[1] == outs[0]
        assert outs[1].startswith("DensifiedMinHash") or \
            "magic=DTPUSMH1" in outs[1]
    capfd.readouterr()
    flags = ["dist", "-k", str(K), "-S", str(S), "--use-superminhash", "-W"]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(f"c_{who}")
        o = tmain.core.CommonOpts(k=K, sketch_size=S, prefix=f"c_{who}",
                                  sketch_type="superminhash")
        stale = tmain.core._cache_fname(genomes[0], o)
        jx.DensifiedMinHash(11, 16).write(stale)
        assert fn(flags + ["-P", f"c_{who}", "-O", f"{who}.W"]
                  + genomes[:2]) == 0
        assert isinstance(jx.SuperMinHash.read(stale), jx.SuperMinHash)
    notes = [l for l in capfd.readouterr().err.splitlines()
             if l.startswith("Note: rebuilding stale DTPUSMH1")]
    assert len(notes) == 2 and notes[0].replace("c_jax", "c_port") == notes[1]
    for nm in os.listdir("c_port"):
        assert _unzip(f"c_port/{nm}") == _unzip(f"c_jax/{nm}")


def test_messages_word_for_word(genomes, cpu_env, capfd):
    """Mixed HyperMinHash register widths and mixed SuperMinHash b at one
    p, a wide HLL beside an HLL, and a .whll under the default type (the
    note) give the JAX CLI's messages."""
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        for tag, flags in (("h8", ["--use-hyperminhash", "-B", "8", "-S",
                                   "11"]),
                           ("h16", ["--use-hyperminhash", "-S", "12"]),
                           ("s8", ["--use-superminhash", "-B", "8", "-S",
                                   "11"]),
                           ("s16", ["--use-superminhash", "-S", "12"]),
                           ("w", ["--use-wide-hll", "-S", "11"]),
                           ("h", ["-S", "11"])):
            assert fn(["sketch", "-k", str(K), "-o", f"{who}.{tag}"]
                      + flags + genomes[:1]) == 0
    cases = [
        (["-H", "{}.h8", "{}.h16"], "regwidth"),
        (["-H", "{}.s8", "{}.s16"], "register widths"),
    ]
    for argv, what in cases:
        msgs = []
        for who, fn in (("jax", jmain.main), ("port", tmain.main)):
            for path in argv[1:]:
                shutil.copyfile(path.format(who), path.format(who) + "x")
            with pytest.raises(SystemExit) as e:
                fn(["dist", "-O", "x.out"]
                   + [a.format(who) + ("x" if "{}" in a else "")
                      for a in argv])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0] and what in msgs[1], msgs
    msgs = []
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        shutil.copyfile(f"{who}.w", f"{who}.w.whll")
        shutil.copyfile(f"{who}.h", f"{who}.h.hll")
        with pytest.raises(SystemExit) as e:
            fn(["dist", "-H", "-O", "x.out", f"{who}.w.whll",
                f"{who}.h.hll"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "mixed sketch types" in msgs[1]
    notes = [l for l in capfd.readouterr().err.splitlines()
             if l.startswith("Note:")]
    jn = [l for l in notes if "jax." in l]
    tn = [l.replace("port.", "jax.") for l in notes if "port." in l]
    assert len(jn) == 5 and tn == jn
    assert any("is a .whll sketch; loading as wide_hll (requested hll)" in l
               for l in jn)


def test_superminhash_b64(genomes, cpu_env):
    """-B 64: `sketch` writes the JAX CLI's bytes; the JAX CLI's compare
    dies on an OverflowError, the port's stops by name."""
    flags = ["-k", str(K), "-S", "10", "--use-superminhash", "-B", "64"]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["sketch", "-o", f"{who}.s"] + flags + genomes[:2]) == 0
    assert _unzip("port.s") == _unzip("jax.s")
    with pytest.raises(OverflowError):
        jmain.main(["dist", "-O", "j.out"] + flags + genomes[:2])
    with pytest.raises(SystemExit, match="b=64 cannot be compared"):
        tmain.main(["dist", "-O", "t.out"] + flags + genomes[:2])
