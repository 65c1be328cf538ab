"""The port's count-min filtered `sketch`/`dist` and its HLL subcommands
(card, cardcmp, hll, union, view, fold, printmat, flatten) against the
JAX CLI on the CPU: sketch records equal (compared decompressed, since a
gzip header carries a write time), `dist -y` matrices at rtol 1e-4 (the
bar of test_torch_slice.test_dist_matches_jax_cli), cardinalities at
rtol 1e-5, and the text and matrix outputs byte for byte."""
import gzip
import io
import os
import struct

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu.io import distmat
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.sketch.khset import KSet

torch.set_num_threads(1)
K, S = 21, 12
LUT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def readsets(tmp_path_factory):
    """Three FASTQ read sets (~8x, 0.5 % substitution errors, half the
    reads reverse-complemented) of genomes 0 %, 1 % and 3 % away from one
    6 kbp ancestor, and two FASTAs of the first two genomes."""
    rng = np.random.default_rng(0xC3)
    root = tmp_path_factory.mktemp("reads")
    anc = rng.integers(0, 4, 6000).astype(np.uint8)
    fq, fa = [], []
    for i, rate in enumerate((0.0, 0.01, 0.03)):
        g = anc.copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size)) & 3
        starts = rng.integers(0, g.size - 100, 480)
        codes = g[starts[:, None] + np.arange(100)]
        flip = rng.random(starts.size) < 0.5
        codes[flip] = 3 - codes[flip, ::-1]
        err = rng.random(codes.shape) < 0.005
        codes[err] = (codes[err] + rng.integers(1, 4, err.sum())) & 3
        path = root / f"r{i}.fq"
        path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (
            j, LUT[c].tobytes(), b"I" * 100) for j, c in enumerate(codes)))
        fq.append(str(path))
        if i < 2:
            path = root / f"g{i}.fa"
            path.write_bytes(b">g%d\n%s\n" % (i, LUT[g].tobytes()))
            fa.append(str(path))
    return fq, fa


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")


def _records(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def _both(tmp_path, args, inputs):
    """Run `sketch` through both CLIs into their own directories; the
    file names and the decompressed records must be equal."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir(parents=True)
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + inputs) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + inputs) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and names
    recs = {}
    for nm in names:
        want = _records(tmp_path / "jax" / nm)
        assert _records(tmp_path / "port" / nm) == want, nm
        recs[nm] = np.frombuffer(want[16:], np.uint8)
    return recs


def test_sketch_countmin_records_equal_jax(readsets, tmp_path, cpu_env):
    """sketch -b -n 2 (every file filtered), -f -n 3 (the FASTQ names
    only), and -b -n 2 -o (one stream)."""
    fq, fa = readsets
    base = ["sketch", "-k", str(K), "-S", str(S)]
    filt = _both(tmp_path / "b", base + ["-b", "-n", "2"], fq + fa[:1])
    plain = _both(tmp_path / "plain", base, fq + fa)
    for nm, regs in filt.items():
        assert (regs <= plain[nm]).all()
        # the read sets lose their error k-mers; a genome has no repeats
        assert regs.sum() < plain[nm].sum() or not regs.any(), nm
    byname = _both(tmp_path / "f", base + ["-f", "-n", "3"], fq + fa)
    for nm, regs in byname.items():
        assert (np.array_equal(regs, plain[nm])
                if ".fa." in nm else regs.sum() < plain[nm].sum()), nm
    jo, to = str(tmp_path / "j.stream"), str(tmp_path / "t.stream")
    assert jmain.main(base + ["-b", "-n", "2", "-o", jo] + fq) == 0
    assert tmain.main(base + ["-b", "-n", "2", "-o", to] + fq) == 0
    assert _records(to) == _records(jo)
    assert _records(to + ".labels.gz") == _records(jo + ".labels.gz")


def _dist(fn, args, tmp_path, tag):
    dists, sizes = str(tmp_path / f"{tag}.bin"), str(tmp_path / f"{tag}.txt")
    assert fn(args + ["-O", dists, "-o", sizes]) == 0
    rows = [l.split("\t") for l in open(sizes).read().splitlines()[1:]]
    return distmat.read_binary(dists), np.array([float(r[1]) for r in rows])


# the three spellings of the count-min filter that the port refused before
# it had one
@pytest.mark.parametrize("extra", [["--countmin"], ["-c", "3", "-y"], ["-y"]])
def test_dist_countmin_matches_jax_cli(readsets, tmp_path, cpu_env, extra):
    fq, _ = readsets
    args = ["dist", "-k", str(K), "-S", str(S), "-M", "-b", "-t", "18"] \
        + extra + fq
    (nj, mj), sj = _dist(jmain.main, args, tmp_path, "jax")
    (nt, mt), st = _dist(tmain.main, args, tmp_path, "port")
    assert nj == nt == 3 and np.isfinite(mt).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1.0)
    (_, plain), sp = _dist(tmain.main, [a for a in args if a not in extra],
                           tmp_path, "plain")
    # fewer k-mers (the read errors') and closer read sets
    assert (st < sp).all() and (mt < plain).all()


def _card_lines(text):
    lines = text.splitlines()
    assert lines[0] == "#Path\tSize (est.)"
    rows = [l.split("\t") for l in lines[1:]]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


@pytest.mark.parametrize("cmd", ["card", "cardcmp"])
def test_card_matches_jax_cli(readsets, tmp_path, cpu_env, capsys, cmd):
    """Text (fixed and -e scientific) at rtol 1e-5, -b float32 the same;
    -y filters here too."""
    fq, fa = readsets
    base = [cmd, "-k", str(K), "-S", str(S)]
    for extra in ([], ["-e"], ["-y", "-c", "2"]):
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(base + extra + fq + fa) == 0
            outs.append(capsys.readouterr().out)
        (nj, cj), (nt, ct) = map(_card_lines, outs)
        assert nt == nj and len(nt) == 5
        np.testing.assert_allclose(ct, cj, rtol=1e-5)
        fmt = "{:0.12g}" if extra == ["-e"] else "{:0.8f}"
        for line in outs[1].splitlines()[1:]:
            val = line.split("\t")[1]
            assert val == fmt.format(float(val)), line
    cards = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        out = str(tmp_path / f"{tag}.bin")
        assert fn(base + ["-b", "-o", out, "-Q", _list(tmp_path, fa[:1])]
                  + fq) == 0
        cards[tag] = np.fromfile(out, np.float32)
    assert cards["port"].shape == (4,) and (cards["port"] > 1000).all()
    np.testing.assert_allclose(cards["port"], cards["jax"], rtol=1e-5)


def _list(tmp_path, paths):
    f = tmp_path / "paths.txt"
    f.write_text("".join(p + "\n" for p in paths))
    return str(f)


def test_hll_matches_jax_cli(readsets, cpu_env, capsys):
    fq, fa = readsets
    outs = []
    for fn in (jmain.main, tmain.main):
        assert fn(["hll", "-k", str(K), "-S", str(S)] + fq + fa) == 0
        outs.append(capsys.readouterr().out.strip())
    pre = "Estimated number of unique exact matches: "
    assert all(o.startswith(pre) for o in outs), outs
    est = [float(o[len(pre):]) for o in outs]
    np.testing.assert_allclose(est[1], est[0], rtol=1e-5)
    assert 10000 < est[1] < 100000


@pytest.fixture(scope="module")
def sketches(readsets, tmp_path_factory):
    """The port's p=12 sketches of the read sets, one per file, and one
    at p=14."""
    fq, _ = readsets
    root = tmp_path_factory.mktemp("sk")
    os.environ["DASHING_TPU_TORCH_DEVICE"] = "cpu"
    try:
        assert tmain.main(["sketch", "-k", str(K), "-S", str(S), "-P",
                           str(root)] + fq) == 0
        assert tmain.main(["sketch", "-k", str(K), "-S", "14", "-P",
                           str(root), fq[0]]) == 0
    finally:
        del os.environ["DASHING_TPU_TORCH_DEVICE"]
    names = sorted(os.listdir(root))
    return ([str(root / n) for n in names if n.endswith(".12.hll")],
            [str(root / n) for n in names if n.endswith(".14.hll")][0])


def test_union_matches_jax_cli(sketches, tmp_path, capsysbinary):
    """To a file (-Z 9 too) and to stdout, gzipped both ways: the records
    equal, and equal to the register max."""
    hlls, _ = sketches
    for extra in ([], ["-Z", "9"]):
        for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
            assert fn(["union", "-o", str(tmp_path / f"{tag}.hll")] + extra
                      + hlls) == 0
        assert (_records(tmp_path / "port.hll")
                == _records(tmp_path / "jax.hll"))
    blobs = []
    for fn in (jmain.main, tmain.main):
        assert fn(["union", "-F", _list(tmp_path, hlls)]) == 0
        blobs.append(capsysbinary.readouterr().out)
    assert blobs[1][:2] == b"\x1f\x8b"
    got = gzip.GzipFile(fileobj=io.BytesIO(blobs[1])).read()
    assert got == gzip.GzipFile(fileobj=io.BytesIO(blobs[0])).read()
    want = np.max([np.frombuffer(_records(h)[16:], np.uint8) for h in hlls],
                  axis=0)
    np.testing.assert_array_equal(np.frombuffer(got[16:], np.uint8), want)


def test_union_refusals(sketches, tmp_path):
    """-H, -r and -b, refused until their families were ported, ask for
    k-mer hash set, bottom-k and Bloom filter files: -H merges two `.khs`
    files into the union of their keys, as the JAX CLI does; on HLL files
    each stops with the JAX CLI's type-mismatch message, word for word
    (test_torch_setsketch_cli.py and test_torch_khset.py merge real
    ones).  An HLL and a Bloom filter stop as mixed types (the JAX CLI
    fails there on a missing attribute); HLLs of two precisions as
    before."""
    hlls, p14 = sketches
    rng = np.random.default_rng(0x4B)
    sets = []
    for i in range(2):
        sets.append(str(tmp_path / f"s{i}.khs"))
        KSet(rng.integers(0, 1 << 64, 300, dtype=np.uint64,
                          endpoint=False)).write(sets[-1])
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        assert fn(["union", "-H", "-o", str(tmp_path / f"{tag}.khs")]
                  + sets) == 0
    got = KSet.read(str(tmp_path / "port.khs"))
    np.testing.assert_array_equal(got.keys, KSet.read(str(
        tmp_path / "jax.khs")).keys)
    np.testing.assert_array_equal(got.keys, np.union1d(
        KSet.read(sets[0]).keys, KSet.read(sets[1]).keys))
    for flag in (["-r"], ["-b", "x"], ["-H"]):
        msgs = []
        for fn in (jmain.main, tmain.main):
            with pytest.raises(SystemExit) as e:
                fn(["union", "-o", str(tmp_path / "u.x")] + flag + hlls)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0] and "explicitly requested" in msgs[1]
    other = str(tmp_path / "bf.bf")
    with gzip.open(other, "wb") as fp:
        fp.write(b"DTPUBF01" + struct.pack("<II", 10, 3) + bytes(1024))
    with pytest.raises(SystemExit, match="mixed sketch types"):
        tmain.main(["union", "-o", str(tmp_path / "u.hll"), hlls[0], other])
    with pytest.raises(SystemExit, match="different p"):
        tmain.main(["union", "-o", str(tmp_path / "u.hll"), hlls[0], p14])


def test_fold_and_view_equal_jax_cli(sketches, tmp_path, capsys):
    """fold -p 10 (and the default p - 1) records equal; view and view
    --header byte for byte, the header over every DTPU family's table."""
    hlls, p14 = sketches
    for extra in (["-p", "10"], []):
        for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
            assert fn(["fold", "-o", str(tmp_path / f"{tag}.hll")] + extra
                      + [p14]) == 0
        got = _records(tmp_path / "port.hll")
        assert got == _records(tmp_path / "jax.hll")
        assert got[8] == (10 if extra else 13)
    containers = [p14, str(tmp_path / "port.hll")]
    for magic, fields in ((b"DTPUBF01", (12, 2)), (b"DTPUSMH2", (10, 8)),
                          (b"DTPUWHL1", (11, 0x0302))):
        path = str(tmp_path / f"{magic.decode()}.bin")
        with gzip.open(path, "wb") as fp:
            fp.write(magic + struct.pack("<II", *fields) + bytes(77))
        containers.append(path)
    for argv in (["view", p14], ["view", "--header"] + containers,
                 ["view", "-H"] + containers[:2]):
        outs = []
        for fn in (jmain.main, tmain.main):
            assert fn(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0] and outs[1], argv
    # a Bloom filter header over a truncated payload: the port, which
    # refused the family before it read it, now stops as the JAX CLI does
    msgs = []
    for fn in (jmain.main, tmain.main):
        with pytest.raises(SystemExit) as e:
            fn(["view", containers[2]])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "truncated bloom filter" in msgs[1]


def test_printmat_and_flatten_equal_jax_cli(readsets, tmp_path, cpu_env,
                                            capsys):
    """printmat (fixed and -s) and flatten byte for byte, on the port's
    own `dist -b` matrices at two k."""
    fq, fa = readsets
    mats = []
    for k in (15, 21):
        mats.append(str(tmp_path / f"d{k}.bin"))
        assert tmain.main(["dist", "-k", str(k), "-S", str(S), "-b", "-O",
                           mats[-1]] + fq + fa) == 0
    capsys.readouterr()
    for extra in ([], ["-s"]):
        outs = []
        for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
            out = str(tmp_path / f"{tag}.txt")
            assert fn(["printmat", mats[1], "-o", out] + extra) == 0
            outs.append(open(out, "rb").read())
        assert outs[1] == outs[0] and outs[1].count(b"\n") >= 5
    flat = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        flat[tag] = str(tmp_path / f"{tag}.flat")
        assert fn(["flatten", "-o", flat[tag], "-k", "15,21"] + mats) == 0
    assert open(flat["port"], "rb").read() == open(flat["jax"], "rb").read()
    nsets, ks, data = distmat.read_flattened(flat["port"])
    assert nsets == 5 and list(ks) == [15, 21] and data.shape == (10, 2)
