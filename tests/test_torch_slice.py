"""The port's CLI slice end to end on the CPU, against the JAX CLI:
`sketch` files equal record for record (with -J too, and under spaced
seeds, minimizer windows, entropy minimizers, ntHash and the cyclic hash),
`dist -M -b` matrices and `-o` sizes within stated tolerances (with the
joint MLE and those encodings too), JAX-written sketches read back by the
port, no import of jax or of the JAX package anywhere in the port, and no
silent CPU fallback."""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dashing_tpu import u64
from dashing_tpu.cli import main as jmain
from dashing_tpu.io import distmat
from dashing_tpu.ops import encode as jenc
from dashing_tpu_torch import device as devmod
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.ops.encode import entropy_table
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 21, 12
RATES = (0.0, 0.004, 0.01, 0.02, 0.03, 0.05)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """6 FASTAs of 20-50 kbp from one ancestor at planted substitution
    rates (so no pair is near-disjoint): several records each, N runs,
    a lowercase record, one gzipped file."""
    rng = np.random.default_rng(0xDA5)
    root = tmp_path_factory.mktemp("genomes")
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, 50000, dtype=np.uint8)
    paths = []
    for i, rate in enumerate(RATES):
        g = anc[:int(rng.integers(20000, 50000))].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
        seq = lut[g]
        seq[1000:1000 + 40 * (i + 1)] = ord("N")
        cuts = np.linspace(0, seq.size, 4).astype(int)
        body = b"".join(
            b">g%d_r%d\n%s\n" % (i, r, (seq[cuts[r]:cuts[r + 1]] | (
                0x20 if r == 1 else 0)).tobytes())
            for r in range(3))
        if i == 2:
            path = root / f"g{i}.fa.gz"
            path.write_bytes(gzip.compress(body))
        else:
            path = root / f"g{i}.fa"
            path.write_bytes(body)
        paths.append(str(path))
    return paths


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")


def _sizes(path):
    rows = [l.split("\t") for l in open(path).read().splitlines()[1:]]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def _records(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def test_sketch_files_identical(genomes, tmp_path, cpu_env):
    """Same file names, and the same DTPUHLL1 bytes inside each gzip
    member (the member headers carry a write time and a temporary file
    name, so the compressed files themselves cannot match)."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["sketch", "-k", str(K), "-S", str(S)]
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + genomes) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + genomes) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for nm in names:
        want = _records(tmp_path / "jax" / nm)
        assert _records(tmp_path / "port" / nm) == want, nm
        assert len(want) == 16 + (1 << S)
    # one -o stream of all sketches
    jo, to = str(tmp_path / "j.stream"), str(tmp_path / "t.stream")
    assert jmain.main(args + ["-o", jo] + genomes) == 0
    assert tmain.main(args + ["-o", to] + genomes) == 0
    assert _records(to) == _records(jo)
    assert _records(to + ".labels.gz") == _records(jo + ".labels.gz")


def test_dist_matches_jax_cli(genomes, tmp_path, cpu_env):
    args = ["dist", "-k", str(K), "-S", str(S), "-M", "-b"]
    outs = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        dists, sizes = str(tmp_path / f"{tag}.bin"), str(tmp_path / f"{tag}.txt")
        assert fn(args + ["-O", dists, "-o", sizes] + genomes) == 0
        outs[tag] = distmat.read_binary(dists), _sizes(sizes)
        assert open(dists + ".labels").read().count("\n") == 6
    (nj, mj), (names_j, sj) = outs["jax"]
    (nt, mt), (names_t, st) = outs["port"]
    assert nj == nt == 6 and names_t == names_j
    assert np.isfinite(mt).all() and (mt > 0).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)
    # sizes are float32 estimates truncated to integers: allow the
    # truncation step on top of rtol=1e-5
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1.0)


def test_jax_sketches_load_into_port(genomes, tmp_path, cpu_env):
    """A .hll written by the JAX package loads with identical registers,
    writes back the same bytes, and `dist --presketched` on it gives the
    port's own matrix for the FASTAs."""
    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert jmain.main(["sketch", "-k", str(K), "-S", str(S), "-P", str(jdir),
                       "--avoid-sorting"] + genomes) == 0
    hlls = [str(jdir / (os.path.basename(g) + f".w.{K}.spacing.{S}.hll"))
            for g in genomes]
    sk = HLL.read(hlls[0])
    again = str(tmp_path / "again.hll")
    sk.write(again)
    assert _records(again) == _records(hlls[0])
    wide = sk.regs.astype(np.int32)
    wide[0] = 300                      # clamped to the uint8 range
    made = HLL.from_numpy(wide, sk.p, sk.estim, sk.jestim)
    assert made.regs[0] == 255
    np.testing.assert_array_equal(made.regs[1:], sk.regs[1:])

    pre, own = str(tmp_path / "pre.bin"), str(tmp_path / "own.bin")
    assert tmain.main(["dist", "-k", str(K), "-M", "-b", "-O", pre, "-H"]
                      + hlls) == 0
    assert tmain.main(["dist", "-k", str(K), "-S", str(S), "-M", "-b",
                       "-O", own, "--avoid-sorting"] + genomes) == 0
    np.testing.assert_array_equal(distmat.read_binary(pre)[1],
                                  distmat.read_binary(own)[1])


def test_sketch_joint_files_identical(genomes, tmp_path, cpu_env):
    """`sketch -J` writes jestim = 3 into the DTPUHLL1 header, byte for
    byte as the JAX CLI does."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["sketch", "-k", str(K), "-S", str(S), "-J"]
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + genomes) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + genomes) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for nm in names:
        want = _records(tmp_path / "jax" / nm)
        assert _records(tmp_path / "port" / nm) == want, nm
        assert want[8:11] == bytes([S, 2, 3])        # p, estim, jestim


def test_dist_joint_matches_jax_cli(genomes, tmp_path, cpu_env):
    """`dist -J`: the joint MLE through both CLIs; the -o sizes stay on
    the MLE estimator."""
    args = ["dist", "-k", str(K), "-S", str(S), "-J", "-M", "-b"]
    outs = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        dists, sizes = str(tmp_path / f"{tag}.bin"), str(tmp_path / f"{tag}.txt")
        assert fn(args + ["-O", dists, "-o", sizes] + genomes) == 0
        outs[tag] = distmat.read_binary(dists), _sizes(sizes)
    (nj, mj), (names_j, sj) = outs["jax"]
    (nt, mt), (names_t, st) = outs["port"]
    assert nj == nt == 6 and names_t == names_j
    assert np.isfinite(mt).all() and (mt > 0).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1.0)
    plain = str(tmp_path / "plain.bin")
    assert tmain.main(["dist", "-k", str(K), "-S", str(S), "-M", "-b",
                       "-O", plain] + genomes) == 0
    assert not np.array_equal(distmat.read_binary(plain)[1], mt)


def test_jax_joint_sketches_load_into_port(genomes, tmp_path, cpu_env):
    """`sketch -J` files of the JAX package load into the port unchanged:
    `dist -H -J` on them equals the port's own `dist -J` on the FASTAs."""
    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert jmain.main(["sketch", "-k", str(K), "-S", str(S), "-J", "-P",
                       str(jdir), "--avoid-sorting"] + genomes) == 0
    hlls = [str(jdir / (os.path.basename(g) + f".w.{K}.spacing.{S}.hll"))
            for g in genomes]
    assert HLL.read(hlls[0]).jestim == 3
    pre, own = str(tmp_path / "pre.bin"), str(tmp_path / "own.bin")
    assert tmain.main(["dist", "-k", str(K), "-J", "-M", "-b", "-O", pre,
                       "-H"] + hlls) == 0
    assert tmain.main(["dist", "-k", str(K), "-S", str(S), "-J", "-M", "-b",
                       "-O", own, "--avoid-sorting"] + genomes) == 0
    np.testing.assert_array_equal(distmat.read_binary(pre)[1],
                                  distmat.read_binary(own)[1])


# the encodings of the ASCII-tile route, as `sketch` spells them (`dist`
# takes -g for --by-entropy)
ENCODINGS = [["-s", "1x4"], ["-w", "40"], ["--by-entropy", "-w", "40"],
             ["--use-nthash", "-k", "40"], ["--use-cyclic-hash"]]


@pytest.fixture()
def jax_entropy_by_table(monkeypatch):
    """The JAX package's entropy minimizer with its float32 score taken
    from the port's table by base composition (the JAX formula evaluated
    op by op; tests/test_torch_encodings.py holds the two equal), and
    everything else (counts, window keys, sliding min, gather, emission)
    the JAX package's own code.  Jitted, XLA rounds the formula
    differently where it fuses it into the sliding min and can break
    near-ties another way; with the score fixed the rest of the route is
    held bitwise."""
    def table_scored(km, wvalid, code, positions, win):
        k = len(positions)
        W = km[0].shape[-1]
        counts = [jnp.zeros(km[0].shape, jnp.int32) for _ in range(3)]
        for p in positions:
            c_t = code[..., p:p + W]
            for b in range(3):
                counts[b] = counts[b] + (c_t == b).astype(jnp.int32)
        idx = (counts[0] * (k + 1) + counts[1]) * (k + 1) + counts[2]
        entq = jnp.asarray(entropy_table(k).astype(np.uint32))[idx]
        offs = jax.lax.broadcasted_iota(jnp.uint32, km[0].shape,
                                        km[0].ndim - 1)
        key_hi = jnp.where(wvalid, entq, jnp.uint32(0xFFFFFFFF))
        best = jenc.sliding_min((key_hi, offs), win)
        sel = best[1].astype(jnp.int32)
        hi = jnp.take_along_axis(km[0], sel, axis=-1)
        lo = jnp.take_along_axis(km[1], sel, axis=-1)
        bad = best[0] == jnp.uint32(0xFFFFFFFF)
        sent = u64.full(hi.shape, jenc._SENTINEL)
        return jnp.where(bad, sent[0], hi), jnp.where(bad, sent[1], lo)

    monkeypatch.setattr(jenc, "_entropy_sliding_min", table_scored)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("extra", ENCODINGS)
def test_sketch_encodings_identical(genomes, tmp_path, cpu_env,
                                   jax_entropy_by_table, extra):
    """The ASCII-tile route: same file names (the -s spacing and the nt. /
    cyclic. infixes included) and the same DTPUHLL1 bytes."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["sketch", "-k", str(K), "-S", str(S)] + extra
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + genomes) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + genomes) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    infix = {"--use-nthash": ".nt.", "--use-cyclic-hash": ".cyclic.",
             "-s": ".spacing1x4."}.get(extra[0], ".spacing.")
    assert all(infix in nm for nm in names), names
    for nm in names:
        want = _records(tmp_path / "jax" / nm)
        assert _records(tmp_path / "port" / nm) == want, nm


@pytest.mark.parametrize("extra", ENCODINGS)
def test_dist_encodings_match_jax_cli(genomes, tmp_path, cpu_env,
                                      jax_entropy_by_table, extra):
    extra = ["-g" if e == "--by-entropy" else e for e in extra]
    args = ["dist", "-k", str(K), "-S", str(S), "-M", "-b"] + extra
    mats = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        dists = str(tmp_path / f"{tag}.bin")
        assert fn(args + ["-O", dists] + genomes) == 0
        mats[tag] = distmat.read_binary(dists)
    (nj, mj), (nt, mt) = mats["jax"], mats["port"]
    assert nj == nt == 6 and np.isfinite(mt).all() and (mt > 0).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)


def test_entropy_near_unpatched_jax_cli(genomes, tmp_path, cpu_env):
    """-g against the JAX CLI as it ships (jitted, its own float32 score):
    the two break near-ties differently, and this bounds how far that
    goes.  Same file names and headers; registers differ in at most 2 of
    the 4096 places of a sketch, by at most 2 ranks; the Mash distances
    then agree at rtol 2e-3 (a changed register moves an HLL estimate by
    about 1/4096; these inputs give one changed register and 6.2e-4)."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["sketch", "-k", str(K), "-S", str(S), "--by-entropy", "-w", "40"]
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + genomes) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + genomes) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for nm in names:
        want = np.frombuffer(_records(tmp_path / "jax" / nm), np.uint8)
        got = np.frombuffer(_records(tmp_path / "port" / nm), np.uint8)
        assert got.shape == want.shape == (16 + (1 << S),)
        assert bytes(got[:16]) == bytes(want[:16]), nm
        diff = np.abs(got[16:].astype(np.int32) - want[16:])
        assert (diff > 0).sum() <= 2 and diff.max() <= 2, (nm, diff.max())
    mats = {}
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        dists = str(tmp_path / f"{tag}.bin")
        assert fn(["dist", "-k", str(K), "-S", str(S), "-M", "-b", "-g", "-w",
                   "40", "-O", dists] + genomes) == 0
        mats[tag] = distmat.read_binary(dists)
    (nj, mj), (nt, mt) = mats["jax"], mats["port"]
    assert nj == nt == 6 and np.isfinite(mt).all() and (mt > 0).all()
    np.testing.assert_allclose(mt, mj, rtol=2e-3, atol=1e-6)


def test_encoding_guards_match_jax_cli(genomes, cpu_env):
    """The JAX CLI's refusals of k and encoding combinations, word for
    word."""
    for extra in (["-k", "33"], ["-k", "40", "-s", "1x2", "--use-nthash"],
                  ["-s", "1x2", "--use-cyclic-hash"],
                  ["-g", "--use-nthash"]):
        msgs = []
        for fn in (jmain.main, tmain.main):
            with pytest.raises(SystemExit) as e:
                fn(["dist"] + extra + genomes[:2])
            msgs.append(str(e.value.code))
        assert msgs[0] == msgs[1], msgs


_BLOCKED_RUN = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "dashing_tpu")   # dashing_tpu_torch stays
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import blocked: {name}")
        return None

sys.meta_path.insert(0, NoJax())
from dashing_tpu_torch.cli.main import main
rc = main(["dist", "-k", "15", "-S", "10", "-M", "-o", sys.argv[1],
           "-O", sys.argv[2]] + sys.argv[3:])
rc |= main(["dist", "-k", "15", "-S", "10", "-J", "-O", sys.argv[2] + ".J"]
           + sys.argv[3:])
rc |= main(["dist", "-k", "15", "-S", "10", "-w", "30", "-O",
            sys.argv[2] + ".w"] + sys.argv[3:])
rc |= main(["dist", "-k", "40", "-S", "10", "--use-nthash", "-O",
            sys.argv[2] + ".nt"] + sys.argv[3:])
rc |= main(["dist", "-k", "15", "-S", "10", "-8", "-O", sys.argv[2] + ".bb"]
           + sys.argv[3:])
rc |= main(["dist", "-k", "15", "-S", "10", "--use-range-minhash", "-O",
            sys.argv[2] + ".rmh"] + sys.argv[3:])
for flags, ext in ((["--use-wide-hll"], "whll"),
                   (["--use-hyperminhash"], "hmh"),
                   (["--use-superminhash"], "smh"),
                   (["--use-full-khash-sets"], "khs"),
                   (["--wj-exact", "--use-wide-hll"], "wjw")):
    rc |= main(["dist", "-k", "15", "-S", "10", "-O",
                sys.argv[2] + "." + ext] + flags + sys.argv[3:])
import glob, os
sk = os.path.join(os.path.dirname(sys.argv[2]), "sk")
os.mkdir(sk)
rc |= main(["sketch", "-k", "15", "-S", "10", "-b", "-n", "2", "-P", sk]
           + sys.argv[3:])
os.environ["DASHING_TPU_USE_HK"] = "1"
rc |= main(["sketch", "-k", "15", "--use-full-khash-sets", "-b", "-n", "2",
            "-P", sk] + sys.argv[3:])
del os.environ["DASHING_TPU_USE_HK"]
rc |= main(["union", "-H", "-o", sys.argv[2] + ".khs.union"]
           + sorted(glob.glob(os.path.join(sk, "*.khs"))))
rc |= main(["hll", "-k", "15", "-S", "12"] + sys.argv[3:])
rc |= main(["card", "-k", "15", "-S", "10", "-o", sys.argv[2] + ".card"]
           + sys.argv[3:])
rc |= main(["union", "-o", sys.argv[2] + ".union"]
           + sorted(glob.glob(os.path.join(sk, "*.hll"))))
rc |= main(["sketch", "-k", "15", "-S", "10", "--wj-exact", "-P", sk]
           + sys.argv[3:4])
ref = glob.glob(os.path.join(sk, os.path.basename(sys.argv[3]) + "*.hll"))[0]
rc |= main(["readfilt", "-k", "15", "-s", ref, "-f", "0.0", "-o",
            sys.argv[2] + ".rf", sys.argv[3]])
import chip_smoke, chip_profile  # noqa: F401  (import-time only)
import dashing_tpu_torch.sketch.sparse  # noqa: F401
import dashing_tpu_torch.sketch.weighted  # noqa: F401
import dashing_tpu_torch.sketch.batch_compare  # noqa: F401
import dashing_tpu_torch.sketch.extra  # noqa: F401
import dashing_tpu_torch.sketch.khset  # noqa: F401
import dashing_tpu_torch.parallel.distributed  # noqa: F401
import dashing_tpu_torch.parallel.mesh  # noqa: F401
from dashing_tpu_torch.sketch.heavykeeper import HeavyKeeper
assert HeavyKeeper(2, 8).native
import torch
from dashing_tpu_torch.hashes import clhash
assert clhash(torch.arange(8)).unique().numel() == 8
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert rc == 0 and not leaked, (rc, leaked)
print("NOJAX-OK")
"""


def test_port_never_imports_jax(genomes, tmp_path):
    env = dict(os.environ, DASHING_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(tmp_path / "s.txt"),
         str(tmp_path / "d.txt")] + genomes[:3],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NOJAX-OK" in res.stdout
    assert (tmp_path / "d.txt").read_text().count("\n") == 4
    assert (tmp_path / "d.txt.rf").read_text().startswith(">g0_r0 |")
    for ext in ("J", "w", "nt", "bb", "rmh", "whll", "hmh", "smh", "khs",
                "wjw"):
        assert (tmp_path / f"d.txt.{ext}").read_text().count("\n") == 4
    assert (tmp_path / "d.txt.card").read_text().count("\n") == 4
    assert len(os.listdir(tmp_path / "sk")) == 6
    assert (tmp_path / "d.txt.khs.union").stat().st_size > 0
    assert HLL.read(str(tmp_path / "d.txt.union")).p == 10
    assert "Estimated number of unique exact matches" in res.stdout


def test_cuda_request_without_card_raises(genomes, tmp_path, monkeypatch):
    """CUDA asked for (explicitly or by default) on a machine without a
    usable card: the CLI stops; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "d.txt"
    for value in ("cuda", None):
        if value is None:
            monkeypatch.delenv("DASHING_TPU_TORCH_DEVICE", raising=False)
        else:
            monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", value)
        with pytest.raises(SystemExit, match="is_available"):
            tmain.main(["dist", "-k", str(K), "-O", str(out)] + genomes[:2])
        assert not out.exists()
    with pytest.raises(RuntimeError):
        devmod.resolve("cuda")
    with pytest.raises(RuntimeError):
        devmod.resolve("mps")
    assert devmod.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("extra", [
    ["--wj"], ["--wj-cm-sketch-size", "12"], ["--use-bloom-filter"], ["-W"],
    ["--use-range-minhash"], ["-N", "--cache-sketches"],
    ["--wj-exact"], ["--use-bb-minhash"], ["-8"], ["--use-hyperminhash"],
    ["--use-superminhash"], ["--use-full-khash-sets"],
    ["--wj-exact", "--use-wide-hll"],
])
def test_out_of_slice_flags_refused(genomes, tmp_path, monkeypatch, cpu_env,
                                    extra):
    """Flags the slice refused while their parts were missing, all of
    them ported since.  The sketch cache flags (-W, --cache-sketches) run:
    the same matrix as without them, and a cache file beside each input
    (under -P).  The weighted-Jaccard flags and the set-sketch type flags
    (Bloom filter, bottom-k, b-bit MinHash, HyperMinHash, SuperMinHash,
    the exact k-mer hash sets, a weighted wide HLL) run too: a finite
    matrix of another value than without them (test_torch_weighted.py,
    test_torch_weighted_types.py, test_torch_setsketch_cli.py,
    test_torch_extra_cli.py and test_torch_khset.py hold them to the JAX
    CLI)."""
    if extra[-1] not in ("-W", "--cache-sketches"):
        monkeypatch.chdir(tmp_path)
        base = ["dist", "-k", str(K), "-S", str(S), "-M", "-b"]
        for out, flags in (("plain.bin", []), ("other.bin", extra)):
            assert tmain.main(base + flags + ["-O", out] + genomes[:2]) == 0
        other = np.fromfile("other.bin", np.float32)
        assert np.isfinite(other).all()
        assert (open("other.bin", "rb").read()
                != open("plain.bin", "rb").read())
        return
    monkeypatch.chdir(tmp_path)
    base = ["dist", "-k", str(K), "-S", str(S), "-M", "-b", "-P", "c"]
    os.mkdir("c")
    assert tmain.main(base + ["-O", "plain.bin"] + genomes[:2]) == 0
    assert not os.listdir("c")
    for run in ("first.bin", "second.bin"):     # writes, then loads
        assert tmain.main(base + extra + ["-O", run] + genomes[:2]) == 0
        assert open(run, "rb").read() == open("plain.bin", "rb").read()
        assert len(os.listdir("c")) == 2


@pytest.fixture(scope="module")
def fastq(genomes, tmp_path_factory):
    """One genome's first 2 kbp as 20 FASTQ reads of 100 bases."""
    seq = b"".join(l for l in open(genomes[0], "rb").read().splitlines()
                   if not l.startswith(b">"))[:2000].upper()
    path = tmp_path_factory.mktemp("fq") / "reads.fq"
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seq[i:i + 100],
                                                      b"I" * 100)
                              for i in range(0, 2000, 100)))
    return str(path)


def test_dist_count_min_parameters_match_jax_cli(genomes, tmp_path, cpu_env):
    """-c/-q/-t/-R (and -N, which dist never reads) are stored and change
    nothing without -y, as in the JAX CLI: the same matrix bytes as the
    port's run without them, and the JAX CLI's matrix at the tolerance of
    test_dist_matches_jax_cli."""
    args = ["dist", "-k", str(K), "-S", str(S), "-M", "-b"]
    cm = ["-c", "3", "-q", "2", "-t", "20", "-R", "7", "-N"]
    out = {}
    for tag, fn, extra in (("plain", tmain.main, []), ("port", tmain.main, cm),
                           ("jax", jmain.main, cm)):
        out[tag] = str(tmp_path / f"{tag}.bin")
        assert fn(args + extra + ["-O", out[tag]] + genomes) == 0
    with open(out["port"], "rb") as a, open(out["plain"], "rb") as b:
        assert a.read() == b.read()
    (nj, mj), (nt, mt) = (distmat.read_binary(out["jax"]),
                          distmat.read_binary(out["port"]))
    assert nj == nt == 6 and np.isfinite(mt).all()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)


def test_sketch_count_min_parameters(genomes, fastq, tmp_path, cpu_env):
    """sketch -n/-q/-H (threshold, sizes) and -b or -f at threshold 1 write
    the plain sketches, byte for byte as the JAX CLI; -b with a threshold
    above 1, -f above 1 on a FASTQ input, and dist -y filter, as the JAX
    CLI does (test_torch_subcommands.py holds the filtered outputs on
    read sets)."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    args = ["sketch", "-k", str(K), "-S", str(S), "-q", "20", "-H", "2",
            "-b", "-f", "-n", "1"]
    assert jmain.main(args + ["-P", str(tmp_path / "jax")] + genomes[:2]
                      + [fastq]) == 0
    assert tmain.main(args + ["-P", str(tmp_path / "port")] + genomes[:2]
                      + [fastq]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for nm in names:
        assert (_records(tmp_path / "port" / nm)
                == _records(tmp_path / "jax" / nm)), nm
    base = ["sketch", "-k", str(K), "-S", str(S), "-P", str(tmp_path)]
    assert tmain.main(base + ["-f", "-n", "3"] + genomes[:2]) == 0
    for i, filtered in enumerate((["-b", "-n", "3"] + genomes[:1],
                                  ["--countmin", "--min-count", "2"]
                                  + genomes[:1],
                                  ["-f", "-n", "3", fastq])):
        outs = []
        for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
            out = str(tmp_path / f"{tag}{i}.stream")
            assert fn(base + ["-o", out] + filtered) == 0
            outs.append(_records(out))
        assert outs[1] == outs[0], filtered
    mats = []
    for tag, fn in (("jax", jmain.main), ("port", tmain.main)):
        out = str(tmp_path / f"{tag}.bin")
        assert fn(["dist", "-k", str(K), "-y", "-c", "3", "-b", "-O", out,
                   fastq, fastq]) == 0
        mats.append(distmat.read_binary(out)[1])
    np.testing.assert_allclose(mats[1], mats[0], rtol=1e-4, atol=1e-6)


def test_out_of_slice_subcommands_refused(cpu_env, capsys):
    """Every subcommand of the JAX CLI is in the port's tables since
    readfilt (the last refused) was ported: readfilt without -s prints its
    usage and returns 1, as the JAX CLI's; a name neither CLI knows still
    stops with "not yet ported"."""
    assert set(jmain.SUBCOMMANDS) <= (set(tmain.SUBCOMMANDS)
                                      | set(tmain.HOST_SUBCOMMANDS))
    assert tmain.main(["readfilt", "x"]) == 1
    assert "readfilt -s ref.hll" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain.main(["no_such_subcommand", "x"])
