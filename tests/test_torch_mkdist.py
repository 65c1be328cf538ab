"""`mkdist --multik` on the CPU against the JAX CLI: the per-k binary
matrices, the flattened .bin and the Jukes-Cantor .jcd at the bar of
test_torch_slice.test_dist_matches_jax_cli (rtol 1e-4); each per-k matrix
bit for bit the port's own `dist -k K -b`; the user's -k placed before
the per-k -k; one multi-k sketch a file; and a device or kernel error in
the fused sketch raising (the JAX package falls back to per-k sketching
there)."""
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py keeps JAX on the CPU)

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat

torch.set_num_threads(1)
S = 11
KS = (13, 17, 21)
MULTIK = "{},13,25,4"
LUT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Five 8-12 kbp FASTAs, copies of one ancestor at planted rates, two
    records each, one with an N run."""
    rng = np.random.default_rng(0x3D)
    root = tmp_path_factory.mktemp("mk")
    anc = rng.integers(0, 4, 12000).astype(np.uint8)
    out = []
    for i, rate in enumerate((0.0, 0.005, 0.01, 0.02, 0.04)):
        g = anc[:int(rng.integers(8000, 12000))].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size)) & 3
        seq = LUT[g]
        seq[500:540 + 10 * i] = ord("N")
        half = seq.size // 2
        path = root / f"g{i}.fa"
        path.write_bytes(b">g%d_a\n%s\n>g%d_b\n%s\n" % (
            i, seq[:half].tobytes(), i, seq[half:].tobytes()))
        out.append(str(path))
    return out


@pytest.fixture()
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)


def _mat(path):
    n, vals = distmat.read_binary(path)
    return n, vals


def test_mkdist_matches_jax_cli(genomes, cpu_env):
    """Per-k matrices (--sizes, the Jukes-Cantor input), the flattened
    container and the .jcd against the JAX CLI."""
    for tag, fn in (("j", jmain.main), ("t", tmain.main)):
        assert fn(["mkdist", "--multik", MULTIK.format(tag), "-S", str(S),
                   "--jukes-cantor"] + genomes) == 0
    for k in KS:
        (nj, mj), (nt, mt) = _mat(f"_j_{k}"), _mat(f"_t_{k}")
        assert nj == nt == 5 and np.isfinite(mt).all() and (mt > 0).all()
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)
    fj, ft = distmat.read_flattened("j.bin"), distmat.read_flattened("t.bin")
    assert fj[0] == ft[0] == 5 and list(ft[1]) == list(fj[1]) == list(KS)
    np.testing.assert_allclose(ft[2], fj[2], rtol=1e-4, atol=1e-6)
    (nj, jj), (nt, jt) = _mat("j.jcd"), _mat("t.jcd")
    assert nj == nt == 5 and np.isfinite(jt).all()
    np.testing.assert_allclose(jt, jj, rtol=1e-4, atol=1e-6)


def test_mkdist_per_k_equals_dist(genomes, cpu_env, monkeypatch):
    """Each per-k matrix is the port's `dist -k K -M -b` bit for bit; the
    user's -k comes before the per-k -k, so it changes nothing; every
    file is sketched once, at all k together, and no per-k pass sketches;
    the private cache and the parked rows are gone afterwards."""
    multik, per_k = [], []
    real_mk = pipeline.sketch_file_hll_multik
    monkeypatch.setattr(pipeline, "sketch_file_hll_multik",
                        lambda path, pl, *a, **kw: multik.append(len(pl))
                        or real_mk(path, pl, *a, **kw))
    real_files = pipeline.sketch_hll_files
    monkeypatch.setattr(pipeline, "sketch_hll_files",
                        lambda todo, *a, **kw: per_k.append(len(todo))
                        or real_files(todo, *a, **kw))
    made = []
    real_tmp = tmain.tempfile.mkdtemp
    monkeypatch.setattr(tmain.tempfile, "mkdtemp",
                        lambda **kw: made.append(real_tmp(**kw)) or made[-1])
    args = ["-S", str(S), "-M", "--avoid-sorting"] + genomes
    assert tmain.main(["mkdist", "--multik", MULTIK.format("a")] + args) == 0
    assert multik == [len(KS)] * 5 and per_k == [0] * len(KS)
    assert not pipeline._dev_rows and not pipeline._join_cache_on
    assert len(made) == 1 and not os.path.exists(made[0])
    assert tmain.main(["mkdist", "--multik", MULTIK.format("b"), "-k", "31"]
                      + args) == 0
    for k in KS:
        assert tmain.main(["dist", "-k", str(k), "-b", "-O", f"d{k}"]
                          + args) == 0
        want = open(f"d{k}", "rb").read()
        assert open(f"_a_{k}", "rb").read() == want
        assert open(f"_b_{k}", "rb").read() == want


def test_mkdist_with_user_cache(genomes, cpu_env):
    """-W -P from the user: the fused sketch fills that cache (one file a
    k), and a second mkdist loads it all."""
    os.mkdir("c")
    args = ["-S", str(S), "-W", "-P", "c", "--avoid-sorting"] + genomes
    assert tmain.main(["mkdist", "--multik", MULTIK.format("a")] + args) == 0
    assert len(os.listdir("c")) == 5 * len(KS)
    stamps = {n: os.stat(os.path.join("c", n)).st_mtime_ns
              for n in os.listdir("c")}
    assert tmain.main(["mkdist", "--multik", MULTIK.format("b")] + args) == 0
    assert stamps == {n: os.stat(os.path.join("c", n)).st_mtime_ns
                      for n in os.listdir("c")}
    assert open("a.bin", "rb").read() == open("b.bin", "rb").read()


def test_mkdist_raises_on_a_sketch_error(genomes, cpu_env, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(pipeline, "sketch_file_hll_multik", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tmain.main(["mkdist", "--multik", MULTIK.format("x"), "-S", str(S)]
                   + genomes)
    assert not pipeline._dev_rows and not pipeline._join_cache_on
    assert not os.path.exists("x.bin")
