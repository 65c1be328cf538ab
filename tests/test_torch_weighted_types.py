"""Weighted Jaccard (`--wj-exact`, and `--wj` with a small count-min) over
every sketch type of the JAX package's tests/test_weighted.py: the
port's `sketch` files equal the JAX CLI's once decompressed (a gzip
header carries a write time), `dist -b -M` matrices agree at rtol 1e-4
(the exact hash sets exactly), `-o` sizes byte for byte, and `dist -W`
names its cache files `.wj[.exact].<ext>` as the JAX CLI does.

The weighted wide HLL is the trap: WideHLL.addh_np hashes the labelled
elements again where the weighted HLL inserts them as they are, so its
registers are not the weighted HLL's, widened; the JAX CLI's are the
reference (test_weighted_wide_hll_rehashes)."""
import gzip
import os

import numpy as np
import pytest
import torch

from dashing_tpu.cli import main as jmain
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.sketch.extra import WideHLL
from dashing_tpu_torch.sketch.hll import HLL

torch.set_num_threads(1)

K, S = 15, 10
LUT = np.frombuffer(b"ACGT", np.uint8)
TYPES = {"hll": [], "khset": ["--use-full-khash-sets"],
         "bf": ["--use-bloom-filter"], "rmh": ["--use-range-minhash"],
         "crmh": ["--use-counting-range-minhash"], "bbmh": ["-8"],
         "cbbmh": ["--use-counting-bb-minhash"],
         "superminhash": ["--use-superminhash"],
         "hmh": ["--use-hyperminhash"], "wide_hll": ["--use-wide-hll"]}
MODES = {"exact": ["--wj-exact"], "cm": ["--wj-cm-sketch-size", "8"]}


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """3 FASTAs whose records repeat a shared block 1-3 times beside a
    block of their own (real multiplicities, every pair related)."""
    rng = np.random.default_rng(0x3A7)
    root = tmp_path_factory.mktemp("wjt")
    shared = LUT[rng.integers(0, 4, 1500)].tobytes()
    out = []
    for i in range(3):
        own = LUT[rng.integers(0, 4, 900)].tobytes()
        recs = [shared] * (i + 1) + [own, own[:400]]
        body = b"".join(b">r%d\n%s\n" % (j, s) for j, s in enumerate(recs))
        path = root / f"w{i}.fa"
        path.write_bytes(body)
        out.append(str(path))
    return out


@pytest.fixture()
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)


def _unzip(path):
    with gzip.open(path, "rb") as fp:
        return fp.read()


def _cond(path):
    raw = open(path, "rb").read()
    return np.frombuffer(raw[9:], "<f4")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stype", sorted(TYPES))
def test_weighted_type_matches_jax(genomes, cpu_env, stype, mode):
    flags = ["-k", str(K), "-S", str(S)] + TYPES[stype] + MODES[mode]
    for who, fn in (("jax", jmain.main), ("port", tmain.main)):
        os.mkdir(who)
        os.mkdir(f"c_{who}")
        assert fn(["sketch"] + flags + ["-P", who] + genomes) == 0
        assert fn(["dist", "-b", "-M", "-W", "-P", f"c_{who}", "-O",
                   f"{who}.out", "-o", f"{who}.sizes"] + flags
                  + genomes) == 0
    names = sorted(os.listdir("jax"))
    assert names == sorted(os.listdir("port")) and len(names) == 3
    for nm in names:
        assert _unzip(f"port/{nm}") == _unzip(f"jax/{nm}"), nm
    cached = sorted(os.listdir("c_port"))
    assert cached == sorted(os.listdir("c_jax"))
    tag = ".wj.exact." if mode == "exact" else ".wj."
    assert len(cached) == 3 and all(tag in nm for nm in cached)
    for nm in cached:
        assert _unzip(f"c_port/{nm}") == _unzip(f"c_jax/{nm}"), nm
    got, want = _cond("port.out"), _cond("jax.out")
    assert got.shape == (3,) and np.isfinite(got).all()
    if stype == "khset":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert open("port.sizes").read() == open("jax.sizes").read()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_weighted_wide_hll_rehashes(genomes, cpu_env, mode):
    """The weighted wide HLL's registers (the JAX CLI's, as the test above
    holds) are not the weighted HLL's: the elements were hashed again."""
    flags = ["sketch", "-k", str(K), "-S", str(S), "-o"]
    assert tmain.main(flags + ["w.whll", "--use-wide-hll"] + MODES[mode]
                      + genomes[:1]) == 0
    assert tmain.main(flags + ["h.hll"] + MODES[mode] + genomes[:1]) == 0
    wide, hll = WideHLL.read("w.whll"), HLL.read("h.hll")
    assert wide.regs.dtype == np.uint16 and wide.regs.any()
    assert not np.array_equal(wide.regs, hll.regs.astype(np.uint16))
