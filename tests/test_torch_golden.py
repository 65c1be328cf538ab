"""The port's CLI held to the JAX CLI's golden fixtures (tests/golden: three
3 kbp genomes and the JAX CLI's outputs on them), on the CPU.

Registers, sketch files and the exact hash-set matrix are held byte for
byte.  Estimator outputs (the JI and Mash floats) are held within atol 2e-6
with labels and layout byte for byte: the estimators sum in float32, the
port level by level and the JAX package in XLA's order, so their last
digits differ (0.465689 against the fixture's 0.46569)."""
import gzip
import os
import shutil

import numpy as np
import pytest

from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat
from dashing_tpu_torch.sketch.hll import HLL

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GENOMES = ["g0.fa", "g1.fa", "g2.fa"]
ATOL = 2e-6                # derived measures (tests/test_pallas.py's bar)


@pytest.fixture()
def in_golden(monkeypatch, tmp_path):
    """A temporary directory holding copies of the genomes, as the working
    directory, with the port on the CPU."""
    for name in GENOMES:
        shutil.copy(os.path.join(GOLDEN, name), tmp_path / name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    return tmp_path


def _fixture(name: str, mode: str = "r"):
    with open(os.path.join(GOLDEN, name), mode) as fp:
        return fp.read()


def _run(argv, capsys) -> str:
    assert tmain.main(argv) == 0
    return capsys.readouterr().out


def _split_tsv(text: str):
    """(layout, values): every field of the TSV with the matrix entries
    replaced by a mark, and those entries as floats."""
    layout, values = [], []
    in_matrix = False
    for line in text.split("\n"):
        fields = line.split("\t")
        if line.startswith("##Names"):
            in_matrix = True
        elif in_matrix and len(fields) > 1:
            for i in range(1, len(fields)):
                if fields[i] != "-":
                    values.append(float(fields[i]))
                    fields[i] = "<value>"
        layout.append(fields)
    return layout, np.array(values)


def test_golden_sketch_registers(in_golden, capsys):
    """sketch -k 21 -S 12 g0.fa: golden.hll's registers, and its bytes
    once decompressed (the gzip header holds a time)."""
    _run(["sketch", "-k", "21", "-S", "12", "g0.fa"], capsys)
    out = "g0.fa.w.21.spacing.12.hll"
    got, want = HLL.read(out), HLL.read(os.path.join(GOLDEN, "golden.hll"))
    assert got.p == want.p == 12
    np.testing.assert_array_equal(got.regs, want.regs)
    with gzip.open(out, "rb") as fp:
        mine = fp.read()
    assert mine == gzip.decompress(_fixture("golden.hll", "rb"))


# (arguments, fixture, atol of its matrix entries): the exact hash sets'
# Jaccard byte for byte (no estimator), the HLL's JI within ATOL
TSV_CASES = {
    "exact": (["dist", "-k", "21", "--use-full-khash-sets",
               "--avoid-sorting", "g0.fa", "g1.fa"], "dist_exact.tsv", None),
    "ji": (["dist", "-k", "21", "-S", "12", "--avoid-sorting"] + GENOMES,
           "dist_ji.tsv", ATOL),
}


@pytest.mark.parametrize("case", list(TSV_CASES))
def test_golden_dist_tsv(in_golden, capsys, case):
    argv, fixture, atol = TSV_CASES[case]
    got, want = _run(argv, capsys), _fixture(fixture)
    if atol is None:
        assert got == want
        return
    (lay_g, val_g), (lay_w, val_w) = _split_tsv(got), _split_tsv(want)
    assert lay_g == lay_w
    assert len(val_w) == len(GENOMES) * (len(GENOMES) - 1) // 2
    np.testing.assert_allclose(val_g, val_w, rtol=0, atol=atol)


def test_golden_mash_binary(in_golden, capsys):
    """dist -M -b -O: the header bytes and labels file byte for byte, each
    Mash distance within ATOL of dist_mash.bin's."""
    _run(["dist", "-k", "21", "-S", "12", "-M", "-b", "-O", "out.bin",
          "--avoid-sorting"] + GENOMES, capsys)
    with open("out.bin", "rb") as fp:
        got = fp.read()
    want = _fixture("dist_mash.bin", "rb")
    assert len(got) == len(want)
    head = distmat.HEADER_BYTES
    assert got[:head] == want[:head]
    n, mine = distmat.read_binary("out.bin")
    n_w, theirs = distmat.read_binary(os.path.join(GOLDEN, "dist_mash.bin"))
    assert n == n_w == len(GENOMES)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=ATOL)
    with open("out.bin.labels") as fp:
        assert fp.read() == _fixture("dist_mash.bin.labels")
