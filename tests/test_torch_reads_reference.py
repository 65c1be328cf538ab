"""The port's count-min filtered `sketch` of a FASTQ read set against the
benchmark's plain reference (portbench/reference/countmin.py) on the
CPU: registers bitwise equal and `card` within float32 rounding of the
reference's float64 MLE, whole and streamed, at two thresholds and two
row counts; the reference's filter against a count in plain Python; and
the filter's tile counters (`cm_tiles`, `cm_rehashed_tiles`) for three
budgets of the hash cache between the passes."""
import os

import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain
from portbench import reads
from portbench.kinds.sketch_reads import read_hll
from portbench.reference import countmin
from portbench.reference import estimators as est

torch.set_num_threads(1)
CPU = torch.device("cpu")
K, P, SIZE, SEED = 31, 12, 16, 1337
SET = {"reads": 20000, "read_length": 100, "genome_length": 200000,
       "substitution_rate": 0.0025}
M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def read_set(tmp_path_factory):
    """The FASTQ file, and the reference's registers and float64 size for
    each (threshold, rows), computed once."""
    root = tmp_path_factory.mktemp("reads")
    path = str(root / "reads.fq")
    reads.write_fastq(SET, 2**33 + 21, path)
    hashes = countmin.window_hashes(countmin.read_fastq(path), K, CPU)
    cache = {}

    def reference(min_count, rows):
        if (min_count, rows) not in cache:
            regs = countmin.filtered_registers(hashes, P, rows, SIZE, SEED,
                                               min_count, CPU)
            size = float(est.mle(est.histogram(regs[None], P), P)[0])
            cache[min_count, rows] = (regs.numpy(), size)
        return cache[min_count, rows]

    return path, reference


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("min_count", [2, 3])
def test_filtered_sketch_equals_reference(read_set, tmp_path, monkeypatch,
                                          min_count, rows, streamed):
    """`sketch -b -n N -q 16 -H R` then `card -H`: streamed, the threshold
    at 0 and 4-row windows, so the file runs through the read-ahead
    thread in many tiles, both passes."""
    path, reference = read_set
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    if streamed:
        monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
        monkeypatch.setattr(pipeline, "MAX_ROWS", 4)
    out = tmp_path / "out"
    out.mkdir()
    assert tmain.main(["sketch", "-k", str(K), "-S", str(P), "-b", "-n",
                       str(min_count), "-q", str(SIZE), "-H", str(rows),
                       "-P", str(out), path]) == 0
    (hll,) = [str(out / f) for f in os.listdir(out)]
    sizes = str(tmp_path / "sizes.tsv")
    assert tmain.main(["card", "-H", "-o", sizes, hll]) == 0
    want_regs, want_size = reference(min_count, rows)
    p, got_regs = read_hll(hll)
    assert p == P
    np.testing.assert_array_equal(got_regs, want_regs)
    with open(sizes) as fp:
        lines = fp.read().splitlines()
    assert lines[0].startswith("#") and len(lines) == 2
    name, size = lines[1].split("\t")
    assert name == hll
    assert float(size) == pytest.approx(want_size, rel=2.0 ** -20)


def _wang64(x):
    x = (~x + (x << 21)) & M64
    x ^= x >> 24
    x = (x + (x << 3) + (x << 8)) & M64
    x ^= x >> 14
    x = (x + (x << 2) + (x << 4)) & M64
    x ^= x >> 28
    return (x + (x << 31)) & M64


def test_reference_filter_equals_python_count(tmp_path):
    """A few hundred reads of a short genome, so that k-mers repeat, into
    2^10 counters a row, so that they collide: the reference's registers
    are those of a count-min and register max written with Python ints."""
    cfg = {"reads": 300, "read_length": 60, "genome_length": 400,
           "substitution_rate": 0.01}
    path = str(tmp_path / "r.fq")
    reads.write_fastq(cfg, 12345, path)
    k, p, rows, size, seed, n = 21, 6, 3, 10, -5, 3
    lines = open(path, "rb").read().split(b"\n")
    code = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}
    hashes_py = []
    for seq in lines[1::4]:
        for s in range(len(seq) - k + 1):
            fwd = rc = 0
            for t, base in enumerate(seq[s:s + k]):
                fwd |= code[base] << (2 * (k - 1 - t))
                rc |= (3 - code[base]) << (2 * t)
            hashes_py.append(_wang64(min(fwd, rc)))
    consts = [((seed + r * 0x9E3779B9) | 1) & M64 for r in range(rows)]
    table = [dict() for _ in range(rows)]
    for h in hashes_py:
        for r in range(rows):
            i = _wang64(h ^ consts[r]) >> (64 - size)
            table[r][i] = table[r].get(i, 0) + 1
    want = np.zeros(1 << p, np.int32)
    admitted = 0
    for h in hashes_py:
        if min(table[r][_wang64(h ^ consts[r]) >> (64 - size)]
               for r in range(rows)) >= n:
            admitted += 1
            rest = ((h << p) | (1 << (p - 1))) & M64
            rank = 64 - rest.bit_length() + 1
            b = h >> (64 - p)
            want[b] = max(want[b], rank)
    assert 0 < admitted < len(hashes_py)
    hashes = countmin.window_hashes(countmin.read_fastq(path), k, CPU,
                                    block_reads=64)
    assert len(hashes) == 5 and sum(h.numel() for h in hashes) == len(
        hashes_py)
    got = countmin.filtered_registers(hashes, p, rows, size, seed, n, CPU)
    twice = countmin.twice_seen(hashes)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = {}
    for h in hashes_py:
        counts[h] = counts.get(h, 0) + 1
    assert twice == sum(c >= 2 for c in counts.values())


@pytest.mark.parametrize("budget", ["none", "two tiles", "all"])
def test_filter_tile_counters(tmp_path, monkeypatch, budget):
    """`cm_tiles` counts the first pass's tiles, `cm_rehashed_tiles` the
    second pass's tiles not in the hash cache: the tiles past the budget."""
    path = str(tmp_path / "reads.fq")
    reads.write_fastq(dict(SET, reads=2000), 77, path)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 2)
    params = pipeline.SketchParams(k=K, use_counting_filter=True,
                                   min_count=2, cm_size_log2=SIZE)
    tiles = list(pipeline.InputFile(0, path, params.spacer()).tiles())
    assert len(tiles) >= 5
    cost = tiles[0].size * 9
    cap = {"none": 0, "two tiles": 2 * cost, "all": 1 << 62}[budget]
    cached = {"none": 0, "two tiles": 2, "all": len(tiles)}[budget]
    monkeypatch.setattr(pipeline, "_CM_HASH_CACHE_BYTES", cap)
    t0, r0 = pipeline.cm_tiles, pipeline.cm_rehashed_tiles
    pipeline.sketch_file_hll(path, params, P, CPU)
    assert pipeline.cm_tiles - t0 == len(tiles)
    assert pipeline.cm_rehashed_tiles - r0 == len(tiles) - cached
