"""The phage collection (phages.py), the `dist_small` kind's streamed
check (reference/condensed.py) and the readers of its metrics: the
generator is deterministic per seed and draws its lengths in the clip
about the stated median; the registers built for many genomes at once
equal the reference's genome by genome; the streamed check equals the
whole-matrix check (compare.expected) and catches one altered distance
and one altered size; the control fails the cell's limits; each reader
gives None where its span or counter is absent."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import genomes as gen, jobs, phages, run
from portbench.reference import compare, condensed, sketch
from portbench.reference import estimators as est
from portbench.trace import Trace
from helpers import config

CELL = "phage16k.dist_small"
CPU = torch.device("cpu")
K, P = 21, 12


def small(ancestors=6, median=6000, lo=2000, hi=20000):
    """The cell's configuration cut to `ancestors` families of short
    genomes (its rates, k and law kept), at p = 12."""
    cfg = config("phage16k_k21_s14")
    col = dict(cfg["collection"], ancestors=ancestors,
               genomes=ancestors * len(cfg["collection"]["rates"]),
               length_median=median, length_min=lo, length_max=hi)
    return dict(cfg, collection=col, p=P)


def test_generator_deterministic_per_seed():
    cfg = small()
    a = phages.make_phages(cfg, 2**40 + 3)
    b = phages.make_phages(cfg, 2**40 + 3)
    c = phages.make_phages(cfg, 2**40 + 4)
    assert len(a) == cfg["collection"]["genomes"]
    assert [g.name for g in a] == [g.name for g in b]
    assert all(len(g.records) == 1 for g in a)
    assert all(np.array_equal(x.records[0], y.records[0])
               for x, y in zip(a, b))
    assert [g.bases for g in a] != [g.bases for g in c]
    seqs = np.concatenate([g.records[0] for g in a])
    assert set(np.unique(seqs).tobytes()) <= set(b"ACGT")
    # the copies of a family share their ancestor's length
    for i in range(0, len(a), 4):
        assert len({g.bases for g in a[i:i + 4]}) == 1
        assert {g.family for g in a[i:i + 4]} == {a[i].family}


def test_lengths_in_clip_about_median():
    col = config("phage16k_k21_s14")["collection"]
    got = phages.lengths(dict(col, ancestors=20000), gen.rng_for(17))
    assert got.min() >= col["length_min"] and got.max() <= col["length_max"]
    assert abs(np.median(got) / col["length_median"] - 1) < 0.03
    inner = np.mean((got > 17000) & (got < 120000))
    assert 0.86 < inner < 0.93


def test_genome_count_must_match():
    cfg = small()
    cfg["collection"]["genomes"] += 1
    with pytest.raises(ValueError):
        phages.make_phages(cfg, 1)


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    """A small collection written as FASTA, its registers genome by
    genome, and the whole-matrix reference."""
    root = tmp_path_factory.mktemp("phages")
    genomes = phages.make_phages(small(), 3_000_000_017)
    paths = gen.write_fasta(genomes, str(root))
    regs = compare.registers_of_files(paths, K, P, 0, CPU)
    sizes, ji = compare.expected(regs, P, False)
    return root, paths, regs, sizes, ji


@pytest.mark.parametrize("block", [1, 50000, 1 << 25])
def test_registers_at_once_equal_genome_by_genome(collection, block):
    _, paths, regs, _, _ = collection
    got = condensed.collection_registers(
        (sketch.read_fasta(x) for x in paths), K, P, CPU, block=block)
    assert torch.equal(got, regs)


def test_registers_of_short_genomes():
    recs = [[np.frombuffer(b"ACGT" * 10, np.uint8)],
            [np.frombuffer(b"ACG", np.uint8)],
            [np.frombuffer(b"ACGTTGCA" * 5, np.uint8),
             np.frombuffer(b"GGCATT" * 6, np.uint8)]]
    got = condensed.collection_registers(recs, K, P, CPU)
    want = sketch.collection_registers(recs, K, P, 0, CPU)
    assert torch.equal(got, want)


def write_matrix(path, n, mash):
    with open(path, "wb") as fp:
        fp.write(b"\x00" + int(n).to_bytes(8, "little"))
        fp.write(mash.numpy().astype("<f4").tobytes())


def test_streamed_gap_equals_whole_matrix(collection, tmp_path):
    """A matrix written in another order of the genomes, with its labels:
    the streamed check, on the registers put in that order, gives the
    whole-matrix check's gap, and a block of rows of any size the same."""
    _, paths, regs, sizes, ji = collection
    n = len(paths)
    order = np.random.default_rng(3).permutation(n)
    labels = [paths[i] for i in order]
    sub_regs = regs[torch.from_numpy(order)]
    _, sub_ji = compare.expected(sub_regs, P, False)
    out = str(tmp_path / "d.bin")
    write_matrix(out, n, est.mash(sub_ji, K))
    with open(out + ".labels", "w") as fp:
        fp.write("\n".join(labels) + "\n")
    sizes_path = str(tmp_path / "sizes.tsv")
    with open(sizes_path, "w") as fp:
        fp.write("#Path\tSize (est.)\n")
        for x, s in zip(paths, sizes):
            fp.write(f"{x}\t{int(s)}\n")
    got_sizes, got_ji = compare.read_outputs(paths, out, sizes_path, K)
    whole = compare.gaps(got_sizes, got_ji, sizes, ji)["jaccard_gap"]
    cond = condensed.open_condensed(out)
    for pairs in (1 << 22, 1000, 37, 1):
        got = condensed.jaccard_gap(sub_regs, P, K, cond, pair_block=pairs)
        assert got == pytest.approx(whole, abs=1e-12)
    assert whole < 1e-6
    # one altered distance is the widest gap, wherever it lies
    bad = est.mash(sub_ji, K).clone()
    pos = n * (n - 1) // 2 - 7
    bad[pos] = bad[pos] * 0.5 if bad[pos] < 1 else 0.1
    write_matrix(out, n, bad)
    want = float((est.jaccard_of_mash(bad[pos:pos + 1].float(), K)
                  - sub_ji[pos]).abs()[0])
    got = condensed.jaccard_gap(sub_regs, P, K,
                                condensed.open_condensed(out), pair_block=150)
    assert got == pytest.approx(want, rel=1e-9) and got > 1e-2


def test_streamed_control_equals_whole_matrix(collection):
    _, _, regs, sizes, ji = collection
    low_sizes, low_ji = compare.expected(regs, P, False, torch.bfloat16)
    whole = compare.gaps(low_sizes, low_ji, sizes, ji)["jaccard_gap"]
    got = condensed.jaccard_gap(regs, P, K, None, torch.bfloat16,
                                pair_block=200)
    assert got == pytest.approx(whole, rel=1e-12) and got > 3e-4


def test_condensed_file_checked(tmp_path):
    out = str(tmp_path / "d.bin")
    write_matrix(out, 5, torch.zeros(9))
    with pytest.raises(ValueError):
        condensed.open_condensed(out)
    write_matrix(out, 5, torch.zeros(10))
    assert condensed.open_condensed(out).size == 10
    assert condensed.row_start(0, 5) == 0
    assert condensed.row_start(1, 5) == 4 and condensed.row_start(4, 5) == 10


# the cell through the harness, on the CPU with the program's plain
# versions, at a small size


def result(capsys, seed=5_000_000_029):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", "0"], device="cpu", overrides=small())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def altered_distance(monkeypatch):
    """One distance of the matrix altered where it is computed: the first
    pair's, two copies of one ancestor (the files sort by size, and a
    family's copies are of one length)."""
    from dashing_tpu_torch.cli import core
    real = core.compare_condensed

    def compare_condensed(*a, **kw):
        out = real(*a, **kw)
        out[0] += 0.01
        return out

    monkeypatch.setattr(core, "compare_condensed", compare_condensed)


def altered_size(monkeypatch):
    """One genome's size altered where the `-o` file is written."""
    from dashing_tpu_torch.cli import core
    real = core.emit_cardinalities

    def emit(fp, names, sketches, *a, **kw):
        class Out:
            def __init__(self):
                self.lines = 0

            def write(self, s):
                self.lines += 1
                if self.lines == 3:
                    name, val = s.rstrip("\n").split("\t")
                    s = f"{name}\t{int(val) + 500}\n"
                fp.write(s)
        return real(Out(), names, sketches, *a, **kw)

    monkeypatch.setattr(core, "emit_cardinalities", emit)


def test_sound_run_is_correct(capsys):
    res = result(capsys)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"size_rel_gap", "jaccard_gap",
                                  "jobs_differing"}


@pytest.mark.parametrize("fault", [altered_distance, altered_size])
def test_fault_is_caught(fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = result(capsys)
    assert not res["correct"], res["checks"]


def test_control_fails():
    _, _, _, traffic, limits = run.load_cell(CELL)
    job = jobs.make(small(), traffic, 99, CPU)
    job.setup()
    try:
        numbers = job.check(control=True)
    finally:
        job.close()
    checks, correct = run.judge(numbers, limits, 0)
    assert not correct, checks
    assert set(numbers) == {"size_rel_gap", "jaccard_gap"}


# the readers of the cell's per-layer metrics

NEW = ("batch_stage_s_per_job.small", "small_batches_per_job.small",
       "compare_put_s_per_job.small", "compare_device_ms_per_job.small")
K3 = "void union_triples_kernel<0, 32>(float const*, float*)"
K1B = "void banks_onchip_kernel<14>(unsigned char const*)"


class Units:
    def __init__(self, counts):
        self.unit_counts = counts


def read(name, trace=None, units=2, buckets=None, job=None):
    trace = trace or Trace([(K1B, 0.0, 0.001), (K3, 0.002, 0.005),
                            ("Memcpy DtoH", 0.006, 0.007),
                            ("count_kernel<false>", 0.008, 0.009)],
                           [], 0.0, 0.010)
    return run.load_reader(name)(run.Context(trace, units, buckets or {},
                                             job))


def test_readers():
    b = {"sketch.batch_stage": 0.5, "compare.put": 0.25}
    assert read(NEW[0], buckets=b) == pytest.approx(0.25)
    assert read(NEW[2], buckets=b) == pytest.approx(0.125)
    job = Units([{"small_batches": 9}, {"small_batches": 256},
                 {"small_batches": 258}])
    assert read(NEW[1], job=job) == pytest.approx(257.0)
    # K3 3 ms and K4's count kernel 1 ms over two jobs; K1 and copies left
    assert read(NEW[3]) == pytest.approx(2.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_absent(name):
    """A program without the span or counter, or no job: nothing."""
    assert read(name, buckets={"host.parse": 1.0},
                trace=Trace([(K1B, 0.0, 0.001)], [], 0.0, 0.01),
                job=Units([{}, {}])) is None
    assert read(name, units=0, buckets={"sketch.batch_stage": 1.0,
                                        "compare.put": 1.0},
                job=Units([{"small_batches": 3}])) is None


def test_cell_declared():
    bench = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "bases_per_s"
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "dist_small"
