"""The read-set cell (`sketch_reads` kind) at a tiny size on the CPU: a
sound run comes out correct, a run with its filter or its registers
broken underneath does not, each arm of the control fails the limits,
the generator follows its seed, and the five readers of the read-set
cell read what they should.  The cell at a small size on the card,
marked `cuda`."""
import gzip
import json

import numpy as np
import pytest

from portbench import jobs, reads, run
from portbench.trace import Trace
from test_portbench_imports import fresh

CELL = "reads10m.sketch_cm"
TINY = {"reads": 20000, "genome_length": 200000, "cm_size_log2": 16}


def result(capsys, trace=0, seed=5_000_000_011, cell=CELL,
           overrides=TINY):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", str(trace)], device="cpu",
                  overrides=overrides)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    res = result(capsys)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["regs_differing"]["value"] == 0
    assert set(res["metrics"]) == {"setup_s", "bases_per_s"}


def no_filter(monkeypatch):
    """The second pass admits every valid window."""
    import torch
    from dashing_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "_cm_query", lambda counts, h, *a:
                        torch.full_like(h, 1 << 30, dtype=torch.int32))


def one_row_fewer(monkeypatch):
    """The counters of the last row are never read."""
    from dashing_tpu_torch import pipeline
    real = pipeline._cm_query
    monkeypatch.setattr(pipeline, "_cm_query",
                        lambda counts, h, nh, *a: real(counts, h, nh - 1,
                                                       *a))


def unchanged_state(monkeypatch):
    """The register fold returns its registers as they were."""
    from dashing_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "update_registers", lambda regs, *a: regs)


@pytest.mark.parametrize("fault", [no_filter, one_row_fewer,
                                   unchanged_state])
def test_fault_is_caught(fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = result(capsys)
    assert not res["correct"], res["checks"]


PLAIN = {"job": "sketch_reads", "args": []}


@pytest.mark.parametrize("mix,arms", [
    (None, {"regs_differing", "size_rel_gap"}),
    (PLAIN, {"size_rel_gap"})])
def test_control_fails_on_each_arm(mix, arms):
    """The filtered mix's control has both arms; an unfiltered mix has no
    filter to take a row from, only the estimator in bfloat16."""
    _, _, config, traffic, limits = run.load_cell(CELL)
    import torch
    job = jobs.make({**config, **TINY}, mix or traffic, 99,
                    torch.device("cpu"))
    job.setup()
    try:
        numbers = job.check(control=True)
    finally:
        job.close()
    assert set(numbers) == arms
    for name, value in numbers.items():
        checks, correct = run.judge({name: value}, limits, 0)
        assert not correct, checks


@pytest.mark.parametrize("args,cm", [
    (None, {"min_count": 2, "cm_size_log2": 16, "cm_rows": 4,
            "cm_seed": 1337}),
    (["-b", "-n", "3", "-H", "2", "-R", "-5"],
     {"min_count": 3, "cm_size_log2": 16, "cm_rows": 2, "cm_seed": -5}),
    ([], {})])
def test_mix_sets_the_command_and_the_check(args, cm):
    """The mix's args go to `sketch` as they are, with each filter option
    it leaves out added from the configuration, and the check holds the
    program to the filter (or to no filter) that the args ran: a unit's
    registers are the reference's, bit for bit."""
    _, _, config, traffic, limits = run.load_cell(CELL)
    import torch
    mix = traffic if args is None else {"job": "sketch_reads", "args": args}
    job = jobs.make({**config, **TINY}, mix, 2**31 + 11, torch.device("cpu"))
    job.setup()
    try:
        assert job.cm == cm
        argv = job.argv
        assert argv[:5] == ["sketch", "-k", "31", "-S", "16"]
        for opt, value in zip(("-n", "-q", "-H", "-R"),
                              ("min_count", "cm_size_log2", "cm_rows",
                               "cm_seed")):
            if cm:
                assert argv[argv.index(opt) + 1] == str(cm[value])
            else:
                assert opt not in argv
        job.run()
        job.after()
        numbers = job.check()
    finally:
        job.close()
    checks, correct = run.judge(numbers, limits, 0)
    assert correct and numbers["regs_differing"] == 0, checks


def test_generator_follows_the_seed(tmp_path):
    cfg = {**run.load_cell(CELL)[2], "reads": 3000, "genome_length": 20000}
    paths = [str(tmp_path / f"{s}.fq") for s in ("a", "b", "c")]
    for path, seed in zip(paths, (2**33 + 7, 2**33 + 7, 2**33 + 8)):
        assert reads.write_fastq(cfg, seed, path) == 3000 * 100
    a, b, c = (open(p, "rb").read() for p in paths)
    assert a == b and a != c and len(a) == len(c) == reads.file_bytes(cfg)
    lines = a.split(b"\n")
    assert lines[0] == b"@r0000" and lines[2] == b"+"
    assert len(lines[1]) == 100 and set(lines[1]) <= set(b"ACGT")
    assert lines[3] == b"I" * 100 and lines[4] == b"@r0001"


def ctx(trace, units, buckets=None, job=None):
    return run.Context(trace, units, buckets or {}, job)


def read(name, c):
    return run.load_reader(name)(c)


class Recorded:
    unit_counts = [{"cm_tiles": 9, "cm_rehashed_tiles": 9},
                   {"cm_tiles": 620, "cm_rehashed_tiles": 607},
                   {"cm_tiles": 620, "cm_rehashed_tiles": 605}]


def test_readers():
    add = "void at::native::indexFuncLargeIndex<int, long, unsigned int>()"
    dev = [(add, 0.000, 0.004), ("Memcpy HtoD", 0.004, 0.005),
           ("void encode_kernel()", 0.005, 0.006), (add, 0.010, 0.012)]
    trace = Trace(dev, [("pb.window", 0.0, 0.02)], 0.0, 0.02)
    b = {"sketch.cm_count": 9.0, "sketch.cm_admit": 5.0,
         "sketch.parse_wait": 0.5}
    c = ctx(trace, 2, b, Recorded())
    assert read("cm_count_s_per_job.reads", c) == pytest.approx(4.5)
    assert read("cm_admit_s_per_job.reads", c) == pytest.approx(2.5)
    assert read("parse_wait_s_per_job.reads", c) == pytest.approx(0.25)
    assert read("cm_device_ms_per_job.reads", c) == pytest.approx(3.0)
    # the window's two units, not the warm-up's
    assert read("rehashed_tiles_per_job.reads", c) == pytest.approx(606.0)
    # nothing to read: no bucket, no counter (a program without it), no
    # count-min kernel in the trace
    empty = ctx(Trace([dev[1]], [], 0.0, 0.02), 2, {}, type(
        "Old", (), {"unit_counts": [{}, {}, {}]})())
    for name in ("cm_count_s_per_job.reads", "cm_admit_s_per_job.reads",
                 "parse_wait_s_per_job.reads", "cm_device_ms_per_job.reads",
                 "rehashed_tiles_per_job.reads"):
        assert read(name, empty) is None


def test_traced_run_reads_the_counters(capsys, monkeypatch):
    from dashing_tpu_torch import metrics
    # the port reads DASHING_TPU_METRICS once, at its first import
    monkeypatch.setattr(metrics, "_ENABLED", True)
    res = result(capsys, trace=1)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["rehashed_tiles_per_job.reads"]["value"] == 0
    for name in ("cm_count_s_per_job.reads", "cm_admit_s_per_job.reads",
                 "parse_wait_s_per_job.reads"):
        assert m[name]["value"] > 0


def test_hll_reader(tmp_path):
    from portbench.kinds.sketch_reads import read_hll
    regs = np.arange(1 << 4, dtype=np.uint8)
    path = str(tmp_path / "x.hll")
    with gzip.open(path, "wb") as fp:
        fp.write(b"DTPUHLL1" + bytes([4, 0, 0, 0, 0, 0, 0, 0])
                 + regs.tobytes())
    p, got = read_hll(path)
    assert p == 4 and np.array_equal(got, regs)


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
rc = run.main(["--workload", {cell!r}, "--seed", "2147483659",
               "--seconds", "0.1", "--trace", "0"], device="cpu",
              overrides={overrides!r})
print(json.dumps({{"rc": rc, "modules": sorted({{m.partition(".")[0]
                                              for m in sys.modules}})}}))
"""


def test_run_and_reference_load_no_jax():
    out = fresh(RUN.format(root=run.ROOT, cell=CELL,
                           overrides=dict(TINY, reads=2000)))
    assert out["rc"] == 0 and "dashing_tpu_torch" in out["modules"]
    assert not set(out["modules"]) & {"jax", "jaxlib", "flax", "dashing_tpu"}
    mods = set(fresh(f"""
import json, sys
sys.path.insert(0, {run.ROOT!r})
import portbench.reads, portbench.reference.countmin
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "dashing_tpu",
                       "dashing_tpu_torch"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(trace, capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rc = run.main(["--workload", CELL, "--seed", "4294967311", "--seconds",
                   "1", "--trace", str(trace)], device="cuda:0",
                  overrides=dict(TINY, reads=400000, genome_length=2000000,
                                 cm_size_log2=22))
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
        for name in ("cm_device_ms_per_job.reads",
                     "rehashed_tiles_per_job.reads"):
            assert res["metrics"][name]["value"] > 0
    else:
        assert "setup_s" in res["metrics"]
