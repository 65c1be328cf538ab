"""The readers of the program's spans on the dispatching thread of dist
(the wait on the parse worker, tiling, emission) on a recorded trace and
recorded buckets: the buckets over the jobs, and the device's idle time
inside the `sketch.parse_wait` ranges by overlap."""
import pytest

from portbench import run
from portbench.trace import Trace

K1 = "void encode_hash_kernel<(In)0, (Out)0, false>(unsigned char const*)"
SPAN_READERS = {"parse_wait_s_per_job.dist": "sketch.parse_wait",
                "host_tile_s_per_job.dist": "host.tile",
                "emit_s_per_job.dist": "cli.emit"}


def recorded():
    """One job of 20 ms: kernels at 0-2, 5-6 and 12-14 ms; a parse wait
    over 1-4 ms (a gap of 2-5 ms, so 2 ms of it inside), a second one
    nested in the harness's sketch range over 9-11 ms (wholly in the gap
    6-12 ms), and a tile span in no gap."""
    dev = [(K1, 0.000, 0.002), ("Memcpy HtoD", 0.005, 0.006),
           (K1, 0.012, 0.014)]
    host = [("pb.window", 0.0, 0.020), ("pb.sketch", 0.0005, 0.0150),
            ("sketch.parse_wait", 0.001, 0.004),
            ("sketch.parse_wait", 0.009, 0.011),
            ("host.tile", 0.0125, 0.0135),
            ("cli.emit", 0.016, 0.019)]
    return Trace(dev, sorted(host, key=lambda iv: iv[1]), 0.0, 0.020)


def read(name, trace, units=1, buckets=None):
    return run.load_reader(name)(run.Context(trace, units, buckets or {},
                                             None))


@pytest.mark.parametrize("name,bucket", sorted(SPAN_READERS.items()))
def test_bucket_over_jobs(name, bucket):
    b = {bucket: 0.9, "host.parse": 5.0}
    assert read(name, recorded(), units=3, buckets=b) == pytest.approx(0.3)
    assert read(name, recorded(), units=3, buckets={bucket: 0.0}) == 0.0
    # absent bucket (a program without the span) or no job: nothing to read
    assert read(name, recorded(), units=3, buckets={"host.parse": 5.0}) \
        is None
    assert read(name, recorded(), units=0, buckets=b) is None


def test_idle_parse_wait_by_overlap():
    name = "idle_parse_wait_s_per_job.dist"
    # gap 2-5 ms half-covered by the wait 1-4 ms: 2 ms; the wait 9-11 ms
    # inside the gap 6-12 ms: 2 ms
    assert read(name, recorded()) == pytest.approx(0.004)
    assert read(name, recorded(), units=2) == pytest.approx(0.002)
    # the midpoint rule labels gap 2-5 (mid 3.5) by the wait, but the
    # reader counts only the part inside the range
    t = recorded()
    assert t.idle_by_host()["sketch.parse_wait"] == pytest.approx(0.003
                                                                 + 0.006)


@pytest.mark.parametrize("waits,want", [
    # two overlapping ranges count once
    ([(0.001, 0.004), (0.003, 0.005)], 0.003),
    # a range over several gaps and the busy time between them
    ([(0.0, 0.020)], 0.020 - 0.002 - 0.001 - 0.002),
    # a range in busy time only
    ([(0.0125, 0.0135)], 0.0),
])
def test_idle_parse_wait_cases(waits, want):
    t = recorded()
    t.host = sorted([iv for iv in t.host if iv[0] != "sketch.parse_wait"]
                    + [("sketch.parse_wait", s, e) for s, e in waits],
                    key=lambda iv: iv[1])
    assert read("idle_parse_wait_s_per_job.dist", t) == pytest.approx(want)


def test_idle_parse_wait_absent():
    t = recorded()
    t.host = [iv for iv in t.host if iv[0] != "sketch.parse_wait"]
    assert read("idle_parse_wait_s_per_job.dist", t) is None
    assert read("idle_parse_wait_s_per_job.dist", recorded(),
                units=0) is None


def test_new_metrics_declared():
    """Each reader is a per_layer entry of BENCHMARK.json for both dist
    cells, moving bases_per_s."""
    bench, *_ = run.load_cell("bact100.dist_mle")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in list(SPAN_READERS) + ["idle_parse_wait_s_per_job.dist"]:
        m = per_layer[name]
        assert m["moves"] == "bases_per_s" and m["better"] == "lower"
        assert m["workloads"] == ["bact100.dist_mle", "bact100.dist_w50"]
