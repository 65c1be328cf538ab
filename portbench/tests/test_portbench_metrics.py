"""Each per-layer metric reader on a recorded trace and recorded
buckets, and the trace's busy time, top operations and idle gaps."""
import pytest

from portbench import run
from portbench.trace import Trace, top

K2 = "void encode_hash_kernel<(In)1, (Out)0, false>(unsigned char const*)"


def recorded():
    """Two units of two K2 launches of 2 ms each, a copy, a compare
    kernel, host ranges around them."""
    dev = [(K2, 0.000, 0.002), (K2, 0.002, 0.004), ("Memcpy HtoD", 0.005, 0.006),
           (K2, 0.010, 0.012), (K2, 0.013, 0.015),
           ("joint_mle_kernel<32>", 0.016, 0.017)]
    host = [("pb.window", 0.0, 0.020), ("pb.sketch", 0.0041, 0.0099),
            ("aten::copy_", 0.0061, 0.0095)]
    return Trace(sorted(dev, key=lambda iv: iv[1]), host, 0.0, 0.020)


def ctx(trace, units=2, buckets=None):
    return run.Context(trace, units, buckets or {}, None)


def read(name, c):
    return run.load_reader(name)(c)


def test_trace_arithmetic():
    t = recorded()
    assert t.busy_s() == pytest.approx(0.004 + 0.001 + 0.002 + 0.002 + 0.001)
    assert t.window_s == pytest.approx(0.020)
    gaps = t.gaps()
    assert gaps[0] == pytest.approx((0.004, 0.005))
    idle = t.idle_by_host()
    # gap 0.004-0.005 (mid 0.0045): pb.sketch; 0.006-0.010 (mid 0.008):
    # aten::copy_ inside pb.sketch; 0.012-0.013, 0.015-0.016 and
    # 0.017-0.020: the window alone
    assert idle["pb.sketch"] == pytest.approx(0.001)
    assert idle["aten::copy_"] == pytest.approx(0.004)
    assert idle["pb.window"] == pytest.approx(0.001 + 0.001 + 0.003)
    assert top(t.by_name(), 1) == [[K2, pytest.approx(0.008)]]


def test_idle_share():
    name = "device_idle_share.dist"
    assert read(name, ctx(recorded())) == pytest.approx(50.0)
    assert read(name, ctx(Trace([], [], 0.0, 1.0))) is None


def test_bucket_readers():
    b = {"host.parse": 3.0, "host.pack2bit": 1.5, "all-pairs compare": 0.3}
    c = ctx(recorded(), units=3, buckets=b)
    assert read("host_parse_s_per_job.dist", c) == pytest.approx(1.0)
    assert read("host_pack_s_per_job.dist", c) == pytest.approx(0.5)
    assert read("compare_s_per_job.dist", c) == pytest.approx(0.1)
    empty = ctx(recorded(), units=3, buckets={})
    for name in ("host_parse_s_per_job.dist", "host_pack_s_per_job.dist",
                 "compare_s_per_job.dist"):
        assert read(name, empty) is None


def test_sketch_device_ms():
    # K2 8 ms, the copy and K5 left out, over 2 jobs
    assert read("sketch_device_ms_per_job.dist",
                ctx(recorded())) == pytest.approx(4.0)
