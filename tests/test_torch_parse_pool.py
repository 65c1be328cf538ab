"""The sketch engine's parse prefetch (`pipeline.prefetch`) on the CPU:
its workers come from the CPUs the process may use (two at most, one kept
for the dispatching thread), files come back in index order whatever order
their parses end in, a parse error is raised at its own file, stopping
early cancels the parses not yet begun, and `parse_overlaps` counts the
parses that began while another ran."""
import sys
import threading
import time

import numpy as np
import pytest

from dashing_tpu_torch import pipeline

SP = pipeline.SketchParams(k=21).spacer()


@pytest.fixture()
def cpus(monkeypatch):
    """Set the CPUs the process may use."""
    def set_count(n):
        monkeypatch.setattr(pipeline.os, "sched_getaffinity",
                            lambda pid: set(range(n)))
    return set_count


@pytest.mark.parametrize("n,workers", [(1, 1), (2, 1), (3, 2), (8, 2),
                                       (64, 2)])
def test_workers_from_affinity(cpus, n, workers):
    cpus(n)
    assert pipeline.parse_workers() == workers


class FakeParse:
    """pipeline._read_joined standing in for the native parser: file i's
    join is i + 1 bytes of value i, ready after delays[i] seconds; a file
    in `fail` raises.  Records the order parses begin in."""

    def __init__(self, delays, fail=()):
        self.delays, self.fail = delays, set(fail)
        self.begun = []
        self.lock = threading.Lock()

    def __call__(self, path, halo):
        i = int(path)
        assert halo == SP.halo
        with self.lock:
            self.begun.append(i)
        time.sleep(self.delays[i])
        if i in self.fail:
            raise ValueError(f"{path}: malformed")
        return np.full(i + 1, i, np.uint8)


def _files(n):
    return [(i, str(i)) for i in range(n)]


def _pool(monkeypatch, parse):
    monkeypatch.setattr(pipeline, "_read_joined", parse)
    monkeypatch.setattr(pipeline, "should_stream", lambda path: False)


def test_index_order_with_two_workers(monkeypatch, cpus):
    """Later files finish first; they still come back in index order,
    each with its own join, and parses overlap."""
    cpus(4)
    delays = [0.12, 0.01, 0.08, 0.01, 0.05, 0.0, 0.02, 0.0]
    parse = FakeParse(delays)
    _pool(monkeypatch, parse)
    before = pipeline.parse_overlaps
    got = []
    for f in pipeline.prefetch(_files(len(delays)), SP):
        np.testing.assert_array_equal(f.joined,
                                      np.full(f.index + 1, f.index, np.uint8))
        got.append(f.index)
    assert got == list(range(len(delays)))
    assert sorted(parse.begun) == got
    assert pipeline.parse_overlaps - before > 0


def test_error_at_its_own_file(monkeypatch, cpus):
    """A parse that fails early, ahead of the files before it, raises only
    when its own file is taken."""
    cpus(4)
    parse = FakeParse([0.1, 0.05, 0.0, 0.0, 0.0], fail={2})
    _pool(monkeypatch, parse)
    gen = pipeline.prefetch(_files(5), SP)
    assert [next(gen).index, next(gen).index] == [0, 1]
    with pytest.raises(ValueError, match="2: malformed"):
        next(gen)


def test_early_stop_cancels_outstanding(monkeypatch, cpus):
    """Closing the generator after the first file waits for the parses
    already running and cancels those not yet begun."""
    cpus(4)
    parse = FakeParse([0.05] + [1.0] * 11)
    _pool(monkeypatch, parse)
    gen = pipeline.prefetch(_files(12), SP)
    assert next(gen).index == 0
    # files 0-3 were submitted; 1 is running, 2 may have begun, 3 waits
    # for a worker until file 1 ends, and is cancelled; the pool's threads
    # have ended when close() returns
    gen.close()
    assert sorted(parse.begun) in ([0, 1], [0, 1, 2])


def test_one_cpu_one_worker_no_overlap(monkeypatch, cpus):
    cpus(1)
    assert pipeline.parse_workers() == 1
    parse = FakeParse([0.02] * 6)
    _pool(monkeypatch, parse)
    before = pipeline.parse_overlaps
    got = [f.index for f in pipeline.prefetch(_files(6), SP)]
    assert got == list(range(6)) and parse.begun == got
    assert pipeline.parse_overlaps == before


def test_streamed_file_has_no_join(monkeypatch, cpus, tmp_path):
    """A file large enough to stream is not parsed by the pool: its tiles
    come from the read-ahead thread, and no join is given beside them."""
    cpus(4)
    path = tmp_path / "a.fa"
    path.write_bytes(b">a\n" + b"ACGT" * 3000 + b"\n")
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    f, = pipeline.prefetch([(0, str(path))], SP)
    assert f.index == 0 and f.joined is None
    want = list(pipeline._joined_tiles(
        pipeline._read_joined(str(path), SP.halo), SP.halo))
    got = list(f.tiles())
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])


def test_overlap_count_under_switches(monkeypatch):
    """16 threads parse at once with the interpreter switching threads
    every microsecond: the running count returns to 0 and the overlaps
    stay below the parses, which a lost update under the lock would
    break."""
    def parse(path, halo):
        time.sleep(0)               # gives the interpreter lock away
        return np.zeros(1, np.uint8)

    monkeypatch.setattr(pipeline, "_read_joined", parse)
    before = pipeline.parse_overlaps
    start = threading.Barrier(16)

    def work():
        start.wait(timeout=10)
        for _ in range(200):
            pipeline._parse("x", SP.halo)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert pipeline._parsing == 0
    assert 0 < pipeline.parse_overlaps - before < 16 * 200
