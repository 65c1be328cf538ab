"""The port's host-only spans (metrics.span): a bucket like `accum`, and
a torch.profiler range of the same name on the thread that opens it,
only when DASHING_TPU_METRICS is on.  Regions that launch or copy keep
`accum` and open no range.  A small `dist` run on the CPU under a
profiler shows the spans of its dispatching thread; on a card (marked
`cuda`, skips without one) no device event carries a span's name."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dashing_tpu_torch import metrics, pipeline
from dashing_tpu_torch.cli import main as tmain

# the spans of dist's dispatching thread, and the buckets with no range
SPANS = ("sketch.parse_wait", "host.tile", "host.pack2bit", "host.parse",
         "cli.emit", "sketch.batch_stage", "compare.put")
ACCUMS = ("sketch.dispatch", "sketch.pull", "compare.dispatch", "cli.sizes")


@pytest.fixture()
def fresh(monkeypatch):
    """Empty buckets; the caller turns metrics on or off."""
    monkeypatch.setattr(metrics, "_totals", {})
    monkeypatch.setattr(metrics, "_counts", {})
    return monkeypatch


def write_genomes(root, rng, rates, length):
    """FASTAs of two records from one ancestor at planted substitution
    rates; returns their names."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, length, dtype=np.uint8)
    names = []
    for i, rate in enumerate(rates):
        g = anc.copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + 1) & 3
        seq = lut[g].tobytes()
        (root / f"s{i}.fa").write_bytes(
            b">a\n%s\n>b\n%s\n" % (seq[:length // 2], seq[length // 2:]))
        names.append(f"s{i}.fa")
    return names


def _cpu_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CPU]


def _names(prof):
    return {e.name for e in _cpu_events(prof)}


@pytest.mark.parametrize("name", SPANS)
def test_span_off_records_nothing(fresh, name):
    fresh.setattr(metrics, "_ENABLED", False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span(name, items=7):
            sum(range(1000))
    assert metrics._totals == {} and metrics._counts == {}
    assert name not in _names(prof)


@pytest.mark.parametrize("name", SPANS)
def test_span_on_records_bucket_and_range(fresh, name):
    fresh.setattr(metrics, "_ENABLED", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with metrics.span(name, items=5):
                sum(range(1000))
    assert metrics._totals[name] > 0
    assert metrics._counts[name] == 10
    ranges = [e for e in _cpu_events(prof) if e.name == name]
    assert len(ranges) == 2
    # the range lies on the profiler's clock and encloses the bucket's
    # clock, so the range's own cost stays out of the bucket
    assert all(e.time_range.end >= e.time_range.start for e in ranges)
    assert sum(e.time_range.elapsed_us() for e in ranges) * 1e-6 \
        >= metrics._totals[name]


def test_span_closes_on_error(fresh):
    fresh.setattr(metrics, "_ENABLED", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with metrics.span("host.tile"):
                raise KeyError("x")
        with metrics.span("cli.emit"):
            pass
    assert set(metrics._totals) == {"host.tile", "cli.emit"}
    assert {"host.tile", "cli.emit"} <= _names(prof)


@pytest.mark.parametrize("name", ACCUMS)
def test_accum_opens_no_range(fresh, name):
    fresh.setattr(metrics, "_ENABLED", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.accum(name):
            torch.ones(4).add_(1)
    assert metrics._totals[name] > 0
    names = _names(prof)
    assert name not in names and "aten::add_" in names


def _dist(tmp_path, monkeypatch, extra=()):
    names = write_genomes(tmp_path, np.random.default_rng(5),
                          (0.0, 0.01, 0.02), length=6000)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    argv = ["dist", "-k", "21", "-S", "12", "-M", "-b", "-O", "d.bin",
            "-o", "sizes.tsv"] + list(extra) + names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tmain.main(argv) == 0
    assert (tmp_path / "d.bin.labels").read_text().split() == names
    return prof


@pytest.mark.parametrize("streamed", [False, True])
def test_dist_spans_on_dispatching_thread(fresh, tmp_path, streamed):
    """Whole files of one chunk: the worker parses, the dispatching thread
    waits on its future, packs each file from its joined bytes (no tile is
    cut), stages the batch and emits.  Streamed files: it waits on the
    read-ahead queue, whose thread parses and tiles."""
    fresh.setattr(metrics, "_ENABLED", True)
    if streamed:
        fresh.setattr(pipeline, "STREAM_THRESHOLD", 0)
    prof = _dist(tmp_path, fresh)
    names = _names(prof)
    on_thread = {"sketch.parse_wait", "host.pack2bit", "cli.emit",
                 "compare.put"}
    if not streamed:
        on_thread.add("sketch.batch_stage")
    assert on_thread <= names
    assert "host.tile" not in names
    # the regions that launch or copy are buckets with no range
    assert not set(ACCUMS) & names
    for bucket in ("host.parse", "host.pack2bit", "all-pairs compare",
                   "sketch.parse_wait", "cli.sizes", "cli.emit",
                   "sketch.pull") + (("host.tile",) if streamed else ()):
        assert metrics._totals.get(bucket, 0.0) > 0, bucket
    assert ("host.tile" in metrics._totals) == streamed


def test_small_file_dist_batch_stage_and_put(fresh, tmp_path):
    """Files of one chunk: each is packed from its joined bytes (one
    `host.pack2bit` a file); the batch's host staging (its rows joined and
    the bank vector) opens `sketch.batch_stage` on the dispatching thread;
    each compare tile's scatter into the condensed output opens
    `compare.put`; `small_batches` counts the one batch."""
    fresh.setattr(metrics, "_ENABLED", True)
    before = pipeline.small_batches
    prof = _dist(tmp_path, fresh)
    assert pipeline.small_batches - before == 1
    assert {"sketch.batch_stage", "compare.put"} <= _names(prof)
    assert len([e for e in _cpu_events(prof)
                if e.name == "host.pack2bit"]) == 3
    for bucket in ("sketch.batch_stage", "compare.put"):
        assert metrics._totals[bucket] > 0, bucket


def test_joined_dist_opens_no_batch_stage(fresh, tmp_path):
    """Whole files of several chunks (rows of 1,024 bases, 2 rows a
    chunk) take the joined route: no batch, so no `sketch.batch_stage`
    and no count in `small_batches`; the compare still opens
    `compare.put`."""
    fresh.setattr(metrics, "_ENABLED", True)
    fresh.setattr(pipeline, "CONTENT", 1024)
    fresh.setattr(pipeline, "MAX_ROWS", 2)
    before = pipeline.small_batches, pipeline.joined_packs
    prof = _dist(tmp_path, fresh)
    names = _names(prof)
    assert pipeline.small_batches == before[0]
    assert pipeline.joined_packs - before[1] == 3 * 3
    assert "sketch.batch_stage" not in names
    assert "sketch.batch_stage" not in metrics._totals
    assert "compare.put" in names


def test_dist_metrics_off_leaves_no_trace(fresh, tmp_path):
    fresh.setattr(metrics, "_ENABLED", False)
    prof = _dist(tmp_path, fresh)
    assert metrics._totals == {}
    assert not set(SPANS) & _names(prof)


@pytest.mark.cuda
def test_no_device_event_named_after_a_span(fresh, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    fresh.setattr(metrics, "_ENABLED", True)
    names = write_genomes(tmp_path, np.random.default_rng(5),
                          (0.0, 0.01, 0.02, 0.04), length=2_200_000)
    fresh.chdir(tmp_path)
    fresh.setenv("DASHING_TPU_TORCH_DEVICE", "cuda")
    argv = ["dist", "-k", "31", "-S", "16", "-M", "-b", "-O", "d.bin",
            "-o", "sizes.tsv"] + names
    assert tmain.main(list(argv)) == 0                 # builds, warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert tmain.main(list(argv)) == 0
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    assert device, "the profiler saw no device work"
    assert not {e.name for e in device} & (set(SPANS) | set(ACCUMS))
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    # files of 269 rows: each chunk is packed from the joined bytes, so no
    # tile is cut
    assert {"sketch.parse_wait", "host.pack2bit", "cli.emit"} <= host
    assert "host.tile" not in host
