"""The harness finds every configuration, traffic mix, metric reader
and limit file that BENCHMARK.json names, by name."""
import json
import os

from portbench import jobs, run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


def test_every_cell_loads():
    for cell in BENCH["workloads"]:
        bench, got, config, traffic, limits = run.load_cell(cell["name"])
        assert got == cell and config["name"] == cell["config"]
        assert os.path.isfile(jobs.kind_path(traffic["job"]))
        assert callable(jobs.load_kind(traffic["job"]))
        assert limits, cell["name"]


def test_every_metric_has_a_reader_and_every_cell_metrics():
    for m in BENCH["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(BENCH, cell["name"],
                                                   "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, cell["name"], "per_layer")


def test_every_config_is_used_and_lies_under_paths():
    used = {c["config"] for c in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = json.load(open(os.path.join(run.ROOT, c["file"])))
        for key in c["reduced"]:
            assert key in data
