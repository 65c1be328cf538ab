"""The port's k-mers/s benchmark (python -m dashing_tpu_torch.bench) on the
CPU at a tiny geometry: bench.py's JSON keys, registers equal to the plain
fold of the same chunks, the pinned baseline read from BASELINE.json, and
no silent CPU run when the card is missing."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from dashing_tpu.hashes import wang_hash_np as jax_wang_hash_np
from dashing_tpu_torch import bench
from dashing_tpu_torch.ops import encode_hash as eh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_pinned",
        "host_baseline_measured"}

def test_bench_prints_bench_keys(capsys, monkeypatch):
    # the entry point as a user calls it, at a tiny geometry
    monkeypatch.setattr(bench, "run", functools.partial(
        bench.run, rows=3, content=200, iters=2, host_n=2048))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert KEYS <= set(rec) and rec["device"] == "cpu"
    assert rec["metric"] == "kmers_sketched_per_sec_per_chip"
    assert rec["unit"] == "kmers/s" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / rec["baseline_pinned"],
                                       3)
    assert err.strip().splitlines()[-1] == "cpu"


def test_bench_registers_equal_plain_fold():
    rec, regs = bench.run(torch.device("cpu"), rows=4, content=160, iters=3,
                          host_n=1024)
    chunks = bench.make_chunks(4, 160, 3)
    assert chunks.shape == (3, 4, 160 + bench.K - 1)
    # bench.py's chunks: the same draw from default_rng(0)
    np.testing.assert_array_equal(
        chunks, np.random.default_rng(0).choice(
            np.frombuffer(b"ACGT", np.uint8), size=chunks.shape))
    want = torch.zeros(1 << bench.P, dtype=torch.int32)
    for c in chunks:
        eh.ascii_to_registers_plain(torch.from_numpy(c), want, k=bench.K,
                                    p=bench.P, canon=True)
    assert int((want > 0).sum()) > 1000
    assert torch.equal(regs, want)


def test_pinned_and_host_baselines():
    with open(os.path.join(REPO, "BASELINE.json")) as fp:
        pinned = json.load(fp)["pinned_numpy_baseline_kmers_per_sec"]
    assert bench.pinned_baseline() == pinned
    assert bench.host_baseline_rate(n=2048, reps=1) > 0
    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(bench.wang_hash_np(x), jax_wang_hash_np(x))


def test_bench_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DASHING_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
