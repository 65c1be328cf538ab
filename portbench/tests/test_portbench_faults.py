"""A run with the timed path broken underneath comes out not correct,
for each fault a cell can have, and a sound run comes out correct; the
control (the reference in the program's place, one precision lower)
fails the limits.  The run's look for a card is skipped: the program
runs its plain versions on the CPU, at a small size."""
import json

import pytest

from portbench import jobs, run
from helpers import tiny, tiny_config

CELLS = {"bact100.dist_mle": "bact100_k31_s16",
         "bact100.dist_w50": "bact100_k31_s16"}


def result(cell, capsys, seed=5_000_000_011):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", "0"], device="cpu",
                  overrides=tiny(CELLS[cell], length=30000, ancestors=2))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the faults, each planted in the program where it produces the value


def unchanged_state(monkeypatch):
    """Every fold returns its registers as they were."""
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash
    regs_at = {"packed_to_registers": 2, "packed_to_banks": 3,
               "ascii_to_registers": 1, "ascii_to_banks": 2,
               "tile_to_registers": 1, "tile_to_banks": 2}
    for mod in (pipeline, encode_hash):
        for name, i in regs_at.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    lambda *a, i=i, **kw: a[i])


def half_batch(monkeypatch):
    """Half of each upload's rows left out."""
    from dashing_tpu_torch import pipeline
    real = pipeline._upload

    def upload(*arrays, device):
        arrays = [a.copy() for a in arrays]
        r = arrays[0].shape[0] // 2
        if len(arrays) >= 2 and arrays[1].ndim == 2:     # packed, vbits
            arrays[1][r:] = 0
        else:                                           # ASCII
            arrays[0][r:] = ord("N")
        return real(*arrays, device=device)

    monkeypatch.setattr(pipeline, "_upload", upload)


def altered_answer(monkeypatch):
    """One distance of the matrix (the first pair's: two copies of one
    ancestor) altered where it is computed."""
    from dashing_tpu_torch.cli import core
    real = core.compare_condensed

    def compare(*a, **kw):
        out = real(*a, **kw)
        out[0] += 0.01
        return out

    monkeypatch.setattr(core, "compare_condensed", compare)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell, capsys):
    res = result(cell, capsys)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cell", list(CELLS))
def test_fault_is_caught(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = result(cell, capsys)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_fails(cell):
    bench, _, config, traffic, limits = run.load_cell(cell)
    config = tiny_config(CELLS[cell], length=30000, ancestors=2)
    import torch
    job = jobs.make(config, traffic, 99, torch.device("cpu"))
    job.setup()
    try:
        numbers = job.check(control=True)
    finally:
        job.close()
    checks, correct = run.judge(numbers, limits, 0)
    assert not correct, checks
