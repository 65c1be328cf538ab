"""Each cell at a small size on the card, traced and untraced: the run's
result line is whole and correct.  Skips without a card."""
import json

import pytest

from portbench import run
from helpers import tiny
from test_portbench_faults import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_on_the_card(cell, trace, capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds",
                   "1", "--trace", str(trace)], device="cuda:0",
                  overrides=tiny(CELLS[cell], length=200000, ancestors=2))
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
    else:
        assert "setup_s" in res["metrics"]
