"""In a fresh process, a run of portbench/run.py loads neither JAX nor
the JAX package, and the reference loads nothing of the program either
(top-level module names, the part before the first dot, compared
whole)."""
import json
import os
import subprocess
import sys

from portbench import run

RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from helpers import tiny
from portbench import run
rc = run.main(["--workload", {cell!r}, "--seed", "2147483659",
               "--seconds", "0.1", "--trace", "0"], device="cpu",
              overrides=tiny({config!r}, length=6000, ancestors=1))
print(json.dumps({{"rc": rc, "modules": sorted({{m.partition(".")[0]
                                              for m in sys.modules}})}}))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.compare, portbench.reference.estimators
import portbench.reference.sketch
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def fresh(code: str):
    env = dict(os.environ, DASHING_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax():
    tests = os.path.dirname(os.path.abspath(__file__))
    for cell, config in (("bact100.dist_mle", "bact100_k31_s16"),
                         ("bact100.dist_w50", "bact100_k31_s16")):
        out = fresh(RUN.format(root=run.ROOT, tests=tests, cell=cell,
                               config=config))
        assert out["rc"] == 0
        assert "dashing_tpu_torch" in out["modules"]
        assert not set(out["modules"]) & {"jax", "jaxlib", "flax",
                                          "dashing_tpu"}


def test_reference_loads_no_jax_and_no_program():
    mods = set(fresh(REF.format(root=run.ROOT)))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "dashing_tpu",
                       "dashing_tpu_torch"}


def test_forbidden_names_are_whole(monkeypatch):
    # the port's name begins with the JAX package's: only whole names count
    real = set(run.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "dashing_tpu_torch_x.y", json)
    assert set(run.forbidden_loaded()) == real
    monkeypatch.setitem(sys.modules, "jax.numpy", json)
    assert "jax" in run.forbidden_loaded()
