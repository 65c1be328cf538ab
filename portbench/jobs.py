"""What every job kind shares, and the loader that finds a kind by name.

A traffic mix (traffic/<mix>.json) names its `job` kind and its
parameters.  The kind is the file kinds/<job>.py, whose
`make(config, traffic, seed, device)` returns a Job built from a
configuration, the mix and a seed.  A new kind (reads from FASTQ, a
screen from sketch files, readfilt) is a new file there that imports
this module and a generator of its inputs (genomes.py, or one of its
own); it edits no file that is already here.

A Job names the end-to-end rate it reports (`rate_metric`) and has
`setup()` (inputs, uploads), `run()` (one unit; returns its work),
`after()` (per-unit bookkeeping outside the timed unit), `counters()`
(the program's launch counters), `release()` (frees the program's
state), `check(control)` (the compared numbers, from the program's
outputs or, with control=True, from the control put in its place) and
`close()`.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


class Job:
    rate_metric = ""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.work: Dict[str, int] = {}

    def counters(self) -> Dict[str, int]:
        from dashing_tpu_torch.ops import (encode_hash, joint_mle,
                                           joint_stats, union_mle)
        return {"K1": encode_hash.launches,
                "K1_banked": encode_hash.banks_launches,
                "K2": encode_hash.ascii_launches,
                "K3": union_mle.launches,
                "rows": union_mle.estimate_launches,
                "K4": joint_stats.launches,
                "K4_x": joint_stats.cum_union_launches,
                "K5": joint_mle.launches}

    def after(self) -> None:
        pass

    def release(self) -> None:
        pass

    def close(self) -> None:
        pass


def kind_path(name: str) -> str:
    return os.path.join(HERE, "kinds", name + ".py")


def load_kind(name: str):
    """kinds/<name>.py's `make`."""
    spec = importlib.util.spec_from_file_location(
        "portbench_kind_" + name.replace(".", "_"), kind_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make(config: dict, traffic: dict, seed: int, device) -> Job:
    return load_kind(traffic["job"])(config, traffic, seed, device)
