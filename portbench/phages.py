"""A synthetic collection of complete phage genomes, made from a seed.

The configuration's `collection` block gives `ancestors` random genomes
whose lengths are log-normal (median `length_median`, shape
`length_sigma`, clipped to `length_min`..`length_max`, one length drawn
an ancestor), each copied once at every substitution rate of `rates` (a
Binomial(length, rate) count of substitutions at uniform positions, each
to one of the three other bases, as genomes.py draws them).  A genome is
one uppercase record with no N: a complete genome has no assembly gaps.
`genomes` must equal ancestors x rates.  The same seed gives the same
lengths and the same bases.
"""
from __future__ import annotations

from typing import List

import numpy as np

from portbench.genomes import Genome, rng_for

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def lengths(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """The ancestors' lengths: log-normal about the median, clipped."""
    raw = rng.lognormal(np.log(float(cfg["length_median"])),
                        float(cfg["length_sigma"]), int(cfg["ancestors"]))
    return np.clip(np.rint(raw), int(cfg["length_min"]),
                   int(cfg["length_max"])).astype(np.int64)


def make_phages(config: dict, seed: int) -> List[Genome]:
    """The collection that a configuration's `collection` block describes,
    drawn from `seed`: ancestor after ancestor, its copies in the order
    of the rates."""
    cfg = config["collection"]
    rates = [float(r) for r in cfg["rates"]]
    if int(cfg["genomes"]) != int(cfg["ancestors"]) * len(rates):
        raise ValueError(f"{cfg['genomes']} genomes are not "
                         f"{cfg['ancestors']} ancestors x {len(rates)} rates")
    rng = rng_for(seed)
    out: List[Genome] = []
    for a, length in enumerate(lengths(cfg, rng)):
        anc = rng.integers(0, 4, int(length), dtype=np.uint8)
        for c, rate in enumerate(rates):
            g = anc.copy()
            hit = rng.integers(0, length, rng.binomial(length, rate))
            g[hit] = (g[hit] + rng.integers(1, 4, hit.size,
                                            dtype=np.uint8)) & 3
            out.append(Genome(f"phage{a:05d}_c{c}", a, c, [_ACGT[g]]))
    return out
