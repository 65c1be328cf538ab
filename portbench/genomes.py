"""Synthetic genome collections, made from a seed.

A collection is `ancestors` random genomes of `genome_length` bases, each
copied once at every substitution rate of `rates` (a Binomial(length,
rate) count of substitutions at uniform positions, each to one of the
three other bases); a copy gets `n_runs` runs of N
(each `run_min`..`run_max` bases long), is cut into `records` FASTA records
of equal size, and record `lower_record` is written in lowercase.  The
same seed gives the same genomes, and every seed the same sizes.

Copied from chip_smoke.py `_write_genomes` (that generator draws from a
fixed seed and tests every base against the rate); here the draws come
from the seed the benchmark is given, the substituted positions are drawn
by count, and the records are returned, so that a job kind can write
them once or hand them to the card without a file.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Genome:
    name: str                  # file stem, anc<a>_c<c>
    family: int                # ancestor index
    copy: int                  # index into the rates
    records: List[np.ndarray]  # uint8 ASCII, one array a record

    @property
    def bases(self) -> int:
        return sum(r.size for r in self.records)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for `seed` (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), 0])


def make_genomes(config: dict, seed: int) -> List[Genome]:
    """The collection that a configuration describes (its `genome_length`
    and `genomes` block), drawn from `seed`."""
    cfg = config["genomes"]
    rng = rng_for(seed)
    rates: Sequence[float] = cfg["rates"]
    length = int(config["genome_length"])
    n_rec = int(cfg["records"])
    cuts = np.linspace(0, length, n_rec + 1).astype(int)
    out: List[Genome] = []
    for a in range(int(cfg["ancestors"])):
        anc = rng.integers(0, 4, length, dtype=np.uint8)
        for c, rate in enumerate(rates):
            g = anc.copy()
            hit = rng.integers(0, length, rng.binomial(length, rate))
            g[hit] = (g[hit] + rng.integers(1, 4, hit.size,
                                            dtype=np.uint8)) & 3
            seq = _ACGT[g]
            starts = rng.integers(0, length - cfg["run_max"],
                                  int(cfg["n_runs"]))
            for s in starts:
                n = int(rng.integers(cfg["run_min"], cfg["run_max"]))
                seq[s:s + n] = ord("N")
            recs = [seq[cuts[r]:cuts[r + 1]] for r in range(n_rec)]
            lo = int(cfg["lower_record"])
            if 0 <= lo < n_rec:
                recs[lo] = recs[lo] | 0x20
            out.append(Genome(f"anc{a:04d}_c{c}", a, c, recs))
    return out


def write_fasta(genomes: Sequence[Genome], root: str) -> List[str]:
    """One FASTA file a genome under `root`, each record on one line;
    returns the paths in the genomes' order."""
    paths = []
    for g in genomes:
        path = os.path.join(root, g.name + ".fa")
        with open(path, "wb") as fp:
            for r, rec in enumerate(g.records):
                fp.write(b">%s_r%d\n" % (g.name.encode(), r))
                fp.write(rec.tobytes())
                fp.write(b"\n")
        paths.append(path)
    return paths
