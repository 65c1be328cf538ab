"""Synthetic read sets, made from a seed and written as FASTQ.

A read set is `reads` reads of `read_length` bases, each from a uniform
position of one random genome of `genome_length` bases; half of them,
drawn at random, are reverse-complemented; then a Binomial(bases,
`substitution_rate`) count of substitutions falls at uniform positions of
each batch of reads, each to one of the three other bases.  The records
are of fixed width: `@r` and a zero-padded id, the bases, `+`, and as many
`I` qualities as bases.  The same seed gives the same file, and every seed
the same size.

Written array by array, a batch of reads at a time, as chip_smoke.py's
`write_reads` writes its reads; the draws here come from the seed the
benchmark is given.
"""
from __future__ import annotations

import numpy as np

from portbench.genomes import rng_for

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def id_digits(config: dict) -> int:
    return len(str(max(int(config["reads"]) - 1, 0)))


def record_bytes(config: dict) -> int:
    """The bytes of one record: header, bases, `+` line, qualities."""
    return 2 + id_digits(config) + 1 + 2 * int(config["read_length"]) + 4


def file_bytes(config: dict) -> int:
    return int(config["reads"]) * record_bytes(config)


def write_fastq(config: dict, seed: int, path: str,
                batch: int = 250_000) -> int:
    """Write the read set of `config` drawn from `seed` to `path`; returns
    its bases."""
    rng = rng_for(seed)
    n_reads, L = int(config["reads"]), int(config["read_length"])
    length = int(config["genome_length"])
    rate = float(config["substitution_rate"])
    digits = id_digits(config)
    genome = rng.integers(0, 4, length, dtype=np.uint8)
    head = 2 + digits + 1
    with open(path, "wb") as fp:
        for b0 in range(0, n_reads, batch):
            n = min(batch, n_reads - b0)
            starts = rng.integers(0, length - L + 1, n)
            c = genome[starts[:, None] + np.arange(L)]
            flip = rng.random(n) < 0.5
            c[flip] = 3 - c[flip, ::-1]
            flat = c.reshape(-1)
            hit = rng.integers(0, flat.size, rng.binomial(flat.size, rate))
            flat[hit] = (flat[hit] + rng.integers(1, 4, hit.size,
                                                  dtype=np.uint8)) & 3
            rec = np.empty((n, record_bytes(config)), np.uint8)
            rec[:, 0], rec[:, 1] = ord("@"), ord("r")
            ids = np.arange(b0, b0 + n)
            for d in range(digits):
                rec[:, 1 + digits - d] = ord("0") + (ids // 10 ** d) % 10
            rec[:, head - 1] = ord("\n")
            rec[:, head:head + L] = _ACGT[c]
            rec[:, head + L:head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, head + L + 3:head + 2 * L + 3] = ord("I")
            rec[:, -1] = ord("\n")
            fp.write(rec.tobytes())
    return n_reads * L
