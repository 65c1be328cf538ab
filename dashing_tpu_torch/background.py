"""Multi-k Jukes-Cantor distance model (the port's copy of
dashing_tpu/background.py; host numpy, `mkdist --jukes-cantor`).

Reference src/background.cpp:31-175 + src/background.h — computes per-genome
nucleotide frequencies, the expected random k-mer match probability, and a
regression of log(intersection - background) on k whose slope recovers the
per-site match probability p, mapped to the Jukes-Cantor distance

    jc = -(3/4) * log1p(-(4/3) * (1 - p))      (background.h:31-33)

In the reference this is only invoked from an `#if 0` block
(mkdistmain.cpp:120-140); here it is live behind `mkdist --jukes-cantor`.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def nuc_freqs(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-genome ACGT frequencies, total sizes, record counts
    (reference nuc_freqs, background.cpp:31-76)."""
    from .io import fasta
    from .io.paths import split_subpaths
    freqs = np.zeros((len(paths), 4), np.float64)
    sizes = np.zeros(len(paths), np.int64)
    numseqs = np.zeros(len(paths), np.int64)
    lut = np.full(256, -1, np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
        lut[ord(chr(b).lower())] = i
    for gi, path in enumerate(paths):
        counts = np.zeros(4, np.int64)
        for sub in split_subpaths(path):
            for _, seq in fasta.read_records(sub):
                arr = lut[np.frombuffer(seq, np.uint8)]
                counts += np.bincount(arr[arr >= 0], minlength=4)[:4]
                sizes[gi] += len(seq)
                numseqs[gi] += 1
        # sizes[gi] accumulated TOTAL sequence length above, including
        # N/ambiguous bases — the reference sums ks->seq.l
        # (background.cpp) and jukes_cantor_p's corrected k-mer count
        # uses that length; frequencies stay ACGT-conditional (the
        # reference's freqs are counts over the same 4 bins)
        total = counts.sum()
        freqs[gi] = counts / max(total, 1)
    return freqs, sizes, numseqs


def background_match(freq_a: np.ndarray, freq_b: np.ndarray) -> float:
    """Expected per-site random match probability sum_b fa[b]*fb[b]
    (reference background.cpp:9-28 SSE dot)."""
    return float(np.dot(freq_a, freq_b))


def jukes_cantor_p(k_values: Sequence[int], isizes: Sequence[float],
                   bg: float, n1: float, n2: float,
                   ns1: int = 1, ns2: int = 1) -> float:
    """Regress log(isz_k - bg^k * 4 * c1 * c2) on k; slope -> p = e^slope,
    where c = size - (k-1)*numseqs is the per-k corrected k-mer count
    (reference jukes_cantor_p, background.cpp:78-99: corrected_size
    lambda at :85 — matters for fragmented assemblies at large k)."""
    xs, ys = [], []
    for k, isz in zip(k_values, isizes):
        c1 = max(n1 - (k - 1) * ns1, 0.0)
        c2 = max(n2 - (k - 1) * ns2, 0.0)
        corrected = isz - (bg ** k) * 4.0 * c1 * c2
        if corrected > 0:
            xs.append(float(k))
            ys.append(math.log(corrected))
    if len(xs) < 2:
        return float("nan")
    slope = np.polyfit(xs, ys, 1)[0]
    return math.exp(slope)


def jcp2dist(p: float) -> float:
    """reference background.h:31-33."""
    if not (0.0 < p <= 1.0):
        return float("nan")
    arg = 1.0 - (4.0 / 3.0) * (1.0 - p)
    if arg <= 0:
        return float("inf")
    return -0.75 * math.log(arg)


def mkmat2jcdistmat(flat_path: str, genome_paths: Sequence[str]) -> np.ndarray:
    """Flattened multi-k SIZES matrices -> condensed Jukes-Cantor distances
    (reference mkmat2jcdistmat, background.cpp:102-175)."""
    from .io.distmat import read_flattened
    nsets, ks, data = read_flattened(flat_path)   # data: (ne, nk)
    freqs, sizes, numseqs = nuc_freqs(genome_paths)
    n = int(nsets)
    if len(genome_paths) != n:
        raise SystemExit(
            f"jukes-cantor: {len(genome_paths)} genome paths but the "
            f"flattened matrix holds {n} sets")
    out = np.empty(data.shape[0], np.float32)
    ks_list = [int(k) for k in ks]
    pos = 0
    for i in range(n):
        for j in range(i + 1, n):
            bg = background_match(freqs[i], freqs[j])
            p = jukes_cantor_p(ks_list, data[pos], bg,
                               float(sizes[i]), float(sizes[j]),
                               int(numseqs[i]), int(numseqs[j]))
            out[pos] = jcp2dist(p) if p == p else float("nan")
            pos += 1
    return out
