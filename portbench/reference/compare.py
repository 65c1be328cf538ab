"""What a dist job should have written, worked out again from the FASTA
files, and the gaps between that and what the job wrote.

`expected(...)` gives the sizes (the `-o` file: each genome's MLE
cardinality) and the Jaccard index of every pair (the `-b` matrix holds
its Mash distance): by inclusion and exclusion of the single MLEs of A, B
and their union, or under `-J` by the joint MLE.  `dtype` is the
precision of the estimators: float64 for the reference, bfloat16 for the
control.  The registers are exact integers either way.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import estimators as est
from . import sketch

PAIR_BLOCK = 1 << 18          # pairs an estimator solves at once


def union_histograms(a: torch.Tensor, b: torch.Tensor, p: int
                     ) -> torch.Tensor:
    """(na, nb, q+2) histograms of max(a, b) for every pair of rows, by
    float64 products of the indicators a <= k and b <= k."""
    q = 64 - p
    out = torch.zeros(a.shape[0], b.shape[0], q + 2, dtype=torch.float64,
                      device=a.device)
    prev = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64,
                       device=a.device)
    for k in range(q + 2):
        cum = (a <= k).double() @ (b <= k).double().T
        out[:, :, k] = cum - prev
        prev = cum
        if bool((cum == a.shape[1]).all()):
            break
    return out


def expected(regs: torch.Tensor, p: int, joint: bool,
             dtype=torch.float64, row_block: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sizes (n,), Jaccard of the pairs i < j in row-major condensed
    order (n(n-1)/2,)), both float64, for (n, 2^p) registers.  The pairs'
    statistics are gathered a block of rows at a time, then solved
    PAIR_BLOCK pairs at a time."""
    n = regs.shape[0]
    hist = est.histogram(regs, p, dtype)
    sizes = est.mle(hist, p)
    ia, jb, stats = [], [], []
    for i0 in range(0, n - 1, row_block):
        a = regs[i0:i0 + row_block]
        b = regs[i0 + 1:]
        ii = torch.arange(i0, i0 + a.shape[0], device=regs.device)[:, None]
        jj = torch.arange(i0 + 1, n, device=regs.device)[None, :]
        keep = (jj > ii).reshape(-1)
        ia.append(ii.expand(-1, jj.shape[1]).reshape(-1)[keep])
        jb.append(jj.expand(ii.shape[0], -1).reshape(-1)[keep])
        if joint:
            st = est.pair_statistics(a, b, p, dtype)
        else:
            st = {"union": union_histograms(a, b, p).to(dtype)}
        stats.append({key: v.reshape(-1, v.shape[-1])[keep]
                      for key, v in st.items()})
    if not ia:
        return sizes.double(), torch.zeros(0, dtype=torch.float64,
                                           device=regs.device)
    ia, jb = torch.cat(ia), torch.cat(jb)
    st = {key: torch.cat([x[key] for x in stats]) for key in stats[0]}
    del stats
    out: List[torch.Tensor] = []
    for s in range(0, ia.numel(), PAIR_BLOCK):
        sl = slice(s, s + PAIR_BLOCK)
        c_a, c_b = sizes[ia[sl]], sizes[jb[sl]]
        if joint:
            part = {key: v[sl] for key, v in st.items()}
            c_u = est.mle(part["eq"] + part["gt_a"] + part["gt_b"], p)
            tri = est.joint_mle(part, c_a, c_b, c_u, p)
        else:
            tri = est.incl_excl(c_a, c_b, est.mle(st["union"][sl], p))
        out.append(est.jaccard(tri).double())
    return sizes.double(), torch.cat(out)


# --------------------------------------------------------------------------
# reading what the job wrote

def read_condensed(path: str) -> Tuple[int, np.ndarray]:
    """The `-b` file: a dtype byte (0: float32), n as a little-endian
    uint64, then the n(n-1)/2 entries of the upper triangle, row-major."""
    with open(path, "rb") as fp:
        head = fp.read(9)
        body = np.frombuffer(fp.read(), dtype="<f4")
    if len(head) != 9 or head[0] != 0:
        raise ValueError(f"{path}: not a float32 condensed matrix")
    n = struct.unpack("<Q", head[1:])[0]
    if body.size != n * (n - 1) // 2:
        raise ValueError(f"{path}: {body.size} entries for n = {n}")
    return n, body


def read_labels(path: str) -> List[str]:
    with open(path) as fp:
        return [line.rstrip("\n") for line in fp if line.strip()]


def read_sizes(path: str) -> Dict[str, float]:
    """The `-o` file: '#Path<TAB>Size (est.)' then one line a sketch."""
    out: Dict[str, float] = {}
    with open(path) as fp:
        for line in fp:
            if line.startswith("#") or not line.strip():
                continue
            name, val = line.rstrip("\n").split("\t")
            out[name] = float(val)
    return out


def reorder(n: int, cond: np.ndarray, order: Sequence[int]) -> np.ndarray:
    """A condensed matrix over items labelled order[0..n) as the condensed
    matrix over items 0..n) (order[i] is the item at position i)."""
    pos = np.empty(n, np.int64)
    pos[np.asarray(order)] = np.arange(n)
    i, j = np.triu_indices(n, 1)
    pi, pj = pos[i], pos[j]
    lo, hi = np.minimum(pi, pj), np.maximum(pi, pj)
    return cond[lo * (2 * n - lo - 1) // 2 + hi - lo - 1]


def registers_of_files(paths: Sequence[str], k: int, p: int, window: int,
                       device) -> torch.Tensor:
    """(n, 2^p) registers of the FASTA files, read again from disk."""
    return sketch.collection_registers(
        (sketch.read_fasta(path) for path in paths), k, p, window, device)


def read_outputs(paths: Sequence[str], out_path: str, sizes_path: str,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sizes (n,), Jaccard (n(n-1)/2,)) as a dist job wrote them, both in
    the order of `paths`, matched by the labels the job wrote beside its
    matrix: the program's own order does not matter.  The Jaccard index
    is the one each written Mash distance stands for."""
    index = {path: i for i, path in enumerate(paths)}
    n, cond = read_condensed(out_path)
    labels = read_labels(out_path + ".labels")
    if n != len(paths) or sorted(labels) != sorted(paths):
        raise ValueError(f"the matrix holds {n} items labelled "
                         f"{len(labels)}, not the {len(paths)} inputs")
    mash = torch.from_numpy(reorder(n, cond, [index[x] for x in labels]))
    sizes = read_sizes(sizes_path)
    if sorted(sizes) != sorted(paths):
        raise ValueError("the sizes file does not name every input")
    return (torch.tensor([sizes[x] for x in paths], dtype=torch.float64),
            est.jaccard_of_mash(mash, k))


def gaps(got_sizes: torch.Tensor, got_ji: torch.Tensor,
         want_sizes: torch.Tensor, want_ji: torch.Tensor
         ) -> Dict[str, float]:
    """The compared numbers of a dist job:
    size_rel_gap  the widest gap of a size from the expected one beyond
                  the one unit that the file's whole numbers may drop,
                  over the expected one;
    jaccard_gap   the widest gap of a pair's Jaccard index from the
                  expected one, over every pair."""
    got_sizes, got_ji = got_sizes.double().cpu(), got_ji.double().cpu()
    want_sizes, want_ji = want_sizes.double().cpu(), want_ji.double().cpu()
    size_gap = (((got_sizes - want_sizes).abs() - 1.0).clamp(min=0.0)
                / want_sizes.clamp(min=1.0))
    gap = (got_ji - want_ji).abs()
    return {"size_rel_gap": float(size_gap.max()),
            "jaccard_gap": float(gap.max()) if gap.numel() else 0.0}
