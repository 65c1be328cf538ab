"""The count-min filter's arithmetic, and its two passes over raw ASCII on
hand-written kernels (csrc/countmin.cu).

A filtered file is read twice (`pipeline.sketch_hll_async`).  Pass 1
counts each valid window's hash h into an (nh, 2^size_log2) int32 table:
row r's counter is the top size_log2 bits of wang_hash(h ^ c_r), c_r =
(seed + r * 0x9E3779B9) | 1 taken to 64 bits (`indices`, `add_hashes`).
Pass 2 admits the windows whose counters all reach min_count (the
count-min estimate, their minimum: `query_hashes`) into the HLL
registers.  These functions are the JAX package's `_cm_indices`,
`_cm_add` and `_cm_query` as PyTorch ops; the counts are exact integers,
so both packages agree bit for bit.

`ascii_cm_add` and `ascii_cm_admit` run a pass over one (R, C) uint8
ASCII tile of exact contiguous k-mers (k <= 32) with WangHash: for a CUDA
tile one launch of `cm_add_kernel` or `cm_admit_kernel`, which hash every
valid window in registers, keep no hash in device memory and touch no
counter for an invalid window; for a CPU tile their plain versions, the
chain the kernels replace (`encode_tile`, `wang_hash`, `add_hashes`, or
`query_hashes` >= min_count and `update_registers`).  There is no fallback
from one to the other: arguments outside the kernels' range raise.  Each
launch is counted, pass 1's in `add_launches` and pass 2's in
`admit_launches`.  `takes(p, **kw)` is the routing rule: which encoder
arguments (`pipeline._encode_kw`) the kernels serve.  They
replace no Pallas kernel: the JAX count-min is XLA scatter and gather.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..hashes import shr, wang_hash
from . import _build
from .encode import encode_tile
from .hll_update import update_registers

# launches of each CUDA entry since the last reset
add_launches = 0
admit_launches = 0


def check_size(size_log2: int) -> None:
    # the JAX index is the top size_log2 bits of a 32-bit word: undefined
    # outside 1..32
    if not 1 <= size_log2 <= 32:
        raise ValueError(f"count-min size_log2 must be in [1, 32], "
                         f"got {size_log2}")


def row_constant(seed: int, row: int) -> int:
    """(seed + row * 0x9E3779B9) | 1 taken to 64 bits, as the int64 of the
    same bit pattern (JAX u64.const masks the Python int to 64 bits)."""
    c = ((seed + row * 0x9E3779B9) | 1) & 0xFFFFFFFFFFFFFFFF
    return c - (1 << 64) if c >> 63 else c


def indices(h: torch.Tensor, nh: int, size_log2: int,
            seed: int) -> torch.Tensor:
    """(nh, *h.shape) int64 counter indices: the top size_log2 bits of
    wang_hash(h ^ c_row), a logical shift of the 64-bit pattern."""
    check_size(size_log2)
    return torch.stack([shr(wang_hash(h ^ row_constant(seed, row)),
                            64 - size_log2) for row in range(nh)])


def add_hashes(counts: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
               nh: int, size_log2: int, seed: int) -> torch.Tensor:
    """Count the valid windows' hashes into `counts` (nh, 2^size_log2)
    int32, in place; invalid windows add 0."""
    idx = indices(h, nh, size_log2, seed).reshape(nh, -1)
    ones = valid.reshape(-1).to(counts.dtype)
    for row in range(nh):
        counts[row].index_add_(0, idx[row], ones)
    return counts


def query_hashes(counts: torch.Tensor, h: torch.Tensor, nh: int,
                 size_log2: int, seed: int) -> torch.Tensor:
    """Estimated count of each hash: the minimum over the rows."""
    idx = indices(h, nh, size_log2, seed)
    est = counts[0][idx[0]]
    for row in range(1, nh):
        est = torch.minimum(est, counts[row][idx[row]])
    return est


def takes(p: int, *, k: int, w: int, positions: Sequence[int], span: int,
          canon: bool, encoding: str, rehash: bool,
          entropy: bool = False) -> bool:
    """Whether a filtered file's passes with these encoder arguments are
    the kernels': the exact encoding of contiguous k-mers, k <= 32,
    WangHashed, no minimizer window (w == span) and 1 <= p <= 31.  Spaced
    seeds, minimizer windows, entropy scoring, the rolling hashes and raw
    k-mers (no rehash) stay on the PyTorch ops."""
    del canon                               # either way
    return (encoding == "bonsai" and rehash and not entropy
            and 1 <= k <= 32 and span == k == w
            and tuple(positions) == tuple(range(k)) and 1 <= p <= 31)


def _tile_hashes(tile: torch.Tensor, k: int, canon: bool):
    km, valid = encode_tile(tile, k=k, w=k, positions=range(k), span=k,
                            canon=canon)
    return wang_hash(km), valid


def ascii_cm_add_plain(tile: torch.Tensor, counts: torch.Tensor, *, k: int,
                       canon: bool, nh: int, size_log2: int,
                       seed: int) -> torch.Tensor:
    """Plain PyTorch version of pass 1: the tile's k-mers, WangHash, and
    `add_hashes` into `counts` in place.  A tile narrower than k has no
    window and leaves the counts as they are."""
    if tile.shape[1] < k:
        return counts
    h, valid = _tile_hashes(tile, k, canon)
    return add_hashes(counts, h, valid, nh, size_log2, seed)


def ascii_cm_admit_plain(tile: torch.Tensor, counts: torch.Tensor,
                         regs: torch.Tensor, *, k: int, canon: bool, nh: int,
                         size_log2: int, seed: int, min_count: int,
                         p: int) -> torch.Tensor:
    """Plain PyTorch version of pass 2: the tile's k-mers, WangHash, the
    windows whose `query_hashes` estimate reaches min_count, and
    `update_registers` into `regs` in place."""
    if tile.shape[1] < k:
        return regs
    h, valid = _tile_hashes(tile, k, canon)
    admitted = valid & (query_hashes(counts, h, nh, size_log2, seed)
                        >= min_count)
    return update_registers(regs, h, admitted, p)


def _check(tile, counts, k, nh, size_log2):
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if nh < 1:
        raise ValueError(f"the count-min needs a row or more, got nh={nh}")
    check_size(size_log2)
    if tile.dtype != torch.uint8 or tile.dim() != 2:
        raise TypeError(f"an ASCII tile is (R, C) uint8, got "
                        f"{tuple(tile.shape)} {tile.dtype}")
    if counts.dtype != torch.int32 or counts.shape != (nh, 1 << size_log2):
        raise TypeError(f"counts must be ({nh}, {1 << size_log2}) int32, "
                        f"got {tuple(counts.shape)} {counts.dtype}")
    if tile.device != counts.device:
        raise ValueError("tile and counts must share a device")
    if tile.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tile.device}")
    if tile.device.type == "cuda" and not counts.is_contiguous():
        raise ValueError("counts must be contiguous")


def ascii_cm_add(tile: torch.Tensor, counts: torch.Tensor, *, k: int,
                 canon: bool = True, nh: int, size_log2: int,
                 seed: int) -> torch.Tensor:
    """Pass 1 over one (R, C) uint8 ASCII tile (any R, C): +1 on each
    valid window's nh counters of `counts` (nh, 2^size_log2) int32, IN
    PLACE, and return them.  1 <= k <= 32, nh >= 1, 1 <= size_log2 <=
    32."""
    _check(tile, counts, k, nh, size_log2)
    if tile.device.type == "cpu":
        return ascii_cm_add_plain(tile, counts, k=k, canon=canon, nh=nh,
                                  size_log2=size_log2, seed=seed)
    tile = tile.contiguous()
    R, C = tile.shape
    _build.launch(_lib(), "dtt_cm_add", tile.device, tile.data_ptr(),
                  counts.data_ptr(), R, C, k, int(bool(canon)), nh,
                  size_log2, seed & 0xFFFFFFFFFFFFFFFF)
    global add_launches
    add_launches += 1
    return counts


def ascii_cm_admit(tile: torch.Tensor, counts: torch.Tensor,
                   regs: torch.Tensor, *, k: int, canon: bool = True,
                   nh: int, size_log2: int, seed: int, min_count: int,
                   p: int) -> torch.Tensor:
    """Pass 2 over one (R, C) uint8 ASCII tile: each valid window whose
    nh counters all reach min_count folds its rank into (2^p,) int32
    `regs` IN PLACE, which are returned.  1 <= p <= 31, the rest as
    `ascii_cm_add`."""
    _check(tile, counts, k, nh, size_log2)
    if not 1 <= p <= 31:
        raise ValueError(f"p must be in [1, 31], got {p}")
    if regs.dtype != torch.int32 or regs.shape != (1 << p,):
        raise TypeError(f"registers must be ({1 << p},) int32, got "
                        f"{tuple(regs.shape)} {regs.dtype}")
    if regs.device != tile.device:
        raise ValueError("tile and regs must share a device")
    if tile.device.type == "cpu":
        return ascii_cm_admit_plain(tile, counts, regs, k=k, canon=canon,
                                    nh=nh, size_log2=size_log2, seed=seed,
                                    min_count=min_count, p=p)
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous (updated in place)")
    tile = tile.contiguous()
    R, C = tile.shape
    _build.launch(_lib(), "dtt_cm_admit", tile.device, tile.data_ptr(),
                  counts.data_ptr(), regs.data_ptr(), R, C, k,
                  int(bool(canon)), nh, size_log2,
                  seed & 0xFFFFFFFFFFFFFFFF, min_count, p)
    global admit_launches
    admit_launches += 1
    return regs


def _lib():
    vp, ci, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    return _build.load("countmin", {
        "dtt_cm_add": ([vp, vp, ci, ci, ci, ci, ci, ci, u64, vp], ci),
        "dtt_cm_admit": ([vp, vp, vp, ci, ci, ci, ci, ci, ci, u64, ci, ci,
                          vp], ci)})
