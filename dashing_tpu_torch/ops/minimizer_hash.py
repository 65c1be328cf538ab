"""Minimizer windows on raw ASCII, fused into the register max (kernel
csrc/minimizer_hash.cu).

`ascii_minimizer_registers` folds an (R, C) uint8 ASCII chunk into (2^p,)
int32 registers under a minimizer window of w bases: the exact encoding
of contiguous k-mers (k <= 32), canonical or not, the unsigned minimum of
each window's w - k + 1 k-mers, WangHash, register max; a window emits
only when all of its bases are valid.  It replaces no TPU kernel: the JAX
package computes this step in XLA code (`_tile_to_registers` under -w),
and its plain version here is that chain as PyTorch ops
(`ops/encode.encode_tile`, `wang_hash`, `hll_update.update_registers`).

For a CUDA tensor the wrapper launches the kernel and counts the launch
(`launches`); for a CPU tensor it runs the plain version.  There is no
fallback from one to the other: arguments outside the kernel's range
raise.  `takes(p, **kw)` is the routing rule of the ASCII route
(`pipeline.tile_to_registers`): which encoder arguments this kernel
serves.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..hashes import wang_hash
from . import _build
from .encode import encode_tile
from .hll_update import update_registers

# launches of the CUDA entry since the last reset
launches = 0

# the most k-mers a window may hold, w - k + 1 (csrc/minimizer_hash.cu
# WIN_MAX; a card test holds the two to each other)
WIN_MAX = 1024


def takes(p: int, *, k: int, w: int, positions: Sequence[int], span: int,
          canon: bool, encoding: str, rehash: bool,
          entropy: bool = False) -> bool:
    """Whether the ASCII route's register fold of these encoder arguments
    (`pipeline._encode_kw`) is this kernel's: the exact encoding of
    contiguous k-mers, k <= 32, WangHashed, picked by value under a
    window wider than the k-mer (w > span), w - k + 1 <= WIN_MAX and
    1 <= p <= 31.  Spaced seeds, entropy minimizers, the rolling hashes,
    raw k-mers (no rehash) and w == span stay on the PyTorch ops."""
    del canon                               # either way
    return (encoding == "bonsai" and rehash and not entropy
            and 1 <= k <= 32 and span == k
            and tuple(positions) == tuple(range(k))
            and span < w and w - k + 1 <= WIN_MAX and 1 <= p <= 31)


def ascii_minimizer_registers_plain(tile: torch.Tensor, regs: torch.Tensor,
                                    *, k: int, w: int, p: int,
                                    canon: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: contiguous k-mers, the
    log-doubling sliding minimum and the emission mask of `encode_tile`,
    WangHash, scatter_reduce("amax") into `regs` in place.  A chunk
    narrower than w has no window and leaves them as they are."""
    if tile.shape[1] < w:
        return regs
    km, valid = encode_tile(tile, k=k, w=w, positions=range(k), span=k,
                            canon=canon)
    return update_registers(regs, wang_hash(km), valid, p)


def _check(tile, regs, k, w, p):
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if not k < w <= k - 1 + WIN_MAX:
        raise ValueError(f"the window must hold 2 to {WIN_MAX} k-mers "
                         f"(k < w <= k - 1 + {WIN_MAX}), got w={w} at k={k}")
    if not 1 <= p <= 31:
        raise ValueError(f"p must be in [1, 31], got {p}")
    if tile.dtype != torch.uint8 or tile.dim() != 2:
        raise TypeError(f"an ASCII tile is (R, C) uint8, got "
                        f"{tuple(tile.shape)} {tile.dtype}")
    if regs.dtype != torch.int32 or regs.shape != (1 << p,):
        raise TypeError(f"registers must be ({1 << p},) int32, got "
                        f"{tuple(regs.shape)} {regs.dtype}")
    if tile.device != regs.device:
        raise ValueError("tile and regs must share a device")
    if tile.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tile.device}")


def ascii_minimizer_registers(tile: torch.Tensor, regs: torch.Tensor, *,
                              k: int, w: int, p: int,
                              canon: bool = True) -> torch.Tensor:
    """Fold one (R, C) uint8 ASCII chunk (any R, C) into (2^p,) int32
    registers IN PLACE under minimizer windows of w bases, and return
    them.  1 <= k <= 32, k < w, w - k + 1 <= WIN_MAX, 1 <= p <= 31."""
    _check(tile, regs, k, w, p)
    if tile.device.type == "cpu":
        return ascii_minimizer_registers_plain(tile, regs, k=k, w=w, p=p,
                                               canon=canon)
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous (updated in place)")
    tile = tile.contiguous()
    R, C = tile.shape
    _build.launch(_lib(), "dtt_minimizer_regs", regs.device, tile.data_ptr(),
                  regs.data_ptr(), R, C, k, w, p, int(bool(canon)))
    global launches
    launches += 1
    return regs


def launch_geometry(R: int, C: int, k: int, w: int) -> dict:
    """The kernel's launch for an (R, C) chunk at (k, w), as the source
    computes it: windows a block (`segment`), grid x (segments a row),
    grid y, threads a block, and the source's WIN_MAX; builds the
    library."""
    out = (ctypes.c_int * 5)()
    err = _lib().dtt_minimizer_geometry(R, C, k, w, out)
    if err == 2:
        raise ValueError(f"(k={k}, w={w}) is outside the kernel's range "
                         f"(WIN_MAX {out[4]})")
    if err:
        raise ValueError(f"no window in a {R} x {C} chunk at w={w}")
    return dict(segment=out[0], grid=(out[1], out[2]), threads=out[3],
                win_max=out[4])


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("minimizer_hash", {
        "dtt_minimizer_regs": ([vp, vp, ci, ci, ci, ci, ci, ci, vp], ci),
        "dtt_minimizer_geometry": ([ci, ci, ci, ci, ctypes.POINTER(ci)],
                                   ci)})
