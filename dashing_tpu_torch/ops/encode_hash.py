"""Fused encode -> hash -> register max (kernels K1 and K2,
csrc/encode_hash.cu).

K1 is the counterpart of dashing_tpu/ops/pallas_encode.py
`encode_hash_keys_from_codes` plus the `unpack_2bit` before it and the
register update after it (dashing_tpu/pipeline.py `_packed_to_registers`):
`packed_to_registers`, the entry the sketch pipeline's packed route calls.

K2 is the counterpart of `encode_hash_keys`, the same tail on raw ASCII
tiles, in two forms of one kernel: `ascii_to_registers` (fused with the
register max; the benchmark calls it) and
`encode_hash_keys` (the TPU kernel's own int32 keys, to hold the kernel
bitwise).

For a CUDA tensor each entry launches the hand-written kernel and counts
the launch; for a CPU tensor it runs its plain PyTorch version beside it.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from ..hashes import wang_hash
from . import _build
from .encode import base_codes, canonical, kmers_contiguous
from .hll_update import bucket_rank, update_registers

# launches of each CUDA entry since the last reset (chip_smoke.py reads
# them): K1 packed -> registers, K2 ASCII -> registers, K2 ASCII -> keys
launches = 0
ascii_launches = 0
keys_launches = 0


def unpack_2bit(packed: torch.Tensor, vbits: torch.Tensor, C: int):
    """(R, C/4) uint8 codes + (R, C/8) uint8 validity bits ->
    ((R, C) int64 codes, (R, C) bool valid)."""
    R = packed.shape[0]
    pb = packed.to(torch.int64)
    code = torch.stack([(pb >> (2 * j)) & 3 for j in range(4)],
                       dim=-1).reshape(R, -1)[:, :C]
    vb = vbits.to(torch.int64)
    valid = torch.stack([((vb >> j) & 1) != 0 for j in range(8)],
                        dim=-1).reshape(R, -1)[:, :C]
    return code, valid


def _hashes(code, valid, k: int, canon: bool):
    fwd, rc, wvalid = kmers_contiguous(code, valid, k)
    return wang_hash(canonical(fwd, rc, canon)), wvalid


def encode_hash_keys_from_codes(code: torch.Tensor, valid: torch.Tensor, *,
                                k: int, p: int, canon: bool = True
                                ) -> torch.Tensor:
    """(R, C) 2-bit codes + validity -> (R, C-k+1) int32 keys
    `bucket << 6 | rank`, rank 0 where the window holds an invalid base.
    Plain version; bitwise equal to the JAX function (2 <= p <= 25 so the
    key fits int32)."""
    if not 2 <= p <= 25:
        raise ValueError(f"packed keys need 2 <= p <= 25, got {p}")
    h, wvalid = _hashes(code, valid, k, canon)
    idx, rank = bucket_rank(h, p)
    rank = torch.where(wvalid, rank, 0)
    return ((idx << 6) | rank).to(torch.int32)


def packed_to_registers_plain(packed: torch.Tensor, vbits: torch.Tensor,
                              regs: torch.Tensor, *, k: int, p: int,
                              canon: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: unpack, k-mers, WangHash,
    scatter_reduce("amax") into `regs` in place."""
    code, valid = unpack_2bit(packed, vbits, packed.shape[1] * 4)
    h, wvalid = _hashes(code, valid, k, canon)
    return update_registers(regs, h, wvalid, p)


def _check_kp(k, p, pmax=31):
    if not 2 <= p <= pmax:
        raise ValueError(f"p must be in [2, {pmax}], got {p}")
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")


def _check_regs(regs, p):
    if regs.dtype != torch.int32 or regs.shape != (1 << p,):
        raise TypeError(f"registers must be ({1 << p},) int32, got "
                        f"{tuple(regs.shape)} {regs.dtype}")


def _check(packed, vbits, regs, k, p):
    _check_kp(k, p)
    if packed.dtype != torch.uint8 or vbits.dtype != torch.uint8:
        raise TypeError("packed codes and validity bits must be uint8")
    _check_regs(regs, p)
    R, C4 = packed.shape
    if vbits.shape != (R, C4 // 2) or C4 % 2:
        raise ValueError(f"validity bits {tuple(vbits.shape)} do not match "
                         f"packed codes {tuple(packed.shape)} (C % 8 == 0)")
    if not (packed.device == vbits.device == regs.device):
        raise ValueError("packed, vbits and regs must share a device")


def packed_to_registers(packed: torch.Tensor, vbits: torch.Tensor,
                        regs: torch.Tensor, *, k: int, p: int,
                        canon: bool = True) -> torch.Tensor:
    """Fold one packed chunk (R rows of C = 4 * packed.shape[1] bases) into
    (2^p,) int32 registers IN PLACE and return them.  2 <= p <= 31,
    1 <= k <= 32."""
    _check(packed, vbits, regs, k, p)
    if regs.device.type == "cpu":
        return packed_to_registers_plain(packed, vbits, regs, k=k, p=p,
                                         canon=canon)
    if regs.device.type != "cuda":
        raise ValueError(f"unsupported device {regs.device}")
    packed = packed.contiguous()
    vbits = vbits.contiguous()
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous (updated in place)")
    lib = _lib()
    R, C = packed.shape[0], packed.shape[1] * 4
    stream = torch.cuda.current_stream(regs.device).cuda_stream
    with torch.cuda.device(regs.device):
        err = lib.dtt_encode_hash_regs(packed.data_ptr(), vbits.data_ptr(),
                                       regs.data_ptr(), R, C, k, p,
                                       int(bool(canon)), stream)
    _build.check(err, "encode_hash_regs", lib)
    global launches
    launches += 1
    return regs


def _check_tile(tile):
    if tile.dtype != torch.uint8 or tile.dim() != 2:
        raise TypeError(f"an ASCII tile is (R, C) uint8, got "
                        f"{tuple(tile.shape)} {tile.dtype}")
    if tile.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tile.device}")


def encode_hash_keys_plain(tile: torch.Tensor, *, k: int, p: int,
                           canon: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2's keys: (R, C) uint8 ASCII -> (R, C-k+1)
    int32 `bucket << 6 | rank`, rank 0 on invalid windows."""
    code, valid = base_codes(tile)
    return encode_hash_keys_from_codes(code, valid, k=k, p=p, canon=canon)


def encode_hash_keys(tile: torch.Tensor, *, k: int, p: int,
                     canon: bool = True) -> torch.Tensor:
    """K2 as the TPU kernel computes it: (R, C) uint8 ASCII (any R, C) ->
    (R, C-k+1) int32 keys; 2 <= p <= 25, 1 <= k <= 32."""
    _check_kp(k, p, 25)
    _check_tile(tile)
    if tile.device.type == "cpu":
        return encode_hash_keys_plain(tile, k=k, p=p, canon=canon)
    tile = tile.contiguous()
    R, C = tile.shape
    keys = torch.empty((R, max(C - k + 1, 0)), dtype=torch.int32,
                       device=tile.device)
    lib = _lib()
    stream = torch.cuda.current_stream(tile.device).cuda_stream
    with torch.cuda.device(tile.device):
        err = lib.dtt_ascii_hash_keys(tile.data_ptr(), keys.data_ptr(), R, C,
                                      k, p, int(bool(canon)), stream)
    _build.check(err, "ascii_hash_keys", lib)
    global keys_launches
    keys_launches += 1
    return keys


def ascii_to_registers_plain(tile: torch.Tensor, regs: torch.Tensor, *,
                             k: int, p: int, canon: bool) -> torch.Tensor:
    """Plain PyTorch version of fused K2: base codes, k-mers, WangHash,
    scatter_reduce("amax") into `regs` in place."""
    code, valid = base_codes(tile)
    h, wvalid = _hashes(code, valid, k, canon)
    return update_registers(regs, h, wvalid, p)


def ascii_to_registers(tile: torch.Tensor, regs: torch.Tensor, *, k: int,
                       p: int, canon: bool = True) -> torch.Tensor:
    """Fold one (R, C) uint8 ASCII chunk (any R, C) into (2^p,) int32
    registers IN PLACE and return them.  2 <= p <= 31, 1 <= k <= 32."""
    _check_kp(k, p)
    _check_tile(tile)
    _check_regs(regs, p)
    if tile.device != regs.device:
        raise ValueError("tile and regs must share a device")
    if tile.device.type == "cpu":
        return ascii_to_registers_plain(tile, regs, k=k, p=p, canon=canon)
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous (updated in place)")
    tile = tile.contiguous()
    lib = _lib()
    R, C = tile.shape
    stream = torch.cuda.current_stream(regs.device).cuda_stream
    with torch.cuda.device(regs.device):
        err = lib.dtt_ascii_hash_regs(tile.data_ptr(), regs.data_ptr(), R, C,
                                      k, p, int(bool(canon)), stream)
    _build.check(err, "ascii_hash_regs", lib)
    global ascii_launches
    ascii_launches += 1
    return regs


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("encode_hash", {
        "dtt_encode_hash_regs": ([vp, vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_ascii_hash_regs": ([vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_ascii_hash_keys": ([vp, vp, ci, ci, ci, ci, ci, vp], ci)})
