"""Fused encode -> hash -> register max (kernels K1 and K2,
csrc/encode_hash.cu).

K1 is the counterpart of dashing_tpu/ops/pallas_encode.py
`encode_hash_keys_from_codes` plus the `unpack_2bit` before it and the
register update after it (dashing_tpu/pipeline.py `_packed_to_registers`):
`packed_to_registers`, the entry the sketch pipeline's packed route calls.

K2 is the counterpart of `encode_hash_keys`, the same tail on raw ASCII
tiles, in two forms of one kernel: `ascii_to_registers` (fused with the
register max; chip_smoke.py times it) and
`encode_hash_keys` (the TPU kernel's own int32 keys, to hold the kernel
bitwise).

Both register forms also come banked, `packed_to_banks` and
`ascii_to_banks`: a per-row int32 bank index sends row r into row bank[r]
of a (B, 2^p) register bank, so one launch folds many small files or
sequence records (the JAX package's keys plus a scatter-max at bucket +
bank * 2^p, `_banks_from_idx_rank`).  Up to p = 14 banked K1 folds each
bank's rows into a copy of its registers in shared memory and walks the
rows in runs of one bank: a caller whose bank vector is non-decreasing
says so (`bank_sorted=True`); otherwise the wrapper orders the rows on
the device first (`row_order`).  Above that p, and in banked K2 (a record
a bank), the registers stay in global memory.

For a CUDA tensor each entry launches the hand-written kernel and counts
the launch; for a CPU tensor it runs its plain PyTorch version beside it.
There is no fallback from one to the other.  `launch_geometry` reports
the kernel's grid for a chunk; `staged_ascii` and `window_fields` repeat
its window arithmetic on the CPU for the tests.
"""
from __future__ import annotations

import ctypes

import torch

from ..hashes import wang_hash
from . import _build
from .encode import base_codes, canonical, kmers_contiguous
from .hll_update import bucket_rank, update_banks, update_registers

# launches of each CUDA entry since the last reset (chip_smoke.py reads
# them): K1 packed -> registers, K2 ASCII -> registers, K2 ASCII -> keys,
# K1 packed -> register banks, K2 ASCII -> register banks
launches = 0
ascii_launches = 0
keys_launches = 0
banks_launches = 0
ascii_banks_launches = 0


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
    R, C = packed.shape[0], packed.shape[1] * 4
    _build.launch(_lib(), "dtt_encode_hash_regs", regs.device,
                  packed.data_ptr(), vbits.data_ptr(), regs.data_ptr(), R, C,
                  k, p, int(bool(canon)))
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
    _build.launch(_lib(), "dtt_ascii_hash_keys", tile.device,
                  tile.data_ptr(), keys.data_ptr(), R, C, k, p,
                  int(bool(canon)))
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
    R, C = tile.shape
    _build.launch(_lib(), "dtt_ascii_hash_regs", regs.device,
                  tile.data_ptr(), regs.data_ptr(), R, C, k, p,
                  int(bool(canon)))
    global ascii_launches
    ascii_launches += 1
    return regs


def _check_banks(bank, regs, R, p, device):
    if regs.dtype != torch.int32 or regs.dim() != 2 \
            or regs.shape[1] != 1 << p:
        raise TypeError(f"a register bank is (B, {1 << p}) int32, got "
                        f"{tuple(regs.shape)} {regs.dtype}")
    if bank.dtype != torch.int32 or bank.shape != (R,):
        raise TypeError(f"bank indices are ({R},) int32, got "
                        f"{tuple(bank.shape)} {bank.dtype}")
    if not (bank.device == regs.device == device):
        raise ValueError("rows, bank indices and registers must share a "
                         "device")
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous (updated in place)")


def packed_to_banks_plain(packed: torch.Tensor, vbits: torch.Tensor,
                          bank: torch.Tensor, regs: torch.Tensor, *, k: int,
                          p: int, canon: bool) -> torch.Tensor:
    """Plain PyTorch version of banked K1: unpack, k-mers, WangHash,
    scatter_reduce("amax") at bucket + bank[row] * 2^p, in place."""
    code, valid = unpack_2bit(packed, vbits, packed.shape[1] * 4)
    h, wvalid = _hashes(code, valid, k, canon)
    return update_banks(regs, h, wvalid, bank, p)


# the largest p whose banks banked K1 keeps on chip (csrc/encode_hash.cu
# ONCHIP_MAX_P; the card tests hold the two to each other)
ONCHIP_MAX_P = 14


def row_order(bank: torch.Tensor, bank_sorted: bool, p: int):
    """The order in which banked K1 walks the rows at p: None (the rows'
    own) when the bank vector is non-decreasing or p is above
    ONCHIP_MAX_P (the global form takes the rows as they come), else the
    stable argsort of `bank` as int32, on its device, so that each bank's
    rows form one run (the on-chip route merges a bank's copy at every
    change of bank)."""
    if bank_sorted or p > ONCHIP_MAX_P or bank.numel() < 2:
        return None
    return torch.argsort(bank, stable=True).to(torch.int32)


def packed_to_banks(packed: torch.Tensor, vbits: torch.Tensor,
                    bank: torch.Tensor, regs: torch.Tensor, *, k: int, p: int,
                    canon: bool = True, bank_sorted: bool = False
                    ) -> torch.Tensor:
    """Fold packed rows (R rows of C = 4 * packed.shape[1] bases) into a
    (B, 2^p) int32 register bank IN PLACE, row r into regs[bank[r]], and
    return it.  A row whose bank lies outside [0, B) folds nothing.
    `bank_sorted`: the caller's bank vector is non-decreasing, so the
    kernel takes the rows as they are (any vector gives the same banks).
    2 <= p <= 31, 1 <= k <= 32."""
    _check_kp(k, p)
    if packed.dtype != torch.uint8 or vbits.dtype != torch.uint8:
        raise TypeError("packed codes and validity bits must be uint8")
    R, C4 = packed.shape
    if vbits.shape != (R, C4 // 2) or C4 % 2:
        raise ValueError(f"validity bits {tuple(vbits.shape)} do not match "
                         f"packed codes {tuple(packed.shape)} (C % 8 == 0)")
    if packed.device != vbits.device:
        raise ValueError("packed and vbits must share a device")
    _check_banks(bank, regs, R, p, packed.device)
    if regs.device.type == "cpu":
        return packed_to_banks_plain(packed, vbits, bank, regs, k=k, p=p,
                                     canon=canon)
    if regs.device.type != "cuda":
        raise ValueError(f"unsupported device {regs.device}")
    packed, vbits, bank = (t.contiguous() for t in (packed, vbits, bank))
    order = row_order(bank, bank_sorted, p)
    _build.launch(_lib(), "dtt_encode_hash_banks", regs.device,
                  packed.data_ptr(), vbits.data_ptr(), bank.data_ptr(),
                  None if order is None else order.data_ptr(), regs.shape[0],
                  regs.data_ptr(), R, C4 * 4, k, p, int(bool(canon)))
    global banks_launches
    banks_launches += 1
    return regs


def ascii_to_banks_plain(tile: torch.Tensor, bank: torch.Tensor,
                         regs: torch.Tensor, *, k: int, p: int,
                         canon: bool) -> torch.Tensor:
    """Plain PyTorch version of banked K2: base codes, k-mers, WangHash,
    scatter_reduce("amax") at bucket + bank[row] * 2^p, in place."""
    code, valid = base_codes(tile)
    h, wvalid = _hashes(code, valid, k, canon)
    return update_banks(regs, h, wvalid, bank, p)


def ascii_to_banks(tile: torch.Tensor, bank: torch.Tensor,
                   regs: torch.Tensor, *, k: int, p: int,
                   canon: bool = True) -> torch.Tensor:
    """Fold (R, C) uint8 ASCII rows (any R, C) into a (B, 2^p) int32
    register bank IN PLACE, row r into regs[bank[r]], and return it.  A
    row whose bank lies outside [0, B) folds nothing.  2 <= p <= 31,
    1 <= k <= 32."""
    _check_kp(k, p)
    _check_tile(tile)
    _check_banks(bank, regs, tile.shape[0], p, tile.device)
    if tile.device.type == "cpu":
        return ascii_to_banks_plain(tile, bank, regs, k=k, p=p, canon=canon)
    tile, bank = tile.contiguous(), bank.contiguous()
    R, C = tile.shape
    _build.launch(_lib(), "dtt_ascii_hash_banks", regs.device,
                  tile.data_ptr(), bank.data_ptr(), regs.shape[0],
                  regs.data_ptr(), R, C, k, p, int(bool(canon)))
    global ascii_banks_launches
    ascii_banks_launches += 1
    return regs


def launch_geometry(R: int, C: int, k: int) -> dict:
    """The kernel's launch for an (R, C) chunk at k, as the source computes
    it: windows a block (`segment`), grid x (segments a row), grid y,
    threads a block; builds the library."""
    out = (ctypes.c_int * 4)()
    if _lib().dtt_encode_hash_geometry(R, C, k, out):
        raise ValueError(f"no window in a {R} x {C} chunk at k={k}")
    return dict(segment=out[0], grid=(out[1], out[2]), threads=out[3])


def banks_geometry(R: int, C: int, k: int, p: int, device=None) -> dict:
    """Banked K1's launch for R packed rows of C bases at k and p on a CUDA
    `device`, as the source computes it: whether the banks stay on chip,
    windows a block (`segment`), segments a row, blocks, threads a block,
    dynamic shared bytes and blocks an SM; builds the library."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = _lib().dtt_banks_geometry(R, C, k, p, out)
    if err == 1:
        raise ValueError(f"no window in a {R} x {C} chunk at k={k}")
    _build.check(err, "dtt_banks_geometry", _lib())
    return dict(onchip=bool(out[0]), segment=out[1], segments=out[2],
                blocks=out[3], threads=out[4], shared=out[5], per_sm=out[6])


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("encode_hash", {
        "dtt_encode_hash_regs": ([vp, vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_ascii_hash_regs": ([vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_ascii_hash_keys": ([vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_encode_hash_banks": ([vp, vp, vp, vp, ci, vp, ci, ci, ci, ci,
                                   ci, vp], ci),
        "dtt_ascii_hash_banks": ([vp, vp, ci, vp, ci, ci, ci, ci, ci, vp],
                                 ci),
        "dtt_encode_hash_geometry": ([ci, ci, ci, ctypes.POINTER(ci)], ci),
        "dtt_banks_geometry": ([ci, ci, ci, ci, ctypes.POINTER(ci)], ci)})


# ---------------------------------------------------------------------------
# The kernel's window arithmetic on the CPU, for the tests only (no path
# calls these): the staged streams and the per-window funnel, pair
# reversal and validity window of csrc/encode_hash.cu, on int64 words.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def staged_ascii(tile: torch.Tensor):
    """(R, C) uint8 ASCII -> the kernel's staged streams of the flat bases,
    as flat uint8 bytes: 2-bit codes (4 bases a byte) and validity bits (8
    a byte), from its four-bytes-at-a-time classification (`classify4`)."""
    flat = tile.reshape(-1)
    pad = (-flat.numel()) % 8
    flat = torch.cat([flat, flat.new_zeros(pad)]).to(torch.int64)
    w = flat.view(-1, 4)
    w = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    up = w & 0xDFDFDFDF
    any_zero = torch.full_like(up, _U32)
    for c in (0x41, 0x43, 0x47, 0x54):
        y = up ^ (c * 0x01010101)
        any_zero &= (((y & 0x7F7F7F7F) + 0x7F7F7F7F) | y) & _U32
    v = ((~any_zero & _U32) >> 7) & 0x01010101
    t = (up >> 1) & 0x03030303
    t = (t ^ ((t >> 1) & 0x01010101)) & (v * 3)
    t = (t | (t >> 6)) & 0x000F000F
    codes = (t | (t >> 12)) & 0xFF
    b = v | (v >> 7)
    nib = (b | (b >> 14)) & 0xF
    valid = nib.view(-1, 2)
    valid = valid[:, 0] | (valid[:, 1] << 4)
    return codes.to(torch.uint8), valid.to(torch.uint8)


def _shr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 <= s < 64 (tensor)."""
    keep = (torch.ones_like(x) << (64 - s).clamp(max=63)) - 1
    return torch.where(s == 0, x, (x >> s) & keep)


def _words(stream: torch.Tensor, bits: int, lead: int) -> torch.Tensor:
    """Flat little-bit-order bytes of `bits`-bit fields -> int64 words,
    preceded by `lead` zero fields and followed by two zero words."""
    pad = (-stream.numel()) % 8 + 16
    w = torch.cat([stream, stream.new_zeros(pad)]).view(torch.int64).clone()
    s = lead * bits
    if s:
        prev = torch.cat([w.new_zeros(1), w[:-1]])
        w = (w << s) | _shr(prev, torch.tensor(64 - s))
    return w


def _funnel(w: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """The 64 bits of word stream `w` from bit position `bit` on."""
    j, s = bit >> 6, bit & 63
    hi = torch.where(s == 0, 0, w[j + 1] << (64 - s))
    return _shr(w[j], s) | hi


def _bit_swap(x: torch.Tensor, s: int, m: int) -> torch.Tensor:
    return (_shr(x, torch.tensor(s)) & m) | ((x & m) << s)


def window_fields(codes: torch.Tensor, valid: torch.Tensor, n: int, k: int,
                  lead: int = 0):
    """(fwd, rc, valid) of the n windows at positions lead .. lead+n-1 of the
    staged streams (flat uint8 `codes`, 2 bits a base, and `valid`, 1 bit a
    base), the streams shifted `lead` bases into their first word, as a
    staged segment starts anywhere in its word: x = the window's 2k bits by
    one funnel shift; rc = ~x & mask; fwd = pairrev64(x) >> (64 - 2k), a
    bit reversal then a swap within each pair; valid = its k validity
    bits all set."""
    cw, vw = _words(codes, 2, lead), _words(valid, 1, lead)
    pos = lead + torch.arange(n, dtype=torch.int64)
    x = _funnel(cw, 2 * pos)
    y = x
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                 (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                 (16, 0x0000FFFF0000FFFF), (32, _U32)):
        y = _bit_swap(y, s, m)                          # __brevll
    y = _bit_swap(y, 1, 0x5555555555555555)             # the pair swap
    fwd = _shr(y, torch.tensor(64 - 2 * k))
    mask = -1 if k == 32 else (1 << (2 * k)) - 1
    kmask = (1 << k) - 1
    ok = (_funnel(vw, pos) & kmask) == kmask
    return fwd, ~x & mask, ok
