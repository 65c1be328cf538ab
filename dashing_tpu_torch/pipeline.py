"""The sketching engine: files -> tiles -> device registers (port of
dashing_tpu/pipeline.py, HLL with contiguous k-mers).

A file's records are joined with invalid separators, cut into rows of
CONTENT bases plus a (k-1)-base halo (width padded to a multiple of 8),
packed on the host to 2 bits per base plus a validity bit
(io/native.pack2bit), uploaded, and folded into the registers
by kernel K1 (ops/encode_hash.py).  One device, no mesh: the TPU banks and
sharded steps are not ported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List

import numpy as np
import torch

from . import metrics
from .io import fasta, native
from .io.paths import split_subpaths
from .ops.encode import Spacer, join_records, parse_spacing, tile_sequence
from .ops.encode_hash import packed_to_registers

# Tile geometry: CONTENT bases of payload per row + halo; rows per upload.
CONTENT = 8192
MAX_ROWS = 256
# Files larger than this on disk stream through the incremental parser in
# O(MAX_ROWS * CONTENT) host memory instead of being read whole.
STREAM_THRESHOLD = 128 * 10 ** 6


@dataclasses.dataclass(frozen=True)
class SketchParams:
    k: int = 31
    w: int = 0                      # window size (-w); 0 -> k-mer span
    spacing: str = ""
    canon: bool = True

    def spacer(self) -> Spacer:
        return Spacer(self.k, self.w, parse_spacing(self.spacing, self.k))


def check_supported(params: SketchParams) -> Spacer:
    """The slice sketches contiguous k-mers (k <= 32) with no minimizer
    window; anything else is refused, never computed some other way."""
    sp = params.spacer()
    if sp.spaced:
        raise NotImplementedError("spaced seeds (-s) are not yet ported, "
                                  "see ROADMAP")
    if sp.w != sp.c:
        raise NotImplementedError("windows wider than k (-w) are not yet "
                                  "ported, see ROADMAP")
    if not 1 <= params.k <= 32:
        raise ValueError(f"k must be in [1, 32], got {params.k}")
    return sp


def _pack_tile_host(tile: np.ndarray):
    """ASCII (R, C) -> (2-bit codes packed 4/byte, validity bits packed
    8/byte, little bit order); C % 8 == 0.  Native C++ packer, numpy when
    the native library is unavailable (byte-identical)."""
    with metrics.accum("host.pack2bit", items=tile.nbytes):
        got = native.pack2bit(tile)
        if got is not None:
            return got
        return _pack_tile_host_inner(tile)


def _pack_tile_host_inner(tile: np.ndarray):
    R, _ = tile.shape
    up = tile & 0xDF
    code = np.zeros(tile.shape, np.uint8)
    code[up == ord("C")] = 1
    code[up == ord("G")] = 2
    code[up == ord("T")] = 3
    valid = np.isin(up, np.frombuffer(b"ACGT", np.uint8))
    c4 = code.reshape(R, -1, 4)
    packed = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
              | (c4[..., 3] << 6))
    vbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, vbits


def _read_joined(path: str, sep_len: int) -> np.ndarray:
    """Logical path (sub-paths joined by the repo's separator) -> one
    separator-joined uint8 array; native C++ loader first."""
    with metrics.accum("host.parse"):
        parts: List[np.ndarray] = []
        for sub in split_subpaths(path):
            nat = native.read_joined(sub, sep_len)
            if nat is not None:
                parts.append(nat[0])
            else:
                parts.append(join_records(
                    [seq for _, seq in fasta.read_records(sub)], sep_len))
        if len(parts) == 1:
            return parts[0]
        sep = np.zeros(sep_len, np.uint8)
        glued: List[np.ndarray] = []
        for i, arr in enumerate(parts):
            if i:
                glued.append(sep)
            glued.append(arr)
        return np.concatenate(glued) if glued else np.zeros(0, np.uint8)


def _row_chunks(tiles: np.ndarray) -> Iterable[np.ndarray]:
    """Split (rows, C) tiles into chunks of at most MAX_ROWS rows.  (The
    JAX package also pads each chunk's row count to a power of two, to
    bound jit shape variants; eager torch and the kernel need no padding,
    and all-'N' rows would only add invalid windows.)"""
    for i in range(0, tiles.shape[0], MAX_ROWS):
        yield tiles[i:i + MAX_ROWS]


def _pad8(tiles: np.ndarray) -> np.ndarray:
    """Pad the row width to a multiple of 8 with N (the packed upload
    needs it; trailing N columns only add invalid windows)."""
    padw = (-tiles.shape[1]) % 8
    if padw:
        tiles = np.pad(tiles, ((0, 0), (0, padw)), constant_values=ord("N"))
    return tiles


def _joined_tiles(joined: np.ndarray, halo: int) -> Iterable[np.ndarray]:
    yield from _row_chunks(_pad8(tile_sequence(joined, CONTENT, halo)))


def should_stream(path: str) -> bool:
    try:
        total = sum(os.stat(s).st_size for s in split_subpaths(path))
    except OSError:
        return False
    return total > STREAM_THRESHOLD


def _stream_joined_parts(path: str, sep_len: int) -> Iterable[np.ndarray]:
    """Incremental joined bytes of a logical path; their concatenation
    equals _read_joined(path, sep_len)."""
    sep = np.zeros(sep_len, np.uint8)
    for si, sub in enumerate(split_subpaths(path)):
        if si:
            yield sep
        gen = native.stream_joined(sub, sep_len)
        if gen is None:
            gen = fasta.stream_joined(sub, sep_len)
        while True:
            with metrics.accum("host.parse"):
                arr = next(gen, None)
            if arr is None:
                break
            yield arr


def _stream_tiles(parts: Iterable[np.ndarray], halo: int
                  ) -> Iterable[np.ndarray]:
    """Cut a joined byte stream into windows joined[s*W : s*W + W + halo]
    (W = MAX_ROWS * CONTENT) of exactly MAX_ROWS rows each, then tile the
    tail; every k-mer window lands in exactly one row, as in whole-file
    tiling."""
    W = MAX_ROWS * CONTENT
    buf: List[np.ndarray] = []
    buflen = 0
    for arr in parts:
        if not arr.size:
            continue
        buf.append(arr)
        buflen += arr.size
        while buflen >= W + halo:
            seg = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield _pad8(tile_sequence(seg[:W + halo], CONTENT, halo)[:MAX_ROWS])
            buf, buflen = [seg[W:]], seg.size - W
    if buflen:
        yield from _joined_tiles(np.concatenate(buf), halo)


def _file_tiles(path: str, sp: Spacer) -> Iterable[np.ndarray]:
    """(rows, CONTENT + halo, padded to %8) uint8 tiles covering a path;
    files above STREAM_THRESHOLD stream (same registers either way)."""
    if should_stream(path):
        yield from _stream_tiles(_stream_joined_parts(path, sp.halo), sp.halo)
    else:
        yield from _joined_tiles(_read_joined(path, sp.halo), sp.halo)


def sketch_chunk_stream(chunks: Iterable[np.ndarray], params: SketchParams,
                        p: int, device: torch.device) -> torch.Tensor:
    """Fold a stream of (rows, C) ASCII tiles into (2^p,) int32 registers
    on `device` (returned without synchronising)."""
    sp = check_supported(params)
    regs = torch.zeros(1 << p, dtype=torch.int32, device=device)
    for tile in chunks:
        packed, vbits = _pack_tile_host(tile)
        with metrics.accum("sketch.dispatch", items=tile.nbytes):
            packed_to_registers(torch.from_numpy(packed).to(device),
                                torch.from_numpy(vbits).to(device), regs,
                                k=sp.k, p=p, canon=params.canon)
    return regs


def registers_to_numpy(regs: torch.Tensor) -> np.ndarray:
    """Device int32 registers -> host uint8 (clamped to 0..255, as the JAX
    package clamps on the pull)."""
    return regs.clamp(0, 255).to(torch.uint8).cpu().numpy()


def sketch_file_hll(path: str, params: SketchParams, p: int,
                    device: torch.device) -> np.ndarray:
    """Sketch one logical path into 2^p uint8 HLL registers."""
    sp = check_supported(params)
    return registers_to_numpy(
        sketch_chunk_stream(_file_tiles(path, sp), params, p, device))


def sketch_joined_hll(joined: np.ndarray, params: SketchParams, p: int,
                      device: torch.device) -> np.ndarray:
    """Sketch an already joined uint8 sequence (records separated by at
    least k-1 invalid bytes) into 2^p uint8 registers."""
    sp = check_supported(params)
    return registers_to_numpy(
        sketch_chunk_stream(_joined_tiles(joined, sp.halo), params, p, device))
