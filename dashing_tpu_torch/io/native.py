"""ctypes bindings for the native FASTA/FASTQ loader and the HeavyKeeper
count filter (dashing_tpu_torch/native).

The loader produces the same joined-bytes layout as the pure-python path
(records separated by `sep_len` zero bytes), so the two are interchangeable;
the pipeline prefers native when the shared library builds.

The port builds its own copy of the C++ sources (fastx.cpp, emit.cpp,
pack.cpp, hk.cpp under dashing_tpu_torch/native/) at first use, with

    g++ -O3 -std=c++17 -fPIC -Wall [-DDTPU_HAVE_ZSTD] -shared \
        -o native/build/libdtt_fastx-<hash>.so fastx.cpp emit.cpp pack.cpp \
        hk.cpp -lz [-lzstd] -lpthread

into a directory that .gitignore lists, under a lock of its own.  <hash>
covers the sources and the full command line, so an edit to either builds
a new library instead of reusing one made another way.  Without a
compiler every entry returns None and callers take the Python path.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native")
_SOURCES = ("fastx.cpp", "emit.cpp", "pack.cpp", "hk.cpp")
BUILD_DIR = os.path.join(_SRC_DIR, "build")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    """Compile the sources if needed; the library's path, or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    zstd = os.path.exists("/usr/include/zstd.h")
    opts = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
            *(["-DDTPU_HAVE_ZSTD"] if zstd else [])]
    libs = ["-lz", *(["-lzstd"] if zstd else []), "-lpthread"]
    key = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as fp:
            key.update(fp.read())
    key.update("\0".join([cxx, *opts, *libs]).encode())
    so = os.path.join(BUILD_DIR, f"libdtt_fastx-{key.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # an exclusive flock serialises first builds across processes
    with open(os.path.join(BUILD_DIR, ".fastx.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                tmp = f"{so}.tmp.{os.getpid()}"
                srcs = [os.path.join(_SRC_DIR, name) for name in _SOURCES]
                res = subprocess.run([cxx, *opts, "-o", tmp, *srcs, *libs],
                                     capture_output=True, timeout=300)
                if res.returncode != 0:
                    return None
                os.replace(tmp, so)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


class _DtpuFastx(ctypes.Structure):
    # `names` must be a raw pointer, NOT c_char_p: attribute access on a
    # c_char_p field converts to a NUL-truncated bytes object, and
    # string_at(that, names_len) then reads past the short buffer —
    # leaked heap bytes (or a crash) for any header containing a NUL
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_len", ctypes.c_uint64),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("names_len", ctypes.c_uint64),
        ("nrecords", ctypes.c_uint64),
        ("rec_ends", ctypes.POINTER(ctypes.c_uint64)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = _build()
            lib = ctypes.CDLL(so) if so else None
        except (OSError, subprocess.SubprocessError):
            lib = None
        if lib is None:
            return None
        lib.dtpu_read_fastx.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                        ctypes.POINTER(_DtpuFastx)]
        lib.dtpu_read_fastx.restype = ctypes.c_int
        lib.dtpu_free.argtypes = [ctypes.POINTER(_DtpuFastx)]
        lib.dtpu_free.restype = None
        lib.dtpu_read_raw.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.dtpu_read_raw.restype = ctypes.c_int
        lib.dtpu_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.dtpu_free_buf.restype = None
        lib.dtpu_fmt_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.dtpu_fmt_rows.restype = ctypes.c_int
        lib.dtpu_fmt_nn_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.dtpu_fmt_nn_rows.restype = ctypes.c_int
        lib.dtpu_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.dtpu_stream_open.restype = ctypes.c_void_p
        lib.dtpu_stream_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.dtpu_stream_read.restype = ctypes.c_int64
        lib.dtpu_stream_close.argtypes = [ctypes.c_void_p]
        lib.dtpu_stream_close.restype = None
        lib.dtpu_pack2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.dtpu_pack2bit.restype = ctypes.c_int
        lib.dtt_pack_joined.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), *[ctypes.c_int64] * 6,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        lib.dtt_pack_joined.restype = ctypes.c_int
        lib.dtpu_hk_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_uint64, ctypes.c_double]
        lib.dtpu_hk_create.restype = ctypes.c_void_p
        lib.dtpu_hk_destroy.argtypes = [ctypes.c_void_p]
        lib.dtpu_hk_destroy.restype = None
        lib.dtpu_hk_add.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.dtpu_hk_add.restype = None
        lib.dtpu_hk_query.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.dtpu_hk_query.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_raw(path: str) -> Optional[bytes]:
    """Whole-file decompressed bytes via the native loader (handles gz and,
    when built against libzstd, zstd frames).  None on unavailability."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_uint8)()
    ln = ctypes.c_uint64()
    rc = lib.dtpu_read_raw(path.encode(), ctypes.byref(buf),
                           ctypes.byref(ln))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(buf, ln.value)
    finally:
        lib.dtpu_free_buf(buf)


def fmt_rows_iter(vals: np.ndarray, counts: np.ndarray, fmt: int):
    """Format matrix rows natively; yields one str segment per row, each of
    the form '\\t<v0>\\t<v1>...'.  `vals` holds the rows concatenated,
    `counts` the per-row value counts.  fmt: 0 = '%.6g', 1 = '%e',
    2 = '%f' (matching io.distmat's emitters).  Returns None when the
    native library is unavailable — callers fall back to the Python loop.

    Rows are processed in bounded batches (~64 MB of formatting buffer) so
    arbitrarily large matrices never materialize a full text copy."""
    lib = _load()
    if lib is None:
        return None
    counts = np.asarray(counts, np.int64)
    if int(counts.sum()) != vals.size:
        raise ValueError("counts do not partition vals")
    slot = 56 if fmt == 2 else 18
    batch_vals = max(1, (64 << 20) // slot)

    def gen():
        r, v0 = 0, 0
        nrows = counts.size
        while r < nrows:
            r1, acc = r, 0
            while r1 < nrows and (acc == 0 or acc + counts[r1] <= batch_vals):
                acc += int(counts[r1])
                r1 += 1
            off = np.zeros(r1 - r + 1, np.int64)
            np.cumsum(counts[r:r1], out=off[1:])
            # convert per batch: `vals` may be an out-of-core memmap of the
            # whole condensed matrix — never materialize it wholesale
            sub = np.ascontiguousarray(vals[v0:v0 + acc], np.float32)
            v0 += acc
            out = ctypes.create_string_buffer(max(1, acc * slot))
            seg = np.zeros(r1 - r, np.int64)
            rc = lib.dtpu_fmt_rows(
                sub.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                r1 - r, fmt, slot, 0, out,
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc != 0:
                raise RuntimeError("dtpu_fmt_rows failed")
            mv = memoryview(out)
            for i in range(r1 - r):
                a = int(off[i]) * slot
                yield bytes(mv[a:a + int(seg[i])]).decode("ascii")
            r = r1
    return gen()


def fmt_nn_rows_iter(vals: np.ndarray, ids: np.ndarray, fmt: int = 0):
    """Format k-NN rows natively; yields one '\\t<id>:<v>...' str segment
    per row.  vals (nrows, nn) float32, ids (nrows, nn) int64.  Returns
    None when unavailable — callers fall back to the Python loop."""
    lib = _load()
    if lib is None:
        return None
    nrows, nn = vals.shape
    slot = 78 if fmt == 2 else 40
    batch_rows = max(1, (64 << 20) // (slot * max(nn, 1)))

    def gen():
        r = 0
        while r < nrows:
            r1 = min(nrows, r + batch_rows)
            sub_v = np.ascontiguousarray(vals[r:r1], np.float32)
            sub_i = np.ascontiguousarray(ids[r:r1], np.int64)
            out = ctypes.create_string_buffer(max(1, (r1 - r) * nn * slot))
            seg = np.zeros(r1 - r, np.int64)
            rc = lib.dtpu_fmt_nn_rows(
                sub_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                sub_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                r1 - r, nn, fmt, slot, out,
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc != 0:
                raise RuntimeError("dtpu_fmt_nn_rows failed")
            mv = memoryview(out)
            for i in range(r1 - r):
                a = i * nn * slot
                yield bytes(mv[a:a + int(seg[i])]).decode("ascii")
            r = r1
    return gen()


def pack2bit(tile: np.ndarray):
    """Single-pass native 2-bit pack: (rows, C) ASCII uint8 ->
    (codes packed 4/byte, validity bits packed 8/byte), byte-identical
    to pipeline._pack_tile_host_inner.  None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows, C = tile.shape
    if C % 8 != 0:
        return None
    tile = np.ascontiguousarray(tile, np.uint8)
    packed = np.empty((rows, C // 4), np.uint8)
    vbits = np.empty((rows, C // 8), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.dtpu_pack2bit(tile.ctypes.data_as(u8p), rows, C,
                           packed.ctypes.data_as(u8p),
                           vbits.ctypes.data_as(u8p))
    if rc != 0:
        return None
    return packed, vbits


def pack_joined(joined: np.ndarray, content: int, halo: int, width: int,
                row0: int, rows: int):
    """Rows [row0, row0 + rows) of the tiling of a joined uint8 sequence
    (row r covers joined[r*content : r*content + content + halo], bytes
    past the end and columns past content + halo read as N, `width`
    columns a row) packed straight from the joined bytes: byte-identical
    to pack2bit of those rows of the tile, which is never made.  None
    when unavailable."""
    lib = _load()
    if lib is None:
        return None
    joined = np.ascontiguousarray(joined, np.uint8)
    packed = np.empty((rows, width // 4), np.uint8)
    vbits = np.empty((rows, width // 8), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.dtt_pack_joined(joined.ctypes.data_as(u8p), joined.size,
                             content, halo, width, row0, rows,
                             packed.ctypes.data_as(u8p),
                             vbits.ctypes.data_as(u8p))
    if rc != 0:
        raise ValueError(f"dtt_pack_joined refused content={content} "
                         f"halo={halo} width={width} rows={row0}+{rows}")
    return packed, vbits


def stream_joined(path: str, sep_len: int, chunk_bytes: int = 4 << 20):
    """Generator of joined uint8 arrays for one file in O(chunk) memory.

    Concatenating the yielded arrays equals read_joined(path, sep_len)[0]
    byte-for-byte (the incremental state machine in native/fastx.cpp
    replicates the batch parser's kseq record semantics).  Returns None
    when the native library lacks the streaming API or the file cannot be
    opened (zstd without libzstd included) — callers fall back to the
    Python streaming parser."""
    lib = _load()
    if lib is None:
        return None
    h = lib.dtpu_stream_open(path.encode(), sep_len)
    if not h:
        return None

    def gen():
        buf = np.empty(chunk_bytes, np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        try:
            while True:
                got = lib.dtpu_stream_read(h, ptr, chunk_bytes)
                if got == 0:
                    return
                if got < 0:
                    raise ValueError(
                        f"{path}: malformed or unreadable FASTA/FASTQ "
                        f"(native stream error {got})")
                yield buf[:got].copy()
        finally:
            lib.dtpu_stream_close(h)
    return gen()


def read_joined(path: str, sep_len: int
                ) -> Optional[Tuple[np.ndarray, List[bytes], np.ndarray]]:
    """Returns (joined uint8 array, record names, record end offsets), or
    None if the native library is unavailable or refuses the file."""
    lib = _load()
    if lib is None:
        return None
    res = _DtpuFastx()
    rc = lib.dtpu_read_fastx(path.encode(), sep_len, ctypes.byref(res))
    if rc != 0:
        return None
    try:
        n = int(res.seq_len)
        seq = np.ctypeslib.as_array(res.seq, shape=(n,)).copy() if n else \
            np.zeros(0, np.uint8)
        names_blob = ctypes.string_at(res.names, int(res.names_len))
        nrec_hdr = int(res.nrecords)
        names = (names_blob.split(b"\n") if nrec_hdr
                 else [])   # one entry per record even for empty headers
        if nrec_hdr and len(names) != nrec_hdr:
            names = (names + [b""] * nrec_hdr)[:nrec_hdr]
        nrec = int(res.nrecords)
        ends = (np.ctypeslib.as_array(res.rec_ends, shape=(nrec,)).copy()
                if nrec else np.zeros(0, np.uint64))
        return seq, names, ends
    finally:
        lib.dtpu_free(ctypes.byref(res))
