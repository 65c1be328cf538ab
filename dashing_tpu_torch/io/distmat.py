"""Distance-matrix file formats and text emitters.

Binary condensed format (byte-compatible with the reference's
dm::DistanceMatrix<float>, reference distmat/distmat.h:390-395 and the
dist -b stream src/sketch_and_cmp.h:820-836):

    1 byte  magic: dtype code (0 = float32, distmat.h:96-108)
    8 bytes u64 little-endian: number of sets n
    4*n(n-1)/2 bytes: float32 upper-triangular entries, row-major
        entry (i, j>i) at index i*(2n-i-1)/2 + j-i-1   (distmat.h:260-264)

Text emitters replicate the reference formats:
  * UT_TSV: '##Names\\t<name>\\t...' header, then per row: name, one '\\t-'
    per column <= i, then '\\t%.6g' values (src/sketch_and_cmp.h:16-35,
    :612-618 header).
  * PHYLIP upper triangular: first line = count; rows = name padded to >= 9
    chars then values (src/sketch_and_cmp.h:27-30).
  * FULL_TSV: '#Names' header then square matrix, '%0.6g' (src/
    sketch_and_cmp.h:851-877).

The flatten_all multi-k container (reference src/flatten_all.cpp:39-43):
    u32 nk | u64 nentries | u64 nsets | u32 k[nk] | f32[nentries*nk]
    entry-major interleaving (all k values for entry 0, then entry 1, ...).
"""
from __future__ import annotations

import struct
from typing import IO, List, Sequence, Union

import numpy as np

MAGIC_FLOAT = 0  # more_magic::MagicNumber::FLOAT


def condensed_index(n: int, i: int, j: int) -> int:
    assert j > i
    return (i * (2 * n - i - 1)) // 2 + j - i - 1


def write_binary(path_or_fp: Union[str, IO[bytes]], condensed: np.ndarray,
                 n: int):
    data = np.ascontiguousarray(condensed, np.float32)
    assert data.size == n * (n - 1) // 2
    if isinstance(path_or_fp, str):
        with open(path_or_fp, "wb") as fp:
            write_binary(fp, data, n)
        return
    fp = path_or_fp
    fp.write(bytes([MAGIC_FLOAT]))
    fp.write(struct.pack("<Q", n))
    fp.write(data.tobytes())


HEADER_BYTES = 9
MAGIC_IN_PROGRESS = 0xFF   # dtype byte while tiles are still being written


def create_binary_mmap(path: str, n: int) -> np.ndarray:
    """Memory-mapped condensed matrix backing `path` — the out-of-core
    writer (reference distmat/distmat.h:193-243: ftruncate + mmap; tiles
    land in the page cache while the device computes the next ones, the
    same compute/IO overlap as dm::parallel_fill :459-512).

    The dtype byte is held at MAGIC_IN_PROGRESS until finalize_binary_mmap
    flips it, so a file from a crashed run is rejected by read_binary
    instead of silently parsing as a complete matrix.  An existing
    right-sized file's allocation is reused (reference distmat.h:209-232);
    its contents are fully overwritten by the fill.
    """
    import os
    ne = n * (n - 1) // 2
    total = HEADER_BYTES + 4 * ne
    attach = False
    if os.path.exists(path) and os.path.getsize(path) == total:
        with open(path, "rb") as fp:
            hdr = fp.read(HEADER_BYTES)
        attach = struct.unpack("<Q", hdr[1:])[0] == n
    with open(path, "r+b" if attach else "wb") as fp:
        fp.write(bytes([MAGIC_IN_PROGRESS]))
        fp.write(struct.pack("<Q", n))
        fp.truncate(total)
    return np.memmap(path, np.float32, "r+", offset=HEADER_BYTES, shape=(ne,))


def attach_binary_mmap(path: str, n: int) -> np.ndarray:
    """Attach to a create_binary_mmap file another process already laid
    out (multi-host stripe writes: rank 0 creates, a barrier orders the
    create before attaches, then every rank writes only its own disjoint
    condensed stripes — the reference's parallel_fill stripe discipline,
    distmat/distmat.h:459-512, lifted across processes).

    Validates the HEADER, not just the size: the in-progress magic + n
    prove this is the file rank 0 just created, not a stale same-sized
    matrix from an earlier run sitting on a rank-local filesystem."""
    import os
    ne = n * (n - 1) // 2
    total = HEADER_BYTES + 4 * ne
    size = os.path.getsize(path)
    if size != total:
        raise ValueError(f"{path}: size {size} != expected {total} "
                         f"for n={n}")
    with open(path, "rb") as fp:
        hdr = fp.read(HEADER_BYTES)
    magic, (file_n,) = hdr[0], struct.unpack("<Q", hdr[1:])
    if magic != MAGIC_IN_PROGRESS or file_n != n:
        raise ValueError(
            f"{path}: header (magic={magic:#x}, n={file_n}) is not the "
            f"in-progress matrix rank 0 laid out for n={n} — stale file "
            "or non-shared filesystem")
    return np.memmap(path, np.float32, "r+", offset=HEADER_BYTES, shape=(ne,))


def finalize_binary_mmap(path: str):
    """Mark a create_binary_mmap file complete (call after flush)."""
    with open(path, "r+b") as fp:
        fp.write(bytes([MAGIC_FLOAT]))


def read_binary_lazy(path: str):
    """Returns (n, condensed float32 array-like) WITHOUT loading the
    payload: plain files come back as a read-only memmap (out-of-core
    matrices stream in O(batch)); gzip falls back to read_binary."""
    import gzip
    import os
    with open(path, "rb") as probe:
        head = probe.read(2)
    if head == b"\x1f\x8b":
        return read_binary(path)
    with open(path, "rb") as fp:
        magic = fp.read(1)[0]
        if magic == MAGIC_IN_PROGRESS:
            raise ValueError(f"{path}: incomplete distance matrix (the "
                             "writing run crashed before finalizing)")
        if magic != MAGIC_FLOAT:
            raise ValueError(f"unsupported distance-matrix dtype code {magic}")
        (n,) = struct.unpack("<Q", fp.read(8))
    ne = n * (n - 1) // 2
    if os.path.getsize(path) < HEADER_BYTES + 4 * ne:
        raise EOFError("truncated distance matrix")
    return n, np.memmap(path, np.float32, "r", offset=HEADER_BYTES,
                        shape=(ne,))


def read_binary(path: str):
    """Returns (n, condensed float32 array).  Accepts gzip like the ref."""
    import gzip
    opener = open
    with open(path, "rb") as probe:
        if probe.read(2) == b"\x1f\x8b":
            opener = gzip.open
    with opener(path, "rb") as fp:
        magic = fp.read(1)[0]
        if magic == MAGIC_IN_PROGRESS:
            raise ValueError(f"{path}: incomplete distance matrix (the "
                             "writing run crashed before finalizing)")
        if magic != MAGIC_FLOAT:
            raise ValueError(f"unsupported distance-matrix dtype code {magic}")
        (n,) = struct.unpack("<Q", fp.read(8))
        payload = fp.read(4 * n * (n - 1) // 2)
        data = np.frombuffer(payload, np.float32)
        if data.size != n * (n - 1) // 2:
            raise EOFError("truncated distance matrix")
    return n, data.copy()


# NOTE on -e/--use-scientific: the reference's dist-mode matrix emitters
# HARDCODE "\t%.6g" / "%0.6g" and ignore the flag (sketch_and_cmp.h:17
# constexpr fmt; :851-877) — it only affects the cardinality table
# (:244) and printmat -s.  Ours honors -e for matrix output too, as the
# flag's own help text promises; deliberate divergence, recorded in
# PARITY.md (without -e the bytes match the reference exactly).


def _row_segments(vals: np.ndarray, counts: np.ndarray, fmt_code: int):
    """Per-row '\\t<v>\\t<v>...' segments; native C++ formatter when the
    shared library is present (15-40x the Python loop; byte-identical,
    asserted by tests/test_io_pipeline.py), Python otherwise.  Values are
    formatted at float32 — the precision the binary format stores
    (write_binary's dtype code 0) — on BOTH paths, so native/fallback and
    text/binary outputs agree.  `vals` may be an out-of-core memmap; both
    paths read it in bounded slices."""
    from . import native
    it = native.fmt_rows_iter(vals, counts, fmt_code)
    if it is not None:
        return it
    py_fmt = ("%.6g", "%e", "%f")[fmt_code]

    def gen():
        pos = 0
        for cnt in counts:
            c = int(cnt)
            row = np.asarray(vals[pos:pos + c], np.float32)
            yield "".join("\t" + py_fmt % v for v in row)
            pos += c
    return gen()


def emit_ut_tsv(fp, names: Sequence[str], condensed: np.ndarray,
                scientific: bool = False):
    n = len(names)
    fp.write("##Names\t" + "\t".join(names) + "\n")
    counts = np.arange(n - 1, -1, -1, dtype=np.int64)
    segs = _row_segments(np.asarray(condensed), counts, 1 if scientific else 0)
    for i, seg in enumerate(segs):
        fp.write(names[i] + "\t-" * (i + 1) + seg + "\n")


def emit_phylip(fp, names: Sequence[str], condensed: np.ndarray,
                scientific: bool = False):
    n = len(names)
    fp.write(f"{n}\n")
    counts = np.arange(n - 1, -1, -1, dtype=np.int64)
    segs = _row_segments(np.asarray(condensed), counts, 1 if scientific else 0)
    for i, seg in enumerate(segs):
        name = names[i]
        if len(name) < 9:
            name = name + " " * (9 - len(name))
        fp.write(name + seg + "\n")


def emit_full_tsv(fp, names: Sequence[str], square: np.ndarray,
                  scientific: bool = False):
    # Header replicates the reference byte-for-byte (src/sketch_and_cmp.h:
    # 852-858): fputs("#Names") then each name followed by '\t' (or '\n'
    # after the last) — note NO separator between "#Names" and name 0.
    fp.write("#Names" + "\t".join(names) + "\n")
    n = len(names)
    sq = np.ascontiguousarray(square, np.float32).reshape(-1)
    counts = np.full(n, n, np.int64)
    segs = _row_segments(sq, counts, 1 if scientific else 0)
    for i, seg in enumerate(segs):
        fp.write(names[i] + seg + "\n")


def emit_rect_tsv(fp, row_names: Sequence[str], mat: np.ndarray,
                  scientific: bool = False):
    """Rectangular (nq, nr) TSV rows 'name\\t<v>...\\t<v>' through the
    native formatter (the Q x R / dist_by_seq emission path previously
    formatted per-value in Python — the exact host-side wall
    native/emit.cpp was written to remove; byte-identical: '%g' ==
    '%.6g')."""
    nq, nr = mat.shape
    counts = np.full(nq, nr, np.int64)
    segs = _row_segments(np.ascontiguousarray(mat, np.float32).reshape(-1),
                         counts, 1 if scientific else 0)
    for nm, seg in zip(row_names, segs):
        fp.write(nm + seg + "\n")


def emit_nn_tsv(fp, row_names: Sequence[str], vals: np.ndarray,
                order: np.ndarray):
    """k-NN TSV rows 'name\\t<id>:<dist>...' (reference nndist_loop TSV,
    src/sketch_and_cmp.h:747-760).  Fully-native '%d:%g' interleave
    (dtpu_fmt_nn_rows) when the library is present; the Python fallback
    routes the float formatting through _row_segments and post-joins the
    ids (byte-identical on both paths)."""
    from . import native
    npairs, nn = vals.shape
    vals32 = np.ascontiguousarray(vals, np.float32)
    ids64 = np.ascontiguousarray(order, np.int64)
    it = native.fmt_nn_rows_iter(vals32, ids64, 0)
    if it is not None:
        for nm, seg in zip(row_names, it):
            fp.write(nm + seg + "\n")
        return
    counts = np.full(npairs, nn, np.int64)
    segs = _row_segments(vals32.reshape(-1), counts, 0)
    for i, seg in enumerate(segs):
        vstrs = seg.split("\t")[1:]          # seg leads with '\t'
        fp.write(row_names[i] + "".join(
            "\t%d:%s" % (int(ids64[i, j]), vstrs[j])
            for j in range(nn)) + "\n")


def condensed_to_square(condensed: np.ndarray, n: int, diag: float = 0.0
                        ) -> np.ndarray:
    out = np.full((n, n), diag, np.float32)
    pos = 0
    for i in range(n):
        cnt = n - i - 1
        out[i, i + 1:] = condensed[pos:pos + cnt]
        out[i + 1:, i] = condensed[pos:pos + cnt]
        pos += cnt
    return out


def print_binary(in_path: str, fp, use_scientific: bool = False):
    """The `printmat` subcommand (reference src/dashing.cpp:425-452):
    binary condensed matrix -> TSV dump.

    Streams the square in bounded row batches straight from the condensed
    layout (upper slice + mirrored column gather), so an out-of-core
    matrix written by create_binary_mmap prints in O(batch) memory like
    the reference's mmap-backed DistanceMatrix::printf — the previous
    condensed_to_square materialized 4*n^2 bytes."""
    n, data = read_binary_lazy(in_path)
    fmt_code = 1 if use_scientific else 2
    rows_per_batch = max(1, (8 << 20) // max(4 * n, 1))
    for i0 in range(0, n, rows_per_batch):
        i1 = min(n, i0 + rows_per_batch)
        block = np.zeros((i1 - i0, n), np.float32)
        for r, i in enumerate(range(i0, i1)):
            start = (i * (2 * n - i - 1)) // 2
            block[r, i + 1:] = data[start:start + (n - i - 1)]
            if i:
                j = np.arange(i, dtype=np.int64)
                block[r, :i] = data[(j * (2 * n - j - 1)) // 2 + i - j - 1]
        segs = _row_segments(block.reshape(-1),
                             np.full(i1 - i0, n, np.int64), fmt_code)
        for seg in segs:
            fp.write(seg[1:] + "\n")


# -- flatten (multi-k) -------------------------------------------------------

def flatten_all(in_paths: List[str], out_path: str, k_values: List[int]) -> int:
    if len(in_paths) != len(k_values):
        # np.empty below would otherwise write uninitialized heap bytes
        # for the unmatched k columns
        raise ValueError(f"flatten: {len(in_paths)} matrices for "
                         f"{len(k_values)} k values")
    mats = [read_binary(p) for p in in_paths]
    ne = mats[0][1].size
    if any(m[1].size != ne for m in mats):
        raise ValueError("matrices disagree on entry count")
    nk = len(k_values)
    inter = np.empty((ne, nk), np.float32)
    for j, (_, data) in enumerate(mats):
        inter[:, j] = data
    with open(out_path, "wb") as fp:
        fp.write(struct.pack("<I", nk))
        fp.write(struct.pack("<Q", ne))
        # byte parity with the reference writer (flatten_all.cpp:30):
        # `number_sets = fpaths.size()` — i.e. this u64 duplicates nk,
        # despite the name.  (The reference's own dormant JC reader,
        # background.cpp:134, reads it as genome count — a reference
        # inconsistency; consumers here derive n from ne instead.)
        fp.write(struct.pack("<Q", len(in_paths)))
        fp.write(np.asarray(k_values, np.uint32).tobytes())
        fp.write(inter.tobytes())
    return 0


def n_from_entries(ne: int) -> int:
    """Genome count from a condensed entry count: ne = n(n-1)/2."""
    n = int(round((1 + (1 + 8 * ne) ** 0.5) / 2))
    if n * (n - 1) // 2 != ne:
        raise ValueError(f"{ne} is not a condensed n(n-1)/2 entry count")
    return n


def read_flattened(path: str):
    """Returns (n_genomes, k_values, (ne, nk) data).  The genome count is
    derived from the entry count, NOT the header's nsets field — the
    reference writer stores fpaths.size() there (see flatten_all)."""
    with open(path, "rb") as fp:
        (nk,) = struct.unpack("<I", fp.read(4))
        (ne,) = struct.unpack("<Q", fp.read(8))
        fp.read(8)    # 'number_sets' = matrix count in reference bytes
        ks = np.frombuffer(fp.read(4 * nk), np.uint32)
        data = np.frombuffer(fp.read(4 * nk * ne), np.float32).reshape(ne, nk)
    return n_from_entries(ne), ks, data
