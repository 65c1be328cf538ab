"""The sketching engine: files -> tiles -> device registers (port of
dashing_tpu/pipeline.py, HLL sketches, one host).

The HLL engine's one entry is `sketch_hll_files`: the CLI says what to
sketch, this module how.  The next files are parsed and joined on a pool
(`prefetch`), each handed on as an `InputFile` (its joined bytes, or None
for a file large enough to stream through its own read-ahead thread); one
decision a file picks its route from its parameters and row count
(`file_route`); one loop folds a file's chunks (`sketch_chunk_stream`);
jobs stay queued on the device up to a bounded window, then are pulled.

A file's records are joined with invalid separators, cut into rows of
CONTENT bases plus a (w-1)-base halo (width padded to a multiple of 8 once
per file), and folded into 2^p registers on the device by one of two
routes, chosen once for a parameter set (`packed_ok`) as the JAX package
chooses them:
  packed  the default exact encoding (contiguous canonical-or-not k-mers,
          WangHash, no minimizer window): the host packs 2 bits per base
          plus a validity bit (io/native.pack2bit; a whole file's join of
          more than one chunk straight from its bytes, sketch_joined_async),
          and kernel K1 (ops/encode_hash.packed_to_registers) folds it;
  ASCII   everything else: spaced seeds (-s), minimizer windows (-w > k),
          entropy minimizers (-g), the rolling hashes (ntHash, cyclic;
          any k).  The raw tile is uploaded and `tile_to_registers`
          folds it into the registers: minimizer windows of contiguous
          k-mers in one launch of the minimizer kernel
          (ops/minimizer_hash), the rest as PyTorch ops that encode it
          (ops/encode.encode_tile or ops/rolling.rolling_hash_tile),
          WangHash it and scatter-max the ranks.
A file can also be count-min filtered (sketch -b/-f, dist -y): two passes
over its tiles, the first counting every k-mer's hash into a count-min
sketch on the device, the second admitting the k-mers whose estimated
count reaches the threshold.  Filtered tiles take the ASCII route: on a
card, exact contiguous k-mers run both passes on the count-min kernels
(ops/countmin.py, one launch a tile a pass, `_count_filtered_kernels`);
every other encoding yields each tile's 64-bit hashes and admission mask
(`_count_filtered_tiles`), and under DASHING_TPU_USE_HK=1 a HeavyKeeper
on the host counts instead (`_hk_filtered_tiles`).
Many small files fold in one launch into a (B, 2^p) register bank
(`sketch_small_batch_async`: the banked K1 over each file's rows packed
from its joined bytes, or the PyTorch encoders and a banked scatter-max
over its tiles), and so do a batch of sequence records
(`sketch_records_hll`: the banked K2).  `sketch_file_hll_multik` sketches
one file at several k from one upload a chunk (mkdist).  The b-bit
MinHash and bottom-k sketches take the ASCII tiles too
(`sketch_file_bbmh_mins`, `sketch_file_bottomk_values`).
On several cards of one host (parallel/mesh.py) the chunks of a stream
and the count-min passes go round-robin over the cards, each card into its
own partial registers, merged at the end (`_fold_over_cards`); the
small-file batches go round-robin, each banked on one card.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from . import device as devmod, metrics
from .hashes import wang_hash
from .io import fasta, native
from .io.paths import split_subpaths
from .ops import countmin, minhash_update, minimizer_hash, rolling
from .ops.countmin import add_hashes as _cm_add
from .ops.countmin import check_size as _check_cm_size
from .ops.countmin import query_hashes as _cm_query
from .ops.encode import (Spacer, encode_tile, join_records, parse_spacing,
                         tile_sequence)
from .ops.encode_hash import ascii_to_banks, encode_hash_keys, \
    packed_to_banks, packed_to_registers
from .ops.hll_update import bucket_rank, update_banks, update_registers
from .parallel import mesh

# Tile geometry: CONTENT bases of payload per row + halo; rows per upload.
CONTENT = 8192
MAX_ROWS = 256
# Files larger than this on disk stream through the incremental parser in
# O(MAX_ROWS * CONTENT) host memory instead of being read whole.
STREAM_THRESHOLD = 128 * 10 ** 6

ENCODINGS = ("bonsai", "nthash", "cyclic")

# host -> device uploads of tiles (one a chunk, whatever its arrays) since
# the last reset; chip_smoke.py reads it to show one upload serving
# several k (sketch_file_hll_multik)
chunk_uploads = 0
# chunks packed straight from a file's joined bytes (sketch_joined_async),
# no ASCII tile made, since the last reset
joined_packs = 0
# count-min filtered tiles through the first pass, and those of the second
# pass that were not kept on the device between the passes, so hashed
# again (a streamed file is also parsed again), since the last reset
cm_tiles = 0
cm_rehashed_tiles = 0
# small-file batches folded (sketch_small_batch_async), since the last reset
small_batches = 0


def _upload(*arrays: np.ndarray, device: torch.device):
    """Upload one chunk's host arrays to `device` (counted once)."""
    global chunk_uploads
    chunk_uploads += 1
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@dataclasses.dataclass(frozen=True)
class SketchParams:
    k: int = 31
    w: int = 0                      # window size (-w); 0 -> k-mer span
    spacing: str = ""
    canon: bool = True
    encoding: str = "bonsai"        # bonsai | nthash | cyclic
    rehash: bool = True             # apply WangHash to the encoder output
    entropy: bool = False           # -g/--by-entropy minimizer scoring
    min_count: int = 1              # threshold (sketch -n, dist -c)
    use_counting_filter: bool = False
    cm_size_log2: int = 20          # count-min geometry: 2^size counters a row
    cm_nhashes: int = 4             #   rows
    cm_seed: int = 1337             #   row-hash seed (-R/--seed)

    @property
    def filtered(self) -> bool:
        """Whether a file is count-min filtered: a threshold of 1 admits
        every k-mer, so only a threshold above 1 filters."""
        return self.use_counting_filter and self.min_count > 1

    def spacer(self) -> Spacer:
        return Spacer(self.k, self.w, parse_spacing(self.spacing, self.k))


def check_supported(params: SketchParams) -> Spacer:
    """Validate the encoder parameters the way the JAX package's encoders
    do (exact k-mers need k <= 32; the rolling hashes are contiguous) and
    return the k-mer shape."""
    if params.encoding not in ENCODINGS:
        raise ValueError(f"unknown encoding {params.encoding!r}")
    sp = params.spacer()
    if params.encoding == "bonsai" and not 1 <= params.k <= 32:
        raise ValueError(f"k must be in [1, 32], got {params.k}")
    if params.encoding != "bonsai" and (sp.spaced or params.entropy):
        raise ValueError("spaced seeds and entropy minimizers need the "
                         "exact (bonsai) encoder")
    return sp


def _encode_kw(params: SketchParams, sp: Spacer) -> dict:
    """The encoder arguments of every sketch path, from one place."""
    return dict(k=sp.k, w=sp.w, positions=tuple(sp.positions), span=sp.c,
                canon=params.canon, encoding=params.encoding,
                rehash=params.rehash, entropy=params.entropy)


def packed_ok(params: SketchParams, sp: Spacer, p: int) -> bool:
    """Whether a tile takes the packed upload to K1 (and a record batch
    the ASCII upload to K2): the exact encoding of contiguous k-mers with
    WangHash and no window, 2 <= p <= 31 (the kernels' range; the JAX
    package stops at p = 25, where its int32 keys end)."""
    return (params.encoding == "bonsai" and not params.entropy
            and params.rehash and sp.w == sp.c and not sp.spaced
            and 2 <= p <= 31)


def tile_hashes(tile: torch.Tensor, *, k: int, w: int, positions, span: int,
                canon: bool, encoding: str, rehash: bool,
                entropy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """An uploaded (R, C) uint8 tile -> (int64 hashes, valid), one per
    window: k-mers or rolling hashes, WangHashed when `rehash` (JAX
    `_tile_to_hashes`)."""
    if encoding == "bonsai":
        km, valid = encode_tile(tile, k=k, w=w, positions=positions,
                                span=span, canon=canon, entropy=entropy)
    else:
        km, valid = rolling.rolling_hash_tile(tile, k=k, kind=encoding,
                                              canon=canon, w=w)
    return (wang_hash(km) if rehash else km), valid


def tile_to_registers(tile: torch.Tensor, regs: torch.Tensor, *, p: int,
                      **kw) -> torch.Tensor:
    """The ASCII route's device step (JAX `_tile_to_registers`): an
    uploaded tile -> register max into `regs` in place.  Minimizer windows
    of exact contiguous k-mers (`minimizer_hash.takes`) fold in one launch
    of the minimizer kernel; every other encoding runs `tile_hashes(tile,
    **kw)` and `update_registers` as PyTorch ops."""
    if minimizer_hash.takes(p, **kw):
        return minimizer_hash.ascii_minimizer_registers(
            tile, regs, k=kw["k"], w=kw["w"], p=p, canon=kw["canon"])
    h, valid = tile_hashes(tile, **kw)
    return update_registers(regs, h, valid, p)


def tile_to_banks(tile: torch.Tensor, bank: torch.Tensor,
                  regs: torch.Tensor, *, p: int, **kw) -> torch.Tensor:
    """The ASCII route into a (B, 2^p) register bank: `tile_hashes(tile,
    **kw)`, then row r's ranks into regs[bank[r]] in place."""
    h, valid = tile_hashes(tile, **kw)
    return update_banks(regs, h, valid, bank, p)


def _pack_tile_host(tile: np.ndarray):
    """ASCII (R, C) -> (2-bit codes packed 4/byte, validity bits packed
    8/byte, little bit order); C % 8 == 0.  Native C++ packer, numpy when
    the native library is unavailable (byte-identical)."""
    with metrics.span("host.pack2bit", items=tile.nbytes):
        got = native.pack2bit(tile)
        if got is not None:
            return got
        return _pack_tile_host_inner(tile)


def joined_rows(n: int) -> int:
    """The rows `tile_sequence` cuts n joined bytes into."""
    return -(-n // CONTENT)


def _pack_joined_host(joined: np.ndarray, halo: int, row0: int, rows: int):
    """Rows [row0, row0 + rows) of _pad8(tile_sequence(joined, CONTENT,
    halo)) packed as _pack_tile_host packs them, read straight from the
    joined bytes by the native packer (io/native.pack_joined); without
    the native library those rows alone are tiled and packed by numpy."""
    width = CONTENT + halo + (-(CONTENT + halo)) % 8      # as _pad8 pads
    with metrics.span("host.pack2bit", items=rows * width):
        got = native.pack_joined(joined, CONTENT, halo, width, row0, rows)
        if got is not None:
            return got
        seg = joined[row0 * CONTENT:(row0 + rows) * CONTENT + halo]
        return _pack_tile_host_inner(
            _pad8(tile_sequence(seg, CONTENT, halo))[:rows])


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


def _read_joined_uncached(path: str, sep_len: int) -> np.ndarray:
    """Logical path (sub-paths joined by the repo's separator) -> one
    separator-joined uint8 array; native C++ loader first."""
    with metrics.span("host.parse"):
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


# Joined-bytes cache (JAX `set_join_cache`): mkdist's per-k passes read
# every file again.  Record separators need at least `halo` invalid bytes
# and longer ones change no window, so one join at _CACHE_SEP serves any
# sep_len <= _CACHE_SEP.  Opt-in (mkdist turns it on around its passes),
# bounded by DASHING_TPU_JOIN_CACHE_MB (default 512), least recently used
# out first; entries carry the file's (mtime_ns, size), so a rewritten
# file is read again.
_CACHE_SEP = 63
_join_cache: "OrderedDict[str, tuple]" = OrderedDict()
_join_cache_on = False
_join_lock = threading.Lock()


def _join_cache_limit() -> int:
    return int(float(os.environ.get("DASHING_TPU_JOIN_CACHE_MB", "512"))
               * 1e6)


def set_join_cache(enabled: bool) -> None:
    """Turn the joined-bytes cache on or off (off drops it)."""
    global _join_cache_on
    with _join_lock:
        _join_cache_on = enabled
        if not enabled:
            _join_cache.clear()


def _path_stamp(path: str):
    try:
        return tuple((st.st_mtime_ns, st.st_size)
                     for st in (os.stat(sub) for sub in split_subpaths(path)))
    except OSError:
        return None


def _read_joined(path: str, sep_len: int) -> np.ndarray:
    """Logical path -> one separator-joined uint8 array, through the
    joined-bytes cache when it is on (a cached array is read-only)."""
    limit = _join_cache_limit()
    if not _join_cache_on or sep_len > _CACHE_SEP or limit <= 0:
        return _read_joined_uncached(path, sep_len)
    stamp = _path_stamp(path)
    with _join_lock:
        hit = _join_cache.pop(path, None)       # pop and reinsert: LRU order
    if hit is not None and stamp is not None and hit[0] == stamp:
        arr = hit[1]
    else:
        arr = _read_joined_uncached(path, _CACHE_SEP)
        if stamp is None or arr.nbytes > limit:
            return arr
        arr.setflags(write=False)
    with _join_lock:
        _join_cache[path] = (stamp, arr)
        total = sum(a.nbytes for _, a in _join_cache.values())
        while total > limit and len(_join_cache) > 1:
            total -= _join_cache.popitem(last=False)[1][1].nbytes
    return arr


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
    with metrics.span("host.tile"):
        tiles = _pad8(tile_sequence(joined, CONTENT, halo))
    yield from _row_chunks(tiles)


def should_stream(path: str) -> bool:
    """Whether a file streams: above STREAM_THRESHOLD on disk, unless the
    joined-bytes cache is on and could hold it."""
    try:
        total = sum(os.stat(s).st_size for s in split_subpaths(path))
    except OSError:
        return False
    if _join_cache_on and total <= _join_cache_limit():
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
            with metrics.span("host.parse"):
                arr = next(gen, None)
            if arr is None:
                break
            yield arr


def _stream_tiles(parts: Iterable[np.ndarray], halo: int
                  ) -> Iterable[np.ndarray]:
    """Cut a joined byte stream into windows joined[s*W : s*W + W + halo]
    (W = MAX_ROWS * CONTENT) of exactly MAX_ROWS rows each, then tile the
    tail; every k-mer window lands in exactly one row, as in whole-file
    tiling.  It runs on the read-ahead thread (`InputFile.tiles`), so its
    `host.tile` time is that thread's, beside the consumer's."""
    W = MAX_ROWS * CONTENT
    buf: List[np.ndarray] = []
    buflen = 0
    for arr in parts:
        if not arr.size:
            continue
        buf.append(arr)
        buflen += arr.size
        while buflen >= W + halo:
            with metrics.span("host.tile"):
                seg = np.concatenate(buf) if len(buf) > 1 else buf[0]
                tiles = _pad8(tile_sequence(seg[:W + halo], CONTENT,
                                            halo)[:MAX_ROWS])
            yield tiles
            buf, buflen = [seg[W:]], seg.size - W
    if buflen:
        with metrics.span("host.tile"):
            tail = np.concatenate(buf)
        yield from _joined_tiles(tail, halo)


def _readahead(gen: Iterable, depth: int = 2) -> Iterator:
    """Run `gen` in a producer thread behind a bounded queue, so that
    parsing a streamed file overlaps the device work on its tiles (JAX
    `_readahead`).  An exception in the producer is raised in the
    consumer; a consumer that stops early stops the producer, which then
    closes `gen`."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in gen:
                if not put(item):
                    return
            put(done)
        except BaseException as exc:    # delivered to the consumer
            put(exc)
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                close()

    threading.Thread(target=work, daemon=True, name="dtt-readahead").start()
    try:
        while True:
            with metrics.span("sketch.parse_wait"):
                item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# parses the prefetch pool began while another of its parses was running
parse_overlaps = 0
_parse_lock = threading.Lock()
_parsing = 0


def parse_workers() -> int:
    """The prefetch pool's workers: two where the process may use three
    CPUs or more (the dispatching thread keeps one), else one."""
    return max(1, min(2, len(os.sched_getaffinity(0)) - 1))


def _parse(path: str, halo: int) -> np.ndarray:
    """_read_joined on a pool worker, counting in `parse_overlaps` each
    parse that begins while another is running (the native parser
    releases the GIL, so two run side by side)."""
    global parse_overlaps, _parsing
    with _parse_lock:
        parse_overlaps += _parsing > 0
        _parsing += 1
    try:
        return _read_joined(path, halo)
    finally:
        with _parse_lock:
            _parsing -= 1


@dataclasses.dataclass(frozen=True, eq=False)
class InputFile:
    """One file of the engine: its index, its path, the k-mer shape of its
    tiles, and its joined bytes from the parse pool, or None where the
    tiles come from the file itself (streamed when it is large)."""
    index: int
    path: str
    sp: Spacer
    joined: Optional[np.ndarray] = None

    def tiles(self) -> Iterator[np.ndarray]:
        """Its (rows, CONTENT + halo, padded to %8) uint8 tiles, cut anew
        at each call (a filtered file's second pass calls it again only
        where its first pass's tiles did not all stay on the card); a
        file above STREAM_THRESHOLD streams, parsed ahead in a producer
        thread (same tiles either way)."""
        halo = self.sp.halo
        if self.joined is not None:
            yield from _joined_tiles(self.joined, halo)
        elif should_stream(self.path):
            yield from _readahead(
                _stream_tiles(_stream_joined_parts(self.path, halo), halo))
        else:
            yield from _joined_tiles(_read_joined(self.path, halo), halo)


def prefetch(indexed_paths: Sequence[Tuple[int, str]], sp: Spacer
             ) -> Iterator[InputFile]:
    """Yield an InputFile per (index, path) in order while parse_workers()
    threads parse and join the next files, one more file ahead than there
    are workers; a file large enough to stream is not parsed ahead (its
    joined bytes are None).  A parse error is raised at its own file;
    stopping early cancels the parses not yet begun."""
    workers = parse_workers()
    ex = ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="dtt-parse")
    try:
        futs = {}
        for pos, (i, path) in enumerate(indexed_paths):
            for j, nxt in indexed_paths[pos:pos + 2 + workers]:
                if j not in futs and not should_stream(nxt):
                    futs[j] = ex.submit(_parse, nxt, sp.halo)
            fut = futs.pop(i, None)
            joined = None
            if fut is not None:
                with metrics.span("sketch.parse_wait"):
                    joined = fut.result()
            yield InputFile(i, path, sp, joined)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _fold_over_cards(units: Iterable, devs: Sequence[torch.device], p: int,
                     fold: Callable) -> torch.Tensor:
    """The mesh round-robin: unit i folds into the (2^p,) int32 registers
    of card i % len(devs) by fold(unit, card, registers); the cards'
    registers are merged on the first one at the end."""
    regs = [torch.zeros(1 << p, dtype=torch.int32, device=d) for d in devs]
    for unit, (card, r) in zip(units, itertools.cycle(zip(devs, regs))):
        fold(unit, card, r)
    return mesh.max_merge(regs)


def _launch(up: Tuple[torch.Tensor, ...], regs: torch.Tensor,
            params: SketchParams, sp: Spacer, p: int, packed: bool):
    """One uploaded chunk into `regs`: (codes, validity bits) to K1 on the
    packed route, else the ASCII tile to tile_to_registers."""
    if packed:
        packed_to_registers(*up, regs, k=sp.k, p=p, canon=params.canon)
    else:
        tile_to_registers(up[0], regs, **_encode_kw(params, sp), p=p)


def sketch_chunk_stream(chunks: Iterable, params: SketchParams, p: int,
                        device: torch.device, packed: bool) -> torch.Tensor:
    """The chunk loop: fold a stream of (rows, C) ASCII tiles into (2^p,)
    int32 registers on `device`, not synchronised (JAX
    `_sketch_chunk_stream`), round-robin over a mesh's cards.  `packed`
    (packed_ok's answer): each tile is packed on the host for K1, unless
    it comes as a (codes, validity bits) pair; else tile_to_registers."""
    sp = check_supported(params)

    def fold(chunk, card, regs):
        if packed and not isinstance(chunk, tuple):
            chunk = _pack_tile_host(chunk)
        up = chunk if packed else (chunk,)
        with metrics.accum("sketch.dispatch",
                           items=up[0].size * (4 if packed else 1)):
            _launch(_upload(*up, device=card), regs, params, sp, p, packed)

    return _fold_over_cards(chunks, mesh.cards(device), p, fold)


def sketch_joined_async(joined: np.ndarray, params: SketchParams, p: int,
                        device: torch.device) -> torch.Tensor:
    """The chunk loop on the packed route over _joined_tiles(joined, halo)'s
    chunks, each of MAX_ROWS rows packed straight from the joined bytes
    (_pack_joined_host), so no ASCII tile is made: the same chunks,
    uploads and launches in the same order, and the same registers.
    Counted in `joined_packs`, a chunk at a time."""
    sp = check_supported(params)
    rows = joined_rows(joined.size)

    def chunks():
        global joined_packs
        for row0 in range(0, rows, MAX_ROWS):
            joined_packs += 1
            yield _pack_joined_host(joined, sp.halo, row0,
                                    min(MAX_ROWS, rows - row0))

    return sketch_chunk_stream(chunks(), params, p, device, packed=True)


# ---------------------------------------------------------------------------
# Small-file batching (JAX pipeline.py:776-882): one launch folds the
# single-chunk tiles of B files into a (B, 2^p) register bank, each row
# into its file's bank by a per-row bank index.  One launch and one pull a
# batch instead of one a file: at a collection of small genomes the
# per-file dispatch and pull held the sketch phase.
# ---------------------------------------------------------------------------

def small_batch_size(p: int) -> int:
    """Files a batched launch: the bank bounded at 64 MB (4 B * B * 2^p),
    a multiple of 8, at most 64.  0 turns batching off (p >= 22, where 8
    banks would pass the bound)."""
    b = min(64, (64 << 20) // (4 << p))
    return (b // 8) * 8


def _tile_shape(chunk) -> Tuple[int, int]:
    """(rows, width) of an ASCII tile or of its (codes, bits) pair's codes."""
    return (chunk[0] if isinstance(chunk, tuple) else chunk).shape


def _join_rows(arrays: Sequence[np.ndarray]) -> np.ndarray:
    return np.concatenate(arrays) if len(arrays) > 1 else arrays[0]


def sketch_small_batch_async(chunks: Sequence, params: SketchParams, p: int,
                             device: torch.device, packed: bool
                             ) -> torch.Tensor:
    """The single-chunk tiles of B files, (R_i, C) uint8 of one width C,
    -> (B, 2^p) int32 register banks on `device`, not synchronised: one
    upload and one launch (the banked K1 where `packed`), counted in
    `small_batches`.  Where `packed`, a chunk may also come as its
    (codes, validity bits) pair (_pack_joined_host).  Row counts may
    differ (the JAX package stacks equal shapes and pads a partial group
    with all-N chunks to bound its jit variants; the bank vector makes
    both unnecessary here)."""
    global small_batches
    small_batches += 1
    sp = check_supported(params)
    B = len(chunks)
    # the batch's host staging: its rows joined, their bank vector and,
    # on the packed route, the 2-bit pack of any tile that came unpacked
    with metrics.span("sketch.batch_stage"):
        bank = np.repeat(np.arange(B, dtype=np.int32),
                         [_tile_shape(c)[0] for c in chunks])
        if packed:
            pairs = [c if isinstance(c, tuple) else _pack_tile_host(c)
                     for c in chunks]
            codes = _join_rows([c for c, _ in pairs])
            vbits = _join_rows([v for _, v in pairs])
        else:
            flat = _join_rows(chunks)
    regs = torch.zeros((B, 1 << p), dtype=torch.int32, device=device)
    if packed:
        with metrics.accum("sketch.dispatch", items=codes.size * 4):
            pk, vb, bk = _upload(codes, vbits, bank, device=device)
            packed_to_banks(pk, vb, bk, regs, k=sp.k, p=p,
                            canon=params.canon, bank_sorted=True)
    else:
        with metrics.accum("sketch.dispatch", items=flat.nbytes):
            tile, bk = _upload(flat, bank, device=device)
            tile_to_banks(tile, bk, regs, **_encode_kw(params, sp), p=p)
    return regs


# ---------------------------------------------------------------------------
# Device register rows (JAX pipeline.py:538-563): mkdist's multi-k sketch
# already holds every (path, k) register row on the device; parked here
# under its -W cache file name, they let each per-k compare stack a bank
# on the device instead of uploading one (ops/pairwise._device_regs_for).
# Rows are int8, clamped as pairwise._device_regs clamps, so the compare
# is bitwise the same either way.  Bounded by DASHING_TPU_DEVICE_BANK_MB
# (default 1024); past it a put is dropped and the compare uploads.
# ---------------------------------------------------------------------------

_dev_rows: dict = {}
_dev_rows_bytes = 0


def device_rows_put(fname: str, dev: torch.Tensor) -> None:
    global _dev_rows_bytes
    cap = int(float(os.environ.get("DASHING_TPU_DEVICE_BANK_MB", "1024"))
              * 1e6)
    nbytes = dev.numel() * dev.element_size()
    if _dev_rows_bytes + nbytes > cap:
        return
    _dev_rows[fname] = dev
    _dev_rows_bytes += nbytes


def device_rows_get(fname: str):
    return _dev_rows.get(fname)


def device_rows_clear() -> None:
    global _dev_rows_bytes
    _dev_rows.clear()
    _dev_rows_bytes = 0


def sketch_file_hll_multik(path: str, params_list: Sequence[SketchParams],
                           p: int, device: torch.device,
                           keep_device: bool = False):
    """Sketch one path at several k from one parse and one upload a chunk
    (mkdist): tiles are cut with the largest halo, each chunk is packed
    and uploaded once (and its ASCII form once, for parameters off the
    packed route), then K1 runs once per k on that upload into that k's
    registers.  The wider halo repeats a few windows at the row seams for
    the smaller k, which the register max absorbs, so this is exact for
    HLL only.  Returns uint8 registers in params_list order, bitwise those
    of sketch_file_hll per k; with keep_device, (those, the int8 device
    rows) for device_rows_put."""
    device = devmod.resolve(device)
    sps = [check_supported(pa) for pa in params_list]
    sp_big = max(sps, key=lambda sp: sp.halo)
    regs = [torch.zeros(1 << p, dtype=torch.int32, device=device)
            for _ in params_list]
    routes = [packed_ok(pa, sp, p) for pa, sp in zip(params_list, sps)]
    for tile in InputFile(0, path, sp_big).tiles():
        ups = {}            # the chunk's upload on each route
        for r, pa, sp, packed in zip(regs, params_list, sps, routes):
            with metrics.accum("sketch.dispatch", items=tile.nbytes):
                if packed not in ups:
                    ups[packed] = _upload(
                        *(_pack_tile_host(tile) if packed else (tile,)),
                        device=device)
                _launch(ups[packed], r, pa, sp, p, packed)
    host = [registers_to_numpy(r) for r in regs]
    if keep_device:
        # ranks are at most 65 - p, so the clamp changes no valid register
        return host, [r.clamp(max=127).to(torch.int8) for r in regs]
    return host


# ---------------------------------------------------------------------------
# Count-min threshold filtering (JAX pipeline.py:1168-1248).  Two passes
# over a file's tiles: count every window's hash into an (nh, 2^size)
# int32 count-min sketch, then admit the windows whose estimated count
# (the minimum over the rows, never below the true count) reaches the
# threshold.  The admitted set, and so the registers, are the JAX
# package's bit for bit: the counts are exact integers.
# ---------------------------------------------------------------------------

# Budget of (hashes, valid) kept on the device between the passes, at 9 B a
# tile byte (int64 hash and bool valid); tiles past it are hashed again in
# the second pass (hashing is pure, so the masks are the same).
_CM_HASH_CACHE_BYTES = 256 << 20


def _hashed_tile(tile: np.ndarray, kw: dict, device: torch.device):
    return tile_hashes(torch.from_numpy(tile).to(device), **kw)


def _use_hk() -> bool:
    return os.environ.get("DASHING_TPU_USE_HK", "") not in ("", "0")


def _summed_counts(counts: List[torch.Tensor], devs) -> List[torch.Tensor]:
    """The cards' count tables summed (exact integers) on the first card,
    and a copy of the sum on each other card."""
    for c in counts[1:]:
        counts[0] += c.to(counts[0].device)
    return [counts[0]] + [counts[0].to(d, copy=True) for d in devs[1:]]


def _count_filtered_tiles(tiles: Callable[[], Iterable[np.ndarray]],
                          params: SketchParams, sp: Spacer,
                          device: torch.device, devs=None):
    """The two-pass filter over the tiles `tiles()` yields (called once a
    pass).  Yields (hashes, admitted) a tile, both on `device`: admitted =
    valid & (estimated count >= params.min_count).  No host pull, unless
    DASHING_TPU_USE_HK=1 swaps the count-min for HeavyKeeper
    (_hk_filtered_tiles).  With `devs`, several cards of one host, tile i
    goes to devs[i % len(devs)] in both passes: each card counts its
    tiles, the counts are summed (exact integers) onto every card between
    the passes, and tile i's pair is yielded on its card.  Counted in
    `cm_tiles` (first pass) and `cm_rehashed_tiles` (second-pass tiles
    not in the cache)."""
    global cm_tiles, cm_rehashed_tiles
    if _use_hk():
        yield from _hk_filtered_tiles(tiles, params, sp, device)
        return
    nh, size, seed = params.cm_nhashes, params.cm_size_log2, params.cm_seed
    _check_cm_size(size)
    kw = _encode_kw(params, sp)
    devs = devs or (device,)
    counts = [torch.zeros((nh, 1 << size), dtype=torch.int32, device=d)
              for d in devs]
    cached = {}
    budget = _CM_HASH_CACHE_BYTES
    with metrics.accum("sketch.cm_count"):
        for i, tile in enumerate(tiles()):
            d = i % len(devs)
            h, valid = _hashed_tile(tile, kw, devs[d])
            _cm_add(counts[d], h, valid, nh, size, seed)
            cm_tiles += 1
            cost = tile.size * 9
            if budget >= cost:
                cached[i] = (h, valid)
                budget -= cost
        counts = _summed_counts(counts, devs)
    stream = enumerate(tiles())
    while True:
        with metrics.accum("sketch.cm_admit"):
            nxt = next(stream, None)
            if nxt is None:
                return
            i, tile = nxt
            d = i % len(devs)
            hit = cached.pop(i, None)
            if hit is None:
                cm_rehashed_tiles += 1
                hit = _hashed_tile(tile, kw, devs[d])
            h, valid = hit
            admitted = valid & (_cm_query(counts[d], h, nh, size, seed)
                                >= params.min_count)
        yield h, admitted


def _hk_filtered_tiles(tiles: Callable[[], Iterable[np.ndarray]],
                       params: SketchParams, sp: Spacer,
                       device: torch.device):
    """The two passes of _count_filtered_tiles through one host HeavyKeeper
    a file (sketch/heavykeeper.py; geometry from the same -q/-t/-R knobs:
    params.cm_nhashes rows of 2^cm_size_log2 slots, seed cm_seed), as
    the JAX package's `_hk_filtered_tiles`: pass 1 pulls each tile's
    valid hashes and adds them in row-major order (HeavyKeeper's state
    depends on that order); pass 2 queries them and yields (hashes,
    admitted) on `device`.  The pulled tiles are kept on the host between
    the passes within _CM_HASH_CACHE_BYTES; the rest are hashed again.
    Buckets `sketch.hk_add` and `sketch.hk_query` time the passes."""
    from .sketch.heavykeeper import HeavyKeeper
    hk = HeavyKeeper(params.cm_nhashes, params.cm_size_log2, params.cm_seed)
    kw = _encode_kw(params, sp)

    def pulled(tile):
        h, valid = _hashed_tile(tile, kw, device)
        return h, h.cpu().numpy().view(np.uint64), valid.cpu().numpy()

    cached = {}
    budget = _CM_HASH_CACHE_BYTES
    with metrics.accum("sketch.hk_add"):
        for i, tile in enumerate(tiles()):
            _, hv, vm = pulled(tile)
            hk.add_np(hv[vm])
            cost = tile.size * 9
            if budget >= cost:
                cached[i] = (hv, vm)
                budget -= cost
    stream = enumerate(tiles())
    while True:
        with metrics.accum("sketch.hk_query"):
            nxt = next(stream, None)
            if nxt is None:
                return
            i, tile = nxt
            if i in cached:
                hv, vm = cached.pop(i)
                h = torch.from_numpy(hv.view(np.int64)).to(device)
            else:
                h, hv, vm = pulled(tile)
            admitted = vm.copy()
            admitted[vm] = hk.query_np(hv[vm]) >= params.min_count
        yield h, torch.from_numpy(admitted).to(device)


# Bytes of pass-1 tiles a CPU tensor's "card" keeps for pass 2 on the
# kernels' route (that route runs on CPU tensors only in tests); a CUDA
# card keeps up to half of its free memory (_cm_keep_budgets).
_CM_KEEP_BYTES = 256 << 20


def _cm_keep_budgets(devs: Sequence[torch.device]) -> List[int]:
    """Bytes of uploaded pass-1 tiles each card may keep for pass 2: half
    of its free memory on a CUDA card (wj_device_fits' reckoning), else
    _CM_KEEP_BYTES."""
    return [torch.cuda.mem_get_info(d)[0] // 2 if d.type == "cuda"
            else _CM_KEEP_BYTES for d in map(torch.device, devs)]


def _count_filtered_kernels(tiles: Callable[[], Iterable[np.ndarray]],
                            params: SketchParams, sp: Spacer, p: int,
                            devs: Sequence[torch.device]) -> torch.Tensor:
    """The two passes of the count-min filter on the hand-written kernels
    (ops/countmin.py), for the tiles `tiles()` yields on CUDA cards:
    pass 1 uploads each tile (`_upload`), counts it with one
    `cm_add_kernel` launch and keeps the upload on its card while the
    card's budget (_cm_keep_budgets, taken once a file after the count
    tables) allows; pass 2 admits each tile's windows straight into its
    card's registers with one `cm_admit_kernel` launch, and frees a kept
    tile once it is admitted.  Where every tile was kept, pass 2 reads
    nothing from the host; else it calls `tiles()` again and uploads only
    the tiles not kept, each counted in `cm_rehashed_tiles`.  The mesh
    round-robin and the counts summed between the passes are
    _count_filtered_tiles'."""
    global cm_tiles
    nh, size = params.cm_nhashes, params.cm_size_log2
    _check_cm_size(size)
    cm = dict(k=sp.k, canon=params.canon, nh=nh, size_log2=size,
              seed=params.cm_seed)
    counts = [torch.zeros((nh, 1 << size), dtype=torch.int32, device=d)
              for d in devs]
    budgets = _cm_keep_budgets(devs)
    kept: List[Optional[torch.Tensor]] = []     # tile i's upload, or None
    with metrics.accum("sketch.cm_count"):
        for i, tile in enumerate(tiles()):
            d = i % len(devs)
            up, = _upload(tile, device=devs[d])
            countmin.ascii_cm_add(up, counts[d], **cm)
            cm_tiles += 1
            if budgets[d] >= tile.nbytes:
                budgets[d] -= tile.nbytes
                kept.append(up)
            else:
                kept.append(None)
        counts = _summed_counts(counts, devs)

    def units():
        """Pass 2's tiles in order: each kept upload, taken out of `kept`
        so that it is freed once admitted, or the host tile again."""
        again = (iter(()) if all(u is not None for u in kept)
                 else iter(tiles()))
        for i in range(len(kept)):
            up, kept[i] = kept[i], None
            tile = next(again, None)
            yield tile if up is None else up

    def admit(unit, card, regs):
        global cm_rehashed_tiles
        up, card_counts = unit
        if isinstance(up, np.ndarray):
            up, = _upload(up, device=card)
            cm_rehashed_tiles += 1
        countmin.ascii_cm_admit(up, card_counts, regs,
                                min_count=params.min_count, p=p, **cm)

    with metrics.accum("sketch.cm_admit"):
        return _fold_over_cards(zip(units(), itertools.cycle(counts)), devs,
                                p, admit)


def sketch_hll_async(tiles: Callable[[], Iterable[np.ndarray]],
                     params: SketchParams, p: int,
                     device: torch.device) -> torch.Tensor:
    """(2^p,) int32 registers on `device`, not synchronised, of the tiles
    that `tiles()` yields: one pass, or the two of the count-min filter
    when `params.filtered` (its tiles take the ASCII route); on a mesh,
    round-robin over its cards.  On CUDA cards a filter of exact
    contiguous k-mers (`countmin.takes`) runs on the count-min kernels;
    every other filter yields (hashes, admitted) pairs to the register
    fold (_count_filtered_tiles)."""
    sp = check_supported(params)
    if not params.filtered:
        return sketch_chunk_stream(tiles(), params, p, device,
                                   packed_ok(params, sp, p))
    if _use_hk():
        devs = (device,)        # HeavyKeeper's passes run on the host
    else:
        devs = mesh.cards(device)
        if (torch.device(device).type == "cuda"
                and countmin.takes(p, **_encode_kw(params, sp))):
            return _count_filtered_kernels(tiles, params, sp, p, devs)
    return _fold_over_cards(
        _count_filtered_tiles(tiles, params, sp, device, devs), devs, p,
        lambda pair, card, regs: update_registers(regs, *pair, p))


def registers_to_numpy(regs: torch.Tensor) -> np.ndarray:
    """Device int32 registers -> host uint8 (clamped to 0..255, as the JAX
    package clamps on the pull)."""
    return regs.clamp(0, 255).to(torch.uint8).cpu().numpy()


def sketch_file_hll(path: str, params: SketchParams, p: int,
                    device: torch.device) -> np.ndarray:
    """Sketch one logical path into 2^p uint8 HLL registers."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    return registers_to_numpy(sketch_hll_async(
        InputFile(0, path, sp).tiles, params, p, device))


def sketch_joined_hll(joined: np.ndarray, params: SketchParams, p: int,
                      device: torch.device) -> np.ndarray:
    """Sketch an already joined uint8 sequence (records separated by at
    least k-1 invalid bytes) into 2^p uint8 registers."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    return registers_to_numpy(sketch_hll_async(
        lambda: _joined_tiles(joined, sp.halo), params, p, device))


# ---------------------------------------------------------------------------
# The HLL engine's entry (JAX cli/core.py `sketch_jobs`, `device_hll_run`).
# ---------------------------------------------------------------------------

def file_route(f: InputFile, filtered: bool, packed: bool, batch: int
               ) -> str:
    """A file's route, from its parameters and its row count alone:
    "filtered" (count-min: two passes over its tiles), "empty" (zero
    registers), "batch" (one chunk: the small-file batch), "joined" (more
    than one chunk on the packed route: packed from its bytes), "stream"
    (any other: the chunk loop over its tiles)."""
    if filtered:
        return "filtered"
    if f.joined is None:
        return "stream"
    rows = joined_rows(f.joined.size)
    if rows == 0:
        return "empty"
    if rows <= MAX_ROWS:
        return "batch" if batch else "stream"
    return "joined" if packed else "stream"


def sketch_hll_files(indexed_paths: Sequence[Tuple[int, str]],
                     params: SketchParams, p: int, device: torch.device, *,
                     filtered=(), land: Callable[[int, np.ndarray], None]
                     ) -> None:
    """The HLL sketch engine: (index, path) pairs -> land(index, (2^p,)
    uint8 registers) as each file lands.  The files whose index is in
    `filtered` are count-min filtered at params' threshold (none at 1 or
    less).  Up to small_batch_size(p) consecutive single-chunk files of
    one tile width fold in one launch (on the packed route each file's
    rows packed from its joined bytes), the batches round-robin over the
    mesh's cards; an empty file lands zero registers without closing the
    batch (the JAX package also closes one on a change of row count).
    Jobs stay queued on the device until more than window_cap files,
    about 256 MiB of registers, are in flight (the JAX package's bounded
    window); then the oldest is pulled.  Strictly more: at a full batch of
    window_cap files `>=` would pull the job just queued and serialise the
    host parse with the device."""
    sp = check_supported(params)
    packed = packed_ok(params, sp, p)
    plain = dataclasses.replace(params, use_counting_filter=False)
    fparams = dataclasses.replace(params, use_counting_filter=True)
    if not fparams.filtered:
        filtered = ()
    batch = small_batch_size(p)
    cards = itertools.cycle(mesh.cards(device))
    window_cap = max(4, min(64, (256 << 20) // (4 << p)))
    queued: deque = deque()
    inflight = 0
    ids, chunks = [], []        # the open batch: indices, tiles

    def drain():
        nonlocal inflight
        job_ids, dev = queued.popleft()
        inflight -= len(job_ids)
        if dev is None:
            regs = np.zeros(1 << p, np.uint8)
        else:
            with metrics.accum("sketch.pull"):
                regs = registers_to_numpy(dev)
        for i, r in zip(job_ids, regs.reshape(len(job_ids), -1)):
            land(i, r)

    def push(job_ids, dev):
        nonlocal inflight
        queued.append((job_ids, dev))
        inflight += len(job_ids)
        while inflight > window_cap and queued:
            drain()

    def flush():
        if ids:
            job = tuple(ids), sketch_small_batch_async(
                chunks, plain, p, next(cards), packed)
            ids.clear()
            chunks.clear()
            push(*job)

    for f in prefetch(indexed_paths, sp):
        route = file_route(f, f.index in filtered, packed, batch)
        if route == "empty":
            push((f.index,), None)
        elif route == "batch":
            if packed:
                # packed from its joined bytes, as a multi-chunk file is
                tile = _pack_joined_host(f.joined, sp.halo, 0,
                                         joined_rows(f.joined.size))
            else:
                tile, = f.tiles()
            if chunks and _tile_shape(chunks[0])[1] != _tile_shape(tile)[1]:
                flush()
            ids.append(f.index)
            chunks.append(tile)
            if len(ids) >= batch:
                flush()
        else:
            flush()
            if route == "filtered":
                dev = sketch_hll_async(f.tiles, fparams, p, device)
            elif route == "joined":
                dev = sketch_joined_async(f.joined, plain, p, device)
            else:
                dev = sketch_chunk_stream(f.tiles(), plain, p, device,
                                          packed)
            push((f.index,), dev)
    flush()
    while queued:
        drain()


def file_kmer_hashes(path: str, params: SketchParams,
                     device: torch.device, tiles=None) -> np.ndarray:
    """Every valid window's hash of a path (the raw k-mer when not
    `params.rehash`), host uint64, count-min filtered when
    `params.filtered` (JAX `file_kmer_hashes`).  `tiles()`, if given,
    yields the path's tiles (a prefetched parse)."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    tiles = tiles or InputFile(0, path, sp).tiles
    if params.filtered:
        pairs = _count_filtered_tiles(tiles, params, sp, device)
    else:
        kw = _encode_kw(params, sp)
        pairs = (_hashed_tile(t, kw, device) for t in tiles())
    outs = [h[keep].cpu().numpy().view(np.uint64) for h, keep in pairs]
    return np.concatenate(outs) if outs else np.zeros(0, np.uint64)


def file_raw_kmers(path: str, params: SketchParams,
                   device: torch.device, tiles=None) -> np.ndarray:
    """The encoded k-mers themselves, unhashed (JAX `file_raw_kmers`)."""
    return file_kmer_hashes(path, dataclasses.replace(params, rehash=False),
                            device, tiles)


# ---------------------------------------------------------------------------
# The set sketches' device routes (JAX pipeline.py:1059-1137): the WangHashed
# windows of each tile fold into a bank that stays on the device until the
# file ends; only the finished bank is pulled.  Bitwise the host route
# (file_raw_kmers and the sketch's addh_np).
# ---------------------------------------------------------------------------

def _hashed_tiles(path: str, params: SketchParams, device: torch.device,
                  tiles):
    sp = check_supported(params)
    tiles = tiles or InputFile(0, path, sp).tiles
    kw = _encode_kw(dataclasses.replace(params, rehash=True), sp)
    for tile in tiles():
        with metrics.accum("sketch.dispatch", items=tile.nbytes):
            yield _hashed_tile(tile, kw, device)


def sketch_file_bbmh_mins(path: str, params: SketchParams, p: int,
                          device: torch.device, tiles=None
                          ) -> Optional[np.ndarray]:
    """The b-bit MinHash's (2^p,) uint64 bucket minima of a path (EMPTY
    where no k-mer landed), by one scatter-min a tile on the device
    (ops/minhash_update.bbmh_update; any p, where the JAX route stops at
    25).  None for a count-min filtered file: its caller takes the host
    route.  `tiles()`, if given, yields the path's tiles."""
    device = devmod.resolve(device)
    if params.filtered:
        return None
    bank = minhash_update.empty_bank(p, device)
    for h, valid in _hashed_tiles(path, params, device, tiles):
        minhash_update.bbmh_update(bank, h, valid, p)
    return minhash_update.to_numpy(bank)


def sketch_file_bottomk_values(path: str, params: SketchParams, kk: int,
                               device: torch.device, tiles=None
                               ) -> Optional[np.ndarray]:
    """The kk smallest distinct WangHash values of a path, sorted uint64,
    merged tile by tile on the device (ops/minhash_update.bottomk_update:
    each tile's valid hashes deduplicated before they count, so repeated
    k-mers need no coverage check or fallback).  None for a count-min
    filtered file."""
    device = devmod.resolve(device)
    if params.filtered:
        return None
    run = minhash_update.empty_values(device)
    for h, valid in _hashed_tiles(path, params, device, tiles):
        run = minhash_update.bottomk_update(run, h, valid, kk)
    return minhash_update.to_numpy(run)


# ---------------------------------------------------------------------------
# Weighted Jaccard with exact counts on the device (JAX pipeline.py:
# 999-1056): the raw k-mers of a file stay on the device, one sort gives
# each value's occurrence indices and the labelled elements fold into the
# registers.  The JAX package keeps this behind an opt-in and a 16 M k-mer
# cap for its TPU compiler; here a bound on the card's free memory picks
# the route before the first launch.
# ---------------------------------------------------------------------------

# device bytes a window may take at the route's peak, reckoned as if every
# window held a valid k-mer: the valid k-mers' concatenation, their sort
# (values, indices and the sort's own buffers), the run arithmetic in
# place and the labels.  On an H100 the route peaked at 66.00 bytes a
# valid k-mer (35.40 a window) over 250,000 reads of 100 bases at k = 31;
# chip_smoke.py e2e (m) measures it on every run
WJ_BYTES_PER_WINDOW = 80


def wj_device_fits(windows: int, device: torch.device) -> bool:
    """Whether `windows` k-mers fit the device route: their peak bytes
    within half of the card's free memory (always on the CPU)."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return windows * WJ_BYTES_PER_WINDOW <= free // 2


def _wj_label_update(h: torch.Tensor, valid: Optional[torch.Tensor],
                     p: int) -> torch.Tensor:
    """Raw int64 k-mers + validity (None: all valid) -> (2^p,) int32
    registers of their labelled elements (exact occurrence counts)."""
    from .sketch.weighted import occurrence_labels_device
    labels, sv = occurrence_labels_device(h, valid)
    regs = torch.zeros(1 << p, dtype=torch.int32, device=h.device)
    return update_registers(regs, labels, sv, p)


def sketch_file_wj_hll(path: str, params: SketchParams, p: int,
                       device: torch.device, tiles=None):
    """--wj-exact HLL registers of a path on the device, 2^p uint8, bitwise
    those of the host route (file_raw_kmers, weighted.weighted_elements,
    HLL.add_np); None where the host route must run instead: a count-min
    filtered file, or more k-mers than wj_device_fits allows (the tiles
    are parsed and counted on the host before any launch).  The metrics
    bucket `wj.device` times this route (`wj.host` the other)."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    if params.filtered:
        return None
    chunks = list((tiles or InputFile(0, path, sp).tiles)())
    windows = sum(t.size for t in chunks)
    if not wj_device_fits(windows, device):
        return None
    with metrics.accum("wj.device", items=windows):
        kw = _encode_kw(dataclasses.replace(params, rehash=False), sp)
        # only the valid k-mers stay on the device between tiles
        vals = [h[valid] for h, valid in
                (_hashed_tile(tile, kw, device) for tile in chunks)]
        if not vals:
            return np.zeros(1 << p, np.uint8)
        h = torch.cat(vals)
        vals.clear()
        regs = _wj_label_update(h, None, p)
        return registers_to_numpy(regs)


# ---------------------------------------------------------------------------
# Per-record sketching (JAX pipeline.py:1283-1480): one sketch a sequence
# record, a batch of records a launch, each record's row into its own
# register bank.
# ---------------------------------------------------------------------------

MAX_RECORD_WIDTH = 65536
# the register bank of one record batch at most (a batch of 2048 records
# would pin 8 GiB at p = 20)
_RECORD_BANK_BYTES = 256 << 20


def _record_batches(seqs: Sequence[bytes], halo: int, batch: int):
    """Group records into batches by length.  Yields (take, tiles): `take`
    indexes seqs; `tiles` is a (len(take), width) N-padded uint8 array,
    width = the longest record + halo (at least 128), or None for the
    records whose width would pass MAX_RECORD_WIDTH (callers sketch each
    alone).  Sorting by length keeps the padding small.  (The JAX package
    pads rows and width to powers of two for its jit variants, and sends
    a whole batch alone when one record is too wide; the registers are the
    same either way.)"""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    order = np.argsort(lens, kind="stable")
    fit = int(np.searchsorted(lens[order] + halo, MAX_RECORD_WIDTH,
                              side="right"))
    for pos in range(0, fit, batch):
        take = order[pos:pos + batch]
        width = max(int(lens[take[-1]]) + halo, halo + 1, 128)
        tiles = np.full((len(take), width), ord("N"), np.uint8)
        for row, i in enumerate(take):
            tiles[row, :lens[i]] = np.frombuffer(seqs[i], np.uint8)
        yield take, tiles
    if fit < len(seqs):
        yield order[fit:], None


def sketch_records_hll(seqs: Sequence[bytes], params: SketchParams, p: int,
                       device: torch.device, batch: int = 2048) -> np.ndarray:
    """Per-record HLL registers -> (n, 2^p) uint8.  A batch of records is
    one ASCII upload and one banked K2 launch (the exact contiguous
    k-mers), or the PyTorch encoders and a banked scatter-max; a record
    wider than MAX_RECORD_WIDTH takes sketch_file_seq."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    kw = _encode_kw(params, sp)
    fused = packed_ok(params, sp, p)
    batch = max(1, min(batch, _RECORD_BANK_BYTES // (4 << p)))
    out = np.zeros((len(seqs), 1 << p), np.uint8)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            for i in take:
                out[i] = sketch_file_seq(seqs[i], params, p, device)
            continue
        regs = torch.zeros((len(take), 1 << p), dtype=torch.int32,
                           device=device)
        with metrics.accum("sketch.dispatch", items=tiles.nbytes):
            tile, = _upload(tiles, device=device)
            bank = torch.arange(len(take), dtype=torch.int32, device=device)
            if fused:
                ascii_to_banks(tile, bank, regs, k=sp.k, p=p,
                               canon=params.canon)
            else:
                tile_to_banks(tile, bank, regs, **kw, p=p)
        out[take] = registers_to_numpy(regs)
    return out


def records_kmer_hashes(seqs: Sequence[bytes], params: SketchParams,
                        device: torch.device, batch: int = 512
                        ) -> List[np.ndarray]:
    """Each record's window values (hashed, or the raw k-mers when not
    `params.rehash`) as host uint64, a batch of records a device pass
    (the per-record count filter of sketch_by_seq)."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    kw = _encode_kw(params, sp)
    out: List = [None] * len(seqs)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            for i in take:
                out[i] = seq_kmer_hashes(seqs[i], params, device)
            continue
        h, valid = _hashed_tile(tiles, kw, device)
        hv = h.cpu().numpy().view(np.uint64)
        vv = valid.cpu().numpy()
        for slot, i in enumerate(take):
            out[i] = hv[slot][vv[slot]]
    return out


def seq_kmer_hashes(seq: bytes, params: SketchParams,
                    device: torch.device) -> np.ndarray:
    """Every window value of ONE long sequence, host uint64 (its tiles
    unpadded, as the JAX package cuts them: a minimizer window over pad
    columns would add values)."""
    device = devmod.resolve(device)
    sp = check_supported(params)
    kw = _encode_kw(params, sp)
    tiles = _row_chunks(tile_sequence(np.frombuffer(seq, np.uint8), CONTENT,
                                      sp.halo))
    outs = [h[v].cpu().numpy().view(np.uint64) for h, v in
            (_hashed_tile(t, kw, device) for t in tiles)]
    return np.concatenate(outs) if outs else np.zeros(0, np.uint64)


def sketch_file_seq(seq: bytes, params: SketchParams, p: int,
                    device: torch.device) -> np.ndarray:
    """One long sequence -> 2^p uint8 registers, tile by tile, unfiltered."""
    return sketch_joined_hll(
        np.frombuffer(seq, np.uint8),
        dataclasses.replace(params, use_counting_filter=False), p, device)


# ---------------------------------------------------------------------------
# The sparse read-vs-reference engine (JAX pipeline.py:1366-1434): readfilt
# ---------------------------------------------------------------------------

# records a readfilt batch: on an H100, 100,000 read pairs of 2 x 150 bases
# took 0.146-0.315 s in batches of 8,192, 0.163-0.293 s of 4,096 and
# 0.345-0.644 s of 1,024 (chip_smoke.py e2e (l), four runs); 4,096 and
# 8,192 tie within the spread of the runs, and 8,192 is taken for half
# the launches (the JAX package takes 1,024, and 4,096 a CLI chunk)
READFILT_BATCH = 8192


def _sync(device: torch.device) -> None:
    """Wait for the device when the metrics buckets time it."""
    if metrics.enabled() and device.type == "cuda":
        torch.cuda.synchronize(device)


def records_joint_triples(seqs: Sequence[bytes], params: SketchParams,
                          ref_regs: torch.Tensor, ref_hist: torch.Tensor,
                          p: int, device: torch.device,
                          batch: int = READFILT_BATCH,
                          ref_card: Optional[Callable[[int], torch.Tensor]]
                          = None) -> np.ndarray:
    """Each record's joint-MLE triple (onlyRecord, onlyRef, shared) against
    ONE dense reference -> (n, 3) float64.

    ref_regs: (2^p,) int32 reference registers, ref_hist: (q+2,) float32
    their histogram, both on `device`.  A batch of records is one ASCII
    upload; its (bucket, rank) keys come from K2's keys form for the exact
    contiguous k-mers at p <= 25 (bitwise the JAX package's keys, which it
    takes from K1), else from the PyTorch encoders; then the sparse
    statistics against the reference, windowed to the batch's largest
    level (sketch/sparse.py).  The reference's cardinality on a batch's
    window comes from `ref_card` (sparse.reference_cardinalities of
    ref_hist and p, made here when not given), which estimates it once a
    window: a caller passing one for every call with this reference
    (readfilt, batch after batch) estimates it once a window for the run.
    A record wider than MAX_RECORD_WIDTH is sketched alone and compared
    by `ertl_joint`."""
    from .sketch.hll import HLL, ertl_joint
    from .sketch.sparse import level_window_bins, \
        reference_cardinalities, stats_kfirst, triples_kfirst
    device = devmod.resolve(device)
    if ref_card is None:
        ref_card = reference_cardinalities(ref_hist, p)
    sp = check_supported(params)
    kw = _encode_kw(params, sp)
    keys_route = packed_ok(params, sp, p) and p <= 25
    ref_max = int(ref_regs.max()) if ref_regs.numel() else 0
    q = 64 - p
    out = np.zeros((len(seqs), 3), np.float64)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            ref = HLL(p, regs=registers_to_numpy(ref_regs))
            for i in take:
                rec = HLL(p, regs=sketch_file_seq(seqs[i], params, p, device))
                out[i] = ertl_joint(rec, ref, device)
            continue
        with metrics.accum("readfilt.keys", items=len(take)):
            tile, = _upload(tiles, device=device)
            if keys_route:
                keys = encode_hash_keys(tile, k=sp.k, p=p,
                                        canon=params.canon)
                idx, rank = keys >> 6, keys & 63
            else:
                h, valid = tile_hashes(tile, **kw)
                idx, rank = bucket_rank(h, p)
                rank = torch.where(valid, rank, 0)
            kb = level_window_bins(max(int(rank.max()), ref_max), q)
        hist = ref_hist[:kb]
        with metrics.accum("readfilt.stats", items=len(take)):
            st = stats_kfirst(idx, rank, ref_regs, hist, p, kb)
            _sync(device)
        with metrics.accum("readfilt.estimate_jmle", items=len(take)):
            out[take] = triples_kfirst(st, hist, p,
                                       ref_card(kb)).cpu().numpy()
    return out
