"""Shared CLI machinery (port of dashing_tpu/cli/core.py): HLL and wide
HLL sketches (the HLL engine and kernels), the set sketches of
sketch/setsketches.py (Bloom filter, bottom-k, b-bit MinHash and their
counting forms), HyperMinHash and SuperMinHash (sketch/extra.py) and the
exact k-mer hash sets (sketch/khset.py), each plain or weighted by
multiplicity (--wj, --wj-exact).

Flag names, defaults and output formats are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import gzip
import itertools
import math
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import metrics, pipeline
from ..io import cache, paths
from ..ops import pairwise as pw
from ..parallel import distributed
from ..sketch import batch_compare, estimators as est
from ..sketch.extra import DensifiedMinHash, WideHLL
from ..sketch.hll import HLL, RegisterSketch, batch_reports
from ..sketch.setsketches import build_typed, read_typed, sketch_of_values

# sketch type -> file extension (the JAX CLI's registry)
SKETCH_EXTS = {"hll": ".hll", "khset": ".khs", "bf": ".bf", "rmh": ".rmh",
               "bbmh": ".bmh", "crmh": ".crmh", "superminhash": ".bbs",
               "hmh": ".hmh", "wide_hll": ".whll", "cbbmh": ".cbmh"}

# rows a block of the set-sketch compare engines; the multi-process
# stripes of these types take their block ownership from it, so every
# process of a run must see the same DASHING_TPU_HOST_COMPARE_TILE
HOST_COMPARE_TILE = int(os.environ.get("DASHING_TPU_HOST_COMPARE_TILE",
                                       "512"))


def eprint(*a, **kw):
    print(*a, file=sys.stderr, **kw)


@dataclasses.dataclass
class CommonOpts:
    k: int = 31
    wsz: int = 0
    spacing: str = ""
    sketch_size: int = 10          # -S, log2 bytes (HLL: p == S)
    canon: bool = True
    encoding: str = "bonsai"       # bonsai | nthash | cyclic
    estim: int = est.ERTL_MLE
    jestim: int = est.ERTL_MLE
    sketch_type: str = "hll"       # a key of SKETCH_EXTS
    sketch_type_explicit: bool = False   # set by a --use-* type flag
    bbnbits: int = 16              # -B/--bbits: b of the b-bit MinHash
    nthreads: int = 1
    paths_file: str = ""
    prefix: str = ""
    suffix: str = ""
    presketched: bool = False
    avoid_sorting: bool = False
    entropy_min: bool = False
    # count-min filtering (dist -y -c -q -t -R; sketch -b/-f -n -q -H)
    mincount: int = 5
    nhashes: int = 1
    cmsketchsize: int = -1
    seed: int = 1337
    use_counting_filter: bool = False
    sketch_by_fname: bool = False
    number_neighbors: int = 0      # --nearest-neighbors (0: the matrix)
    cache_sketch: bool = False     # -W: load/write sketches beside the inputs
    # weighted Jaccard (--wj: count-min counts, --wj-exact: exact counts)
    weighted_jaccard: bool = False
    exact_weighted: bool = False
    wj_cmsize: int = 22            # --wj-cm-sketch-size, log2 counters a row
    wj_nhashes: int = 10           # --wj-cm-nhashes

    @property
    def weighted(self) -> bool:
        return self.weighted_jaccard or self.exact_weighted


def hll_p_from_S(S: int) -> int:
    return S


def parse_common(opts: CommonOpts, flag: str, val: str) -> bool:
    """Apply one option shared by sketch and dist.  Returns True if
    consumed."""
    m = {
        "-k": ("k", int), "--kmer-length": ("k", int),
        "-w": ("wsz", int), "--window-size": ("wsz", int),
        "-s": ("spacing", str), "--spacing": ("spacing", str),
        "-S": ("sketch_size", int), "--sketch-size": ("sketch_size", int),
        "-p": ("nthreads", int), "--nthreads": ("nthreads", int),
        "-F": ("paths_file", str), "--paths": ("paths_file", str),
        "-P": ("prefix", str), "--prefix": ("prefix", str),
        "-x": ("suffix", str), "--suffix": ("suffix", str),
        "-c": ("mincount", int), "--min-count": ("mincount", int),
        "-q": ("nhashes", int), "--nhashes": ("nhashes", int),
        "-t": ("cmsketchsize", int), "--cm-sketch-size": ("cmsketchsize", int),
        "-R": ("seed", int), "--seed": ("seed", int),
        "-B": ("bbnbits", int), "--bbits": ("bbnbits", int),
    }
    if flag in m:
        name, conv = m[flag]
        setattr(opts, name, conv(val))
        return True
    flags = {
        "-C": ("canon", False), "--no-canon": ("canon", False),
        "-H": ("presketched", True), "--presketched": ("presketched", True),
        "-n": ("avoid_sorting", True), "--avoid-sorting": ("avoid_sorting", True),
        "-E": ("estim", est.ORIGINAL), "--original": ("estim", est.ORIGINAL),
        "-I": ("estim", est.ERTL_IMPROVED), "--improved": ("estim", est.ERTL_IMPROVED),
        "-m": ("estim", est.ERTL_MLE), "--ertl-mle": ("estim", est.ERTL_MLE),
        "-g": ("entropy_min", True), "--by-entropy": ("entropy_min", True),
        "-y": ("use_counting_filter", True),
        "--countmin": ("use_counting_filter", True),
        "-N": ("sketch_by_fname", True),
        "--sketch-by-fname": ("sketch_by_fname", True),
        "-W": ("cache_sketch", True),
        "--cache-sketches": ("cache_sketch", True),
        "--use-nthash": ("encoding", "nthash"),
        "--use-cyclic-hash": ("encoding", "cyclic"),
        "--wj": ("weighted_jaccard", True),
        "--wj-exact": ("exact_weighted", True),
        "--use-bb-minhash": ("sketch_type", "bbmh"),
        "-8": ("sketch_type", "bbmh"),
        "--use-range-minhash": ("sketch_type", "rmh"),
        "--use-counting-range-minhash": ("sketch_type", "crmh"),
        "--use-counting-bb-minhash": ("sketch_type", "cbbmh"),
        "--use-bloom-filter": ("sketch_type", "bf"),
        "--use-full-khash-sets": ("sketch_type", "khset"),
        "--use-full-hash-sets": ("sketch_type", "khset"),
        "--use-hash-sets": ("sketch_type", "khset"),
        "--hash-sets": ("sketch_type", "khset"),
        "--use-full-sets": ("sketch_type", "khset"),
        "--use-wide-hll": ("sketch_type", "wide_hll"),
        "--use-superminhash": ("sketch_type", "superminhash"),
        "--use-hyperminhash": ("sketch_type", "hmh"),
    }
    if flag in flags:
        name, v = flags[flag]
        setattr(opts, name, v)
        if name == "estim":
            opts.jestim = v
        elif name == "sketch_type":
            opts.sketch_type_explicit = True
        return True
    if flag in ("-J", "--ertl-joint-mle"):
        opts.jestim = est.ERTL_JOINT_MLE
        return True
    if flag == "--nearest-neighbors":
        opts.number_neighbors = int(val)
        return True
    if flag in ("--wj-cm-sketch-size", "--wj-cm-nhashes"):
        # either implies weighted mode, as in the JAX CLI
        if flag == "--wj-cm-sketch-size":
            opts.wj_cmsize = int(val)
        else:
            opts.wj_nhashes = int(val)
        opts.weighted_jaccard = True
        return True
    return False


def validate_k(opts: CommonOpts):
    """The JAX CLI's checks of k against the encoding, word for word."""
    if opts.k > 32 and opts.encoding == "bonsai":
        raise SystemExit("k must be <= 32 for non-rolling hashes.")
    if opts.k > 32 and opts.spacing:
        raise SystemExit("kmers must be unspaced for k > 32")
    if opts.encoding != "bonsai":
        # the rolling hashes consume contiguous windows; -w applies to
        # their hash stream, spaced seeds and entropy scoring do not
        if opts.spacing:
            raise SystemExit("spaced seeds require the exact (bonsai) "
                             "encoder; rolling hashes are contiguous")
        if opts.entropy_min:
            raise SystemExit("--by-entropy requires the exact (bonsai) "
                             "encoder; rolling windows minimize by hash")


def sketch_params(opts: CommonOpts) -> pipeline.SketchParams:
    return pipeline.SketchParams(
        k=opts.k, w=opts.wsz, spacing=opts.spacing, canon=opts.canon,
        encoding=opts.encoding, entropy=opts.entropy_min,
        min_count=opts.mincount,
        use_counting_filter=opts.use_counting_filter,
        cm_size_log2=(opts.cmsketchsize if opts.cmsketchsize > 0 else 20),
        cm_nhashes=(opts.nhashes if opts.nhashes > 1 else 4),
        cm_seed=opts.seed)


def gather_inpaths(opts: CommonOpts, positional: List[str]) -> List[str]:
    return (paths.get_paths(opts.paths_file) if opts.paths_file
            else list(positional))


# file magic -> sketch family of every DTPU container (the JAX CLI's table)
MAGIC_TYPES = {b"DTPUHLL1": "hll", b"DTPUBF01": "bf", b"DTPURMH1": "rmh",
               b"DTPUCRM1": "crmh", b"DTPUBBM1": "bbmh",
               b"DTPUCBB1": "cbbmh",
               b"DTPUWHL1": "wide_hll", b"DTPUHMH1": "hmh",
               b"DTPUSMH1": "superminhash", b"DTPUSMH2": "superminhash"}


def _sniff_sketch_type(path: str) -> Optional[str]:
    try:
        with gzip.open(path, "rb") as fp:
            t = MAGIC_TYPES.get(fp.read(8))
    except OSError:
        return None
    if t is None and path.endswith(".khs"):
        return "khset"    # reference-compatible khset files carry no magic
    return t


def read_sketch_auto(path, sketch_type: str = "hll", explicit: bool = False):
    """Load a sketch from a path or a stream (the JAX CLI's
    `read_sketch_auto`): a path's type is sniffed from its magic; one that
    contradicts an explicitly requested type (a --use-* flag) stops the
    run, one that contradicts the default type is loaded as what it is,
    with a note.  A stream is read as `sketch_type`."""
    sniffed = _sniff_sketch_type(path) if isinstance(path, str) else None
    if sniffed and sniffed != sketch_type:
        if explicit:
            raise SystemExit(
                f"{path} is a {sniffed} sketch but {sketch_type} was "
                f"explicitly requested; drop the type flag to auto-detect "
                f"or re-sketch the input")
        eprint(f"Note: {path} is a .{SKETCH_EXTS[sniffed].lstrip('.')} "
               f"sketch; loading as {sniffed} (requested {sketch_type})")
        sketch_type = sniffed
    if sketch_type == "hll":
        return HLL.read(path)
    return read_typed(path, sketch_type)


def _cache_fname(path: str, opts: CommonOpts, wj_ext: bool = True) -> str:
    """The -W cache file name of a path (cache.make_fname, the `.w.`
    quirk included), its extension the sketch type's; a weighted sketch's
    is `.wj.exact.hll` or `.wj.hll` unless `wj_ext` is off (`sketch`
    names its outputs without it, as the JAX CLI does)."""
    sp = sketch_params(opts).spacer()
    ext = SKETCH_EXTS[opts.sketch_type]
    if wj_ext and opts.exact_weighted:
        ext = ".wj.exact" + ext
    elif wj_ext and opts.weighted_jaccard:
        ext = ".wj" + ext
    return cache.make_fname(path, hll_p_from_S(opts.sketch_size), sp.w,
                            opts.k, sp.c, opts.spacing, opts.suffix,
                            opts.prefix, opts.encoding, ext)


def atomic_write_sketch(sk, fname: str) -> None:
    """Write then rename: concurrent writers of one cache file each make a
    whole file and the last rename wins."""
    tmp = f"{fname}.tmp.{os.getpid()}"
    sk.write(tmp)
    os.replace(tmp, fname)


def weighted_elements(raw: np.ndarray, opts: CommonOpts) -> np.ndarray:
    """The occurrence-labelled elements of raw k-mers under --wj-exact
    (exact counts) or --wj (count-min estimates)."""
    from ..sketch.weighted import weighted_elements as elements
    return elements(raw, exact=opts.exact_weighted,
                    cmsize_log2=opts.wj_cmsize, nhashes=opts.wj_nhashes,
                    seed=opts.seed)


def weighted_registers(path: str, tiles, opts: CommonOpts,
                       params: pipeline.SketchParams, device: torch.device
                       ) -> np.ndarray:
    """The weighted-Jaccard HLL registers of one path (JAX
    `_build_weighted`): --wj-exact on the device where the card's memory
    allows (pipeline.sketch_file_wj_hll), else, and for --wj's count-min
    estimates always, the host route: the raw k-mers pulled, labelled by
    weighted.weighted_elements and inserted on the host."""
    p = hll_p_from_S(opts.sketch_size)
    if opts.exact_weighted:
        regs = pipeline.sketch_file_wj_hll(path, params, p, device, tiles)
        if regs is not None:
            return regs
    with metrics.accum("wj.host"):
        raw = pipeline.file_raw_kmers(path, params, device, tiles)
        h = HLL(p)
        h.add_np(weighted_elements(raw, opts))
    return h.regs


def weighted_run(indexed_paths, opts: CommonOpts, put, device: torch.device,
                 filter_idx=None, filt_min_count: Optional[int] = None):
    """device_hll_run for weighted sketches: calls put(index, (2^p,) uint8
    registers) file by file (host_run; cache files `.wj[.exact].hll`)."""
    p = hll_p_from_S(opts.sketch_size)

    def build(path, tiles, params):
        return HLL(p, opts.estim, opts.jestim,
                   weighted_registers(path, tiles, opts, params, device))

    host_run(indexed_paths, opts, lambda i, sk: put(i, sk.regs), build,
             filter_idx, filt_min_count)


def build_sketch(path: str, tiles, opts: CommonOpts,
                 params: pipeline.SketchParams, device: torch.device):
    """One path's sketch of opts.sketch_type, built file by file (JAX
    `build_sketch` and `_build_weighted`'s set-sketch branch): a weighted
    one holds the labelled elements of the path's raw k-mers, made and
    inserted on the host (metrics bucket `wj.host`; each type hashes them
    as its addh_np does, so a weighted wide HLL re-hashes them where a
    weighted HLL does not); else setsketches.build_typed."""
    if opts.weighted:
        with metrics.accum("wj.host"):
            raw = pipeline.file_raw_kmers(path, params, device, tiles)
            return sketch_of_values(opts.sketch_type, opts,
                                    weighted_elements(raw, opts))
    return build_typed(opts.sketch_type, path, opts, params, device, tiles)


def typed_run(indexed_paths, opts: CommonOpts, put, device: torch.device,
              filter_idx=None, filt_min_count: Optional[int] = None):
    """The engine of every sketch the HLL engine does not build (JAX
    `_sketch_paths_generic`): calls put(index, sketch of
    opts.sketch_type) file by file (host_run; build_sketch)."""
    host_run(indexed_paths, opts, put,
             lambda path, tiles, params: build_sketch(path, tiles, opts,
                                                      params, device),
             filter_idx, filt_min_count)


def host_run(indexed_paths, opts: CommonOpts, put, build, filter_idx=None,
             filt_min_count: Optional[int] = None):
    """The engine of the sketches built file by file: calls put(index,
    sketch) in order, sketch = build(path, tiles, params), the next
    files' parse prefetched behind each build (pipeline.prefetch); -W
    loads and writes the cache files (a SuperMinHash run rebuilds and
    overwrites a cache file that holds the older densified MinHash, with
    the JAX CLI's note).  filter_idx / filt_min_count as in
    device_hll_run (a count-min filtered file takes the host route)."""
    base, filter_idx = _filtering(opts, indexed_paths, filter_idx,
                                  filt_min_count)
    fnames = {}
    for i, path in indexed_paths:
        fname = _cache_fname(path, opts) if opts.cache_sketch else None
        if fname is not None and os.path.isfile(fname):
            sk = read_sketch_auto(fname, opts.sketch_type,
                                  opts.sketch_type_explicit)
            if not (opts.sketch_type == "superminhash"
                    and isinstance(sk, DensifiedMinHash)):
                put(i, sk)
                continue
            eprint(f"Note: rebuilding stale DTPUSMH1 cache {fname} in the "
                   "SuperMinHash (DTPUSMH2) format")
        fnames[i] = fname
    for f in pipeline.prefetch([t for t in indexed_paths if t[0] in fnames],
                               pipeline.check_supported(base)):
        sk = build(f.path, f.tiles, dataclasses.replace(
            base, use_counting_filter=f.index in filter_idx))
        if fnames[f.index] is not None:
            atomic_write_sketch(sk, fnames[f.index])
        put(f.index, sk)


def hll_engine(opts: CommonOpts) -> bool:
    """Whether the HLL engine builds opts' sketches: HLLs (weighted ones
    by weighted_run) and plain wide HLLs.  A weighted wide HLL takes
    typed_run, where WideHLL.addh_np re-hashes the labelled elements as
    the JAX package's does."""
    return (opts.sketch_type == "hll"
            or (opts.sketch_type == "wide_hll" and not opts.weighted))


def register_class(opts: CommonOpts):
    """The sketch class of the HLL engine's registers: the wide HLL under
    --use-wide-hll (its registers are HLL's, widened), else HLL."""
    return WideHLL if opts.sketch_type == "wide_hll" else HLL


def _filtering(opts: CommonOpts, indexed_paths, filter_idx=None,
               filt_min_count: Optional[int] = None):
    """(sketch parameters at the count-min threshold, the indices of the
    files filtered): filter_idx None is every file under -y/-b, none
    otherwise; filt_min_count None is opts.mincount floored at 2 (the
    `dist` rule)."""
    if filt_min_count is None:
        filt_min_count = opts.mincount if opts.mincount > 1 else 2
    if filter_idx is None:
        filter_idx = ({i for i, _ in indexed_paths}
                      if opts.use_counting_filter else frozenset())
    return (dataclasses.replace(sketch_params(opts), min_count=filt_min_count),
            filter_idx)


def device_hll_run(indexed_paths, opts: CommonOpts, put,
                   device: torch.device, filter_idx=None,
                   filt_min_count: Optional[int] = None):
    """The HLL sketch engine (pipeline.sketch_hll_files) behind the -W
    cache: calls put(index, (2^p,) registers) as each file lands, uint8
    (uint16 from a wide HLL's cache file).  -W (opts.cache_sketch) loads
    a file's sketch from its cache file when there is one and writes the
    others' (`.hll`, or `.whll` records under --use-wide-hll).
    filter_idx / filt_min_count: the files count-min filtered and their
    threshold (_filtering)."""
    p = hll_p_from_S(opts.sketch_size)
    fnames = ({i: _cache_fname(path, opts) for i, path in indexed_paths}
              if opts.cache_sketch else {})
    todo = []
    cls = register_class(opts)
    for i, path in indexed_paths:
        if i in fnames and os.path.isfile(fnames[i]):
            put(i, read_sketch_auto(fnames[i], opts.sketch_type,
                                    opts.sketch_type_explicit).regs)
        else:
            todo.append((i, path))

    def land(i, regs):
        if i in fnames:
            atomic_write_sketch(cls(p, opts.estim, opts.jestim, regs),
                                fnames[i])
        put(i, regs)

    params, filter_idx = _filtering(opts, todo, filter_idx, filt_min_count)
    pipeline.sketch_hll_files(todo, params, p, device, filtered=filter_idx,
                              land=land)


def sketch_paths(paths_list: List[str], opts: CommonOpts,
                 device: torch.device) -> List:
    """Sketch or load many logical paths: HLLs or wide HLLs (the HLL
    engine; the wide HLL's registers are HLL's, bitwise the JAX package's
    host route), or the other sketches of opts.sketch_type (typed_run,
    weighted wide HLLs among them).  Under -W an
    HLL whose registers mkdist parked on the device carries them as
    `dev_regs`, so the compare stacks its bank there
    (ops/pairwise._device_regs_for).  Under several processes the HLL
    engine's list is split across them (parallel/distributed.py); the
    other types are built whole on every process, as in the JAX CLI."""
    if opts.presketched:
        return [read_sketch_auto(path, opts.sketch_type,
                                 opts.sketch_type_explicit)
                for path in paths_list]
    out: List = [None] * len(paths_list)
    if not hll_engine(opts):
        typed_run(list(enumerate(paths_list)), opts, out.__setitem__,
                  device)
        return out
    p = hll_p_from_S(opts.sketch_size)
    cls = register_class(opts)
    run = weighted_run if opts.weighted else device_hll_run
    if (distributed.process_count() > 1 and opts.sketch_type == "hll"
            and not opts.weighted):
        # several processes: each sketches its stride of the list, then one
        # register max all-reduce rebuilds every sketch on every process
        # (the rows a process did not sketch are zero)
        regs = np.zeros((len(paths_list), 1 << p), np.uint8)
        device_hll_run(distributed.my_shard(list(enumerate(paths_list))),
                       opts, regs.__setitem__, device)
        regs = distributed.global_register_max(regs)
        return [cls(p, opts.estim, opts.jestim, r) for r in regs]
    run(list(enumerate(paths_list)), opts,
        lambda i, regs: out.__setitem__(
            i, cls(p, opts.estim, opts.jestim, regs)),
        device)
    if opts.cache_sketch:
        for path, sk in zip(paths_list, out):
            dev = pipeline.device_rows_get(_cache_fname(path, opts))
            if dev is not None:
                sk.dev_regs = dev
    return out


def check_compatible(sketches):
    """Stop on mixed sketch parameters (e.g. different -S among
    presketched inputs) with the JAX CLI's messages, before an engine
    compares garbage or fails on a shape."""
    ps = {getattr(s, "p", None) for s in sketches}
    ps.discard(None)
    if len(ps) > 1:
        raise SystemExit(
            f"sketches have mixed precisions p={sorted(ps)}; re-sketch with "
            "a common -S or fold the larger ones down (dashing_tpu fold)")
    for attr, what in (("kk", "minhash sizes"), ("b", "register widths"),
                       ("nbits_log2", "bloom filter sizes"),
                       ("nhashes", "bloom hash counts"),
                       ("regwidth", "hyperminhash register widths")):
        vals = {getattr(s, attr, None) for s in sketches}
        vals.discard(None)
        if len(vals) > 1:
            raise SystemExit(
                f"sketches have mixed {what} {attr}={sorted(vals)}; "
                "re-sketch with common parameters")
    types = {type(s).__name__ for s in sketches}
    if len(types) > 1:
        raise SystemExit(f"mixed sketch types {sorted(types)} cannot be "
                         "compared")


def host_measure(tri: np.ndarray, result_type: int, ksinv: float,
                 device: torch.device) -> np.ndarray:
    """float64 triples -> float32 measures by pw.measure_from_triples on
    `device` (the triples rounded to float32 first, as the JAX CLI does)."""
    t = torch.from_numpy(np.asarray(tri, np.float32)).to(device)
    return pw.measure_from_triples(t, result_type, ksinv).cpu().numpy()


def _per_pair_engine(row_blocks) -> None:
    if row_blocks is not None:
        raise ValueError("multi-process stripes need the device tile "
                         "engine or a batched host engine")


def compare_condensed(sketches, result_type: int, k: int, estim: int,
                      jestim: int, device: torch.device,
                      out: Optional[np.ndarray] = None,
                      row_blocks=None) -> np.ndarray:
    """Symmetric all-pairs condensed vector: the device tile engine for
    HLL and wide HLL sketches; for the other types the batched numpy
    engines over blocks of HOST_COMPARE_TILE rows of the upper triangle
    (a block's rows pack contiguously in the condensed vector), each
    block's measures in one call on `device`; a type without an engine
    (the exact k-mer hash sets) pair by pair on the host, every pair's
    measure in one call.  `row_blocks` restricts the compare to those
    tile-row starts (a process's stripes; the other entries of a new
    vector are zero)."""
    check_compatible(sketches)
    if isinstance(sketches[0], RegisterSketch):
        return pw.all_pairs_condensed(sketches, result_type, k, estim,
                                      jestim, device, out=out,
                                      row_blocks=row_blocks)
    n = len(sketches)
    if out is None:
        out = (np.zeros if row_blocks is not None else np.empty)(
            n * (n - 1) // 2, np.float32)
    if not batch_compare.supports(sketches):
        _per_pair_engine(row_blocks)
        with metrics.accum("compare.host"):
            tri = np.array([a.full_set_comparison(b) for a, b in
                            itertools.combinations(sketches, 2)],
                           np.float64).reshape(-1, 3)
        if tri.shape[0]:
            out[:] = host_measure(tri, result_type, 1.0 / k, device)
        return out
    T = HOST_COMPARE_TILE
    for i0 in range(0, n, T) if row_blocks is None else sorted(row_blocks):
        with metrics.accum("compare.host"):
            rect = batch_compare.batch_triples(sketches[i0:i0 + T],
                                               sketches[i0:])
            tri = np.concatenate([rect[ii, ii + 1:]
                                  for ii in range(rect.shape[0])])
        if tri.shape[0]:
            start = (i0 * (2 * n - i0 - 1)) // 2
            out[start:start + tri.shape[0]] = host_measure(
                tri, result_type, 1.0 / k, device)
    return out


def compare_rect(refs, queries, result_type: int, k: int, estim: int,
                 jestim: int, device: torch.device,
                 ref_blocks=None) -> np.ndarray:
    """Query x reference (nq, nr) matrix, the reference on the lhs of
    each pair's triples: the device tile engine for HLL and wide HLL
    sketches, the batched numpy engines for the other types, pair by pair
    on the host for a type without one (the exact k-mer hash sets).
    `ref_blocks` restricts the compare to the references of those tile
    starts (a process's column stripes; the other columns are zero)."""
    check_compatible(list(refs) + list(queries))
    if isinstance(refs[0], RegisterSketch):
        return pw.rect_pairs(refs, queries, result_type, k, estim, jestim,
                             device, ref_blocks=ref_blocks)
    if ref_blocks is not None:
        if not batch_compare.supports(refs):
            _per_pair_engine(ref_blocks)
        out = np.zeros((len(queries), len(refs)), np.float32)
        for i0 in sorted(ref_blocks):
            sub = refs[i0:i0 + HOST_COMPARE_TILE]
            out[:, i0:i0 + len(sub)] = compare_rect(
                sub, queries, result_type, k, estim, jestim, device)
        return out
    with metrics.accum("compare.host"):
        if batch_compare.supports(refs):
            tri = batch_compare.batch_triples(refs, queries)
            tri = tri.transpose(1, 0, 2)
        else:
            tri = np.array([[r.full_set_comparison(q) for r in refs]
                            for q in queries], np.float64)
    return host_measure(tri.reshape(-1, 3), result_type, 1.0 / k,
                        device).reshape(len(queries), len(refs))


def host_nn_topk(refs, queries, result_type: int, k: int, estim: int,
                 jestim: int, nn: int, exclude_self: bool,
                 device: torch.device, tile: int = HOST_COMPARE_TILE,
                 ref_blocks=None):
    """Streaming k-nearest neighbours of every type but HLL (the wide HLL
    too, as in the JAX CLI) -> (vals, idx), each (n_q, nn): reference
    tiles through compare_rect and a stable host merge, O(n_q * (nn +
    tile)) memory.  Ties order by ascending reference
    index, as the dense argsort would: a tile's stable argsort keeps them
    in index order and earlier tiles come first in the merge.
    `ref_blocks` restricts the scan to those reference tile starts (a
    process's stripes; padded with (worst, -1) below nn candidates)."""
    sim = pw.is_similarity(result_type)
    nq, nr = len(queries), len(refs)
    nn = min(nn, nr)
    worst = -np.inf if sim else np.inf
    best_v = np.full((nq, 0), worst, np.float32)
    best_i = np.zeros((nq, 0), np.int64)
    for j0 in range(0, nr, tile) if ref_blocks is None else sorted(
            ref_blocks):
        block = compare_rect(refs[j0:j0 + tile], queries, result_type, k,
                             estim, jestim, device)
        rt = block.shape[1]
        if exclude_self:
            for qi in range(max(j0, 0), min(j0 + rt, nq)):
                block[qi, qi - j0] = worst
        idx = np.argsort(-block if sim else block, axis=1,
                         kind="stable")[:, :nn]
        cat_v = np.concatenate(
            [best_v, np.take_along_axis(block, idx, 1)], axis=1)
        cat_i = np.concatenate([best_i, idx + j0], axis=1)
        order = np.argsort(-cat_v if sim else cat_v, axis=1,
                           kind="stable")[:, :nn]
        best_v = np.take_along_axis(cat_v, order, 1)
        best_i = np.take_along_axis(cat_i, order, 1)
    return pw.pad_nn_candidates(best_v, best_i, nn, worst)


def emit_cardinalities(fp, names: Sequence[str], sketches,
                       device: torch.device, integer: bool = True,
                       use_scientific: bool = False):
    """'#Path\\tSize (est.)' then one line per sketch: '%s\\t%zu' (dist),
    or the float as `card` prints it.  HLL and wide HLL estimates come
    from one batched call per (p, estimator) on `device`; another sketch
    reports its own."""
    with metrics.accum("cardinality"):
        batch_reports([s for s in sketches
                       if isinstance(s, RegisterSketch)], device)
    fp.write("#Path\tSize (est.)\n")
    for name, sk in zip(names, sketches):
        card = sk.report()
        if integer:
            val = "inf" if not math.isfinite(card) else str(int(card))
        elif use_scientific:
            val = f"{card:0.12g}"
        else:
            val = f"{card:0.8f}"
        fp.write(f"{name}\t{val}\n")


def open_output(path: Optional[str], binary: bool = False):
    if not path or path == "-" or path == "/dev/stdout":
        return (sys.stdout.buffer if binary else sys.stdout), False
    return open(path, "wb" if binary else "w"), True
