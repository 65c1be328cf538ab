"""Shared CLI machinery (port of dashing_tpu/cli/core.py, the HLL slice).

Flag names, defaults and output formats are the JAX package's.  Flags
outside the slice are refused with a "not yet ported" error rather than
computed some other way.
"""
from __future__ import annotations

import dataclasses
import gzip
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import NotPorted, metrics, pipeline
from ..io import paths
from ..ops import pairwise as pw
from ..sketch import estimators as est
from ..sketch.hll import HLL, BadMagic, batch_reports

HLL_EXT = ".hll"


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


def hll_p_from_S(S: int) -> int:
    return S


# Options of the JAX CLI that the slice refuses, with the name to report.
_REFUSED = {
    "-W": "sketch caching (-W)", "--cache-sketches": "sketch caching (-W)",
    "--wj": "weighted Jaccard", "--wj-exact": "weighted Jaccard",
    "--wj-cm-sketch-size": "weighted Jaccard",
    "--wj-cm-nhashes": "weighted Jaccard",
    "-B": "b-bit MinHash (-B)", "--bbits": "b-bit MinHash",
    "-8": "non-HLL sketch types",
}


def parse_common(opts: CommonOpts, flag: str, val: str) -> bool:
    """Apply one option shared by sketch and dist.  Returns True if
    consumed; raises NotPorted for options outside the slice."""
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
        "--use-nthash": ("encoding", "nthash"),
        "--use-cyclic-hash": ("encoding", "cyclic"),
    }
    if flag in flags:
        name, v = flags[flag]
        setattr(opts, name, v)
        if name == "estim":
            opts.jestim = v
        return True
    if flag in ("-J", "--ertl-joint-mle"):
        opts.jestim = est.ERTL_JOINT_MLE
        return True
    if flag == "--nearest-neighbors":
        opts.number_neighbors = int(val)
        return True
    if flag in _REFUSED:
        raise NotPorted(_REFUSED[flag])
    if flag.startswith("--use-") or flag.endswith("-sets"):
        raise NotPorted(f"{flag} (non-HLL sketch types)")
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


# file magic -> sketch family of every DTPU container (the JAX CLI's
# table); the port reads the HLL family only
MAGIC_TYPES = {b"DTPUHLL1": "hll", b"DTPUBF01": "bf", b"DTPURMH1": "rmh",
               b"DTPUCRM1": "crmh", b"DTPUBBM1": "bbmh",
               b"DTPUCBB1": "cbbmh",
               b"DTPUWHL1": "wide_hll", b"DTPUHMH1": "hmh",
               b"DTPUSMH1": "superminhash", b"DTPUSMH2": "superminhash"}


def _refuse_family(what, magic: bytes) -> None:
    family = MAGIC_TYPES.get(magic)
    if family is not None and family != "hll":
        raise NotPorted(f"reading {family} sketches ({what})")


def read_hll(path_or_fp) -> HLL:
    """Load one HLL record from a path or a stream.  Another DTPU family is
    refused by name; a file that is no sketch fails on its magic."""
    try:
        return HLL.read(path_or_fp)
    except BadMagic as e:
        _refuse_family(path_or_fp, e.magic)
        raise


def read_sketch_auto(path: str) -> HLL:
    """The JAX CLI's `read_sketch_auto` for the HLL family: the magic is
    sniffed first, and any other family (a .khs, a bloom filter, a MinHash)
    is refused rather than loaded as something else."""
    try:
        with gzip.open(path, "rb") as fp:
            magic = fp.read(8)
    except OSError:
        magic = b""
    if path.endswith(".khs") and magic not in MAGIC_TYPES:
        raise NotPorted(f"reading khset sketches ({path})")
    _refuse_family(path, magic)
    return HLL.read(path)


def device_hll_jobs(indexed_paths, opts: CommonOpts, device: torch.device,
                    filter_idx=None, filt_min_count: Optional[int] = None,
                    lookahead: int = 2
                    ) -> Iterator[Tuple[int, torch.Tensor]]:
    """The HLL sketch engine over (index, path) pairs: yields (index,
    (2^p,) int32 registers on `device`, not synchronised).  A worker
    thread parses and joins the next `lookahead` files while this one
    uploads and sketches; files large enough to stream are parsed ahead
    by their own producer thread (pipeline._readahead).

    filter_idx: the indices whose file is count-min filtered (None: all of
    them under opts.use_counting_filter, none otherwise); filt_min_count:
    their threshold (None: opts.mincount floored at 2, the `dist` rule).
    A threshold of 1 or less admits every k-mer: no filter."""
    p = hll_p_from_S(opts.sketch_size)
    if filt_min_count is None:
        filt_min_count = opts.mincount if opts.mincount > 1 else 2
    base = sketch_params(opts)
    plain = dataclasses.replace(base, use_counting_filter=False)
    filt = dataclasses.replace(base, use_counting_filter=True,
                               min_count=filt_min_count)
    if filter_idx is None:
        filter_idx = ({i for i, _ in indexed_paths}
                      if opts.use_counting_filter else frozenset())
    if filt_min_count <= 1:
        filter_idx = frozenset()
    sp = pipeline.check_supported(base)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        futs = {}
        for pos, (i, path) in enumerate(indexed_paths):
            for j, nxt in indexed_paths[pos:pos + 1 + lookahead]:
                if j not in futs and not pipeline.should_stream(nxt):
                    futs[j] = ex.submit(pipeline._read_joined, nxt, sp.halo)
            fut = futs.pop(i, None)
            joined = None if fut is None else fut.result()

            def tiles(path=path, joined=joined):
                # a filtered file's second pass re-tiles a prefetched join
                if joined is None:
                    return pipeline._file_tiles(path, sp)
                return pipeline._joined_tiles(joined, sp.halo)

            yield i, pipeline.sketch_hll_async(
                tiles, filt if i in filter_idx else plain, p, device)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def device_hll_run(indexed_paths, opts: CommonOpts, put,
                   device: torch.device, filter_idx=None,
                   filt_min_count: Optional[int] = None):
    """device_hll_jobs, calling put(index, (2^p,) uint8 registers) as each
    file lands."""
    for i, regs in device_hll_jobs(indexed_paths, opts, device, filter_idx,
                                   filt_min_count):
        put(i, pipeline.registers_to_numpy(regs))


def sketch_paths(paths_list: List[str], opts: CommonOpts,
                 device: torch.device) -> List[HLL]:
    """Sketch or load many logical paths into HLLs."""
    if opts.presketched:
        return [read_sketch_auto(path) for path in paths_list]
    p = hll_p_from_S(opts.sketch_size)
    out: List = [None] * len(paths_list)
    device_hll_run(list(enumerate(paths_list)), opts,
                   lambda i, regs: out.__setitem__(
                       i, HLL(p, opts.estim, opts.jestim, regs)),
                   device)
    return out


def check_compatible(sketches):
    ps = {s.p for s in sketches}
    if len(ps) > 1:
        raise SystemExit(
            f"sketches have mixed precisions p={sorted(ps)}; re-sketch with "
            "a common -S or fold the larger ones down (dashing_tpu fold)")


def compare_condensed(sketches, result_type: int, k: int, estim: int,
                      jestim: int, device: torch.device,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Symmetric all-pairs condensed vector over HLL sketches."""
    check_compatible(sketches)
    return pw.all_pairs_condensed(sketches, result_type, k, estim, jestim,
                                  device, out=out)


def compare_rect(refs, queries, result_type: int, k: int, estim: int,
                 jestim: int, device: torch.device) -> np.ndarray:
    """Query x reference (nq, nr) matrix over HLL sketches, the reference
    on the lhs of each pair's triples."""
    check_compatible(list(refs) + list(queries))
    return pw.rect_pairs(refs, queries, result_type, k, estim, jestim,
                         device)


def emit_cardinalities(fp, names: Sequence[str], sketches,
                       device: torch.device, integer: bool = True,
                       use_scientific: bool = False):
    """'#Path\\tSize (est.)' then one line per sketch: '%s\\t%zu' (dist),
    or the float as `card` prints it.  The estimates come from one batched
    call per (p, estimator) on `device`."""
    with metrics.accum("cardinality"):
        batch_reports(sketches, device)
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
