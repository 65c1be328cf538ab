"""Shared CLI machinery (port of dashing_tpu/cli/core.py, the HLL slice).

Flag names, defaults and output formats are the JAX package's.  Flags
outside the slice are refused with a "not yet ported" error rather than
computed some other way.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import metrics, pipeline
from ..io import fasta, paths
from ..ops import pairwise as pw
from ..sketch import estimators as est
from ..sketch.hll import HLL, batch_reports

HLL_EXT = ".hll"


class NotPorted(SystemExit):
    """A flag or mode the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to dashing_tpu_torch, "
                         "see ROADMAP.md")


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
    # count-min filtering: parsed and stored as the JAX CLI does; a run
    # where a filter would apply is refused (count_filter_refusal)
    mincount: int = 5
    nhashes: int = 1
    cmsketchsize: int = -1
    seed: int = 1337
    use_counting_filter: bool = False
    sketch_by_fname: bool = False


def hll_p_from_S(S: int) -> int:
    return S


def count_filter_refusal(opts: CommonOpts, inpaths: Sequence[str],
                         sketch: bool) -> None:
    """Raise NotPorted where the JAX CLI would count-filter a file
    (dashing_tpu/cli/core.py device_hll_run, dashing_tpu/cli/main.py
    sketch_main).  `dist` filters every sketched file under -y/--countmin,
    at a threshold of -c floored at 2, and never reads -N.  `sketch`
    filters a file under -b/--countmin, or under -f on a FASTQ name, when
    its threshold -n (1 unless given) is above 1: a threshold of 1 admits
    every k-mer, so the run is the plain one."""
    if opts.presketched:
        return
    if not sketch:
        if opts.use_counting_filter:
            raise NotPorted("dist -y/--countmin (count-min filtered "
                            "sketching)")
        return
    if opts.mincount > 1 and (opts.use_counting_filter or (
            opts.sketch_by_fname and any(map(fasta.fname_is_fq, inpaths)))):
        raise NotPorted("sketch -b/--countmin, or -f on FASTQ inputs, with a "
                        "threshold -n above 1 (count-min filtered sketching)")


# Options of the JAX CLI that the slice refuses, with the name to report.
_REFUSED = {
    "-W": "sketch caching (-W)", "--cache-sketches": "sketch caching (-W)",
    "--wj": "weighted Jaccard", "--wj-exact": "weighted Jaccard",
    "--wj-cm-sketch-size": "weighted Jaccard",
    "--wj-cm-nhashes": "weighted Jaccard",
    "--nearest-neighbors": "nearest-neighbour mode",
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
    return pipeline.SketchParams(k=opts.k, w=opts.wsz, spacing=opts.spacing,
                                 canon=opts.canon, encoding=opts.encoding,
                                 entropy=opts.entropy_min)


def gather_inpaths(opts: CommonOpts, positional: List[str]) -> List[str]:
    return (paths.get_paths(opts.paths_file) if opts.paths_file
            else list(positional))


def read_hll(path_or_fp) -> HLL:
    """Load an HLL record; other sketch types are refused by their magic."""
    try:
        return HLL.read(path_or_fp)
    except ValueError as e:
        if "magic" in str(e):
            raise NotPorted(f"reading non-HLL sketches ({e})")
        raise


def device_hll_run(indexed_paths, opts: CommonOpts, put,
                   device: torch.device, lookahead: int = 2):
    """Sketch (index, path) pairs on `device`, calling put(index, regs)
    with (2^p,) uint8 registers as each lands.  A worker thread parses and
    joins the next `lookahead` files while this one packs and uploads;
    files large enough to stream are parsed incrementally instead."""
    p = hll_p_from_S(opts.sketch_size)
    params = sketch_params(opts)
    sp = pipeline.check_supported(params)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        futs = {}
        for pos, (i, path) in enumerate(indexed_paths):
            for j, nxt in indexed_paths[pos:pos + 1 + lookahead]:
                if j not in futs and not pipeline.should_stream(nxt):
                    futs[j] = ex.submit(pipeline._read_joined, nxt, sp.halo)
            fut = futs.pop(i, None)
            if fut is None:
                regs = pipeline.sketch_file_hll(path, params, p, device)
            else:
                regs = pipeline.sketch_joined_hll(fut.result(), params, p,
                                                  device)
            put(i, regs)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def sketch_paths(paths_list: List[str], opts: CommonOpts,
                 device: torch.device) -> List[HLL]:
    """Sketch or load many logical paths into HLLs."""
    if opts.presketched:
        return [read_hll(path) for path in paths_list]
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


def emit_cardinalities(fp, names: Sequence[str], sketches,
                       device: torch.device):
    """'#Path\\tSize (est.)' then one '%s\\t%zu' line per sketch."""
    with metrics.accum("cardinality"):
        batch_reports(sketches, device)
    fp.write("#Path\tSize (est.)\n")
    for name, sk in zip(names, sketches):
        card = sk.report()
        val = "inf" if not math.isfinite(card) else str(int(card))
        fp.write(f"{name}\t{val}\n")


def open_output(path: Optional[str], binary: bool = False):
    if not path or path == "-" or path == "/dev/stdout":
        return (sys.stdout.buffer if binary else sys.stdout), False
    return open(path, "wb" if binary else "w"), True
