"""dashing_tpu_torch command-line interface (the HLL slice).

    python -m dashing_tpu_torch.cli sketch [opts] genomes...
    python -m dashing_tpu_torch.cli dist   [opts] genomes...

Same getopt surface and outputs as `python -m dashing_tpu.cli` for what the
slice covers: HLL sketches of exact k-mers (contiguous or spaced, with or
without minimizer windows, scored by value or by entropy) or of the
ntHash and cyclic rolling hashes, symmetric measures, the
ORIGINAL/IMPROVED/MLE estimators and the joint MLE (-J).  Everything else
is refused with a "not yet ported" error.  The device comes from
DASHING_TPU_TORCH_DEVICE (default "cuda"); asking for CUDA without a card
raises.
"""
from __future__ import annotations

import getopt
import gzip
import os
import sys
from typing import List, Optional

from .. import __version__, device as devmod, metrics
from ..io import cache, distmat, paths
from ..ops import pairwise as pw
from ..sketch.hll import HLL
from . import core
from .core import CommonOpts, NotPorted, eprint

UT_TSV, BINARY, PHYLIP, FULL_TSV = 0, 1, 2, 3

# the JAX CLI's option tables, so every flag parses and the slice can
# refuse what it lacks by name
DIST_LONG = [
    "avoid-sorting", "by-entropy", "cache-sketches", "countmin",
    "emit-binary", "full-mash-dist", "full-tsv", "no-canon", "phylip",
    "presketched", "sizes", "sketch-by-fname", "use-bb-minhash",
    "use-scientific", "bbits=", "cm-sketch-size=", "ertl-joint-mle",
    "ertl-mle", "improved", "kmer-length=", "min-count=", "nhashes=",
    "nthreads=", "original", "out-dists=", "out-sizes=", "paths=",
    "prefix=", "query-paths=", "seed=", "sketch-size=", "spacing=",
    "suffix=", "window-size=", "help", "use-range-minhash",
    "use-full-khash-sets", "use-full-hash-sets", "use-hash-sets",
    "hash-sets", "use-full-sets", "full-containment-dist",
    "use-bloom-filter", "use-nthash", "containment-index",
    "use-counting-range-minhash", "use-counting-bb-minhash",
    "containment-dist", "mash-dist", "symmetric-containment-index",
    "symmetric-containment-dist", "use-cyclic-hash", "wj-cm-sketch-size=",
    "wj-cm-nhashes=", "wj", "nearest-neighbors=", "wj-exact",
    "use-wide-hll", "use-superminhash", "use-hyperminhash",
    "defer-hll", "nperbatch=", "multik=",
]
DIST_SHORT_OPTS = "Q:P:x:F:c:p:o:s:w:O:S:k:t:R:q:B:8TglICbMEeHJhZNyUmW?hn"

SKETCH_LONG = [
    "countmin", "sketch-by-fname", "no-canon", "skip-cached", "by-entropy",
    "use-bb-minhash", "bbits=", "paths=", "prefix=", "nhashes=", "original",
    "improved", "ertl-joint-mle", "seed=", "sketch-size=", "kmer-length=",
    "min-count=", "nthreads=", "cm-sketch-size=", "spacing=", "window-size=",
    "suffix=", "wj-cm-sketch-size=", "wj-cm-nhashes=", "use-range-minhash",
    "use-full-khash-sets", "use-bloom-filter", "use-nthash",
    "use-cyclic-hash", "avoid-sorting", "wj", "wj-exact", "use-wide-hll",
    "use-counting-range-minhash", "use-counting-bb-minhash",
    "use-superminhash", "use-hyperminhash", "defer-hll", "help",
]
SKETCH_SHORT_OPTS = "n:P:F:o:p:x:R:s:S:k:w:H:q:B:8JbfjEIcCeh?"


def _getopts(argv, short, long_):
    try:
        return getopt.gnu_getopt(argv, short, long_)
    except getopt.GetoptError as e:
        raise SystemExit(f"option error: {e}")


# ===========================================================================
# dist / cmp
# ===========================================================================

def dist_main(argv: List[str], device) -> int:
    o = CommonOpts()
    result_type = pw.JI
    emit_fmt = UT_TSV
    use_scientific = False
    out_sizes: Optional[str] = None
    out_dists: Optional[str] = None
    if not argv:
        _dist_usage()
    optlist, positional = _getopts(argv, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-M", "--mash-dist"):
            result_type = pw.MASH_DIST
        elif flag in ("-l", "--full-mash-dist"):
            result_type = pw.FULL_MASH_DIST
        elif flag in ("-Z", "--sizes"):
            result_type = pw.SIZES
        elif flag == "--symmetric-containment-index":
            result_type = pw.SYMMETRIC_CONTAINMENT_INDEX
        elif flag == "--symmetric-containment-dist":
            result_type = pw.SYMMETRIC_CONTAINMENT_DIST
        elif flag in ("--containment-index", "--containment-dist",
                      "--full-containment-dist", "-Q", "--query-paths"):
            raise NotPorted(f"{flag} (query/reference and asymmetric measures)")
        elif flag in ("-b", "--emit-binary"):
            emit_fmt = BINARY
        elif flag in ("-U", "--phylip"):
            emit_fmt = PHYLIP
        elif flag in ("-T", "--full-tsv"):
            emit_fmt = FULL_TSV
        elif flag in ("-e", "--use-scientific"):
            use_scientific = True
        elif flag == "-o":
            out_sizes = val
        elif flag == "-O":
            out_dists = val
        elif flag in ("-h", "-?", "--help"):
            _dist_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        _dist_usage()
    core.count_filter_refusal(o, inpaths, sketch=False)
    if not o.presketched and not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)

    names = list(inpaths)
    if o.presketched and len(inpaths) == 1:
        # one presketched file may hold a stream of sketches
        sketches = []
        with gzip.open(inpaths[0], "rb") as fp:
            while True:
                try:
                    sketches.append(core.read_hll(fp))
                except EOFError:
                    break
        names = [str(i) for i in range(len(sketches))]
    else:
        with metrics.phase("sketch", items=len(inpaths), unit="files"):
            sketches = core.sketch_paths(inpaths, o, device)
    for sk in sketches:
        sk.estim = o.estim
        sk.jestim = o.jestim

    fp_sizes, close_sizes = core.open_output(out_sizes)
    core.emit_cardinalities(fp_sizes, names, sketches, device)
    if close_sizes:
        fp_sizes.close()

    n = len(sketches)
    use_mmap = (emit_fmt == BINARY
                and out_dists not in (None, "-", "/dev/stdout"))
    mm = distmat.create_binary_mmap(out_dists, n) if use_mmap else None
    with metrics.phase("all-pairs compare", items=n * (n - 1) / 2,
                       unit="pairs"):
        cond = core.compare_condensed(sketches, result_type, o.k, o.estim,
                                      o.jestim, device, out=mm)
    if emit_fmt == BINARY:
        if mm is not None:
            mm.flush()
            distmat.finalize_binary_mmap(out_dists)
        else:
            fp, close = core.open_output(out_dists, binary=True)
            distmat.write_binary(fp, cond, n)
            if close:
                fp.close()
        _write_labels(out_dists, names)
    elif emit_fmt == PHYLIP:
        fp, close = core.open_output(out_dists)
        distmat.emit_phylip(fp, names, cond, use_scientific)
        if close:
            fp.close()
    elif emit_fmt == FULL_TSV:
        fp, close = core.open_output(out_dists)
        distmat.emit_full_tsv(fp, names, distmat.condensed_to_square(cond, n),
                              use_scientific)
        if close:
            fp.close()
    else:
        fp, close = core.open_output(out_dists)
        distmat.emit_ut_tsv(fp, names, cond, use_scientific)
        if close:
            fp.close()
    return 0


def _write_labels(out_dists: Optional[str], names):
    """Binary emission writes a .labels sidecar."""
    label_path = (out_dists + ".labels") if out_dists else "unspecified"
    try:
        with open(label_path, "w") as fp:
            for nm in names:
                fp.write(nm + "\n")
    except OSError as e:
        eprint(f"warning: could not write labels file {label_path}: {e}")


# ===========================================================================
# sketch
# ===========================================================================

def sketch_main(argv: List[str], device) -> int:
    o = CommonOpts()
    o.mincount = 1
    output_file = ""
    optlist, positional = _getopts(argv, SKETCH_SHORT_OPTS, SKETCH_LONG)
    for flag, val in optlist:
        # sketch's short letters differ from dist's: -b=countmin,
        # -f=by-fname, -c=skip-cached, -n=min-count, -q=cm size,
        # -H=nhashes, -o=output stream
        if flag in ("-b", "--countmin"):
            o.use_counting_filter = True
            continue
        if flag in ("-f", "--sketch-by-fname"):
            o.sketch_by_fname = True
            continue
        if flag in ("-n", "--min-count"):
            o.mincount = int(val)
            continue
        if flag == "-q":
            o.cmsketchsize = int(val)
            continue
        if flag == "-H":
            o.nhashes = int(val)
            continue
        if flag in ("-c", "--skip-cached"):
            raise NotPorted(f"{flag} (skip cached sketches)")
        if flag == "-o":
            output_file = val
            continue
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-h", "-?", "--help"):
            _sketch_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        _sketch_usage()
    core.count_filter_refusal(o, inpaths, sketch=True)
    if not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
    sp = core.sketch_params(o).spacer()
    p = core.hll_p_from_S(o.sketch_size)
    fnames = {i: cache.make_fname(path, p, sp.w, o.k, sp.c, o.spacing,
                                  o.suffix, o.prefix, o.encoding,
                                  core.HLL_EXT)
              for i, path in enumerate(inpaths)}
    results: dict = {}

    def put(i, regs):
        sk = HLL(p, o.estim, o.jestim, regs)
        if output_file:
            results[i] = sk
        else:
            tmp = f"{fnames[i]}.tmp.{os.getpid()}"
            sk.write(tmp)
            os.replace(tmp, fnames[i])

    core.device_hll_run(list(enumerate(inpaths)), o, put, device)
    if output_file:
        with gzip.open(output_file + ".labels.gz", "wt") as fp:
            for path in inpaths:
                fp.write(path + "\n")
        with gzip.open(output_file, "wb") as fp:
            for i in sorted(results):
                results[i].write_record(fp)
    eprint(f"Successfully finished sketching from {len(inpaths)} files")
    return 0


# ===========================================================================
# usage + dispatcher
# ===========================================================================

def _dist_usage():
    raise SystemExit(
        "Usage: dist <opts> [genomes... or -F paths.txt]\n"
        "  -k/--kmer-length INT    k-mer size [31], max 32 unless rolling\n"
        "  -s/--spacing STR        spaced seed, e.g. 1x4 (gaps after "
        "positions)\n"
        "  -w/--window-size INT    minimizer window [k-mer span]\n"
        "  -g/--by-entropy         minimizers by base-composition entropy\n"
        "  --use-nthash, --use-cyclic-hash  rolling hashes (any k)\n"
        "  -S/--sketch-size INT    log2 bytes per sketch [10]\n"
        "  -F/--paths FILE         one input path per line\n"
        "  -o/-O FILE              cardinality / distance outputs\n"
        "  -M/--mash-dist, --full-mash-dist, --sizes, "
        "--symmetric-containment-*\n"
        "  -b binary, -U phylip, -T full TSV (default upper-triangular TSV)\n"
        "  -E/-I/-m                estimator: original/improved/MLE\n"
        "  -J/--ertl-joint-mle     set comparisons by the joint MLE\n"
        "  -C no canonicalization, -H presketched inputs, -e scientific\n"
        "  -c/-q/-t/-R, -N          count-min parameters (stored; no "
        "filter without -y)\n"
        "Not yet ported (see ROADMAP.md): -Q and asymmetric measures, "
        "-y/--countmin, -W, weighted Jaccard, non-HLL sketches\n")


def _sketch_usage():
    raise SystemExit("Usage: sketch <opts> [genomes...]; see dist for shared "
                     "options; -o writes all sketches to one stream")


SUBCOMMANDS = {
    "sketch": sketch_main,
    "dist": dist_main,
    "cmp": dist_main,
    "setdist": dist_main,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    eprint(f"dashing_tpu_torch version: {__version__}")
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit("Usage: dashing_tpu_torch <sketch|dist> [options...]")
    cmd = argv[0]
    fn = SUBCOMMANDS.get(cmd)
    if fn is None:
        raise NotPorted(f"the {cmd!r} subcommand")
    try:
        device = devmod.from_env()
    except RuntimeError as e:
        raise SystemExit(f"{cmd}: {e}")
    try:
        rc = fn(argv[1:], device)
    except (FileNotFoundError, IsADirectoryError) as e:
        raise SystemExit(f"{cmd}: {e}")
    except NotImplementedError as e:
        raise SystemExit(f"{cmd}: {e}")
    except (EOFError, ValueError, gzip.BadGzipFile) as e:
        if os.environ.get("DASHING_TPU_DEBUG"):
            raise
        raise SystemExit(f"{cmd}: {type(e).__name__}: {e}")
    metrics.summary()
    return rc


if __name__ == "__main__":
    sys.exit(main())
