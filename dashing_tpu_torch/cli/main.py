"""dashing_tpu_torch command-line interface.

    python -m dashing_tpu_torch.cli sketch [opts] genomes...
    python -m dashing_tpu_torch.cli dist   [opts] genomes...
    python -m dashing_tpu_torch.cli card|cardcmp|hll [opts] genomes...
    python -m dashing_tpu_torch.cli mkdist --multik pref,k0,k1[,step] ...
    python -m dashing_tpu_torch.cli sketch_by_seq|dist_by_seq|panel ...
    python -m dashing_tpu_torch.cli readfilt -s ref.hll [-f 0.5] r1 [r2]
    python -m dashing_tpu_torch.cli union|view|fold|printmat|flatten ...

Same getopt surface and outputs as `python -m dashing_tpu.cli` for what the
slice covers: HLL sketches of exact k-mers (contiguous or spaced, with or
without minimizer windows, scored by value or by entropy) or of the
ntHash and cyclic rolling hashes, count-min filtered or not (sketch -b/-f,
dist -y), weighted by multiplicity (--wj, --wj-exact), cached beside the
inputs (dist -W, sketch -c), every measure, the ORIGINAL/IMPROVED/MLE
estimators and the joint MLE (-J), query x reference rows (-Q) and
k-nearest neighbours (--nearest-neighbors);
per-k matrices (mkdist, with --jukes-cantor), one sketch a record
(sketch_by_seq/sbs) and their compare (dist_by_seq/cmp_by_seq), a query
screen against a sketch database (panel), the reads contained in a
reference sketch (readfilt); cardinalities (card, hll) and the file
tools (union, view, fold, printmat, flatten).  The wide HLL
(--use-wide-hll) takes the HLL engine and kernels.  The set sketches (-8
/ --use-bb-minhash with -B bits, --use-counting-bb-minhash,
--use-range-minhash, --use-counting-range-minhash, --use-bloom-filter,
--use-hyperminhash and --use-superminhash with -B bits) and the exact
k-mer hash sets (--use-full-khash-sets and its aliases; `.khs` files)
run through sketch, dist, card, union (-r, -b, -H), view, mkdist,
sketch_by_seq and dist_by_seq -B/-S/-8/-r/-K, every type plain or
weighted (--wj, --wj-exact); a DTPUSMH1 file (the densified MinHash) is
read as the JAX CLI reads it.  DASHING_TPU_USE_HK=1 count filters through
HeavyKeeper instead of the count-min sketch.  The device comes from
DASHING_TPU_TORCH_DEVICE (default "cuda"); asking for CUDA without a
card raises.  The file tools run on the host and never create a device.
DASHING_TPU_DISTRIBUTED=1 runs every subcommand across the processes of
a torch.distributed group (parallel/distributed.py), with the output of
one process; the bare "cuda" spreads the work over every card of the
host (parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses
import getopt
import gzip
import itertools
import os
import shutil
import struct
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from .. import NotPorted, __version__, device as devmod, metrics, pipeline
from ..background import mkmat2jcdistmat
from ..io import distmat, fasta, paths
from ..ops import pairwise as pw
from ..parallel import distributed
from ..sketch import batch_compare, estimators as est
from ..sketch.hll import HLL, RegisterSketch, batch_reports
from ..sketch.setsketches import sketch_of_values
from ..sketch.sparse import reference_cardinalities
from . import core
from .core import CommonOpts, eprint

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
    querypaths: List[str] = []
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
        elif flag == "--containment-index":
            result_type = pw.CONTAINMENT_INDEX
        elif flag == "--containment-dist":
            result_type = pw.CONTAINMENT_DIST
        elif flag == "--full-containment-dist":
            result_type = pw.FULL_CONTAINMENT_DIST
        elif flag == "--symmetric-containment-index":
            result_type = pw.SYMMETRIC_CONTAINMENT_INDEX
        elif flag == "--symmetric-containment-dist":
            result_type = pw.SYMMETRIC_CONTAINMENT_DIST
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
        elif flag in ("-Q", "--query-paths"):
            querypaths = paths.get_paths(val)
        elif flag in ("-h", "-?", "--help"):
            _dist_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        _dist_usage()
    nq = len(querypaths)
    if nq == 0 and not pw.is_symmetric(result_type):
        eprint("Note: No query files provided, but an asymmetric distance was "
               "requested. Switching to a query/reference format with all "
               "references as queries.")
        querypaths = list(inpaths)
        nq = len(querypaths)
    if not o.presketched and not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
        querypaths = paths.sort_paths_by_fsize(querypaths)
    # queries that are the references: sketch each file once and alias the
    # sketch objects as the query half
    mirror_queries = (bool(querypaths) and querypaths == inpaths
                      and not o.presketched)
    allpaths = inpaths + ([] if mirror_queries else querypaths)

    names = list(allpaths)
    if o.presketched and len(allpaths) == 1:
        # one presketched file may hold a stream of sketches
        sketches = []
        with gzip.open(allpaths[0], "rb") as fp:
            while True:
                try:
                    sketches.append(core.read_sketch_auto(fp, o.sketch_type))
                except EOFError:
                    break
        names = [str(i) for i in range(len(sketches))]
    else:
        with metrics.phase("sketch", items=len(allpaths), unit="files"):
            sketches = core.sketch_paths(allpaths, o, device)
    if mirror_queries:
        sketches = sketches + sketches       # the aliased query half
        names = names + names
    for sk in sketches:
        if hasattr(sk, "estim"):
            sk.estim = o.estim
        if hasattr(sk, "jestim"):
            sk.jestim = o.jestim

    # Several processes: every process holds every sketch (the sketch
    # phase's register max); the compare is split into tile-row stripes
    # (the register families: DEFAULT_TILE rows; the batched host engines:
    # HOST_COMPARE_TILE rows), and rank 0 writes every output.  The
    # per-pair engine (the exact k-mer hash sets) stays on rank 0.
    shard = _shard_tile(sketches)
    if not distributed.is_main() and not shard:
        return 0
    if distributed.is_main():
        # the row-estimate kernel runs inside: a bucket, no profiler range
        with metrics.accum("cli.sizes"):
            fp_sizes, close_sizes = core.open_output(out_sizes)
            core.emit_cardinalities(fp_sizes, names, sketches, device)
            if close_sizes:
                fp_sizes.close()

    if o.number_neighbors > 0:
        return _nn_emit(sketches, names, o, result_type, emit_fmt, out_dists,
                        nq, device, shard)
    if nq:
        return _rect_emit(sketches, names, o, result_type, emit_fmt,
                          out_dists, nq, use_scientific, device, shard)

    n = len(sketches)
    use_mmap = (emit_fmt == BINARY
                and out_dists not in (None, "-", "/dev/stdout"))
    row_blocks = distributed.owned_tile_rows(n, shard) if shard else None
    if use_mmap and shard:
        mm = _shared_mmap(out_dists, n)
        use_mmap = mm is not None
    else:
        mm = distmat.create_binary_mmap(out_dists, n) if use_mmap else None
    with metrics.phase("all-pairs compare", items=n * (n - 1) / 2,
                       unit="pairs"):
        cond = core.compare_condensed(sketches, result_type, o.k, o.estim,
                                      o.jestim, device, out=mm,
                                      row_blocks=row_blocks)
    if shard:
        if use_mmap:
            mm.flush()
            distributed.barrier("dashing_tpu_distmat_fill")
        else:
            cond = distributed.combine_condensed(cond, n, shard)
        if not distributed.is_main():
            return 0
    with metrics.span("cli.emit"):
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
            distmat.emit_full_tsv(fp, names,
                                  distmat.condensed_to_square(cond, n),
                                  use_scientific)
            if close:
                fp.close()
        else:
            fp, close = core.open_output(out_dists)
            distmat.emit_ut_tsv(fp, names, cond, use_scientific)
            if close:
                fp.close()
    return 0


def _shard_tile(sketches) -> int:
    """The stripe width of a multi-process compare of `sketches`, or 0 for
    none (one process, or the per-pair engine, which stays on rank 0)."""
    if distributed.process_count() == 1 or not sketches:
        return 0
    if isinstance(sketches[0], RegisterSketch):
        return pw.DEFAULT_TILE
    return core.HOST_COMPARE_TILE if batch_compare.supports(sketches) else 0


def _shared_mmap(out_dists: str, n: int):
    """The binary matrix file that every rank fills with its own stripes:
    rank 0 lays it out, a barrier orders that before the others attach.
    Stripe boundaries fall at arbitrary byte offsets, so the ranks must
    share one page cache (one host), unless DASHING_TPU_SHARED_MMAP=1
    asserts a coherent parallel file system; else None, and the stripes
    are gathered to rank 0 instead."""
    import socket
    host = np.frombuffer(socket.gethostname().encode()[:64].ljust(64),
                         np.uint8)
    hosts = distributed.allgather_np(host)
    if not ((hosts == hosts[0]).all() or os.environ.get(
            "DASHING_TPU_SHARED_MMAP", "") not in ("", "0")):
        if distributed.is_main():
            eprint(f"note: ranks span multiple hosts; landing {out_dists} "
                   "by stripe gather to rank 0 (set DASHING_TPU_SHARED_MMAP=1"
                   " on a coherent parallel filesystem for rank-local "
                   "writes)")
        return None
    mm = (distmat.create_binary_mmap(out_dists, n) if distributed.is_main()
          else None)
    distributed.barrier("dashing_tpu_distmat_create")
    return mm if mm is not None else distmat.attach_binary_mmap(out_dists, n)


def _rect_emit(sketches, names, o: CommonOpts, result_type: int,
               emit_fmt: int, out_dists: Optional[str], nq: int,
               use_scientific: bool, device, shard: int = 0) -> int:
    """Query x reference emission: headerless float32 rows (nq, nr) for
    -b, with the .labels sidecar of every name (references, then
    queries); otherwise one TSV row a query, whatever -T/-U say.  With
    `shard` (the stripe width) each process computes its reference
    columns and rank 0 writes."""
    nr = len(sketches) - nq
    with metrics.phase("query/reference compare", items=nq * nr,
                       unit="pairs"):
        mat = core.compare_rect(
            sketches[:nr], sketches[nr:], result_type, o.k, o.estim,
            o.jestim, device,
            ref_blocks=distributed.owned_tile_rows(nr, shard) if shard
            else None)
    if shard:
        mat = distributed.combine_columns(mat, nr, shard)
        if not distributed.is_main():
            return 0
    if emit_fmt == BINARY:
        fp, close = core.open_output(out_dists, binary=True)
        fp.write(np.ascontiguousarray(mat, np.float32).tobytes())
        if close:
            fp.close()
        _write_labels(out_dists, names)
    else:
        fp, close = core.open_output(out_dists)
        distmat.emit_rect_tsv(fp, names[nr:], mat, use_scientific)
        if close:
            fp.close()
    return 0


def _nn_emit(sketches, names, o: CommonOpts, result_type: int, emit_fmt: int,
             out_dists: Optional[str], nq: int, device, shard: int = 0
             ) -> int:
    """k-nearest-neighbour mode: TSV rows 'name\tid:value...' or binary
    (u32 rows, u32 nn, then (f32 value, u32 id) records row by row).
    Without -Q every sketch is a query against all the others.  With
    `shard`, each process scans its reference tile stripes (the HLL's
    DEFAULT_TILE, the others' HOST_COMPARE_TILE), and one gather of the
    candidates merges them on rank 0."""
    nn = o.number_neighbors
    n = len(sketches)
    nref = n - nq if nq else n
    npairs = nq if nq else n
    if nn > nref:
        eprint(f"Only reporting {nref} rather than {nn} neighbors due to "
               "their being only that many sets.")
        nn = nref
    refs = sketches[:nref] if nq else sketches
    queries = sketches[nref:] if nq else sketches
    with metrics.phase("nearest-neighbour compare", items=npairs * nref,
                       unit="pairs"):
        if isinstance(sketches[0], HLL):
            vals, order = pw.nn_topk(
                refs, queries, result_type, o.k, o.estim, o.jestim, nn,
                exclude_self=not nq, device=device,
                ref_blocks=(distributed.owned_tile_rows(nref, pw.DEFAULT_TILE)
                            if shard else None))
        else:
            vals, order = core.host_nn_topk(
                refs, queries, result_type, o.k, o.estim, o.jestim, nn,
                not nq, device,
                ref_blocks=(distributed.owned_tile_rows(
                    nref, core.HOST_COMPARE_TILE) if shard else None))
    if shard:
        vals, order = distributed.combine_nn(vals, order, nn,
                                             pw.is_similarity(result_type))
        if not distributed.is_main():
            return 0
    if emit_fmt == BINARY:
        fp, close = core.open_output(out_dists, binary=True)
        fp.write(np.uint32(npairs).tobytes())
        fp.write(np.uint32(nn).tobytes())
        rec = np.zeros(npairs * nn, dtype=[("v", "<f4"), ("i", "<u4")])
        rec["v"] = vals.reshape(-1)
        rec["i"] = order.reshape(-1).astype(np.uint32)
        fp.write(rec.tobytes())
        if close:
            fp.close()
    else:
        fp, close = core.open_output(out_dists)
        fp.write("#File\tNeighbor ID:distance\t...\n")
        distmat.emit_nn_tsv(fp, names[n - npairs:], vals, order)
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
    skip_cached = False
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
            skip_cached = True
            continue
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
    if not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
    p = core.hll_p_from_S(o.sketch_size)
    work = list(enumerate(inpaths))
    if distributed.process_count() > 1:
        # one -o stream has one writer; per-file outputs are written by
        # every process for its stride of the list
        if output_file:
            if not distributed.is_main():
                return 0
        else:
            work = distributed.my_shard(work)
    fnames = {i: core._cache_fname(path, o, wj_ext=False)
              for i, path in work}
    results: dict = {}
    todo = []
    for i, path in work:
        # -c: a file whose sketch file exists is not sketched again
        if skip_cached and os.path.isfile(fnames[i]):
            if output_file:
                results[i] = core.read_sketch_auto(
                    fnames[i], o.sketch_type, o.sketch_type_explicit)
            continue
        todo.append((i, path))

    def land(i, sk):
        if output_file:
            results[i] = sk
        else:
            core.atomic_write_sketch(sk, fnames[i])

    # -b filters every file, -f the FASTQ ones, at the threshold -n
    filter_idx = {i for i, path in todo
                  if o.use_counting_filter
                  or (o.sketch_by_fname and fasta.fname_is_fq(path))}
    if not core.hll_engine(o):
        core.typed_run(todo, o, land, device, filter_idx, o.mincount)
    else:
        cls = core.register_class(o)
        run = core.weighted_run if o.weighted else core.device_hll_run
        run(todo, o, lambda i, regs: land(i, cls(p, o.estim, o.jestim, regs)),
            device, filter_idx=filter_idx, filt_min_count=o.mincount)
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
# card / hll / union / view / fold / printmat / flatten
# ===========================================================================

def card_main(argv: List[str], device) -> int:
    """Cardinalities of the inputs (also `cardcmp`): text, or -b float32."""
    o = CommonOpts()
    use_scientific = False
    emit_binary = False
    out: Optional[str] = None
    querypaths: List[str] = []
    optlist, positional = _getopts(argv, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-b", "--emit-binary"):
            emit_binary = True
        elif flag in ("-e", "--use-scientific"):
            use_scientific = True
        elif flag == "-o":
            out = val
        elif flag in ("-Q", "--query-paths"):
            querypaths = paths.get_paths(val)
        elif flag in ("-h", "-?", "--help"):
            _dist_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        return 1
    if not o.presketched and not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
        querypaths = paths.sort_paths_by_fsize(querypaths)
    inpaths += querypaths
    sketches = core.sketch_paths(inpaths, o, device)
    if not distributed.is_main():
        return 0
    if emit_binary:
        batch_reports([s for s in sketches
                       if isinstance(s, RegisterSketch)], device)
        fp, close = core.open_output(out, binary=True)
        fp.write(np.asarray([s.report() for s in sketches],
                            np.float32).tobytes())
    else:
        fp, close = core.open_output(out)
        core.emit_cardinalities(fp, inpaths, sketches, device, integer=False,
                                use_scientific=use_scientific)
    if close:
        fp.close()
    return 0


def hll_main(argv: List[str], device) -> int:
    """One HLL merged over all inputs -> one cardinality (default -S 24)."""
    o = CommonOpts()
    o.sketch_size = 24
    optlist, positional = _getopts(argv, "Cw:s:S:p:k:F:tfh?", ["help"])
    for flag, val in optlist:
        if flag in ("-t", "-f"):
            continue    # taken without an argument and ignored (JAX CLI)
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-h", "-?", "--help"):
            eprint("usage: hll [-k k] [-S p] [-F paths] files...")
            return 1
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("usage: hll [-k k] [-S p] [-F paths] files...")
        return 1
    core.validate_k(o)
    p = core.hll_p_from_S(o.sketch_size)
    regs = np.zeros(1 << p, np.uint8)
    # every file max-folded into one register set as it lands; several
    # processes: each folds its stride of the files, then one register max
    # all-reduce merges them
    core.device_hll_run(
        distributed.my_shard(list(enumerate(inpaths))), o,
        lambda i, got: np.maximum(regs, got, out=regs), device)
    regs = distributed.global_register_max(regs)
    if not distributed.is_main():
        return 0
    h = HLL(p, o.estim, o.jestim, regs)
    batch_reports([h], device)
    print(f"Estimated number of unique exact matches: {h.report():f}")
    return 0


def union_main(argv: List[str]) -> int:
    """Union of sketch files (HLL and wide HLL register max; -r bottom-k,
    -b Bloom filter, -H exact k-mer hash sets; the other types by the type
    of the first file), gzipped to -o (default stdout)."""
    opath = "/dev/stdout"
    plist: List[str] = []
    sketch_type, explicit = "hll", False
    compression_level = 6
    optlist, positional = _getopts(argv, "p:b:o:F:zZ:rHh?", ["help"])
    for flag, val in optlist:
        if flag in ("-h", "--help", "-?"):
            _union_usage()
        elif flag == "-Z":
            compression_level = int(val)
        elif flag == "-o":
            opath = val
        elif flag == "-F":
            plist = paths.get_paths(val)
        elif flag == "-r":
            sketch_type, explicit = "rmh", True
        elif flag == "-b":
            # the reference's -b takes an argument; the JAX CLI ignores it
            sketch_type, explicit = "bf", True
        elif flag == "-H":
            sketch_type, explicit = "khset", True
    plist += positional
    if not plist:
        _union_usage()

    def read(path):
        return core.read_sketch_auto(path, sketch_type, explicit)

    def merge(into, other):
        if type(other) is not type(into):
            names = sorted({type(into).__name__, type(other).__name__})
            raise SystemExit(f"union: mixed sketch types {names} cannot be "
                             "merged")
        into += other
        return into

    merged = read(plist[0])
    if type(merged) is HLL and distributed.process_count() > 1:
        # each process folds its stride of the files, then one register
        # max all-reduce merges the strides
        part = HLL(merged.p, merged.estim, merged.jestim)
        for path in distributed.my_shard(plist):
            merge(part, read(path))
        merged.regs = distributed.global_register_max(part.regs)
        merged._card = None
    else:
        for path in plist[1:]:
            merge(merged, read(path))
    if not distributed.is_main():
        return 0
    if opath in ("-", "/dev/stdout"):
        # gzipped on stdout too, so that every subcommand reads it back
        with gzip.GzipFile(fileobj=sys.stdout.buffer, mode="wb",
                           compresslevel=compression_level) as fp:
            merged.write_record(fp)
    else:
        with gzip.open(opath, "wb", compresslevel=compression_level) as fp:
            merged.write_record(fp)
    return 0


# DTPU container header field names, by magic (the JAX CLI's table): every
# container is a gzip member holding the 8-byte magic (7 family characters
# and a version digit), then little-endian fields; all but HLL's are two
# u32s
_HDR_FIELDS = {
    b"DTPUHLL1": ("p", "estim", "jestim", "flags"),          # BBBB + u32 rsvd
    b"DTPUBF01": ("nbits_log2", "nhashes"),
    b"DTPURMH1": ("k", "n_values"),
    b"DTPUCRM1": ("k", "n_values"),
    b"DTPUBBM1": ("p", "b"),
    b"DTPUCBB1": ("p", "b"),
    b"DTPUWHL1": ("p", "estim_jestim_packed"),
    b"DTPUHMH1": ("p", "regwidth"),
    b"DTPUSMH1": ("p", "b"),
    b"DTPUSMH2": ("p", "b"),
}


def _view_header(path: str, fp) -> None:
    """The raw container header (magic, family, version, endianness,
    header fields, payload bytes), without parsing the payload."""
    try:
        g = gzip.open(path, "rb")
        head = g.read(16)
    except OSError:
        raise SystemExit(f"view --header: {path} is not a gzip container")
    with g:
        magic = head[:8]
        fields = _HDR_FIELDS.get(magic)
        if fields is None and not path.endswith(".khs") and len(head) < 16:
            raise SystemExit(f"view --header: {path}: truncated container "
                             f"({len(head)} bytes)")
        if fields is not None and len(head) < 16:
            raise SystemExit(f"view --header: {path}: truncated "
                             f"{magic.decode(errors='replace')} header "
                             f"({len(head)} bytes)")
        rest = lambda used: len(head) - used + sum(  # noqa: E731
            len(c) for c in iter(lambda: g.read(1 << 20), b""))
        if fields is None:
            if path.endswith(".khs"):
                if len(head) < 8:
                    raise SystemExit(f"view --header: {path}: truncated "
                                     ".khs header")
                n = struct.unpack("<Q", head[:8])[0]
                fp.write(f"{path}\tformat=khs (reference khset64, no magic)"
                         f"\tendian=little\tn_keys={n}"
                         f"\tpayload_bytes={rest(8)}\n")
                return
            raise SystemExit(
                f"view --header: {path}: unknown magic {head[:8]!r}")
        fmt = "<BBBBI" if magic == b"DTPUHLL1" else "<II"
        vals = struct.unpack(fmt, head[8:16])[:len(fields)]
        kv = "\t".join(f"{k}={v}" for k, v in zip(fields, vals))
        fp.write(f"{path}\tmagic={magic.decode()}"
                 f"\tfamily={core.MAGIC_TYPES[magic]}\tversion={chr(magic[7])}"
                 f"\tendian=little\t{kv}\tpayload_bytes={rest(16)}\n")


def _view_dump(sk, fp) -> None:
    """A sketch's dump: an HLL's register dump (`printf`); for the set
    sketches the class name, its public scalars, then each public array,
    16 values a line (the JAX CLI's listing, attribute by attribute)."""
    if hasattr(sk, "printf"):
        sk.printf(fp)
        return
    fp.write(type(sk).__name__)
    for name, val in sorted(vars(sk).items()):
        if name.startswith("_"):
            continue
        if isinstance(val, (int, float, bool, str)):
            fp.write(f" {name}={val}")
    fp.write("\n")
    for name, val in sorted(vars(sk).items()):
        if name.startswith("_") or not isinstance(val, np.ndarray):
            continue
        flat = val.reshape(-1)
        fp.write(f"{name} n={flat.size} dtype={flat.dtype}\n")
        for i in range(0, flat.size, 16):
            row = " ".join(str(v) for v in flat[i:i + 16])
            fp.write(f"{i}\t{row}\n")


def view_main(argv: List[str]) -> int:
    """Dumps of sketch files (any family the port reads), or with
    --header/-H every container's header."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    header_only = False
    paths_ = []
    for a in argv:
        if a in ("--header", "-H"):
            header_only = True
        else:
            paths_.append(a)
    if not paths_:
        raise SystemExit("Usage: view [--header] f1.hll [f2.bf ...] "
                         "(type auto-detected from the file magic)")
    for path in paths_:
        if header_only:
            _view_header(path, sys.stdout)
        else:
            _view_dump(core.read_sketch_auto(path), sys.stdout)
    return 0


def fold_main(argv: List[str]) -> int:
    """Fold an HLL or a wide HLL exactly to a smaller precision (-p;
    default p - 1)."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    out, inp, destp = "/dev/stdout", "/dev/stdin", -1
    optlist, positional = _getopts(argv, "p:o:h?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            out = val
        elif flag == "-p":
            destp = int(val)
        else:
            eprint("Usage: fold [-o out] [-p destp] in.hll")
            return 1
    if positional:
        inp = positional[0]
    # a stream (/dev/stdin) is not sniffed: that would consume its magic
    h = core.read_sketch_auto(inp) if os.path.isfile(inp) else HLL.read(inp)
    if not hasattr(h, "compress"):
        raise SystemExit(f"fold: {type(h).__name__} sketches have no "
                         "precision fold (only hll/wide_hll registers do)")
    if destp <= 0:
        destp = h.p - 1
    h.compress(destp).write(out if out != "-" else "/dev/stdout")
    return 0


def printmat_main(argv: List[str]) -> int:
    """A binary distance matrix (`dist -b`) as text."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    use_scientific = False
    outpath = ""
    optlist, positional = _getopts(argv, "o:sh?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
        elif flag == "-s":
            use_scientific = True
        else:
            eprint("printmat <binary matrix> [-o out] [-s]")
            return 1
    if not positional:
        eprint("printmat <binary matrix> [-o out] [-s]")
        return 1
    fp, close = core.open_output(outpath or None)
    distmat.print_binary(positional[0], fp, use_scientific)
    if close:
        fp.close()
    return 0


def flatten_main(argv: List[str]) -> int:
    """Per-k binary matrices -> one flattened container."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    optlist, positional = _getopts(argv, "o:k:h?", ["help"])
    out = "flattened.bin"
    ks: List[int] = []
    for flag, val in optlist:
        if flag == "-o":
            out = val
        elif flag == "-k":
            ks = [int(x) for x in val.split(",")]
    if not positional or len(ks) != len(positional):
        eprint("flatten -o out -k k1,k2,... mat1 mat2 ...")
        return 1
    return distmat.flatten_all(positional, out, ks)


# ===========================================================================
# mkdist (--multik): per-k matrices, flattened, in process
# ===========================================================================

def _mkdist_presketch(rest: List[str], ks: List[int], device):
    """Sketch every input at every k not yet cached, from one parse and
    one upload a chunk (pipeline.sketch_file_hll_multik), into the -W
    cache that the per-k dist passes then read, with each register row
    parked on the device for their compares.  Returns (extra dist
    arguments, cleanup), or (None, None) where the run cannot be fused
    (queries, a count-min filter, presketched inputs, the rolling hashes,
    entropy minimizers, weighted Jaccard, k outside 4..32, several
    processes): the per-k passes then sketch alone.  Unlike the JAX
    package, which falls back to per-k sketching on any exception here, a
    device or kernel error raises."""
    if distributed.process_count() > 1:
        return None, None          # the per-k passes split their work
    o = CommonOpts()
    try:
        optlist, positional = _getopts(list(rest), DIST_SHORT_OPTS, DIST_LONG)
    except SystemExit:
        return None, None
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-Q", "--query-paths"):
            return None, None
    if (o.sketch_type != "hll" or o.use_counting_filter or o.presketched
            or o.sketch_by_fname or o.encoding != "bonsai" or o.entropy_min
            or o.weighted):
        return None, None
    if not ks or not all(4 <= k <= 32 for k in ks):
        return None, None
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        return None, None
    extra: List[str] = []
    cleanup = None
    if not o.cache_sketch:
        # no -W from the user: a private cache, threaded through the per-k
        # passes and removed at the end
        tmpdir = tempfile.mkdtemp(prefix="dashing_tpu_torch_mkdist_")
        o.prefix, o.cache_sketch = tmpdir, True
        extra = ["-W", "-P", tmpdir]
        def cleanup():
            shutil.rmtree(tmpdir, ignore_errors=True)
    p = core.hll_p_from_S(o.sketch_size)
    try:
        for path in inpaths:
            todo = []
            for k in ks:
                o_k = dataclasses.replace(o, k=k)
                fname = core._cache_fname(path, o_k)
                if not os.path.isfile(fname):     # a user's cache file wins
                    todo.append((core.sketch_params(o_k), fname))
            if not todo:
                continue
            regs_list, dev_list = pipeline.sketch_file_hll_multik(
                path, [t[0] for t in todo], p, device, keep_device=True)
            for (_, fname), regs, dev in zip(todo, regs_list, dev_list):
                core.atomic_write_sketch(HLL(p, o.estim, o.jestim, regs),
                                         fname)
                pipeline.device_rows_put(fname, dev)
    except BaseException:
        if cleanup:
            cleanup()
        raise
    return extra, cleanup


def mkdist_main(argv: List[str], device) -> int:
    """`mkdist --multik <outpref>,<start>,<end>[,<step>] [--jukes-cantor]
    <dist options>`: one binary matrix a k (`_<outpref>_<k>`), flattened
    into <outpref>.bin; with --jukes-cantor the sizes matrices also give
    Jukes-Cantor distances in <outpref>.jcd."""
    multik = None
    jukes_cantor = False
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--multik":
            multik = argv[i + 1]
            i += 2
            continue
        if a.startswith("--multik="):
            multik = a.split("=", 1)[1]
        elif a == "--jukes-cantor":
            jukes_cantor = True
        else:
            rest.append(a)
        i += 1
    if not multik:
        eprint("mkdist: --multik <outpref>,<start>,<end>[,<step>] plus dist "
               "options")
        return 1
    parts = multik.split(",")
    outpref, start, end = parts[0], int(parts[1]), int(parts[2])
    step = int(parts[3]) if len(parts) > 3 else (1 if end > start else -1)
    if (end > start) != (step > 0):
        step = -step
    ks = list(range(start, end, step))
    fpaths = []
    # the per-k passes read every input again: keep the joined bytes
    pipeline.set_join_cache(True)
    cleanup = None
    try:
        extra, cleanup = _mkdist_presketch(rest, ks, device)
        for k in ks:
            outp = f"_{outpref}_{k}"
            # the per-k flags after the user's: getopt keeps the last, so
            # a user's -k or -O cannot override the pass's own, and the
            # private cache's -W -P come last of all
            args = rest + ["-b", "-O", outp, "-k", str(k)] + (extra or [])
            if jukes_cantor:
                # Jukes-Cantor needs the intersection sizes and the paths'
                # own order, each added on its own
                if "--sizes" not in args and "-Z" not in args:
                    args = ["--sizes"] + args
                if "--avoid-sorting" not in args and "-n" not in args:
                    args = ["--avoid-sorting"] + args
            rc = dist_main(args, device)
            if rc != 0:
                return rc
            fpaths.append(outp)
    finally:
        pipeline.set_join_cache(False)
        pipeline.device_rows_clear()
        if cleanup:
            cleanup()
    # the per-k passes split their compares; flattening has one writer
    if not distributed.is_main():
        return 0
    eprint("Finished distance matrix calculations. Now flattening")
    rc = distmat.flatten_all(fpaths, outpref + ".bin", ks)
    if rc != 0 or not jukes_cantor:
        return rc
    optlist, gpaths = _getopts(rest, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if flag in ("-F", "--paths"):
            gpaths = paths.get_paths(val)
    jc = mkmat2jcdistmat(outpref + ".bin", gpaths)
    distmat.write_binary(outpref + ".jcd", jc, len(gpaths))
    eprint(f"Wrote Jukes-Cantor distances to {outpref}.jcd")
    return 0


# ===========================================================================
# sketch_by_seq / dist_by_seq (HLL)
# ===========================================================================

def sketch_by_seq_main(argv: List[str], device) -> int:
    """One sketch a FASTA/FASTQ record (an HLL, or the set sketch of a
    type flag), into one gzip stream, with a .names sidecar headed
    '#k=<k>:'.  With -b -n N a record keeps the k-mers it holds at least N
    times, counted exactly within the record."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    o = CommonOpts()
    o.mincount = 1
    outpath = "/dev/stdout"
    optlist, positional = _getopts(
        argv, "o:n:P:p:x:R:s:S:k:w:H:q:B:8JbfjEIcCeh?", SKETCH_LONG)
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
        elif flag == "-b":
            o.use_counting_filter = True
        elif flag == "-n":
            o.mincount = int(val)
        elif flag == "-q":
            o.cmsketchsize = int(val)
        elif flag == "-H":
            o.nhashes = int(val)
        elif core.parse_common(o, flag, val):
            continue
        elif flag in ("-h", "-?", "--help"):
            eprint("sketch_by_seq [opts] input.fa")
            return 1
    core.validate_k(o)
    inpath = positional[0] if positional else "/dev/stdin"
    params = core.sketch_params(o)
    namepath = ("stdout.names" if outpath == "/dev/stdout"
                else outpath + ".names")
    p = core.hll_p_from_S(o.sketch_size)
    use_filter = o.use_counting_filter and o.mincount > 1
    raw_params = dataclasses.replace(params, rehash=False)
    records = fasta.iter_records_full(inpath)
    with open(namepath, "w") as namefp, gzip.open(outpath, "wb") as ofp:
        namefp.write(f"#k={o.k}:Names for sequences sketched\n")
        while True:
            batch = list(itertools.islice(records, 2048))
            if not batch:
                break
            for name, _, _, _ in batch:
                namefp.write(name.decode() + "\n")
            seqs = [seq for _, _, seq, _ in batch]
            if use_filter or o.sketch_type != "hll":
                # a set sketch inserts each record's raw k-mers on the
                # host; the filter counts the within-record multiplicity
                # exactly on them (WangHash is a bijection), as the JAX
                # CLI does
                for raw in pipeline.records_kmer_hashes(seqs, raw_params,
                                                        device):
                    if use_filter:
                        vals, cnts = np.unique(raw, return_counts=True)
                        raw = vals[cnts >= o.mincount]
                    if o.sketch_type == "hll":
                        sk = HLL(p, o.estim, o.jestim)
                        sk.addh_np(raw)
                    else:
                        sk = sketch_of_values(o.sketch_type, o, raw)
                    sk.write_record(ofp)
            else:
                for row in pipeline.sketch_records_hll(seqs, params, p,
                                                       device):
                    HLL(p, o.estim, o.jestim, row).write_record(ofp)
    return 0


# dist_by_seq's sketch-type letters
_DBS_TYPES = {"-B": "bf", "-S": "bbmh", "-8": "bbmh", "-r": "rmh",
              "-K": "khset"}


def dist_by_seq_main(argv: List[str], device) -> int:
    """Compare the per-record sketches of one sketch_by_seq stream: all
    pairs (condensed), or with -q the records of a second stream as
    queries (rows).  HLL records, or with -B/-S/-8/-r/-K the Bloom
    filter, b-bit MinHash, bottom-k or exact k-mer hash set records of
    such a stream."""
    o = CommonOpts()
    outpath = "/dev/stdout"
    namefile = ""
    otherpath = ""
    emit_fmt = UT_TSV
    result_type = pw.JI
    k = -1
    long_opts = ["containment-index", "containment-dist", "mash-dist",
                 "symmetric-containment-index", "symmetric-containment-dist",
                 "sizes", "help"]
    optlist, positional = _getopts(argv, "q:o:k:n:p:EIJMBbS8KCTrUh?",
                                   long_opts)
    for flag, val in optlist:
        if flag in _DBS_TYPES:
            o.sketch_type = _DBS_TYPES[flag]
        elif flag == "-p":
            o.nthreads = int(val)
        elif flag == "-o":
            outpath = val
        elif flag == "-E":
            o.estim = o.jestim = est.ORIGINAL
        elif flag == "-I":
            o.estim = o.jestim = est.ERTL_IMPROVED
        elif flag == "-J":
            o.jestim = est.ERTL_JOINT_MLE
        elif flag in ("-M", "--mash-dist"):
            result_type = pw.MASH_DIST
        elif flag == "--containment-index":
            result_type = pw.CONTAINMENT_INDEX
        elif flag == "--containment-dist":
            result_type = pw.CONTAINMENT_DIST
        elif flag == "--symmetric-containment-index":
            result_type = pw.SYMMETRIC_CONTAINMENT_INDEX
        elif flag == "--symmetric-containment-dist":
            result_type = pw.SYMMETRIC_CONTAINMENT_DIST
        elif flag in ("-Z", "--sizes"):
            result_type = pw.SIZES
        elif flag == "-k":
            k = int(val)
        elif flag == "-n":
            namefile = val
        elif flag == "-q":
            otherpath = val
        elif flag == "-b":
            emit_fmt = BINARY
        elif flag == "-T":
            emit_fmt = FULL_TSV
        elif flag == "-U":
            emit_fmt = PHYLIP
        elif flag in ("-h", "-?", "--help"):
            _dbs_usage()
    if len(positional) != 1 or not namefile:
        _dbs_usage()
    labels = paths.get_paths(namefile)
    if labels and labels[0].startswith("#k="):
        if k <= 0:
            try:
                k = int(labels[0][3:].split(":")[0])
            except ValueError:
                k = 31
        labels = labels[1:]
    if k <= 0:
        k = 31
    with gzip.open(positional[0], "rb") as fp:
        sketches = [core.read_sketch_auto(fp, o.sketch_type)
                    for _ in labels]
    if otherpath:
        qnames = [q for q in paths.get_paths(otherpath + ".names")
                  if not q.startswith("#k=")]
        with gzip.open(otherpath, "rb") as qfp:
            qsketches = [core.read_sketch_auto(qfp, o.sketch_type)
                         for _ in qnames]
    for sk in sketches:
        if hasattr(sk, "estim"):
            sk.estim = o.estim
        if hasattr(sk, "jestim"):
            sk.jestim = o.jestim
    # several processes: the compare splits into stripes as dist's does
    shard = _shard_tile(sketches)
    if not distributed.is_main() and not shard:
        return 0
    if otherpath:
        mat = core.compare_rect(
            sketches, qsketches, result_type, k, o.estim, o.jestim, device,
            ref_blocks=(distributed.owned_tile_rows(len(sketches), shard)
                        if shard else None))
        if shard:
            mat = distributed.combine_columns(mat, len(sketches), shard)
            if not distributed.is_main():
                return 0
        fp, close = core.open_output(outpath, binary=(emit_fmt == BINARY))
        if emit_fmt == BINARY:
            fp.write(np.ascontiguousarray(mat, np.float32).tobytes())
        else:
            distmat.emit_rect_tsv(fp, qnames, mat)
    else:
        if not pw.is_symmetric(result_type):
            raise SystemExit("Can't perform asymmetric comparison without "
                             "query paths")
        cond = core.compare_condensed(
            sketches, result_type, k, o.estim, o.jestim, device,
            row_blocks=(distributed.owned_tile_rows(len(sketches), shard)
                        if shard else None))
        if shard:
            cond = distributed.combine_condensed(cond, len(sketches), shard)
            if not distributed.is_main():
                return 0
        fp, close = core.open_output(outpath, binary=(emit_fmt == BINARY))
        if emit_fmt == BINARY:
            distmat.write_binary(fp, cond, len(labels))
        elif emit_fmt == PHYLIP:
            distmat.emit_phylip(fp, labels, cond)
        elif emit_fmt == FULL_TSV:
            distmat.emit_full_tsv(
                fp, labels, distmat.condensed_to_square(cond, len(labels)))
        else:
            distmat.emit_ut_tsv(fp, labels, cond)
    if close:
        fp.close()
    return 0


# ===========================================================================
# panel: query genomes against a sketch database
# ===========================================================================

def panel_main(argv: List[str], device) -> int:
    """`panel <db> <query> [-F] [-o out]`: each query's best match in a
    `sketch -o` database by containment (the joint MLE), one row a query:
    '#Query BestMatch Containment Jaccard'."""
    o = CommonOpts()
    outpath = "/dev/stdout"
    filesinfile = False
    optlist, positional = _getopts(argv, "p:o:k:S:Fh?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
        elif flag == "-F":
            filesinfile = True
        else:
            core.parse_common(o, flag, val)
    if len(positional) != 2:
        eprint("panel <sketch-db> <query> [-F: query is a file of paths] "
               "[-o out]")
        return 1
    dbpath, inpath = positional
    labels_path = (dbpath + ".labels" if os.path.exists(dbpath + ".labels")
                   else dbpath + ".labels.gz")
    if labels_path.endswith(".gz"):
        with gzip.open(labels_path, "rt") as lf:
            labels = [line.strip() for line in lf if line.strip()]
    else:
        labels = [line for line in paths.get_paths(labels_path) if line]
    with gzip.open(dbpath, "rb") as fp:
        refs = [HLL.read_record(fp) for _ in labels]
    qpaths = paths.get_paths(inpath) if filesinfile else [inpath]
    o.sketch_size = refs[0].p
    core.validate_k(o)
    p = refs[0].p
    # the queries through the sketch engine, then one query x reference
    # pass of the joint MLE (K4's joint form and K5)
    queries: List = [None] * len(qpaths)
    core.device_hll_run(
        list(enumerate(qpaths)), o,
        lambda i, regs: queries.__setitem__(
            i, HLL(p, o.estim, est.ERTL_JOINT_MLE, regs)), device)
    # several processes: every one sketches the queries, computes its
    # reference tile stripes, and rank 0 writes
    shard = distributed.process_count() > 1
    tri = pw.rect_triples(
        refs, queries, o.estim, est.ERTL_JOINT_MLE, device,
        ref_blocks=(distributed.owned_tile_rows(len(refs), pw.DEFAULT_TILE)
                    if shard else None))
    if shard:
        tri = distributed.combine_columns(tri, len(refs), pw.DEFAULT_TILE)
        if not distributed.is_main():
            return 0
    # lhs = reference, so t1 is the query's own mass
    shared = tri[..., 2]
    cont = np.where(tri[..., 1] + shared > 0,
                    shared / np.maximum(tri[..., 1] + shared, 1e-30), 0.0)
    union = tri.sum(-1)
    ji = np.where(union > 0, shared / np.maximum(union, 1e-30), 0.0)
    fp, close = core.open_output(outpath)
    fp.write("#Query\tBestMatch\tContainment\tJaccard\n")
    for qi, qp in enumerate(qpaths):
        best = int(np.argmax(cont[qi]))          # the first maximum
        fp.write(f"{qp}\t{labels[best]}\t{cont[qi, best]:.6g}"
                 f"\t{ji[qi, best]:.6g}\n")
    if close:
        fp.close()
    return 0


# ===========================================================================
# readfilt: the reads (or read pairs) contained in a reference sketch
# ===========================================================================

READFILT_USAGE = "readfilt -s ref.hll [-k 21] [-f 0.5] reads.fq [mates.fq]"


def readfilt_main(argv: List[str], device) -> int:
    """Stream reads (pairs from two files, mates joined by N x halo so no
    k-mer spans them) and write each one whose containment index in the
    reference, shared / (onlyRead + shared) by the joint MLE, reaches -f,
    in the JAX CLI's format: FASTQ mate 1 '@name comment|CI:%lf|onlyq|
    onlyref|shared|', later mates and FASTA records '...|%lf'; a mate 1
    without qualities makes the pair FASTA."""
    if not distributed.is_main():     # one writer: rank 0
        return 0
    o = CommonOpts()
    o.k = 21
    hllpath = ""
    frac_cutoff = 0.5
    opath = None
    optlist, positional = _getopts(argv, "Chk:s:f:o:?", ["help"])
    for flag, val in optlist:
        if flag == "-s":
            hllpath = val
        elif flag == "-f":
            frac_cutoff = float(val)
        elif flag == "-k":
            o.k = int(val)
        elif flag == "-o":
            opath = val
        elif flag == "-C":
            o.canon = False
        elif flag in ("-h", "-?", "--help"):
            eprint(READFILT_USAGE)
            return 1
    if not positional or not hllpath:
        eprint(READFILT_USAGE)
        return 1
    core.validate_k(o)
    ref = HLL.read(hllpath)
    params = core.sketch_params(o)
    sep = b"N" * params.spacer().halo
    ref_regs = torch.from_numpy(ref.regs.astype(np.int32)).to(device)
    ref_hist = torch.from_numpy(ref.histogram()).to(device)
    fp, close = core.open_output(opath)
    streams = [fasta.iter_records_full(path) for path in positional[:2]]
    end = object()
    if len(streams) == 2:
        pairs = itertools.zip_longest(*streams, fillvalue=end)
    else:
        pairs = ((rec,) for rec in streams[0])
    truncated = False
    # the reference's cardinality, estimated once a level window
    ref_card = reference_cardinalities(ref_hist, ref.p)
    while True:
        with metrics.accum("readfilt.parse"):
            batch = []
            for recs in pairs:
                if end in recs:
                    eprint("Warning: mismatched numbers of reads between "
                           "paired-end files")
                    truncated = True
                    break
                batch.append(recs)
                if len(batch) >= pipeline.READFILT_BATCH:
                    break
        if not batch:
            break
        seqs = [sep.join(r[2] for r in recs) for recs in batch]
        tri = pipeline.records_joint_triples(seqs, params, ref_regs,
                                             ref_hist, ref.p, device,
                                             ref_card=ref_card)
        denom = tri[:, 0] + tri[:, 2]
        ci = np.where(denom > 0, tri[:, 2] / np.maximum(denom, 1e-300), 0.0)
        with metrics.accum("readfilt.emit"):
            for recs, c, tr in zip(batch, ci, tri):
                if c < frac_cutoff:
                    continue
                fastq = recs[0][3] is not None
                for mate, (name, comment, seq, qual) in enumerate(recs):
                    nm, cm = name.decode(), comment.decode()
                    if not fastq:
                        fp.write(f">{nm} {cm}|{c:.6f}\n{seq.decode()}\n")
                        continue
                    q = qual.decode() if qual is not None else ""
                    if mate == 0:
                        fp.write(f"@{nm} {cm}|CI:{c:.6f}|{tr[0]:.6f}"
                                 f"|{tr[1]:.6f}|{tr[2]:.6f}|\n"
                                 f"{seq.decode()}\n+\n{q}\n")
                    else:
                        fp.write(f"@{nm} {cm}|{c:.6f}\n{seq.decode()}"
                                 f"\n+\n{q}\n")
        if truncated or len(batch) < pipeline.READFILT_BATCH:
            break
    if close:
        fp.close()
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
        "  --containment-index, --containment-dist, --full-containment-dist"
        "  asymmetric\n"
        "  -Q/--query-paths FILE   query x reference rows (one path a line)\n"
        "  --nearest-neighbors N   the N nearest references of each query\n"
        "  -b binary, -U phylip, -T full TSV (default upper-triangular TSV)\n"
        "  -E/-I/-m                estimator: original/improved/MLE\n"
        "  -J/--ertl-joint-mle     set comparisons by the joint MLE\n"
        "  -C no canonicalization, -H presketched inputs, -e scientific\n"
        "  -y/--countmin           count-min filter: admit k-mers seen at "
        "least -c times [5, floored at 2]\n"
        "  -c/-q/-t/-R             threshold, rows, log2 counters a row "
        "[20], seed [1337]\n"
        "  -W/--cache-sketches     load and write sketches beside the "
        "inputs\n"
        "  --wj, --wj-exact        weighted Jaccard (count-min or exact "
        "counts);\n"
        "  --wj-cm-sketch-size/--wj-cm-nhashes  its count-min [22, 10]\n"
        "  -8/--use-bb-minhash [-B bits], --use-counting-bb-minhash,\n"
        "  --use-range-minhash, --use-counting-range-minhash,\n"
        "  --use-bloom-filter,\n"
        "  --use-hyperminhash, --use-superminhash [-B bits]\n"
        "                          set sketches instead of HLL\n"
        "  --use-wide-hll          HLL with 16-bit registers\n"
        "  --use-full-khash-sets (--use-full-hash-sets, --use-hash-sets,\n"
        "  --hash-sets, --use-full-sets)  exact k-mer sets (.khs)\n"
        "  DASHING_TPU_USE_HK=1    count filter through HeavyKeeper\n")


def _sketch_usage():
    raise SystemExit("Usage: sketch <opts> [genomes...]; see dist for shared "
                     "options; -o writes all sketches to one stream; -b "
                     "count-min filters every file, -f the FASTQ ones, at "
                     "-n [1] with -q log2 counters a row and -H rows")


def _dbs_usage():
    raise SystemExit("Usage: dist_by_seq -n namefile [opts] sketchstream.gz")


def _union_usage():
    raise SystemExit("Usage: union [-o out] [-Z level] [-F paths] "
                     "[-r | -b x | -H] f1.hll f2.hll ...")


SUBCOMMANDS = {
    "sketch": sketch_main,
    "dist": dist_main,
    "cmp": dist_main,
    "setdist": dist_main,
    "card": card_main,
    "cardcmp": card_main,
    "hll": hll_main,
    "mkdist": mkdist_main,
    "sketch_by_seq": sketch_by_seq_main,
    "sbs": sketch_by_seq_main,
    "dist_by_seq": dist_by_seq_main,
    "cmp_by_seq": dist_by_seq_main,
    "panel": panel_main,
    "readfilt": readfilt_main,
}
# the file tools: run on the host, take no device
HOST_SUBCOMMANDS = {
    "union": union_main,
    "view": view_main,
    "fold": fold_main,
    "printmat": printmat_main,
    "flatten": flatten_main,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    eprint(f"dashing_tpu_torch version: {__version__}")
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit("Usage: dashing_tpu_torch <subcommand> [options...]\n"
                         "Subcommands: " + ", ".join(SUBCOMMANDS)
                         + ", " + ", ".join(HOST_SUBCOMMANDS))
    cmd = argv[0]
    # several processes (DASHING_TPU_DISTRIBUTED=1): join the process group
    # before the device is resolved, then give the rank its card
    distributed.maybe_initialize()
    if cmd in HOST_SUBCOMMANDS:
        run = HOST_SUBCOMMANDS[cmd]
    elif cmd in SUBCOMMANDS:
        try:
            device = distributed.rank_device(devmod.from_env())
        except RuntimeError as e:
            raise SystemExit(f"{cmd}: {e}")
        run = lambda args: SUBCOMMANDS[cmd](args, device)  # noqa: E731
    else:
        raise NotPorted(f"the {cmd!r} subcommand")
    try:
        rc = run(argv[1:])
    except (FileNotFoundError, IsADirectoryError) as e:
        raise SystemExit(f"{cmd}: {e}")
    except NotImplementedError as e:
        raise SystemExit(f"{cmd}: {e}")
    except (EOFError, ValueError, OSError) as e:
        if os.environ.get("DASHING_TPU_DEBUG"):
            raise
        raise SystemExit(f"{cmd}: {type(e).__name__}: {e}")
    metrics.summary()
    return rc


def readfilt_entry() -> int:
    """The standalone readfilt (console script dashing_tpu_torch_readfilt)."""
    return main(["readfilt"] + sys.argv[1:])


def cardcmp_entry() -> int:
    """The standalone cardcmp (console script dashing_tpu_torch_cardcmp)."""
    return main(["cardcmp"] + sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
