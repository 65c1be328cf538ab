#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_profile.py [--reps 3] [--only NAME] [--fastq-reads N]
                            [--no-trace]
    python3 chip_profile.py --other DIR [--reps N]

Six workloads, each run `--reps` times untraced and then once under
torch.profiler (not with --no-trace):
  config 2   `dist -k 31 -S 16 -M -b -O ... -o ...` through the CLI entry on
             the 100 synthetic 5 Mbp genomes of chip_smoke.py (same seed),
             with the DASHING_TPU_METRICS buckets of every untraced run;
  n1024      all_pairs_condensed over the 1024-sketch p=14 bank of
             chip_smoke.py's K3 phase (one 1024 x 1024 tile, Mash, MLE):
             K4's X-only form (cum_union), the marginals and K3;
  j1000      the same engine with the joint MLE (-J) over the 1000-sketch
             p=14 bank of chip_smoke.py's K4 phase (one 1000 x 1000 tile,
             Mash): kernels K4 and K5;
  fastq      BASELINE.json config 3: `sketch -k 31 -S 16` over the FASTQ
             read set of chip_smoke.py's e2e (f) (--fastq-reads reads of
             100 bases, default 1 M), plain and count-min filtered (-b -n 2
             -q 28), with the buckets of each run: host.parse,
             sketch.cm_count and sketch.cm_admit (the host wall of each
             pass); then the count-min kernels (csrc/countmin.cu) on one
             of the file's 256-row tiles, into the table a pass over the
             file leaves, and its upload, timed with CUDA events;
  rect       chip_smoke.py's e2e (g) shapes: first both K4 forms on its
             1000 x 500 reference x query tile and on the transpose, kernel
             alone; then its 1000 p=14 reference .hll files and 500 queries, `dist -k 31 -H -Q q.txt -M -b` and
             `dist -k 31 -H -Q q.txt --nearest-neighbors 5` through the
             CLI entry, with the buckets of every untraced run: sketch
             (loading the .hll files), cardinality (-o),
             compare.stack_upload (stacking each bank's registers and
             uploading them), compare.dispatch (queueing
             each tile's kernels, and the device top-k in NN mode),
             compare.pull (waiting for and copying each tile's result, or
             its (qt, nn) candidates), nn.merge (the host argsort merge).
  smallfiles chip_smoke.py's e2e (h): its 1,000 FASTA genomes of 200 kbp,
             the sketch phase alone (cli/core.sketch_paths, k21 S14: 16
             banked K1 launches) with the buckets of every untraced run:
             host.parse (the prefetch worker's parse and join),
             host.pack2bit, sketch.dispatch (upload and launch of each
             batch), sketch.pull; beside it the per-file loop
             (pipeline.sketch_file_hll a file), in turns with it; and
             the host time of writing the 1,000 sketches as `sketch -o`
             writes them (one gzip stream at level 9) and as -W writes
             them (one gzip file each, written then renamed).
With --other DIR it runs none of them: it times the single register
forms of K1 and K2 (csrc/encode_hash.cu) of the checkout at DIR against
this one's, kernel alone, in turns (other, this, this, other) at
chip_smoke.py's three encode/hash shapes.
For the traced run it prints the profiler's table (top ops by self device
time) and the device busy share of that one run: the union of the device
activity intervals in the trace over the run's wall clock.  The profiler
slows the host, so that share is a lower bound for an untraced run.

Everything printed also goes to chiprun_out/profile.log.  Needs CUDA; exits
non-zero without it.
"""
from __future__ import annotations

import argparse
import gzip
import os
import shutil
import subprocess
import sys
import tempfile
import time

os.environ["DASHING_TPU_METRICS"] = "1"   # read when dashing_tpu_torch.metrics loads

import numpy as np  # noqa: E402

LOG_PATH = os.path.join("chiprun_out", "profile.log")
_log_fp = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_fp is not None:
        _log_fp.write(msg + "\n")
        _log_fp.flush()


def device_busy(prof) -> tuple:
    """(seconds, events): union of the device-side intervals in a trace."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, len(spans)


def traced(label: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=15, max_name_column_width=60))
    busy, nev = device_busy(prof)
    log(f"[{label} traced] wall {wall:.4f}s, device busy {busy:.4f}s over "
        f"{nev} device events, busy share {busy / wall:.4f} (one traced run)")


def buckets() -> str:
    from dashing_tpu_torch import metrics
    out = ", ".join(f"{k} {v:.3f}s" for k, v in sorted(metrics._totals.items()))
    metrics._totals.clear()
    metrics._counts.clear()
    return out


def config2(dev, reps: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.cli.main import main
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    tmp = tempfile.mkdtemp(prefix="dtt_profile_")
    try:
        genomes = chip_smoke._write_genomes(tmp, 20, 5_000_000, rng)
        paths = [g[0] for g in genomes]
        argv = ["dist", "-k", "31", "-S", "16", "-M", "-b",
                "-O", os.path.join(tmp, "d.bin"),
                "-o", os.path.join(tmp, "sizes.txt"), "--avoid-sorting"] + paths

        def run():
            if main(list(argv)) != 0:
                raise SystemExit("config 2 dist returned nonzero")

        run()                     # warm-up: builds, first-touch
        buckets()
        for r in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            log(f"[config2] rep {r} wall {time.perf_counter() - t0:.4f}s; "
                f"buckets: {buckets()}")
        if trace:
            traced("config2", run)
        buckets()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def n1024(dev, reps: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    p, n = 14, 1024
    bank, _ = chip_smoke._k3_bank(dev, p, n)
    sketches = [HLL.from_numpy(r, p) for r in bank.cpu().numpy()]

    def run():
        pw.all_pairs_condensed(sketches, pw.MASH_DIST, 21, est.ERTL_MLE,
                               est.ERTL_MLE, dev)

    run()
    for r in range(reps):
        js.cum_union_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[n1024] rep {r} compare {dt:.4f}s, "
            f"{n * (n - 1) / 2 / dt:.0f} pairs/s, K4 X-only launches "
            f"{js.cum_union_launches}")
    if trace:
        traced("n1024", run)


def j1000(dev, reps: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    p, n = 14, 1000
    bank, _ = chip_smoke._k3_bank(dev, p, n)
    sketches = [HLL.from_numpy(r, p, est.ERTL_MLE, est.ERTL_JOINT_MLE)
                for r in bank.cpu().numpy()]

    def run():
        pw.all_pairs_condensed(sketches, pw.MASH_DIST, 31, est.ERTL_MLE,
                               est.ERTL_JOINT_MLE, dev)

    run()
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[j1000] rep {r} compare -J {dt:.4f}s, "
            f"{n * (n - 1) / 2 / dt:.0f} pairs/s")
    if trace:
        traced("j1000", run)


def fastq(dev, reps: int, reads: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch import metrics, pipeline
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import countmin
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    tmp = tempfile.mkdtemp(prefix="dtt_profile_fq_")
    try:
        fq = os.path.join(tmp, "reads.fq")
        chip_smoke.write_reads(fq, rng, reads)
        log(f"[fastq] {reads} reads, {os.path.getsize(fq) / 1e6:.1f} MB")
        for label, extra in (("plain", []), ("filtered", [
                "-b", "-n", "2", "-q", str(chip_smoke.FQ_CM_LOG2)])):
            argv = ["sketch", "-k", "31", "-S", "16", "-P", tmp] + extra + [fq]

            def run():
                if main(list(argv)) != 0:
                    raise SystemExit(f"fastq {label} returned nonzero")

            run()
            buckets()
            for r in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                share = metrics._totals.get("host.parse", 0.0) / wall
                log(f"[fastq {label}] rep {r} wall {wall:.4f}s, "
                    f"{reads / wall:,.0f} reads/s, host.parse share "
                    f"{share:.3f}; buckets: {buckets()}")
            if trace:
                traced(f"fastq {label}", run)
                buckets()
        # the count-min kernels alone, on one full tile of the file, into
        # the table the filtered sketch's first pass would leave
        params = pipeline.SketchParams(
            k=31, use_counting_filter=True, min_count=2,
            cm_size_log2=chip_smoke.FQ_CM_LOG2)
        sp = params.spacer()
        tiles = pipeline.InputFile(0, fq, sp).tiles()
        tile = next(tiles)
        ups = [torch.from_numpy(tile).to(dev)]
        ups += [torch.from_numpy(t).to(dev) for t in tiles]
        kw = dict(k=31, canon=True, nh=params.cm_nhashes,
                  size_log2=params.cm_size_log2, seed=params.cm_seed)
        counts = torch.zeros((kw["nh"], 1 << kw["size_log2"]),
                             dtype=torch.int32, device=dev)
        for up in ups:
            countmin.ascii_cm_add(up, counts, **kw)
        regs = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
        up = ups[0]
        times = {
            "upload": chip_smoke.cuda_ms(
                lambda: torch.from_numpy(tile).to(dev), 20),
            "cm_add_kernel": chip_smoke.cuda_ms(
                lambda: countmin.ascii_cm_add(up, counts, **kw), 20),
            "cm_admit_kernel": chip_smoke.cuda_ms(
                lambda: countmin.ascii_cm_admit(up, counts, regs,
                                                min_count=2, p=16, **kw),
                20),
        }
        per_pass = (times["upload"] + times["cm_add_kernel"],
                    times["upload"] + times["cm_admit_kernel"])
        log(f"[fastq cm kernels] one {tile.shape[0]}x{tile.shape[1]} tile of "
            f"{len(ups)}, ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in times.items())
            + f"; so about {per_pass[0] * len(ups) / 1e3:.3f}s of device "
            f"work with the uploads in the counting pass and "
            f"{per_pass[1] * len(ups) / 1e3:.3f}s in the admitting pass")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rect(dev, reps: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    p = 14
    bank, _ = chip_smoke._k3_bank(dev, p, 1000)
    other, qs = chip_smoke.query_bank(dev, bank)
    k4_orientation(bank, qs)
    tmp = tempfile.mkdtemp(prefix="dtt_profile_rect_")
    try:
        hdir = os.path.join(tmp, "bank")
        os.makedirs(hdir)
        hlls = []
        for i, r in enumerate(bank.cpu().numpy().astype(np.uint8)):
            hlls.append(os.path.join(hdir, f"s{i:04d}.hll"))
            HLL(p, est.ERTL_MLE, est.ERTL_MLE, r).write(hlls[-1])
        queries = chip_smoke.write_query_bank(os.path.join(tmp, "queries"),
                                              other, hlls)
        qfile = chip_smoke._write_list(os.path.join(tmp, "q.txt"), queries)
        out = os.path.join(tmp, "out")
        pairs = len(hlls) * len(queries)
        for label, extra in (("-Q -M -b", ["-M", "-b"]),
                             ("-Q --nearest-neighbors 5",
                              ["--nearest-neighbors", "5"])):
            argv = (["dist", "-k", "31", "-H", "-Q", qfile, "-O", out, "-o",
                     out + ".sizes"] + extra + hlls)

            def run():
                if main(list(argv)) != 0:
                    raise SystemExit(f"rect {label} returned nonzero")

            run()
            buckets()
            for r in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                log(f"[rect {label}] rep {r} wall {wall:.4f}s, "
                    f"{pairs / wall:.0f} pairs/s; buckets: {buckets()}")
            if trace:
                traced(f"rect {label}", run)
                buckets()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def k4_orientation(bank, qs) -> None:
    """Both K4 forms on e2e (g)'s reference x query tile and on its
    transpose (the queries on the lhs), over the CLI's window for that
    tile: kernel ms each way (CUDA events, 5 calls after a warm-up)."""
    import chip_smoke
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import pairwise as pw
    mm = [pw._block_minmax(x.cpu().numpy().astype(np.int32), x.shape[0],
                           pw.DEFAULT_TILE)[0] for x in (bank, qs)]
    kmax, kmin = pw._pair_window(mm[0], mm[1], 64 - 14)
    parts = []
    for tag, (a, b) in (("refs x queries", (bank, qs)),
                        ("queries x refs", (qs, bank))):
        x = chip_smoke.cuda_ms(
            lambda: js.cum_union_counts(a, b, kmin=kmin, kmax=kmax), 5)
        j = chip_smoke.cuda_ms(
            lambda: js.joint_pair_stats(a, b, kmin=kmin, kmax=kmax), 5)
        parts.append(f"{tag} ({a.shape[0]}x{b.shape[0]}) {x:.4f} / {j:.4f}")
    log(f"[rect] K4 by orientation, kmin={kmin} K={kmax - kmin + 1} (kernel "
        "ms, X-only / joint): " + "; ".join(parts))


def smallfiles(dev, reps: int, trace: bool) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli import core
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    tmp = tempfile.mkdtemp(prefix="dtt_profile_small_")
    try:
        genomes = chip_smoke._write_genomes(tmp, chip_smoke.SMALL_ANC,
                                            chip_smoke.SMALL_LEN, rng)
        paths = [g[0] for g in genomes]
        n = len(paths)
        opts = core.CommonOpts(k=21, sketch_size=14)
        params = pipeline.SketchParams(k=21)
        runs = {"banked": lambda: core.sketch_paths(paths, opts, dev),
                "per-file": lambda: [pipeline.sketch_file_hll(
                    q, params, 14, dev) for q in paths]}
        for fn in runs.values():
            fn()                  # warm-up: builds, first-touch
        buckets()
        for r in range(reps):
            for label in ("banked", "per-file", "per-file", "banked"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[label]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                log(f"[smallfiles {label}] rep {r} wall {wall:.4f}s, "
                    f"{n / wall:.0f} files/s; buckets: {buckets()}")
        if trace:
            for label, fn in runs.items():
                traced(f"smallfiles {label}", fn)
                buckets()
        from dashing_tpu_torch.sketch.hll import HLL
        sketches = runs["banked"]()
        os.makedirs(os.path.join(tmp, "w"))
        t0 = time.perf_counter()
        with gzip.open(os.path.join(tmp, "db.gz"), "wb") as fp:
            for sk in sketches:
                sk.write_record(fp)
        t_stream = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, sk in enumerate(sketches):
            core.atomic_write_sketch(sk, os.path.join(tmp, "w", f"{i}.hll"))
        t_files = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(n):
            HLL.read(os.path.join(tmp, "w", f"{i}.hll"))
        log(f"[smallfiles gzip] {n} p=14 sketches (host): one level-9 gzip "
            f"stream {t_stream:.4f}s, {n} level-9 files {t_files:.4f}s, "
            f"reading the files back {time.perf_counter() - t0:.4f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def encode_ab(dev, other: str, reps: int) -> None:
    """K1 and K2's single register forms (csrc/encode_hash.cu) of this
    checkout against those of the checkout at `other`, in turns (other,
    this, this, other) `reps` times, kernel alone (chip_smoke.kernel_alone_ms)
    at chip_smoke.py's ENC_SHAPES, on its chunks."""
    import ctypes
    import torch
    import chip_smoke
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import _build
    from dashing_tpu_torch.ops import encode_hash as eh
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {"this": eh._lib(), "other": _build.load("encode_hash_other", {
        "dtt_encode_hash_regs": ([vp, vp, vp, ci, ci, ci, ci, ci, vp], ci),
        "dtt_ascii_hash_regs": ([vp, vp, ci, ci, ci, ci, ci, vp], ci)},
        src=os.path.join(other, "dashing_tpu_torch", "csrc",
                         "encode_hash.cu"))}
    this_lib = eh._lib
    rng = np.random.default_rng(chip_smoke.SEED)
    try:
        for k, p in chip_smoke.ENC_SHAPES:
            C = pipeline.CONTENT + k - 1
            C += (-C) % 8
            tile = chip_smoke._random_chunk(rng, pipeline.MAX_ROWS, C)
            pk, vb = (torch.from_numpy(a).to(dev)
                      for a in pipeline._pack_tile_host(tile))
            t = torch.from_numpy(tile).to(dev)
            ring = torch.zeros((chip_smoke.RING, 1 << p), dtype=torch.int32,
                               device=dev)
            forms = {
                "K1": lambda i: eh.packed_to_registers(pk, vb, ring[i], k=k,
                                                       p=p),
                "K2": lambda i: eh.ascii_to_registers(t, ring[i], k=k, p=p)}
            for form, launch in forms.items():
                got = {"other": [], "this": []}
                for _ in range(reps):
                    for which in ("other", "this", "this", "other"):
                        eh._lib = lambda which=which: libs[which]
                        ms, _ = chip_smoke.kernel_alone_ms(
                            launch, ring.zero_, f"{form} {which}")
                        got[which].append(ms)
                log(f"[encode_ab] {form} k={k} p={p} ({tile.shape[0]}x{C}), "
                    "kernel alone ms in turns: " + "; ".join(
                        f"{w} " + " ".join(f"{v:.4f}" for v in vals)
                        for w, vals in got.items()))
            del ring
    finally:
        eh._lib = this_lib


WORKLOADS = ("config2", "n1024", "j1000", "fastq", "rect", "smallfiles")


def main() -> int:
    global _log_fp
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", choices=WORKLOADS,
                    help="run this workload alone")
    ap.add_argument("--fastq-reads", type=int, default=1_000_000)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the torch.profiler runs")
    ap.add_argument("--other", metavar="DIR",
                    help="another checkout: time its K1/K2 (csrc/"
                    "encode_hash.cu) against this one's in turns, alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    os.makedirs("chiprun_out", exist_ok=True)
    _log_fp = open(LOG_PATH, "w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    os.environ["DASHING_TPU_TORCH_DEVICE"] = "cuda"
    from dashing_tpu_torch import device as devmod
    dev = devmod.from_env()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    trace = not args.no_trace
    runs = {"config2": lambda: config2(dev, args.reps, trace),
            "n1024": lambda: n1024(dev, args.reps, trace),
            "j1000": lambda: j1000(dev, args.reps, trace),
            "fastq": lambda: fastq(dev, args.reps, args.fastq_reads, trace),
            "rect": lambda: rect(dev, args.reps, trace),
            "smallfiles": lambda: smallfiles(dev, args.reps, trace)}
    if args.other:
        encode_ab(dev, args.other, args.reps)
    else:
        for name in WORKLOADS:
            if args.only in (None, name):
                runs[name]()
    _log_fp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
