#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dashing_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines with seconds:
  1. device   the card's name and power limit (nvidia-smi); fails without CUDA
  2. build    every CUDA kernel from dashing_tpu_torch/csrc (nvcc, sm_90a,
              one nvcc per source, all started together), with ptxas's
              registers, stack frame and spills per kernel; then the rates
              of the binary tensor-core MMAs (mma.sync, which K4 runs, and
              wgmma), measured by the loops of b1_peak.cu beside this
              script (the data sheet gives none); K4's bounds are reckoned
              against the faster; and the floor of short kernels' times,
              an empty <<<1, 32>>> launch (b1_peak.cu), alone and as
              launched
  3. K1       fused encode/hash/register-max kernel vs its plain PyTorch
              version on the card, one 256-row chunk at k=31 p=14, k=21
              p=16 and k=31 p=16: registers must be bitwise equal; the
              launch grid, and SASS instruction counts (cuobjdump)
     K2       the same tail on raw ASCII: 256 x 8222 chunks at k=31 and
              256 x 8212 at k=21, same p (N runs, lowercase, IUPAC, 0x00
              and bytes >= 0x80): fused registers and keys bitwise equal
              to the plain versions; beside it K1 on the packed form of the
              same chunk, with the host 2-bit pack and the upload of each
              form timed.  K1 and K2 are timed alone (launches queued
              behind a spin kernel, each into fresh registers) and as
              launched (the host's dispatch pace)
     minimizer  minimizer windows on raw ASCII into registers
              (csrc/minimizer_hash.cu) vs its plain version, bitwise, from
              zero registers and from another chunk's fold: dist -w 50's
              chunk (256 x 8248, k31 w50 p16) and k21 w40 p14; timed
              alone, into filled registers and as launched, beside the
              plain version and the bound
     countmin the count-min filter's two kernels (csrc/countmin.cu) at the
              read-set cell's tile (256 rows of CONTENT + 30 bases of
              100-base reads, k31, 4 x 2^28 counters, p16, min count 2):
              table and registers bitwise the plain chain's; then each
              timed alone and as launched against a table already filled
              by a pass over ~65x coverage of reads, beside the plain
              chain and the bound (sector traffic of the valid windows'
              row-updates, or their operations)
  4. K3       union-MLE kernel vs its plain version on the card, 1024 x 1024
              pairs at p=14, ORIGINAL / IMPROVED / MLE: bit for bit (max
              abs err 0, non-finite entries alike) and inside the old bar
              rtol=2e-4 atol=5e-2 on triples; the row-estimate kernel
              (marginals, MLE by the chain as the compare takes them, and
              a ragged 1001 rows) bit for bit, through the wrapper and 8
              and 32 lanes a row, each form timed alone and as launched (every
              row-estimate check does so, at every shape the main path
              gives the kernel); K4's X-only form (cum_union of the main path)
              bitwise equal to its plain version on that same-bank
              1024 x 2^14 bank
  5. K4, K5   joint pair statistics (K4) vs their plain version, bitwise
              equal, on a same-bank 1000 x 2^14 bank and a distinct ragged
              600 x 1000 pair of banks with a window kmin > 0; the joint MLE
              (K5) vs its plain version on 256 x 1000 pairs of the same-bank
              statistics: bit for bit, and inside the old bars rtol=2e-4
              atol=5e-2 on triples and atol=2e-6 on Jaccard
     rect     e2e (g)'s query x reference tile at its shape and window:
              that bank as references against its 500 queries (490 rows
              from other ranges of the pool, ten byte copies of
              references; two tensors, each side its own marginals): K4's
              X-only form, K3 (MLE and ORIGINAL, c_a != c_b), K4's joint
              form and K5 (all 1000 x 500 pairs, ha != hb), each bit for
              bit against its plain version, and the ten identical pairs
              at Jaccard 1 within 1e-5
     banks    the banked forms of K1 and K2 (one launch folds rows into
              the register banks of their files or records): K1 at the
              1k-genome batch (64 files x 25 rows x 8224, k21 p14), at 64
              files of 2 Mbp (250 rows), at p = 10 and 16 (64 files) and
              p = 21 (8 files), on both sides of its on-chip cut (p = 14),
              and at the 1k-genome batch with its rows in no order; K2 at
              one sketch_by_seq batch (2,048 records padded to 4,096, k21
              p10); each bitwise equal to its plain version and to every
              bank folded alone by the single-bank entry, timed alone and
              as launched, K1's merges logged beside its bound; then
              the three genomes of tests/golden sketched by the CLI on
              the card (one banked K1 launch), g0's registers equal to
              golden.hll
  The build phase also prints SASS instruction counts: K1/K2 per window,
  and the Newton step of K3 (MLE) and K5 at K = 32 per level-step, and of
  the row-estimate kernel's main-path instantiations, with their ptxas
  registers and spills.
  6. e2e      the port's CLI entry (dashing_tpu_torch.cli.main.main):
              (a) 4 genomes, dist -k 21 -S 14 -M -T
              (b) 100 synthetic 5 Mbp genomes (20 ancestors x 5 copies at
                  planted substitution rates), dist -k 31 -S 16 -M -b -O -o
              (c) the same 100 genomes, dist -k 31 -S 16 -J -M -b (joint MLE)
              (d) 1000 p=14 sketches of the K4 bank written as .hll files,
                  dist -H -J -M -b (all 499,500 pairs), its wall time and
                  pairs/s, and the largest Jaccard difference from the same
                  run without -J; K4's joint form and K5 must launch in the
                  first, K4's X-only form and K3 in the second
              In (b) and (c) every kernel of the path must have launched
              (counts set to 0 just before the run, read just after), in
              (b) K2's unbanked form and the minimizer kernel must not
              (K2's count, 0, is the one the `kernels` line gives for
              ascii_hash_regs), the
              matrix must be finite and of length n(n-1)/2, and every
              planted pair's Mash distance within 0.25 d + 0.001 of d; two
              genomes' registers must equal the plain version's on the card.
              Then K3, the row-estimate kernel, both forms of K4 and K5 are
              held against their plain versions at the shapes config 2
              gives them (one 100 x 100 tile at p=16, its marginals by
              the chain and by the direct form of the -J start; the -o
              histograms; one sketch's full histogram).
              (e) the ASCII-tile route: the same genomes through `dist -k 31
                  -S 16 -M -b` with -s 1x4, with -w 50, with -g -w 50, and
                  with --use-nthash -k 41: each matrix finite and
                  n(n-1)/2 long, the minimizer kernel launched once a
                  chunk under -w 50 (the `kernels` line's count) and never
                  under the others, -s and ntHash planted pairs within
                  0.25 d + 0.001, and two genomes' registers on the card
                  bitwise equal to a CPU run of the same port code
              (f) BASELINE.json config 3 at 1 M reads of 100 bases (213 MB
                  of FASTQ, streamed; from one 5 Mbp genome, half
                  reverse-complemented, 0.5 % substitution errors), k=31:
                  `sketch -S 16` and `sketch -S 16 -b -n 2 -q 28`, their
                  `card` within 2 % and 3 % of the exact distinct and
                  twice-seen k-mer counts, filtered <= plain registers;
                  `union` of the two equal to the plain sketch; `hll`
                  (p=24) within 1 %; `dist -S 14 -M -y -c 2 -t 28` over the
                  four quarters, every distance below the unfiltered one;
                  the filtered registers of 20,000 reads on the card
                  bitwise equal to the CPU run.  K1, the row-estimate
                  kernel, K4's X-only form and K3 must launch in their steps,
                  and the filtered sketch each count-min kernel once a tile
              (g) query/reference dist over (d)'s files and 500 queries
                  (ten byte copies of references): -Q -M, --containment-
                  index (each copy's containment in its reference 1),
                  -J -Q, --nearest-neighbors 5 with and without -Q, TSV
                  and binary (each copy's first neighbour its reference),
                  --containment-dist without -Q (1000 x 1000; over 20
                  FASTA genomes the aliased half sketches each file once),
                  and -Q with the references as queries, bit for bit equal
                  to (d)'s condensed -M matrix; a 64 x 48 corner of the -M
                  and -J matrices against the plain versions on the CPU.
                  Each run's kernels must launch, every value be finite
              (h) BASELINE.md's 1k-genome row from FASTA: 1,000 genomes of
                  200 kbp (200 ancestors x the 5 RATES copies), `sketch -k
                  21 -S 14 -o` (ceil(1000/64) banked K1 launches, no
                  single-file one; ten files' registers equal to each
                  sketched alone), `dist -M -b` with and without -J
                  (planted pairs within 0.25 d + 0.001), `dist -W -P`
                  twice (the second launches no K1, same bytes); the
                  sketch phase in turns, per-file engine against the
                  banked one, in files/s; the compare walls
              (i) `mkdist --multik mk,17,33,4 -S 14 --jukes-cantor` over
                  250 of (h)'s files: one upload a chunk, four K1 launches on
                  it; each per-k matrix bit for bit a separate `dist -k K
                  -S 14 --sizes -b` (the measure --jukes-cantor gives the
                  passes); .bin finite, .jcd finite on related pairs at
                  a planted d >= 0.005
              (j) 5,000 records of 500-50,000 bases and 20 above
                  MAX_RECORD_WIDTH cut from (h)'s genomes: `sketch_by_seq
                  -k 21 -S 10` (banked K2; .names and record count; 20
                  records' registers equal to each sketched alone),
                  `dist_by_seq -b` over all pairs, and -q against 1,000
                  other records (ten byte copies at Jaccard 1)
              (k) `panel -k 21 -F` of 40 byte copies of (h)'s genomes and
                  10 fresh copies of ancestors against (h)'s `-o`
                  database: each copy's best match its genome at
                  containment 1 (1e-5), each fresh copy's in its family;
                  K4's joint form and K5 launch
              (l), (m) readfilt and weighted Jaccard (phase_e2e_readfilt)
              (n) phase `setsketch`, the set sketches over (b)'s 100
                  genomes at k31 S16 (b-bit p = 15, bottom-k kk = 8,192):
                  8 genomes' device b-bit minima (est_cardinality_ too)
                  and bottom-k values bitwise equal to the host addh_np
                  route, and a synthetic tile (top bit, 0, all ones, a
                  run of copies) against the plain versions; the device
                  spans of the encoders, the scatter-min and the bottom-k
                  merge (CUDA events); `dist -M -b` walls under -8 and
                  --use-range-minhash (planted pairs within 0.25 d +
                  0.001), `sketch -o` of 20 then `dist -H` bit for bit
                  that corner of the matrix; `dist -8 -Q` with 10 byte
                  copies of references (Jaccard 1) and
                  --nearest-neighbors 5; the
                  host-route families (--use-bloom-filter, the counting
                  forms) over a cut of 6 genomes; metrics buckets
                  (host.parse, sketch.dispatch, sketch.host_insert,
                  compare.host) beside each wall
              (o) phase `extra` over (b)'s 100 genomes, k31 S16: the wide
                  HLL's registers from the HLL engine (K1) bitwise equal to
                  the host route (file_raw_kmers + WideHLL.addh_np) on 8
                  genomes, both routes timed; `dist --use-wide-hll -M -b`
                  (K1, K4 X-only, K3 and the row estimates launch) and
                  `-J` (K4 joint and K5) bit for bit (b)'s and (c)'s
                  matrices; `sketch -o` of 20 then `dist -H` bit for bit
                  that corner; -Q with (n)'s 10 byte copies (Jaccard 1)
                  and --nearest-neighbors 5 (each copy its reference
                  first); HyperMinHash and SuperMinHash (host route) `dist
                  -M -b` over 6 genomes and a byte copy of the first (the
                  copy at Jaccard 1), each builder's seconds a genome; the
                  phase's seconds
              (p) phase `khset`: the exact k-mer hash sets over (b)'s
                  first KHS_CUT genomes and a byte copy of the first, k31
                  (`dist --use-full-khash-sets -M -b`: the copy at Jaccard
                  1, each pair's exact Jaccard within 0.02 of (b)'s HLL
                  Jaccard; `sketch -o` then `dist -H` bit for bit; `union
                  -H` of two sets (their keys below 2^60) holding |A u B|
                  keys, each key of both; the builder, raw k-mers and
                  np.unique, and the compare timed); `--wj-exact
                  -8` and `--wj-exact --use-wide-hll` over WJ_CUT genomes
                  and the copy (the copy at Jaccard 1; K4's X-only form and
                  K3 launch for the wide HLL); gf64_mul on 2^20 pairs on
                  the card equal to gf64_mul_np.  Its HeavyKeeper half runs
                  at the end of (f), over (f)'s reads: the native
                  structure, DASHING_TPU_USE_HK=1 `sketch -b -n 2` of
                  HK_HEAD reads on the card bitwise equal to a CPU run in a
                  subprocess, and over the 1 M reads HeavyKeeper against
                  the count-min at -q HK_Q (walls, buckets `sketch.hk_add`
                  / `sketch.hk_query`, each filtered cardinality's error
                  against the k-mers seen at least twice); the phase's
                  seconds
              (q) phase `parallel`: the CLI as 2 and 3 gloo ranks sharing
                  the one card (DASHING_TPU_DISTRIBUTED=1, each rank on
                  cuda:0, spawned by torch.multiprocessing, compare tiles
                  of PAR_TILE rows) over (h)'s 1,000 genomes: `dist -M -b
                  -O` (rank-local mmap stripes) and as TSV at 2 and 3
                  ranks; at 2 also `-J -M -b -O`, `-Q` of 500 queries (ten
                  byte copies of references, at distance 0) as `-M -b` and
                  `--nearest-neighbors 5`, `hll`, `sketch -P` and `union`:
                  each output byte-identical to one process's, banked K1,
                  K4 X-only and K3 (K4 joint and K5 under -J) launched on
                  every rank, each rank set inside PAR_TIMEOUT or the
                  phase fails; rank 0's walls (processes sharing one card,
                  not scaling) and buckets.  Its mesh half runs in e2e
                  after (c): the mesh pinned to (cuda:0, cuda:0), `dist -k
                  31 -S 16 -M -b` and `-J` bit for bit (b)'s and (c)'s
                  matrices with each genome's chunks on both shards, and
                  the 100 sketches' compare at MESH_TILE-row tiles bit for
                  bit one card's with tiles on both shards
The line before the last is the per-kernel JSON record (launches from the
run of the kernel's path (the two-bank records: from e2e (g)'s -Q -M
and -J -Q runs; banked K1 from e2e (h)'s sketch, banked K2 from e2e (j)'s
sketch_by_seq), times as CUDA-event means (K1 and K2 alone,
with no host dispatch between launches), each kernel's bound
and, where one PyTorch call computes the same function, that call's time:
for K4 one float32 bmm of the stacked indicators; the log line beside it
also times torch._int_mm per level product, int8 in, int32 out);
the last line is {"ok": true, "device": {...}}.  Any failure exits
non-zero with no result.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260
K3_RTOL, K3_ATOL = 2e-4, 5e-2
JI_ATOL = 2e-6             # Jaccard of the K5 triples vs plain
K1_SRC = "dashing_tpu_torch/csrc/encode_hash.cu"
K2_REPLACES = "dashing_tpu/ops/pallas_encode.py:54"
MIN_SRC = "dashing_tpu_torch/csrc/minimizer_hash.cu"
MIN_REPLACES = ("none: XLA code (dashing_tpu/pipeline.py _tile_to_registers "
                "under -w)")
CM_SRC = "dashing_tpu_torch/csrc/countmin.cu"
CM_REPLACES = ("none: XLA scatter and gather (dashing_tpu/pipeline.py "
               "_cm_add, _cm_query)")
K3_SRC = "dashing_tpu_torch/csrc/union_mle.cu"
K3_REPLACES = "dashing_tpu/ops/pallas_mle.py:77"
ROWS_SRC = "dashing_tpu_torch/csrc/estimate_rows.cu"
K4_SRC = "dashing_tpu_torch/csrc/joint_stats.cu"
K4_REPLACES = "dashing_tpu/ops/pallas_stats.py:112"
K5_SRC = "dashing_tpu_torch/csrc/joint_mle.cu"
K5_REPLACES = "dashing_tpu/ops/pallas_jmle.py:86"
RATES = (0.001, 0.01, 0.03, 0.001, 0.01)   # per-copy substitution rates

# Peak rates of one H100 SXM for the bounds (NVIDIA's H100 datasheet):
# HBM bytes/s, float32 outside the tensor cores, int8 tensor cores.  The
# int32 rate is not in the datasheet: it is the float32 rate's clock and SM
# count with 64 int32 lanes per SM instead of 128 float32 FMA lanes.
HBM_BPS = 3.35e12
FP32_OPS = 67e12
INT8_TC_OPS = 1979e12
INT32_OPS = 67e12 / 4
# one-bit multiply-adds a second of the faster binary MMA (.b1 .and.popc,
# mma.sync or wgmma), measured in this run by phase_b1_peak
B1_MACS = {"rate": None}
# an empty <<<1, 32>>> launch, alone and as launched (empty_launch_floor)
EMPTY_MS = {"alone": float("nan"), "paced": float("nan")}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record(records, name, source, replaces, counter, max_abs_err, ms,
           plain_ms, nbytes, ops, op_rate, library_ms=None):
    """One kernel entry of the JSON line; the bound is the larger of the
    bytes the function must move (each input read once, each output
    written once) over HBM_BPS and its operations over their peak rate."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / op_rate * 1e3
    records.append(dict(
        name=name, route="cuda", source=source, replaces=replaces,
        counter=counter, max_abs_err=float(max_abs_err), ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms))


# Operation counts per pair (or row), from the kernels' sources: float32
# arithmetic operations, each transcendental (exp, log, expm1) and each
# division counted as one, so the bound they give is a floor.
def k3_ops(n: int, K: int, method: int, iters: int, nonempty: int) -> int:
    """csrc/union_mle.cu, for `n` pairs (or rows) whose histograms are
    nonzero at `nonempty` (pair, level) places in all: histogram
    difference and mass (2 per level), the estimator, and the triple
    (~10).  MLE (hll_estimators.cuh `mle_chain_win`) adds the improved
    start (2 per level, ~150 for the sigma/tau series) and per Newton step
    the chain step (2 per level), ~25 (exp, the expm1 seed, the top bin,
    the clamped step), and 12 per nonempty level (w = z ((1 - c) / c) 3,
    the two sums 9; empty levels are skipped).  The row estimates' direct
    form (an expm1f and a division a level) skips them too up to 16 steps
    (hll_estimators.cuh SKIP_EMPTY_ITERS); above, every level is
    computed: pass nonempty = n * K."""
    if method == 0:
        return n * (2 * K + 3 * K + 10)
    if method == 1:
        return n * (2 * K + 2 * K + 150 + 10)
    return (n * (2 * K + 2 * K + 150 + iters * (2 * K + 25) + 10)
            + nonempty * iters * 12)


def k5_ops(pairs: int, K: int, iters: int, eq_levels: int) -> int:
    """csrc/joint_mle.cu, for `pairs` pairs whose eq is nonzero at
    `eq_levels` (pair, level) places in all: per Newton step ~75 per
    level (three chain steps, four marginal terms with a division each)
    and ~110 more where eq > 0 (the equal-level term, two divisions, nine
    sums; skipped where eq = 0), plus ~120 (exponentials, seeds, 3x3
    solve, step); two likelihood passes of ~32 per level (four marginal
    logs) and ~21 where eq > 0 (one log); loads, lt_a/lt_b and the union
    start 8 per level."""
    return (pairs * (8 * K + 20 + iters * (75 * K + 120) + 2 * (32 * K + 30))
            + eq_levels * (iters * 110 + 2 * 21))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"numpy {np.__version__} {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()} ({time.perf_counter() - t0:.2f}s)")


def phase_build():
    """Build every kernel library at once (one nvcc each, in parallel),
    then print ptxas's report for each kernel."""
    from concurrent.futures import ThreadPoolExecutor
    from dashing_tpu_torch.ops import (_build, countmin, encode_hash,
                                       joint_mle, joint_stats,
                                       minimizer_hash, union_mle)
    t0 = time.perf_counter()
    builds = [m._lib for m in (encode_hash, union_mle, joint_stats,
                               joint_mle, minimizer_hash, countmin)] + [
                                   union_mle._rows_lib, _b1_lib]
    with ThreadPoolExecutor(len(builds)) as ex:
        for f in [ex.submit(b) for b in builds]:
            f.result()
    log(f"[build] nvcc {_build.nvcc()}: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in _build.build_seconds.items())
        + f" (phase {time.perf_counter() - t0:.1f}s)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            line = line.strip()
            if "Compiling entry" in line or "registers" in line \
                    or "stack frame" in line or "Potential" in line:
                log(f"[ptxas {name}] {line.replace('ptxas info    : ', '')}")
    nvcc = _build.nvcc()
    _sass_report(encode_hash._lib()._name, nvcc)
    _sass_report(minimizer_hash._lib()._name, nvcc)
    _sass_report(countmin._lib()._name, nvcc)
    _sass_newton_report({"union_mle": union_mle._lib()._name,
                         "joint_mle": joint_mle._lib()._name,
                         "estimate_rows": union_mle._rows_lib()._name},
                        nvcc)


def _sass_functions(so: str, nvcc: str):
    """{mangled kernel name: [SASS instruction texts]} and, per kernel, its
    loops as (first, last) instruction indices of every backward branch
    (cuobjdump -sass); None if cuobjdump fails."""
    import re
    exe = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        log(f"[sass] cuobjdump failed: {res.stderr.strip()[:200]}")
        return None
    out = {}
    for body in res.stdout.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        ins, labels = [], {}
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(ins)
            op = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if op:
                ins.append((int(op.group(1), 16), op.group(2).strip()))
        index = {addr: i for i, (addr, _) in enumerate(ins)}
        loops = []
        for i, (_, text) in enumerate(ins):
            if "BRA" not in text:
                continue
            t = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", text)
            tl = re.search(r"\((\.L_x_\d+)\)", text)
            j = (index.get(int(t.group(1), 16)) if t
                 else labels.get(tl.group(1)) if tl else None)
            if j is not None and j <= i:
                loops.append((j, i))
        out[name] = ([x for _, x in ins], loops)
    return out


def _sass_report(so: str, nvcc: str) -> None:
    """SASS instructions of each encode/hash kernel: the whole kernel, and
    its window loop per window (the smallest backward branch span that
    holds a BREV, over its BREVs / 2: one __brevll is two); of the
    minimizer kernel, its k-mer loop per k-mer; of the count-min
    kernels, the window loop (its row loop inside) per window."""
    import re
    funcs = _sass_functions(so, nvcc)
    if funcs is None:
        return
    forms = {("0", "0", "0"): "K1 packed->regs",
             ("1", "0", "0"): "K2 ascii->regs",
             ("1", "1", "0"): "K2 ascii->keys",
             ("0", "0", "1"): "K1 packed->banks (global form)",
             ("1", "0", "1"): "K2 ascii->banks"}
    for name, (ins, loops) in funcs.items():
        unit = "window"
        if "minimizer_regs_kernel" in name:
            form, unit = "minimizer ascii->regs", "k-mer"
        elif "cm_add_kernel" in name:
            form = "count-min pass 1 ascii->counts"
        elif "cm_admit_kernel" in name:
            form = "count-min pass 2 ascii->regs"
        elif "banks_onchip_kernel" in name:
            form = "K1 packed->banks on chip"
        elif "encode_hash_kernel" in name:
            m = re.search(r"InE(\d)ELNS_3OutE(\d)ELb(\d)E", name)
            form = forms.get(m.groups() if m else None, name)
        else:
            continue
        best = None
        for j, i in loops:
            brevs = sum("BREV" in x for x in ins[j:i + 1])
            if brevs and (best is None or i - j < best[0]):
                best = (i - j + 1, brevs // 2)
        per = (f"{unit} loop {best[0]} instructions for {best[1]} {unit}(s)"
               f" = {best[0] / max(best[1], 1):.1f} a {unit}"
               if best else f"{unit} loop not found")
        log(f"[sass] {form}: {len(ins)} instructions; {per}")


# (kernel, library, mangled-name stem, levels a loop pass): K3's MLE
# instantiation at K = 32 (its 32 levels unrolled into the Newton step), K5
# (its level loop unrolled by two, `#pragma unroll 2` in csrc/joint_mle.cu)
# and the row-estimate kernel at the main path's shapes: the direct form at
# 24 levels 8 lanes a row (readfilt's batches), at 58 levels a warp a row
# (the -o sizes' K = 50); the chain at 32 levels a warp a row (the compare
# marginals)
NEWTON_SASS = (
    ("K3 MLE", "union_mle", "union_triples_kernelILi32ELb1ELi2E", 32),
    ("K5", "joint_mle", "joint_mle_kernel", 2),
    ("rows direct, 8 lanes a row, KT=24", "estimate_rows",
     "row_group_kernelILi24ELi2ELi8E", 24),
    ("rows direct, a warp a row, KT=58", "estimate_rows",
     "row_group_kernelILi58ELi2ELi32E", 58),
    ("rows chain, a warp a row, KT=32", "estimate_rows",
     "row_group_kernelILi32ELi3ELi32E", 32))


def _mufu(ins) -> dict:
    out = {}
    for x in ins:
        if "MUFU." in x:
            op = x[x.index("MUFU."):].split()[0]
            out[op] = out.get(op, 0) + 1
    return out


def _ptxas_of(lib: str, stem: str) -> str:
    """ptxas's registers and stack/spill line for the kernel whose mangled
    name holds `stem`, from the build log of library `lib` (empty when
    the library was not built in this process)."""
    from dashing_tpu_torch.ops import _build
    entry, props = None, {}
    for line in _build.build_logs.get(lib, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("stack frame" in line or "registers" in line):
            props.setdefault(entry, []).append(
                line.replace("ptxas info    : ", "").strip())
    hits = [v for k, v in props.items() if stem in k]
    return "; ".join(hits[0]) if hits else ""


def _sass_newton_report(sos: dict, nvcc: str) -> None:
    """SASS of the Newton step of each kernel of NEWTON_SASS (`sos`: its
    library's path by name): the whole kernel; the step, its largest loop
    (backward branch span); the instructions a level-step: the smallest
    loop inside the step that holds a division (MUFU.RCP), when the level
    loop is rolled, else the step, over the levels one pass of it holds;
    the special-function (MUFU), call and shuffle (SHFL) instructions of
    the step (expf, expm1f; a call is an IEEE division's slow path); and
    ptxas's registers and spills."""
    funcs_of = {}
    for what, lib, stem, levels in NEWTON_SASS:
        if lib not in funcs_of:
            funcs_of[lib] = _sass_functions(sos[lib], nvcc) or {}
        hits = [(n, f) for n, f in funcs_of[lib].items() if stem in n]
        if not hits:
            log(f"[sass] {what}: kernel {stem} not found")
            continue
        ins, loops = hits[0][1]
        regs = _ptxas_of(lib, stem)
        regs = f"; ptxas: {regs}" if regs else ""
        if not loops:
            log(f"[sass] {what}: {len(ins)} instructions; no loop found{regs}")
            continue
        j, i = max(loops, key=lambda s: s[1] - s[0])
        step = ins[j:i + 1]
        inner = [(a, b) for a, b in loops if j <= a and b <= i
                 and (a, b) != (j, i) and _mufu(ins[a:b + 1]).get("MUFU.RCP")]
        if inner:
            a, b = min(inner, key=lambda s: s[1] - s[0])
            per = (f"level loop {b - a + 1} instructions for {levels} "
                   f"levels = {(b - a + 1) / levels:.1f} a level-step "
                   f"({_mufu(ins[a:b + 1])})")
        else:
            per = (f"{len(step) / levels:.1f} instructions a level-step "
                   f"at K={levels}")
        log(f"[sass] {what}: {len(ins)} instructions; Newton step loop "
            f"{len(step)} instructions, {per}; in the step: "
            f"{_mufu(step) or 'no MUFU'}, {sum('CALL' in x for x in step)} "
            f"calls, {sum('SHFL' in x for x in step)} shuffles{regs}")


def _b1_lib():
    """The binary-MMA rate probe beside this script (b1_peak.cu)."""
    import ctypes
    from dashing_tpu_torch.ops import _build
    ci, vp = ctypes.c_int, ctypes.c_void_p
    sig = ([ci, ci, vp, vp], ci)
    return _build.load("b1_peak", {"dtt_b1_peak": sig,
                                   "dtt_b1_peak_wgmma": sig,
                                   "dtt_empty": ([vp], ci)},
                       src=os.path.join(os.path.dirname(
                           os.path.abspath(__file__)), "b1_peak.cu"))


def phase_b1_peak(dev):
    """The binary MMAs' rates on this card: b1_peak.cu's register-operand
    loops of mma.sync m16n8k256 (two 8-warp blocks per SM) and of wgmma
    m64n128k256 (two warpgroups per SM), timed by CUDA events (best of
    3).  K4's bounds take the faster."""
    import torch
    from dashing_tpu_torch.ops import _build
    lib = _b1_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(2 * sms * 256, dtype=torch.int32, device=dev)
    rates = {}
    # (entry, what, iters, one-bit multiply-adds per block and iteration)
    for fn, what, iters, per in (
            ("dtt_b1_peak", "mma.sync m16n8k256", 20000, 8 * 8 * 16 * 8 * 256),
            ("dtt_b1_peak_wgmma", "wgmma m64n128k256", 2000,
             8 * 64 * 128 * 256)):
        blocks = 2 * sms

        def run():
            _build.launch(lib, fn, dev, blocks, iters, scratch.data_ptr())

        ms = min(cuda_ms(run, 1) for _ in range(3))
        rates[what] = blocks * iters * per / ms * 1e3
        log(f"[b1 peak] {what}: {blocks} blocks x {iters} iterations: "
            f"{ms:.4f} ms, {rates[what] / 1e15:.3f}e15 one-bit multiply-adds/s"
            f" ({2 * rates[what] / INT8_TC_OPS:.2f}x the int8 tensor cores' "
            f"{INT8_TC_OPS / 1e12:.0f} TOP/s)")
    best = max(rates, key=rates.get)
    B1_MACS["rate"] = rates[best]
    log(f"[b1 peak] K4's bounds take the {best} rate, "
        f"{B1_MACS['rate'] / 1e15:.3f}e15/s")


def _random_chunk(rng, rows: int, C: int) -> np.ndarray:
    """ASCII chunk with N runs and lowercase."""
    tile = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8),
                      size=(rows, C), p=[0.2, 0.2, 0.2, 0.2] + [0.05] * 4)
    for r in range(rows):
        for _ in range(3):
            s = int(rng.integers(0, C - 64))
            tile[r, s:s + int(rng.integers(1, 64))] = ord("N")
    tile[rng.random((rows, C)) < 1e-4] = ord("R")      # IUPAC bytes
    return tile


# Encode/hash chunk shapes (k, p): the benchmark's k31 p14, and config 2's
# p = 16 at k21 and k31
ENC_SHAPES = ((31, 14), (21, 16), (31, 16))
# 32-bit integer instructions the encode/hash function needs, counted from
# its own arithmetic (csrc/encode_hash.cu; loads and stores not counted).
# Every window: its staged positions and word indices 5, three funnel
# shifts, the validity test 2, the loop 2:
ENC_WINDOW_OPS = 12
# every hashed window (the valid ones into registers, all of them into
# keys): the forward k-mer's pair reversal (two BREV, the pair swap 6, the
# shift by 64 - 2k 3) 11, rc 2, canonical min 5, WangHash in 32-bit halves
# 38 (its seven steps 6 + 4 + 8 + 4 + 8 + 4 + 4), bucket 1, rank (64-bit
# shift, or, two-word clz, + 1) 9, register compare or key 3:
ENC_HASH_OPS = 69
# every ASCII base: a quarter of classifying four bytes at once (the case
# mask 1, four byte compares 12, codes 8, validity bits 5, packing 6):
ENC_ASCII_OPS = 8
RING = 50                  # launches timed, each into fresh registers
SPIN_CYCLES = 50_000_000   # the torch.cuda._sleep ahead of them, ~25 ms


def _valid_windows(tile: np.ndarray, k: int) -> int:
    """Windows of an ASCII tile whose k bases are all valid."""
    ok = np.isin(tile & 0xDF, np.frombuffer(b"ACGT", np.uint8))
    bad = np.pad(np.cumsum(~ok, axis=1), ((0, 0), (1, 0)))
    return int(((bad[:, k:] - bad[:, :-k]) == 0).sum())


def enc_ops(R: int, C: int, k: int, hashed: int, ascii_in: bool) -> int:
    """Integer operations of one encode/hash call on an (R, C) chunk with
    `hashed` windows hashed."""
    return (ENC_WINDOW_OPS * R * (C - k + 1) + ENC_HASH_OPS * hashed
            + (ENC_ASCII_OPS * R * C if ascii_in else 0))


def kernel_alone_ms(launch, reset, what: str, n: int = RING):
    """(kernel-alone ms, as-launched ms) a launch of launch(i), i < n.
    Kernel alone: reset() (re-zeroing the register ring, outside the
    timing), then the n launches queued behind a torch.cuda._sleep spin so
    that the card runs them back to back; CUDA events from the spin's end
    to the last launch's end.  Fails if the spin ends before the host has
    queued them.  As launched: reset(), then events around the same n
    launches as the host issues them (the dispatch pace when a launch is
    shorter than its dispatch)."""
    import torch
    launch(0)                                  # warm-up
    reset()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for i in range(n):
        launch(i)
    enqueue = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin = ev[0].elapsed_time(ev[1])
    if enqueue >= spin:
        fail(f"{what}: the spin ({spin:.3f} ms) ended before the {n} "
             f"launches were queued ({enqueue:.3f} ms)")
    alone = ev[1].elapsed_time(ev[2]) / n
    reset()
    torch.cuda.synchronize()
    ev[3].record()
    for i in range(n):
        launch(i)
    ev[4].record()
    torch.cuda.synchronize()
    return alone, ev[3].elapsed_time(ev[4]) / n


def _filled_ms(launch, ring, rng, k, p, what):
    """Kernel-alone ms into registers that already hold the fold of
    another chunk of the same shape (the later chunks of a genome)."""
    import torch
    from dashing_tpu_torch.ops import encode_hash as eh
    other = torch.from_numpy(_random_chunk(rng, 256, 8192 + k - 1)).to(
        ring.device)
    filled = torch.zeros(1 << p, dtype=torch.int32, device=ring.device)
    eh.ascii_to_registers_plain(other, filled, k=k, p=p, canon=True)
    ms, _ = kernel_alone_ms(launch, lambda: ring.copy_(filled.expand_as(ring)),
                            what)
    return ms


def _enc_log(tag, k, p, R, C, nbytes, ops, ms, paced, plain_ms, eh,
             filled_ms=None):
    """One log line for an encode/hash chunk: grid, times, bound terms."""
    g = eh.launch_geometry(R, C, k)
    W = R * (C - k + 1)
    filled = ("" if filled_ms is None else
              f", into filled registers {filled_ms:.4f} ms")
    log(f"[{tag}] k={k} p={p} chunk ({R}, {C}): grid {g['grid'][0]} x "
        f"{g['grid'][1]} = {g['grid'][0] * g['grid'][1]} blocks of "
        f"{g['threads']} threads, {g['segment']} windows a block; kernel "
        f"alone {ms:.4f} ms ({W / ms / 1e6:.2f} G windows/s){filled}, as "
        f"launched {paced:.4f} ms a launch, plain {plain_ms:.4f} ms; bound "
        f"terms: bytes {nbytes / HBM_BPS * 1e3:.4f} ms, {ops / W:.1f} int32 "
        f"ops a window {ops / INT32_OPS * 1e3:.4f} ms")


def phase_k1(dev, records):
    """K1 (packed -> registers) vs its plain version at ENC_SHAPES, one
    256-row chunk each: registers bitwise equal, then kernel-alone and
    as-launched times into a ring of fresh registers."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    rng = np.random.default_rng(SEED)
    R, C = pipeline.MAX_ROWS, pipeline.CONTENT + 30
    log(f"[K1] bounds count operations a window (ENC_*_OPS); the count "
        f"before, ~100 int32 operations a base with the halo, gave "
        f"{100 * R * C / INT32_OPS * 1e3:.4f} ms for a {R} x {C} chunk")
    for k, p in ENC_SHAPES:
        C = pipeline.CONTENT + k - 1
        C += (-C) % 8
        tile = _random_chunk(rng, pipeline.MAX_ROWS, C)
        packed, vbits = pipeline._pack_tile_host(tile)
        pk = torch.from_numpy(packed).to(dev)
        vb = torch.from_numpy(vbits).to(dev)
        regs_k = torch.zeros(1 << p, dtype=torch.int32, device=dev)
        regs_p = torch.zeros_like(regs_k)
        eh.packed_to_registers(pk, vb, regs_k, k=k, p=p)
        eh.packed_to_registers_plain(pk, vb, regs_p, k=k, p=p, canon=True)
        torch.cuda.synchronize()
        nz = int((regs_p > 0).sum())
        if not torch.equal(regs_k, regs_p) or nz == 0:
            diff = int((regs_k != regs_p).sum())
            fail(f"K1 k={k} p={p}: {diff} registers differ from the plain "
                 f"version ({nz} nonzero)")
        ring = torch.zeros((RING, 1 << p), dtype=torch.int32, device=dev)
        k1 = lambda i: eh.packed_to_registers(pk, vb, ring[i], k=k, p=p)
        ms, paced = kernel_alone_ms(k1, ring.zero_, f"K1 k={k} p={p}")
        filled_ms = _filled_ms(k1, ring, rng, k, p, f"K1 k={k} p={p}")
        del ring
        plain_ms = cuda_ms(lambda: eh.packed_to_registers_plain(
            pk, vb, regs_p.zero_(), k=k, p=p, canon=True), 10)
        R = tile.shape[0]
        # bytes: codes and validity bits in, the registers read and
        # written; operations: per window and per valid window (ENC_*)
        nbytes = packed.nbytes + vbits.nbytes + 2 * 4 * (1 << p)
        ops = enc_ops(R, C, k, _valid_windows(tile, k), False)
        log(f"[K1] registers bitwise equal ({nz} nonzero)")
        _enc_log("K1", k, p, R, C, nbytes, ops, ms, paced, plain_ms, eh,
                 filled_ms)
        record(records, f"encode_hash_regs k={k} p={p}", K1_SRC,
               "dashing_tpu/ops/pallas_encode.py:99", "encode_hash", 0.0, ms,
               plain_ms, nbytes, ops, INT32_OPS)


def _wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call, each call synchronized (uploads)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_k2(dev, records):
    """K2 (ASCII -> registers, ASCII -> keys) vs its plain versions,
    bitwise, at ENC_SHAPES (256 x 8222 at k31, the benchmark's chunk;
    256 x 8212 at k21); kernel-alone and as-launched times; then the packed
    route on the same chunk for comparison: host pack, upload of each
    form, K1."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    rng = np.random.default_rng(SEED + 2)
    for k, p in ENC_SHAPES:
        C = pipeline.CONTENT + k - 1
        tile = _random_chunk(rng, pipeline.MAX_ROWS, C)
        tile[rng.random(tile.shape) < 1e-4] = 0          # separators
        tile[rng.random(tile.shape) < 1e-4] = 0xC1       # high bytes
        t = torch.from_numpy(tile).to(dev)
        regs_k = torch.zeros(1 << p, dtype=torch.int32, device=dev)
        regs_p = torch.zeros_like(regs_k)
        eh.ascii_to_registers(t, regs_k, k=k, p=p)
        eh.ascii_to_registers_plain(t, regs_p, k=k, p=p, canon=True)
        keys_k = eh.encode_hash_keys(t, k=k, p=p)
        keys_p = eh.encode_hash_keys_plain(t, k=k, p=p)
        torch.cuda.synchronize()
        nz = int((regs_p > 0).sum())
        if not torch.equal(regs_k, regs_p) or nz == 0:
            fail(f"K2 k={k} p={p}: {int((regs_k != regs_p).sum())} registers "
                 f"differ from the plain version ({nz} nonzero)")
        if not torch.equal(keys_k, keys_p):
            fail(f"K2 keys k={k} p={p}: {int((keys_k != keys_p).sum())} of "
                 f"{keys_p.numel()} keys differ from the plain version")
        zero = int(((keys_p & 63) == 0).sum())
        del keys_k, keys_p
        ring = torch.zeros((RING, 1 << p), dtype=torch.int32, device=dev)
        k2 = lambda i: eh.ascii_to_registers(t, ring[i], k=k, p=p)
        ms, paced = kernel_alone_ms(k2, ring.zero_, f"K2 k={k} p={p}")
        filled_ms = _filled_ms(k2, ring, rng, k, p, f"K2 k={k} p={p}")
        plain_ms = cuda_ms(lambda: eh.ascii_to_registers_plain(
            t, regs_p.zero_(), k=k, p=p, canon=True), 10)
        keys_ms, keys_paced = kernel_alone_ms(
            lambda i: eh.encode_hash_keys(t, k=k, p=p), lambda: None,
            f"K2 keys k={k} p={p}")
        keys_plain_ms = cuda_ms(lambda: eh.encode_hash_keys_plain(
            t, k=k, p=p), 10)
        R = tile.shape[0]
        W = R * (C - k + 1)
        # bytes: the ASCII chunk in, the registers read and written;
        # operations: per window, per valid window and per base (ENC_*)
        nbytes = tile.nbytes + 2 * 4 * (1 << p)
        ops = enc_ops(R, C, k, _valid_windows(tile, k), True)
        keys_ops = enc_ops(R, C, k, W, True)
        log(f"[K2] registers and keys bitwise equal ({nz} nonzero "
            f"registers, {zero} rank-0 keys)")
        _enc_log("K2", k, p, R, C, nbytes, ops, ms, paced, plain_ms, eh,
                 filled_ms)
        _enc_log("K2 keys", k, p, R, C, tile.nbytes + 4 * W, keys_ops,
                 keys_ms, keys_paced, keys_plain_ms, eh)
        record(records, f"ascii_hash_regs k={k} p={p} ({R}x{C})", K1_SRC,
               K2_REPLACES, "ascii_hash_regs", 0.0, ms, plain_ms, nbytes, ops,
               INT32_OPS)
        # the packed route on the same chunk: host pack, two uploads, K1
        # (the pack needs C % 8 == 0: pad with N, as the pipeline does)
        padded = pipeline._pad8(tile)
        t0 = time.perf_counter()
        for _ in range(5):
            packed, vbits = pipeline._pack_tile_host(padded)
        pack_ms = (time.perf_counter() - t0) / 5 * 1e3
        up_ascii = _wall_ms(lambda: torch.from_numpy(tile).to(dev), 20)
        up_packed = _wall_ms(lambda: (torch.from_numpy(packed).to(dev),
                                      torch.from_numpy(vbits).to(dev)), 20)
        pk = torch.from_numpy(packed).to(dev)
        vb = torch.from_numpy(vbits).to(dev)
        k1_ms, _ = kernel_alone_ms(
            lambda i: eh.packed_to_registers(pk, vb, ring[i], k=k, p=p),
            ring.zero_, f"K1 k={k} p={p} (K2's chunk)")
        del ring
        log(f"[K2 vs K1] k={k} p={p}, one chunk, kernels alone: ASCII route "
            f"upload {up_ascii:.4f} ms ({tile.nbytes} B) + K2 {ms:.4f} ms = "
            f"{up_ascii + ms:.4f} ms; packed route host pack2bit "
            f"{pack_ms:.4f} ms + upload {up_packed:.4f} ms "
            f"({packed.nbytes + vbits.nbytes} B) + K1 {k1_ms:.4f} ms = "
            f"{pack_ms + up_packed + k1_ms:.4f} ms")


# The minimizer kernel's chunks (k, w, p): dist -w 50's (256 rows of
# CONTENT + 49 bases padded to 8,248, config 2's k31 p16), and k21 w40 p14
MIN_SHAPES = ((31, 50, 16), (21, 40, 14))
# 32-bit integer instructions the minimizer function needs, counted from
# its own arithmetic (csrc/minimizer_hash.cu; loads and stores not
# counted).  Every k-mer: ENC_WINDOW_OPS (staged positions, the funnel
# shifts, the validity test, the loop), the pair reversal 11, rc 2, the
# canonical min 5, the invalid select 2:
MIN_KMER_OPS = ENC_WINDOW_OPS + 20
# every window: the sliding minimum (a backward step: a 64-bit
# compare-and-select 4, the flag 1, the loop 2; a forward step: two
# compare-and-selects 8, two flags 2, the loop 2) 19; the emission test (a
# 64-bit compare 2, the flags 3, a lane's share of the ballot, popc,
# shuffle and queue slot 4) 9:
MIN_WINDOW_OPS = 28
# every emitted window: WangHash in 32-bit halves 38, bucket 1, rank 9,
# register compare 3:
MIN_EMIT_OPS = 51


def _emitted_windows(t, k: int, w: int) -> int:
    """Windows of an ASCII chunk that fold a minimizer (the kernel's
    emission rule, segment starts aside): valid, and the row's first,
    after an invalid window, or with a minimizer other than the window
    before's."""
    from dashing_tpu_torch.ops.encode import encode_tile
    km, valid = encode_tile(t, k=k, w=w, positions=range(k), span=k,
                            canon=True)
    same = valid[:, :-1] & (km[:, 1:] == km[:, :-1])
    return int(valid[:, 0].sum()) + int((valid[:, 1:] & ~same).sum())


def min_ops(R: int, C: int, k: int, w: int, emitted: int) -> int:
    """Integer operations of one minimizer call on an (R, C) chunk with
    `emitted` windows folded."""
    return (ENC_ASCII_OPS * R * C + MIN_KMER_OPS * R * (C - k + 1)
            + MIN_WINDOW_OPS * R * (C - w + 1) + MIN_EMIT_OPS * emitted)


def phase_minimizer(dev, records):
    """The minimizer kernel (ASCII -> minimizer windows -> registers) vs
    its plain version, bitwise, at MIN_SHAPES, from zero registers and
    from registers holding another chunk's fold; kernel-alone (fresh and
    filled registers) and as-launched times, the plain version's time,
    the bound, the launch grid."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import minimizer_hash as mh
    rng = np.random.default_rng(SEED + 3)
    for k, w, p in MIN_SHAPES:
        C = pipeline.CONTENT + w - 1
        C += (-C) % 8
        R = pipeline.MAX_ROWS
        tile = _random_chunk(rng, R, C)
        tile[rng.random(tile.shape) < 1e-4] = 0          # separators
        tile[rng.random(tile.shape) < 1e-4] = 0xC1       # high bytes
        t = torch.from_numpy(tile).to(dev)
        other = torch.from_numpy(_random_chunk(rng, R, C)).to(dev)
        filled = torch.zeros(1 << p, dtype=torch.int32, device=dev)
        mh.ascii_minimizer_registers_plain(other, filled, k=k, w=w, p=p,
                                           canon=True)
        for start in (torch.zeros_like(filled), filled):
            regs_k, regs_p = start.clone(), start.clone()
            mh.ascii_minimizer_registers(t, regs_k, k=k, w=w, p=p)
            mh.ascii_minimizer_registers_plain(t, regs_p, k=k, w=w, p=p,
                                               canon=True)
            torch.cuda.synchronize()
            if not torch.equal(regs_k, regs_p) or not (regs_p > 0).any():
                fail(f"minimizer k={k} w={w} p={p}: "
                     f"{int((regs_k != regs_p).sum())} registers differ "
                     f"from the plain version "
                     f"({'filled' if start is filled else 'zero'} start)")
        nz = int((regs_p > 0).sum())
        ring = torch.zeros((RING, 1 << p), dtype=torch.int32, device=dev)
        run = lambda i: mh.ascii_minimizer_registers(t, ring[i], k=k, w=w,
                                                     p=p)
        what = f"minimizer k={k} w={w} p={p}"
        ms, paced = kernel_alone_ms(run, ring.zero_, what)
        filled_ms, _ = kernel_alone_ms(
            run, lambda: ring.copy_(filled.expand_as(ring)), what)
        del ring
        plain_ms = cuda_ms(lambda: mh.ascii_minimizer_registers_plain(
            t, regs_p.zero_(), k=k, w=w, p=p, canon=True), 5)
        emitted = _emitted_windows(t, k, w)
        W = R * (C - w + 1)
        # bytes: the ASCII chunk in, the registers read and written;
        # operations: per base, per k-mer, per window and per emitted
        # window (MIN_*)
        nbytes = tile.nbytes + 2 * 4 * (1 << p)
        ops = min_ops(R, C, k, w, emitted)
        g = mh.launch_geometry(R, C, k, w)
        log(f"[minimizer] k={k} w={w} p={p} chunk ({R}, {C}): registers "
            f"bitwise equal from zero and filled starts ({nz} nonzero); "
            f"{emitted} of {W} windows emit ({emitted / W:.4f}); grid "
            f"{g['grid'][0]} x {g['grid'][1]} blocks of {g['threads']} "
            f"threads, {g['segment']} windows a block; kernel alone "
            f"{ms:.4f} ms ({W / ms / 1e6:.2f} G windows/s), into filled "
            f"registers {filled_ms:.4f} ms, as launched {paced:.4f} ms a "
            f"launch, plain {plain_ms:.4f} ms; bound terms: bytes "
            f"{nbytes / HBM_BPS * 1e3:.4f} ms, {ops / W:.1f} int32 ops a "
            f"window {ops / INT32_OPS * 1e3:.4f} ms")
        record(records, f"minimizer_regs k={k} w={w} p={p} ({R}x{C})",
               MIN_SRC, MIN_REPLACES, "minimizer_regs", 0.0, ms, plain_ms,
               nbytes, ops, INT32_OPS)


# Phase `countmin`: the read-set cell's filter (`sketch -b -n 2 -q 28 -H 4
# -R 1337`, k31 p16) on one of its tiles: 100-base reads joined by 30
# zero bytes, cut into 256 rows of CONTENT + 30 bases.  The reads come
# from a CM_GENOME-base genome at 0.25 % substitutions, CM_FILL_READS of
# them (~65x coverage, the cell's table has ~140x) counted before the
# timing, so that the table holds what pass 1 leaves and most windows
# pass pass 2's test.
CM_K, CM_NH, CM_LOG2, CM_SEED, CM_P, CM_MIN = 31, 4, 28, 1337, 16, 2
CM_GENOME = 1_000_000
CM_FILL_READS = 650_000
CM_CELL_TILES = 620          # tiles a pass of the cell's 10 M reads
# 32-bit integer instructions a row-update of a valid window: c_r 2, h ^
# c_r 2, WangHash in 32-bit halves 38, the shift 3, the 64-bit offset 3,
# the atomic or load 1
CM_ROW_OPS = 49
# table bytes a row-update: pass 1 reads a 32-byte sector and writes it
# back, pass 2 reads it
CM_ADD_BYTES, CM_READ_BYTES = 64, 32


def _cm_tiles(rng):
    """The cell's tiles of CM_FILL_READS reads (host uint8, as
    `pipeline._joined_tiles` cuts the join of a FASTQ file)."""
    from dashing_tpu_torch import pipeline
    genome = rng.integers(0, 4, CM_GENOME).astype(np.uint8)
    starts = rng.integers(0, CM_GENOME - 100, CM_FILL_READS)
    c = genome[starts[:, None] + np.arange(100)]
    flip = rng.random(CM_FILL_READS) < 0.5
    c[flip] = 3 - c[flip, ::-1]
    hit = rng.random(c.shape) < 0.0025
    c[hit] = (c[hit] + rng.integers(1, 4, int(hit.sum()))) & 3
    rec = np.zeros((CM_FILL_READS, 100 + CM_K - 1), np.uint8)
    rec[:, :100] = np.frombuffer(b"ACGT", np.uint8)[c]
    joined = rec.reshape(-1)[:-(CM_K - 1)]
    return list(pipeline._joined_tiles(joined, CM_K - 1))


def _cm_rows_read(t, counts):
    """(valid windows, admitted windows, counter reads pass 2 needs): a
    valid window reads its rows up to the first below CM_MIN."""
    import torch
    from dashing_tpu_torch.ops import countmin as cm
    from dashing_tpu_torch.ops.encode import encode_tile
    from dashing_tpu_torch.hashes import wang_hash
    km, valid = encode_tile(t, k=CM_K, w=CM_K, positions=range(CM_K),
                            span=CM_K, canon=True)
    h = wang_hash(km)[valid]
    idx = cm.indices(h, CM_NH, CM_LOG2, CM_SEED)
    ok = torch.stack([counts[r][idx[r]] >= CM_MIN for r in range(CM_NH)])
    alive = torch.cumprod(ok.to(torch.int32), 0)
    reads = h.numel() + int(alive[:-1].sum())
    return h.numel(), int(alive[-1].sum()), reads


def phase_countmin(dev, records):
    """The count-min kernels vs the plain chain, bitwise, on two of the
    cell's tiles into a fresh 4 x 2^28 table and zero registers; then,
    with the table filled by a pass over CM_FILL_READS reads, each kernel
    alone and as launched on the cell's tile, the plain chain's time, and
    the bound: the larger of the table's sector traffic over HBM_BPS and
    the operations over INT32_OPS."""
    import torch
    from dashing_tpu_torch.ops import countmin as cm
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    tiles = _cm_tiles(rng)
    R, C = tiles[0].shape
    kw = dict(k=CM_K, canon=True, nh=CM_NH, size_log2=CM_LOG2, seed=CM_SEED)
    shape = (CM_NH, 1 << CM_LOG2)
    counts = torch.zeros(shape, dtype=torch.int32, device=dev)
    plain = torch.zeros_like(counts)
    regs = torch.zeros(1 << CM_P, dtype=torch.int32, device=dev)
    regs_p = torch.zeros_like(regs)
    two = [torch.from_numpy(x).to(dev) for x in tiles[:2]]
    for x in two:
        cm.ascii_cm_add(x, counts, **kw)
        cm.ascii_cm_add_plain(x, plain, **kw)
    for x in two:
        cm.ascii_cm_admit(x, counts, regs, min_count=CM_MIN, p=CM_P, **kw)
        cm.ascii_cm_admit_plain(x, plain, regs_p, min_count=CM_MIN, p=CM_P,
                                **kw)
    torch.cuda.synchronize()
    if not torch.equal(counts, plain):
        fail(f"countmin: {int((counts != plain).sum())} counters differ from "
             "the plain chain's")
    if not torch.equal(regs, regs_p) or not (regs_p > 0).any():
        fail(f"countmin: {int((regs != regs_p).sum())} registers differ from "
             "the plain chain's")
    del plain
    torch.cuda.empty_cache()
    for x in tiles[2:]:
        cm.ascii_cm_add(torch.from_numpy(x).to(dev), counts, **kw)
    t = two[0]
    valid, admitted, reads = _cm_rows_read(t, counts)
    W = R * (C - CM_K + 1)
    enc = ENC_ASCII_OPS * R * C + ENC_WINDOW_OPS * W + ENC_HASH_OPS * valid
    ring = torch.zeros((RING, 1 << CM_P), dtype=torch.int32, device=dev)
    work = {
        "cm_add": (lambda i: cm.ascii_cm_add(t, counts, **kw), lambda: None,
                   lambda: cm.ascii_cm_add_plain(t, counts, **kw),
                   t.numel() + valid * CM_NH * CM_ADD_BYTES,
                   enc + CM_ROW_OPS * valid * CM_NH),
        "cm_admit": (lambda i: cm.ascii_cm_admit(t, counts, ring[i],
                                                 min_count=CM_MIN, p=CM_P,
                                                 **kw),
                     ring.zero_,
                     lambda: cm.ascii_cm_admit_plain(
                         t, counts, regs_p, min_count=CM_MIN, p=CM_P, **kw),
                     t.numel() + reads * CM_READ_BYTES + 2 * 4 * (1 << CM_P),
                     enc + CM_ROW_OPS * reads),
    }
    for name, (run, reset, plain_run, nbytes, ops) in work.items():
        what = f"{name} k={CM_K} {CM_NH}x2^{CM_LOG2}"
        ms, paced = kernel_alone_ms(run, reset, what)
        plain_ms = cuda_ms(plain_run, 3)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = ops / INT32_OPS * 1e3
        log(f"[countmin] {name} tile ({R}, {C}): {valid} of {W} windows "
            f"valid ({valid / W:.4f}), {admitted} admitted, {reads} counter "
            f"reads in pass 2; kernel alone {ms:.4f} ms "
            f"({valid * CM_NH / ms / 1e6:.3f} G row-updates/s), as launched "
            f"{paced:.4f} ms, plain chain {plain_ms:.4f} ms; bound terms: "
            f"bytes {t_bytes:.4f} ms ({nbytes / 1e6:.1f} MB), operations "
            f"{t_ops:.4f} ms ({ops / max(valid, 1):.1f} a valid window), "
            f"share {max(t_bytes, t_ops) / ms:.1%}; at {CM_CELL_TILES} "
            f"tiles a pass: {ms * CM_CELL_TILES / 1e3:.3f} s alone")
        record(records, f"{name} k={CM_K} {CM_NH}x2^{CM_LOG2} p={CM_P} "
               f"({R}x{C})", CM_SRC, CM_REPLACES, name, 0.0, ms, plain_ms,
               nbytes, ops, INT32_OPS)
    del ring, counts
    torch.cuda.empty_cache()
    log(f"[countmin] phase {time.perf_counter() - t0:.1f}s")


# Phase `banks`: the banked forms of K1 and K2 at the shapes the small-file
# engine and sketch_by_seq give them.  Banked K1 (files, rows a file,
# width, k, p): the 1k-genome batch (64 files of a 200 kbp genome, 25 rows
# of 8224, k21 p14), the largest single-chunk files (64 of 2 Mbp, 250
# rows), p = 10 and 16 at 64 files and p = 21 at 8 (the last p that
# batches): the on-chip route up to ONCHIP_MAX_P = 14, the global form
# above; then the 1k-genome batch with its rows in no order, which the
# wrapper orders first.  Banked K2: one record batch of sketch_by_seq
# (2,048 records padded to width 4,096, k21 p10).  Last, the three golden
# genomes of tests/golden sketched by the CLI on the card.
BANK_K1 = (64, 25, 8224, 21, 14)
BANK_K1_SHAPES = (BANK_K1, (64, 250, 8224, 21, 14), (64, 25, 8224, 21, 10),
                  (64, 25, 8224, 21, 16), (8, 25, 8224, 21, 21))
BANK_K2 = (2048, 4096, 21, 10)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden")


def _check_banks(got, want, singles, what):
    """The kernel's banks bitwise equal to the plain version's and to the
    single-bank entry's fold of each bank's rows alone."""
    import torch
    torch.cuda.synchronize()
    nz = int((want > 0).sum(dim=1).min())
    if nz == 0:
        fail(f"{what}: a bank of the plain version is empty")
    for other, name in ((want, "the plain version"),
                        (singles, "each bank folded alone")):
        if not torch.equal(got, other):
            fail(f"{what}: {int((got != other).sum())} registers differ "
                 f"from {name}")
    log(f"[banks] {what}: {got.shape[0]} banks bitwise equal to the plain "
        f"version and to each bank folded alone by the single-bank entry "
        f"(at least {nz} nonzero registers a bank)")


def _merge_work(pk, vb, bk, B, k, p, geo, order=None):
    """(merges, stores) of banked K1's on-chip route on these rows, as the
    kernel walks them: a merge for every run of one bank in a block's
    units (2^p shared reads each), a store (one atomicMax) for every
    nonzero entry of each merged copy."""
    import torch
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops.hll_update import bucket_rank
    dev = pk.device
    R, C = pk.shape[0], pk.shape[1] * 4
    nseg, seg, nb = geo["segments"], geo["segment"], geo["blocks"]
    U = R * nseg
    walk = (torch.arange(R, device=dev) if order is None
            else order.to(torch.int64))
    bank = bk.to(torch.int64)
    starts = torch.arange(nb, device=dev, dtype=torch.int64) * U // nb
    units = torch.arange(U, device=dev, dtype=torch.int64)
    ubank = bank[walk[units // nseg]]
    ublock = torch.searchsorted(starts, units, right=True) - 1
    ok = (ubank >= 0) & (ubank < B)
    run = (ublock * B + ubank)[ok]
    merges = int((run[1:] != run[:-1]).sum()) + int(run.numel() > 0)
    code, valid = eh.unpack_2bit(pk, vb, C)
    h, wvalid = eh._hashes(code, valid, k, True)
    del code, valid
    idx, _ = bucket_rank(h, p)
    del h
    place = torch.empty(R, dtype=torch.int64, device=dev)
    place[walk] = torch.arange(R, device=dev)
    W = C - k + 1
    wunit = place[:, None] * nseg + (torch.arange(W, device=dev) // seg)
    wblock = torch.searchsorted(starts, wunit.reshape(-1),
                                right=True).view(R, W) - 1
    keep = wvalid & ((bank >= 0) & (bank < B))[:, None]
    key = ((wblock * B + bank[:, None]) << p) + idx
    stores = int(torch.unique(key[keep]).numel())
    return merges, stores


def _banks_k1(dev, records, rng, shape, shuffled=False):
    """Banked K1 at one shape, bitwise against its plain version and the
    single-bank entry; kernel-alone and as-launched times into a ring of
    fresh banks; the function's bound, and beside it the work the on-chip
    route's merges (and the wrapper's ordering, where it runs) add."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    B, rows, C, k, p = shape
    R = B * rows
    tile = _random_chunk(rng, R, C)
    packed, vbits = pipeline._pack_tile_host(tile)
    bank = np.repeat(np.arange(B, dtype=np.int32), rows)
    if shuffled:
        bank = rng.permutation(bank)
    pk, vb, bk = (torch.from_numpy(x).to(dev) for x in (packed, vbits, bank))
    got = torch.zeros((B, 1 << p), dtype=torch.int32, device=dev)
    want, singles = torch.zeros_like(got), torch.zeros_like(got)
    fold = lambda regs: eh.packed_to_banks(  # noqa: E731
        pk, vb, bk, regs, k=k, p=p, bank_sorted=not shuffled)
    fold(got)
    eh.packed_to_banks_plain(pk, vb, bk, want, k=k, p=p, canon=True)
    for j in range(B):
        sel = torch.from_numpy(np.flatnonzero(bank == j)).to(dev)
        eh.packed_to_registers(pk[sel], vb[sel], singles[j], k=k, p=p)
    order = "rows in no order, " if shuffled else ""
    what = f"banked K1 k={k} p={p} ({order}{B} files x {rows} rows x {C})"
    _check_banks(got, want, singles, what)
    ring = torch.zeros((RING, B, 1 << p), dtype=torch.int32, device=dev)
    ms, paced = kernel_alone_ms(lambda i: fold(ring[i]), ring.zero_, what)
    del ring
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: eh.packed_to_banks_plain(
        pk, vb, bk, want.zero_(), k=k, p=p, canon=True), 3)
    geo = eh.banks_geometry(R, C, k, p, dev)
    # the function's bound: bytes, the codes, validity bits and bank
    # vector in, the registers read and written; operations, per window
    # and valid window (ENC_*), a bank load a row
    nbytes = packed.nbytes + vbits.nbytes + bank.nbytes + 8 * B * (1 << p)
    ops = enc_ops(R, C, k, _valid_windows(tile, k), False) + R
    # what this implementation adds, outside the bound: on chip, 2^p
    # shared reads a merge and a store a nonzero entry merged; the
    # wrapper's ordering, the bank read and the order written and R log2 R
    # comparisons
    merges = stores = 0
    if geo["onchip"]:
        merges, stores = _merge_work(pk, vb, bk, B, k, p, geo,
                                     eh.row_order(bk, not shuffled, p))
    extra_ops = merges * (1 << p) + stores
    extra_bytes = 0
    if shuffled and geo["onchip"]:
        extra_bytes = 8 * R
        extra_ops += R * int(np.ceil(np.log2(R)))
    extra_ms = max(extra_bytes / HBM_BPS, extra_ops / INT32_OPS) * 1e3
    route = (f"on chip, {geo['blocks']} blocks ({geo['per_sm']} an SM, "
             f"{geo['shared']} B shared)" if geo["onchip"] else
             "global form")
    log(f"[banks] {what}: {route}; beside the bound, {merges} merges x "
        f"2^{p} shared reads + {stores} merged stores"
        + (f" + the ordering ({extra_bytes} B, {R} log2 {R} comparisons)"
           if extra_bytes else "")
        + f" = {extra_ops} operations, {extra_ms:.4f} ms at the int32 rate, "
        f"{100 * extra_ms / ms:.1f} % of the {ms:.4f} ms measured")
    _enc_log("banked K1", k, p, R, C, nbytes, ops, ms, paced, plain_ms, eh)
    record(records, f"encode_hash_banks k={k} p={p} ({order}{B}x{rows}x{C})",
           K1_SRC, "dashing_tpu/ops/pallas_encode.py:99", "encode_hash_banks",
           0.0, ms, plain_ms, nbytes, ops, INT32_OPS)


def _banks_golden(dev):
    """tests/golden's three genomes through `sketch -k 21 -S 12` on the
    card: one banked K1 launch and no single-file one; g0's registers equal
    to golden.hll, the JAX CLI's; every file's equal to its plain fold."""
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.sketch.hll import HLL
    names = [f"g{i}.fa" for i in range(3)]
    tmp = tempfile.mkdtemp(prefix="dtt_golden_")
    cwd = os.getcwd()
    try:
        for name in names:
            shutil.copy(os.path.join(GOLDEN, name), tmp)
        os.chdir(tmp)
        eh.launches = eh.banks_launches = 0
        _timed(["sketch", "-k", "21", "-S", "12"] + names, "golden sketch")
        if eh.banks_launches != 1 or eh.launches:
            fail(f"golden genomes: {eh.banks_launches} banked and "
                 f"{eh.launches} single-file K1 launches (want 1 and 0)")
        want = HLL.read(os.path.join(GOLDEN, "golden.hll"))
        regs = [HLL.read(f"{name}.w.21.spacing.12.hll") for name in names]
        if regs[0].p != want.p or not np.array_equal(regs[0].regs,
                                                     want.regs):
            fail("golden genomes: g0's card registers differ from "
                 "golden.hll")
        params = pipeline.SketchParams(k=21)
        for name, got in zip(names, regs):
            plain = pipeline.sketch_file_hll(name, params, 12, "cpu")
            if not np.array_equal(got.regs, plain):
                fail(f"golden genomes: {name}'s card registers differ from "
                     "its plain fold on the CPU")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log("[banks] golden genomes: one banked K1 launch; g0's registers equal "
        "golden.hll (the JAX CLI's), all three their plain fold on the CPU")


def phase_banks(dev, records):
    """Banked K1 at BANK_K1_SHAPES and with its rows in no order, banked
    K2 at BANK_K2: each bitwise against its plain version on the card and
    the single-bank entry bank by bank, timed alone and as launched; then
    the golden genomes.  Bounds as K1's and K2's, plus the bank vector
    read once and one bank load a row; banked K1's merges and ordering
    are logged beside its bound, not in it."""
    import torch
    from dashing_tpu_torch.ops import encode_hash as eh
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 4)
    for shape in BANK_K1_SHAPES:
        _banks_k1(dev, records, rng, shape)
    _banks_k1(dev, records, rng, BANK_K1, shuffled=True)

    G, W, k, p = BANK_K2
    tile = _random_chunk(rng, G, W)
    # records of 500 bases to the full width, padded with N as
    # pipeline._record_batches pads them
    lens = np.exp(rng.uniform(np.log(500), np.log(W - 20), G)).astype(int)
    tile[np.arange(W)[None, :] >= lens[:, None]] = ord("N")
    t = torch.from_numpy(tile).to(dev)
    bk = torch.arange(G, dtype=torch.int32, device=dev)
    got = torch.zeros((G, 1 << p), dtype=torch.int32, device=dev)
    want, singles = torch.zeros_like(got), torch.zeros_like(got)
    eh.ascii_to_banks(t, bk, got, k=k, p=p)
    eh.ascii_to_banks_plain(t, bk, want, k=k, p=p, canon=True)
    for r in range(G):
        eh.ascii_to_registers(t[r:r + 1], singles[r], k=k, p=p)
    _check_banks(got, want, singles, f"banked K2 k={k} p={p} ({G} records "
                 f"x {W})")
    ring = torch.zeros((RING, G, 1 << p), dtype=torch.int32, device=dev)
    ms, paced = kernel_alone_ms(
        lambda i: eh.ascii_to_banks(t, bk, ring[i], k=k, p=p), ring.zero_,
        "banked K2")
    del ring
    plain_ms = cuda_ms(lambda: eh.ascii_to_banks_plain(
        t, bk, want.zero_(), k=k, p=p, canon=True), 5)
    nbytes = tile.nbytes + 4 * G + 2 * 4 * G * (1 << p)
    ops = enc_ops(G, W, k, _valid_windows(tile, k), True) + G
    _enc_log("banked K2", k, p, G, W, nbytes, ops, ms, paced, plain_ms, eh)
    record(records, f"ascii_hash_banks k={k} p={p} ({G}x{W})", K1_SRC,
           K2_REPLACES, "ascii_hash_banks", 0.0, ms, plain_ms, nbytes, ops,
           INT32_OPS)
    _banks_golden(dev)
    log(f"[banks] phase {time.perf_counter() - t0:.1f}s")


def _k3_bank(dev, p: int, n: int):
    """n register rows at realistic cardinalities: sketch i is K1 over a
    contiguous range of a shared pool of random packed rows, so sizes run
    from ~33 thousand to ~4 million k-mers and overlapping ranges share
    content."""
    import torch
    from dashing_tpu_torch.ops import encode_hash as eh
    g = torch.Generator(device=dev).manual_seed(SEED)
    C = 8224
    pool_rows = 16384
    pool = torch.randint(0, 256, (pool_rows, C // 4), dtype=torch.uint8,
                         device=dev, generator=g)
    vb = torch.full((pool_rows, C // 8), 255, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(SEED)
    lens = np.exp(rng.uniform(np.log(4), np.log(512), n)).astype(int)
    starts = rng.integers(0, pool_rows - lens)
    bank = torch.zeros((n, 1 << p), dtype=torch.int32, device=dev)
    for i in range(n):
        s, ln = int(starts[i]), int(lens[i])
        eh.packed_to_registers(pool[s:s + ln], vb[s:s + ln], bank[i], k=31,
                               p=p)
    return bank.to(torch.int8), lens


def phase_k3(dev, records):
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    p, n = 14, 1024
    t0 = time.perf_counter()
    bank, lens = _k3_bank(dev, p, n)
    regs = bank.cpu().numpy().astype(np.int32)
    mm = pw._block_minmax(regs, n, n)
    kmax, kmin = pw._pair_window(mm[0], mm[0], 64 - p)
    stats = pw.pair_stats(bank, bank, kmax, kmin, same=True)
    cumT = stats["cum_union"].permute(2, 0, 1).contiguous()
    K = cumT.shape[0]
    log(f"[K3] bank {n} x 2^{p} from K1 ({lens.min()}-{lens.max()} rows of "
        f"8192 bases each), window kmin={kmin} K={K} "
        f"({time.perf_counter() - t0:.2f}s)")
    check_cum_union(bank, bank, kmin, kmax, True, "n1024 same bank",
                    records)
    for method, name in ((est.ORIGINAL, "ORIGINAL"),
                         (est.ERTL_IMPROVED, "IMPROVED"),
                         (est.ERTL_MLE, "MLE")):
        c_a = _check_estimates(stats["hist_a"], p, kmin, method,
                               est.WINDOW_MLE_ITERS, f"marginals {name}",
                               f"{n} rows p={p} K={K}", records, chain=True)
        _check_triples(cumT, c_a, c_a, p, kmin, method, name,
                       f"{n}x{n} pairs p={p} K={K}", 10, 3, records)
    # a ragged row count: 1001 rows, no whole number of blocks or warps
    _check_estimates(stats["hist_a"][:1001], p, kmin, est.ERTL_MLE,
                     est.WINDOW_MLE_ITERS, "marginals MLE ragged",
                     f"1001 rows p={p} K={K}", records, chain=True)


def _bitwise(got, want, what):
    """Fail unless got equals want bit for bit: max abs err 0 on the
    finite entries, the same finite, NaN and infinite entries."""
    import torch
    fin = torch.isfinite(want)
    inf = torch.isinf(want)
    if not (torch.equal(fin, torch.isfinite(got))
            and torch.equal(torch.isnan(want), torch.isnan(got))
            and torch.equal(got[inf], want[inf])):
        fail(f"{what}: non-finite entries differ")
    err = (got - want).abs()[fin]
    max_err = float(err.max()) if err.numel() else 0.0
    if max_err != 0.0 or not torch.equal(got[fin], want[fin]):
        fail(f"{what}: not bit for bit equal to the plain version (max abs "
             f"err {max_err})")


def empty_launch_floor(dev):
    """The floor a short kernel's times are read against: an empty
    <<<1, 32>>> launch (b1_peak.cu `dtt_empty`) through the same ctypes
    path, timed alone and as launched (kernel_alone_ms)."""
    from dashing_tpu_torch.ops import _build
    lib = _b1_lib()
    alone, paced = kernel_alone_ms(
        lambda i: _build.launch(lib, "dtt_empty", dev), lambda: None,
        "empty launch")
    EMPTY_MS.update(alone=alone, paced=paced)
    log(f"[floor] empty <<<1, 32>>> launch: alone {alone:.4f} ms, as "
        f"launched {paced:.4f} ms")


def _rows_times(hist, p, kmin, code, iters, lanes_all):
    """{lanes: (alone ms, as-launched ms)} of the row-estimate kernel on
    hist in each form of lanes_all.  Raw launches into one output (no
    wrapper, no count)."""
    import torch
    from dashing_tpu_torch.ops import _build
    from dashing_tpu_torch.ops import union_mle as um
    n, K = hist.shape
    dev = hist.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = um._rows_lib()
    args = (hist.data_ptr(), out.data_ptr(), n, K, p, kmin, code, iters)
    return {x: kernel_alone_ms(
        lambda i, x=x: _build.launch(lib, "dtt_estimate_rows", dev, *args, x),
        lambda: None, f"rows lanes {x}") for x in lanes_all}


def _check_estimates(hist, p, kmin, method, iters, what, shape, records,
                     chain=False):
    """Row-estimate kernel vs its plain version, bit for bit (max abs err
    0, non-finite entries alike), through the wrapper and, for an MLE, in
    both forms (8 and 32 lanes a row); returns the wrapper's estimates.
    `chain`: MLE by the complement chain, as a compare tile's marginals
    take it.  Each form timed alone and as launched (`_rows_times`),
    beside the empty-launch floor; the record's ms is the wrapper's form
    alone."""
    import torch
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    n, K = hist.shape
    auto = um.row_lanes(n, method)
    lanes_all = (8, 32) if method == est.ERTL_MLE else (1,)
    want = um.estimate_rows_plain(hist, p=p, kmin=kmin, method=method,
                                  iters=iters, chain=chain)
    result = um.estimate_rows(hist, p=p, kmin=kmin, method=method,
                              iters=iters, chain=chain)
    torch.cuda.synchronize()
    _bitwise(result, want, f"estimate_rows {what} ({shape}, the wrapper)")
    for lanes in lanes_all:
        got = um._launch_rows(hist, p=p, kmin=kmin, method=method,
                              iters=iters, chain=chain, lanes=lanes)
        torch.cuda.synchronize()
        _bitwise(got, want, f"estimate_rows {what} ({shape}, lanes {lanes})")
    code = 3 if chain and method == est.ERTL_MLE else method
    times = _rows_times(hist, p, kmin, code, iters, lanes_all)
    ms = times[auto][0]
    plain_ms = cuda_ms(lambda: um.estimate_rows_plain(
        hist, p=p, kmin=kmin, method=method, iters=iters, chain=chain), 3)
    forms = ", ".join(f"lanes {k} {v[0]:.4f} / {v[1]:.4f}"
                      for k, v in times.items())
    log(f"[est] {what}, {shape}: bit for bit (max abs err 0) in every form; "
        f"ms alone / as launched: {forms} (the wrapper takes lanes {auto}); "
        f"empty launch {EMPTY_MS['alone']:.4f} / {EMPTY_MS['paced']:.4f}; "
        f"plain {plain_ms:.4f} ms")
    # the MLE forms skip empty levels up to SKIP_EMPTY_ITERS steps; with
    # more, every level is computed
    nonempty = int((hist != 0).sum()) if iters <= 16 else n * K
    record(records, f"estimate_rows {what} ({shape})", ROWS_SRC, K3_REPLACES,
           "estimate_rows", 0.0, ms, plain_ms, 4 * n * K + 4 * n,
           k3_ops(n, K, method, iters, nonempty), FP32_OPS)
    return result


def _check_triples(cumT, c_a, c_b, p, kmin, method, name, shape, reps,
                   plain_reps, records):
    """K3 vs its plain version: bit for bit (max abs err 0, non-finite
    entries alike), and within the old bar (rtol=K3_RTOL, atol=K3_ATOL on
    triples) as well.  Returns the kernel's triples."""
    import torch
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    na, nb = cumT.shape[1:]
    got = um.union_triples(cumT, c_a, c_b, p=p, kmin=kmin, method=method)
    want = um.union_triples_plain(cumT, c_a, c_b, p=p, kmin=kmin,
                                  method=method)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not (torch.equal(fin, torch.isfinite(got))
            and torch.equal(torch.isnan(want), torch.isnan(got))):
        fail(f"K3 {name} {shape}: non-finite entries differ")
    err = (got - want).abs()[fin]
    tol = K3_ATOL + K3_RTOL * want.abs()[fin]
    bad = int((err > tol).sum())
    max_err = float(err.max())
    if bad:
        fail(f"K3 {name} {shape}: {bad} triples outside rtol={K3_RTOL} "
             f"atol={K3_ATOL} (max abs err {max_err})")
    if max_err != 0.0 or not torch.equal(got[fin], want[fin]):
        fail(f"K3 {name} {shape}: not bit for bit equal to the plain "
             f"version (max abs err {max_err})")
    ms = cuda_ms(lambda: um.union_triples(cumT, c_a, c_b, p=p, kmin=kmin,
                                          method=method), reps)
    plain_ms = cuda_ms(lambda: um.union_triples_plain(
        cumT, c_a, c_b, p=p, kmin=kmin, method=method), plain_reps)
    log(f"[K3] {name} {shape}: bit for bit equal, max abs err {max_err:.3g}"
        f" (bar rtol={K3_RTOL} atol={K3_ATOL}); kernel {ms:.4f} ms "
        f"({na * nb / ms / 1e3:.1f} M pairs/s), plain {plain_ms:.4f} ms")
    K = cumT.shape[0]
    nonempty = int((cumT[0] != 0).sum() + (cumT[1:] != cumT[:-1]).sum())
    log(f"[K3] {name} {shape}: nonempty levels a pair "
        f"{nonempty / (na * nb):.2f} of {K}")
    record(records, f"union_triples {name} ({shape})", K3_SRC, K3_REPLACES,
           "union_triples", max_err, ms, plain_ms,
           4 * (K * na * nb + na + nb + 3 * na * nb),
           k3_ops(na * nb, K, method, est.WINDOW_MLE_ITERS, nonempty),
           FP32_OPS)
    return got


def _indicators(a, b, kmin: int, kmax: int, joint: bool):
    """Stacked 0/1 indicators of the yardsticks, one pair of planes per
    product: X (k, k) for every level, and with `joint` also Y (k, k-1)
    and Z (k-1, k)."""
    import torch
    ks = torch.arange(kmin, kmax + 1, device=a.device, dtype=torch.int8)
    ka = torch.cat([ks, ks, ks - 1]) if joint else ks
    kb = torch.cat([ks, ks - 1, ks]) if joint else ks
    return a[None] <= ka[:, None, None], b[None] <= kb[:, None, None]


def _indicator_bmm(a, b, kmin: int, kmax: int, joint: bool):
    """The library yardstick for K4: every product as ONE batched float32
    matmul (TF32 off) of the stacked indicators; the port never calls
    it."""
    import torch
    ia, ib = _indicators(a, b, kmin, kmax, joint)
    A = ia.to(torch.float32)
    B = ib.to(torch.float32).transpose(1, 2)
    return lambda: torch.bmm(A, B)


def _indicator_int_mm(a, b, kmin: int, kmax: int, joint: bool):
    """The int8 yardstick: torch._int_mm (int8 in, int32 out, the JAX
    package's `_dot`) once per product; rows padded with zeros to a
    multiple of 8 and past 16, as its shape rules require.  The port
    never calls it."""
    import torch
    ia, ib = _indicators(a, b, kmin, kmax, joint)
    na, nb = a.shape[0], b.shape[0]
    pa, pb = max(17, -(-na // 8) * 8), -(-nb // 8) * 8
    A = torch.zeros((ia.shape[0], pa, a.shape[1]), dtype=torch.int8,
                    device=a.device)
    B = torch.zeros((ib.shape[0], pb, b.shape[1]), dtype=torch.int8,
                    device=a.device)
    A[:, :na] = ia
    B[:, :nb] = ib
    del ia, ib

    def run():
        for t in range(A.shape[0]):
            torch._int_mm(A[t], B[t].T)
    return run


def _yardsticks(a, b, kmin, kmax, joint):
    """(fp32 bmm ms, int8 _int_mm ms) for the same products."""
    import torch
    times = []
    for make in (_indicator_bmm, _indicator_int_mm):
        fn = make(a, b, kmin, kmax, joint)
        times.append(cuda_ms(fn, 2))
        del fn
        torch.cuda.empty_cache()
    return times


def check_k4(a, b, kmin, kmax, same, what, records, reps=5):
    """K4 vs its plain version, bitwise, then kernel, plain and library
    times.  Returns the kernel's statistics."""
    import torch
    from dashing_tpu_torch.ops import joint_stats as js
    (na, m), nb = a.shape, b.shape[0]
    K = kmax - kmin + 1
    got = js.joint_pair_stats(a, b, kmin=kmin, kmax=kmax, same=same)
    want = js.joint_pair_stats_plain(a, b, kmin=kmin, kmax=kmax, same=same)
    torch.cuda.synchronize()
    for key in want:
        if not torch.equal(got[key], want[key]):
            diff = int((got[key] != want[key]).sum())
            fail(f"K4 {what}: {key} differs from the plain version in "
                 f"{diff} entries")
    ms = cuda_ms(lambda: js.joint_pair_stats(a, b, kmin=kmin, kmax=kmax,
                                             same=same), reps)
    plain_ms = cuda_ms(lambda: js.joint_pair_stats_plain(
        a, b, kmin=kmin, kmax=kmax, same=same), 2)
    del want
    lib_ms, int_ms = _yardsticks(a, b, kmin, kmax, True)
    npairs = na * nb
    nbytes, macs = _k4_work(na, nb, m, K, same, joint=True)
    log(f"[K4] {what}: {na}x{nb} pairs, m={m}, kmin={kmin} K={K}: bitwise "
        f"equal; kernel {ms:.4f} ms ({npairs / ms / 1e3:.1f} M pairs/s), "
        f"plain {plain_ms:.4f} ms, one fp32 bmm of the indicators "
        f"{lib_ms:.4f} ms, torch._int_mm per product {int_ms:.4f} ms; "
        f"{_k4_bounds(nbytes, macs)}")
    record(records, f"joint_pair_stats {what} ({na}x{nb} m={m} K={K})",
           K4_SRC, K4_REPLACES, "joint_pair_stats", 0.0, ms, plain_ms,
           nbytes, macs, B1_MACS["rate"], lib_ms)
    return got


def _k4_work(na, nb, m, K, same, joint):
    """(bytes, one-bit multiply-adds) that a K4 call needs.  Bytes: the
    registers in (one bank read once when `same`), the float32 outputs
    out (four (K, na, nb) stacks joint, one X-only).  Multiply-adds per
    level and register: X over every pair, and joint also Y and Z; for
    one bank X is symmetric (n (n + 1) / 2 pairs determine it) and Z is
    Y^T, so it needs X over the unordered pairs and Y over all pairs."""
    pairs = na * nb
    x_pairs = na * (na + 1) // 2 if same else pairs
    nbytes = (na if same else na + nb) * m + (16 if joint else 4) * K * pairs
    if not joint:
        return nbytes, K * x_pairs * m
    return nbytes, K * (x_pairs + (1 if same else 2) * pairs) * m


def _k4_bounds(nbytes, macs):
    """The log's bound terms: bytes over HBM, the multiply-adds at the
    binary MMAs' measured rate, and (for comparison) at the int8 tensor
    cores' rate."""
    return (f"bound terms: bytes {nbytes / HBM_BPS * 1e3:.4f} ms, one-bit "
            f"MACs {macs / B1_MACS['rate'] * 1e3:.4f} ms (at the int8 rate "
            f"{2 * macs / INT8_TC_OPS * 1e3:.4f} ms)")


def check_cum_union(a, b, kmin, kmax, same, what, records, reps=5):
    """K4's X-only form vs its plain version, bitwise, then kernel, plain
    and library times.  `same`: a and b are one bank (for the bound)."""
    import torch
    from dashing_tpu_torch.ops import joint_stats as js
    (na, m), nb = a.shape, b.shape[0]
    K = kmax - kmin + 1
    got = js.cum_union_counts(a, b, kmin=kmin, kmax=kmax)
    want = js.cum_union_counts_plain(a, b, kmin=kmin, kmax=kmax)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K4 X-only {what}: {int((got != want).sum())} counts differ "
             "from the plain version")
    del got, want
    ms = cuda_ms(lambda: js.cum_union_counts(a, b, kmin=kmin, kmax=kmax),
                 reps)
    plain_ms = cuda_ms(lambda: js.cum_union_counts_plain(
        a, b, kmin=kmin, kmax=kmax), 2)
    lib_ms, int_ms = _yardsticks(a, b, kmin, kmax, False)
    npairs = na * nb
    nbytes, macs = _k4_work(na, nb, m, K, same, joint=False)
    log(f"[K4 X-only] {what}: {na}x{nb} pairs, m={m}, kmin={kmin} K={K}: "
        f"bitwise equal; kernel {ms:.4f} ms ({npairs / ms / 1e3:.1f} M "
        f"pairs/s), plain {plain_ms:.4f} ms, one fp32 bmm of the indicators "
        f"{lib_ms:.4f} ms, torch._int_mm per level {int_ms:.4f} ms; "
        f"{_k4_bounds(nbytes, macs)}")
    record(records, f"cum_union_counts {what} ({na}x{nb} m={m} K={K})",
           K4_SRC, K4_REPLACES, "cum_union_counts", 0.0, ms, plain_ms,
           nbytes, macs, B1_MACS["rate"], lib_ms)


def check_k5(st, rows, ha, hb, c_a, c_b, p, kmin, what, records, reps=5,
             c_u=None):
    """K5 vs its plain version on the K-first statistics `st` restricted to
    row slice `rows` (given the union seeds `c_u` if any): bit for bit
    (max abs err 0, non-finite entries alike), and within the old bars
    (rtol=K3_RTOL atol=K3_ATOL on triples, JI_ATOL on Jaccard) as well.
    Returns the kernel's triples."""
    import torch
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.sketch import estimators as est
    args = [st[key][:, rows].contiguous() for key in ("eq", "gt_a", "gt_b")]
    args += [ha[:, rows].contiguous(), hb, c_a[rows].contiguous(), c_b]
    if c_u is not None:
        args.append(c_u[rows].contiguous())
    K, na, nb = args[0].shape
    got = jm.joint_triples(*args, p=p, kmin=kmin)
    want = jm.joint_triples_plain(*args, p=p, kmin=kmin)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not (torch.equal(fin, torch.isfinite(got))
            and torch.equal(torch.isnan(want), torch.isnan(got))):
        fail(f"K5 {what}: non-finite entries differ")
    err = (got - want).abs()[fin]
    max_err = float(err.max()) if err.numel() else 0.0
    bad = int((err > K3_ATOL + K3_RTOL * want.abs()[fin]).sum())
    ji = [t[2] / t.sum(0).clamp(min=1e-30) for t in (got, want)]
    ok = torch.isfinite(ji[1])
    ji_err = float((ji[0] - ji[1]).abs()[ok].max())
    if bad or ji_err > JI_ATOL:
        fail(f"K5 {what}: {bad} triples outside rtol={K3_RTOL} "
             f"atol={K3_ATOL} (max abs err {max_err}), Jaccard max err "
             f"{ji_err}")
    if max_err != 0.0 or not torch.equal(got[fin], want[fin]):
        fail(f"K5 {what}: not bit for bit equal to the plain version (max "
             f"abs err {max_err})")
    ms = cuda_ms(lambda: jm.joint_triples(*args, p=p, kmin=kmin), reps)
    plain_ms = cuda_ms(lambda: jm.joint_triples_plain(*args, p=p, kmin=kmin),
                       1)
    iters = est.jmle_iters(p)
    eq_levels = int((args[0] > 0).sum())
    log(f"[K5] {what}: {na}x{nb} pairs p={p} kmin={kmin} K={K} ({iters} "
        f"Newton steps, eq > 0 at {eq_levels / (na * nb):.2f} levels a "
        f"pair): bit for bit equal, max abs err {max_err:.3g} (bars rtol="
        f"{K3_RTOL} atol={K3_ATOL}, Jaccard {JI_ATOL}: max err "
        f"{ji_err:.3g}); kernel {ms:.4f} ms ({na * nb / ms / 1e3:.1f} M "
        f"pairs/s), plain {plain_ms:.4f} ms")
    # bytes: three (K, na, nb) stacks, the marginals and cardinalities
    # (and the seeds) in, (3, na, nb) out; operations: k5_ops at the
    # float32 rate
    seeds = 0 if c_u is None else na * nb
    record(records, f"joint_triples {what} ({na}x{nb} p={p} K={K})", K5_SRC,
           K5_REPLACES, "joint_triples", max_err, ms, plain_ms,
           4 * (3 * K * na * nb + K * (na + nb) + na + nb + seeds
                + 3 * na * nb),
           k5_ops(na * nb, K, iters, eq_levels), FP32_OPS)
    return got


def phase_k4_k5(dev, records):
    """K4 on a same-bank 1000 x 2^14 bank and on a ragged 600 x 1000 pair
    of distinct banks with kmin > 0; K5 on 256 x 1000 pairs of the
    same-bank statistics.  Returns the bank (e2e (d) sketches it)."""
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    p, n = 14, 1000
    t0 = time.perf_counter()
    bank, _ = _k3_bank(dev, p, n)
    regs = bank.cpu().numpy().astype(np.int32)
    mm = pw._block_minmax(regs, n, n)
    kmax, kmin = pw._pair_window(mm[0], mm[0], 64 - p)
    log(f"[K4] bank {n} x 2^{p} from K1, window kmin={kmin} K={kmax - kmin + 1}"
        f" ({time.perf_counter() - t0:.2f}s)")
    st = check_k4(bank, bank, kmin, kmax, True, "same bank", records)
    other, _ = _k3_bank(dev, p, 607)       # other ranges of the pool
    lo = int(min(regs.min(), other.min().item()))
    check_k4(other[:600], bank, lo + 2, kmax, False,
             "distinct ragged, kmin>0", records)
    del other
    hist = pw.marginal_histograms(bank, kmin, kmax - kmin + 1)
    c = um.estimate_rows(hist, p=p, kmin=kmin, method=est.ERTL_MLE)
    check_k5(st, slice(0, 256), hist.T, hist.T.contiguous(), c, c, p, kmin,
             "p=14 bank", records)
    return bank


# e2e (g): query positions that are byte copies of reference files, and
# the references they copy
QUERY_COPIES = {7 + 50 * i: 3 + 97 * i for i in range(10)}
N_QUERIES = 500


def query_bank(dev, bank):
    """e2e (g)'s queries as the card holds them: (the `other` bank whose
    rows fill them, the (N_QUERIES, 2^14) int8 query tensor).  Position i
    of QUERY_COPIES holds reference QUERY_COPIES[i]'s row (its .hll file's
    byte copy), every other position the next row of `other`, a bank of
    N_QUERIES - 10 rows from other ranges of the pool."""
    import torch
    other, _ = _k3_bank(dev, 14, N_QUERIES - len(QUERY_COPIES))
    rows = iter(range(other.shape[0]))
    return other, torch.stack([bank[QUERY_COPIES[i]] if i in QUERY_COPIES
                               else other[next(rows)]
                               for i in range(N_QUERIES)])


def phase_rect(dev, bank, records):
    """The query x reference tile of e2e (g)'s -Q runs, at its shape and
    window: the 1000 x 2^14 bank as references (lhs) against the 500
    queries of query_bank (rhs), two tensors, each side with its own
    marginals.  K4's X-only form, K3 (MLE and ORIGINAL, c_a != c_b), K4's
    joint form and K5 (all 1000 x 500 pairs, ha != hb), each bit for bit
    against its plain version; the ten identical (reference, copy) pairs
    must give Jaccard 1 within 1e-5 from K3 and K5.  Their records count
    launches from e2e (g)'s -Q runs.  Returns the `other` bank (e2e (g)
    writes its rows as query files)."""
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    p = 14
    t0 = time.perf_counter()
    other, qs = query_bank(dev, bank)
    n0 = len(records)
    nr, nq = bank.shape[0], qs.shape[0]
    # the CLI's window for its one (1024-row tiles) reference x query tile
    mm_r = pw._block_minmax(bank.cpu().numpy().astype(np.int32), nr,
                            pw.DEFAULT_TILE)
    mm_q = pw._block_minmax(qs.cpu().numpy().astype(np.int32), nq,
                            pw.DEFAULT_TILE)
    kmax, kmin = pw._pair_window(mm_r[0], mm_q[0], 64 - p)
    K = kmax - kmin + 1
    shape = f"{nr}x{nq} pairs p={p} K={K}"
    log(f"[rect] references {nr} x 2^{p}, queries {nq} x 2^{p} ("
        f"{len(QUERY_COPIES)} of them reference rows) from K1, window "
        f"kmin={kmin} K={K} ({time.perf_counter() - t0:.2f}s)")
    copies = (list(QUERY_COPIES.values()), list(QUERY_COPIES))

    def identical(tri, what):
        t = tri[:, copies[0], copies[1]].double()
        err = float((t[2] / t.sum(0) - 1.0).abs().max())
        if not err <= 1e-5:
            fail(f"{what}: a reference and its byte copy have Jaccard "
                 f"{1 - err}")
        log(f"[rect] {what}: the {len(copies[0])} identical pairs at Jaccard"
            f" 1 within {err:.3g} (onlyA, onlyB at most "
            f"{float(t[:2].abs().max()):.3g})")

    check_cum_union(bank, qs, kmin, kmax, False, "two banks", records)
    stats = pw.pair_stats(bank, qs, kmax, kmin)
    cumT = stats["cum_union"].permute(2, 0, 1).contiguous()
    for method, name in ((est.ERTL_MLE, "MLE"), (est.ORIGINAL, "ORIGINAL")):
        c_a, c_b = (um.estimate_rows(stats[h], p=p, kmin=kmin, method=method,
                                     chain=True) for h in ("hist_a", "hist_b"))
        tri = _check_triples(cumT, c_a, c_b, p, kmin, method,
                             f"{name} two banks", shape, 10, 2, records)
        if method == est.ERTL_MLE:
            identical(tri, "K3 MLE two banks")
    del stats, cumT, tri
    st = check_k4(bank, qs, kmin, kmax, False, "two banks", records)
    ha, hb = (pw.marginal_histograms(x, kmin, K) for x in (bank, qs))
    c_a, c_b = (um.estimate_rows(h, p=p, kmin=kmin, method=est.ERTL_MLE)
                for h in (ha, hb))
    tri = check_k5(st, slice(0, nr), ha.T, hb.T.contiguous(), c_a, c_b, p,
                   kmin, "two banks", records, reps=3)
    identical(tri, "K5 two banks")
    del st, tri
    for r in records[n0:]:
        r["counter"] = "rect " + r["counter"]
    return other


def _write_genomes(root: str, n_anc: int, length: int, rng,
                   ancestors=None):
    """n_anc ancestors x len(RATES) mutated copies, each a multi-record
    FASTA with N runs and one lowercase record.  Returns (paths, family,
    copy index) per genome; the ancestors' codes go into `ancestors` when
    a list is given."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for a in range(n_anc):
        anc = rng.integers(0, 4, length, dtype=np.uint8)
        if ancestors is not None:
            ancestors.append(anc)
        for c, rate in enumerate(RATES):
            g = anc.copy()
            hit = np.flatnonzero(rng.random(length) < rate)
            g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
            seq = lut[g]
            for s in rng.integers(0, length - 200, 4):
                seq[s:s + int(rng.integers(20, 200))] = ord("N")
            cuts = np.linspace(0, length, 5).astype(int)
            path = os.path.join(root, f"anc{a:02d}_c{c}.fa")
            with open(path, "wb") as fp:
                for r in range(4):
                    rec = seq[cuts[r]:cuts[r + 1]]
                    if r == 1:
                        rec = rec | 0x20              # lowercase record
                    fp.write(b">anc%d_c%d_r%d\n" % (a, c, r))
                    fp.write(rec.tobytes())
                    fp.write(b"\n")
            out.append((path, a, c))
    return out


def _expected_d(r1: float, r2: float) -> float:
    """Per-site mismatch after independent substitutions at r1 and r2."""
    return r1 * (1 - r2) + r2 * (1 - r1) + r1 * r2 * (2.0 / 3.0)


def _read_condensed(path: str):
    """The `dist -b` file: 1 byte dtype code (0 = float32), u64 LE n, then
    n(n-1)/2 float32 upper-triangle entries, row-major."""
    with open(path, "rb") as fp:
        head = fp.read(9)
        body = np.frombuffer(fp.read(), dtype="<f4")
    if len(head) != 9 or head[0] != 0:
        fail(f"{path}: not a float32 condensed matrix (header {head!r})")
    return int.from_bytes(head[1:], "little"), body


def _cond_index(n: int, i: int, j: int) -> int:
    """Row-major condensed position of pair (i, j), i < j."""
    return i * (2 * n - i - 1) // 2 + j - i - 1


def phase_e2e(dev, bank, other, counts, records):
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import minimizer_hash as mh
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch.hll import HLL
    rng = np.random.default_rng(SEED + 1)
    tmp = tempfile.mkdtemp(prefix="dtt_smoke_")
    try:
        t0 = time.perf_counter()
        genomes = _write_genomes(tmp, 20, 5_000_000, rng)
        paths = [g[0] for g in genomes]
        total_bases = sum(os.path.getsize(p) for p in paths)
        log(f"[e2e] wrote {len(paths)} genomes, {total_bases / 1e6:.1f} MB "
            f"of FASTA ({time.perf_counter() - t0:.1f}s)")

        # (a) config 1's shape: 4 genomes, k21 S14 Mash, full TSV
        out_a = os.path.join(tmp, "a.tsv")
        t0 = time.perf_counter()
        if main(["dist", "-k", "21", "-S", "14", "-M", "-T", "-O", out_a,
                 "-o", os.path.join(tmp, "a.sizes")] + paths[:4]) != 0:
            fail("e2e (a) returned nonzero")
        rows = [l.split("\t") for l in open(out_a).read().splitlines()
                if not l.startswith("#")]
        vals = np.array([[float(v) for v in r[1:]] for r in rows])
        if vals.shape != (4, 4) or not np.isfinite(vals).all():
            fail(f"e2e (a): bad matrix {vals.shape}")
        log(f"[e2e a] 4 genomes k21 S14 -M -T: 4x4 finite "
            f"({time.perf_counter() - t0:.2f}s)")

        # (b) config 2: 100 genomes, k31 S16 Mash, binary
        out_b = os.path.join(tmp, "b.bin")
        eh.launches = eh.ascii_launches = mh.launches = 0
        um.launches = 0
        um.estimate_launches = 0
        js.cum_union_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if main(["dist", "-k", "31", "-S", "16", "-M", "-b", "-O", out_b,
                 "-o", os.path.join(tmp, "b.sizes"), "--avoid-sorting"]
                + paths) != 0:
            fail("e2e (b) returned nonzero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        main_path = {"encode_hash": eh.launches, "union_triples": um.launches,
                     "estimate_rows": um.estimate_launches,
                     "cum_union_counts": js.cum_union_launches}
        log(f"[e2e b] launches: K1 {eh.launches}, K4 X-only "
            f"{js.cum_union_launches}, K3 {um.launches}, row estimates "
            f"{um.estimate_launches}, K2 unbanked {eh.ascii_launches}, "
            f"minimizer {mh.launches}")
        if min(main_path.values()) == 0:
            fail(f"a kernel of the main path was not launched: {main_path}")
        if eh.ascii_launches or mh.launches:
            fail(f"the main path launched K2 unbanked {eh.ascii_launches} "
                 f"and the minimizer kernel {mh.launches} times; it reads "
                 f"2-bit tiles, not ASCII")
        counts.update(main_path)
        counts["ascii_hash_regs"] = eh.ascii_launches
        _check_planted(out_b, genomes, "(b)", wall, total_bases)

        # (c) config 2 with the joint MLE: K1, the row estimates, K4, K5
        out_c = os.path.join(tmp, "c.bin")
        eh.launches = um.launches = um.estimate_launches = 0
        js.launches = js.cum_union_launches = jm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if main(["dist", "-k", "31", "-S", "16", "-J", "-M", "-b", "-O",
                 out_c, "-o", os.path.join(tmp, "c.sizes"),
                 "--avoid-sorting"] + paths) != 0:
            fail("e2e (c) returned nonzero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        joint = {"encode_hash": eh.launches, "estimate_rows":
                 um.estimate_launches, "joint_pair_stats": js.launches,
                 "joint_triples": jm.launches}
        log(f"[e2e c] launches: K1 {eh.launches}, row estimates "
            f"{um.estimate_launches}, K4 {js.launches}, K5 {jm.launches}, "
            f"K3 {um.launches}, K4 X-only {js.cum_union_launches}")
        if min(joint.values()) == 0:
            fail(f"a kernel of the -J path was not launched: {joint}")
        counts["joint_pair_stats"] = js.launches
        counts["joint_triples"] = jm.launches
        _check_planted(out_c, genomes, "(c) -J", wall, total_bases)

        # registers of two genomes through the CLI vs the plain version
        out_s = os.path.join(tmp, "two.hll")
        if main(["sketch", "-k", "31", "-S", "16", "-o", out_s,
                 "--avoid-sorting", paths[0], paths[7]]) != 0:
            fail("sketch returned nonzero")
        with gzip.open(out_s, "rb") as fp:
            got = [HLL.read_record(fp).regs for _ in range(2)]
        params = pipeline.SketchParams(k=31)
        for path, regs in zip((paths[0], paths[7]), got):
            plain = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
            f = pipeline.InputFile(0, path, params.spacer())
            for tile in f.tiles():
                packed, vbits = pipeline._pack_tile_host(tile)
                eh.packed_to_registers_plain(
                    torch.from_numpy(packed).to(dev),
                    torch.from_numpy(vbits).to(dev), plain, k=31, p=16,
                    canon=params.canon)
            if not np.array_equal(pipeline.registers_to_numpy(plain), regs):
                fail(f"{os.path.basename(path)}: CLI registers differ from "
                     "the plain version")
        log("[e2e] two genomes' CLI registers bitwise equal to the plain "
            "version on the card")
        _e2e_encodings(dev, genomes, total_bases, tmp, counts)
        sketches = _phase_times(dev, paths, total_bases)
        _config2_kernels(dev, sketches, records)
        _e2e_mesh(dev, paths, sketches, tmp, out_b, out_c)
        hlls, cond_m = _e2e_joint_bank(bank, tmp)
        _e2e_query(dev, other, hlls, cond_m, paths[:20], tmp, counts)
        _e2e_setsketch(dev, genomes, tmp)
        _e2e_extra(dev, genomes, tmp, out_b, out_c)
        _e2e_khset(dev, genomes, tmp, out_b)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# e2e (e): (tag, dist options, planted check, SketchParams of the CPU run)
ENCODING_RUNS = (
    ("-s 1x4", ["-k", "31", "-s", "1x4"], True,
     dict(k=31, spacing="1x4")),
    ("-w 50", ["-k", "31", "-w", "50"], False, dict(k=31, w=50)),
    ("-g -w 50", ["-k", "31", "-g", "-w", "50"], False,
     dict(k=31, w=50, entropy=True)),
    ("--use-nthash -k 41", ["-k", "41", "--use-nthash"], True,
     dict(k=41, encoding="nthash")),
)


def _e2e_encodings(dev, genomes, total_bases, tmp, counts):
    """(e) The ASCII-tile route through the CLI: config 2's genomes under
    -s, -w, -g -w and ntHash.  Each run: wall time, a finite n(n-1)/2
    matrix, the compare kernels launched; -s and ntHash: every planted pair
    within 0.25 d + 0.001.  Then two genomes' registers from the CLI on the
    card against a CPU run of the same port code.  -w and -g run on the
    first 20 genomes if the first two runs took over 60 s."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import minimizer_hash as mh
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch.hll import HLL
    paths = [g[0] for g in genomes]
    spent = 0.0
    for tag, opts, planted, kw in ENCODING_RUNS:
        use = genomes
        if not planted and spent > 60.0:
            use = genomes[:20]
        out = os.path.join(tmp, "e.bin")
        eh.launches = eh.ascii_launches = mh.launches = 0
        um.launches = um.estimate_launches = 0
        pipeline.chunk_uploads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if main(["dist", "-S", "16", "-M", "-b", "-O", out, "-o",
                 out + ".sizes", "--avoid-sorting"] + opts
                + [g[0] for g in use]) != 0:
            fail(f"e2e (e) {tag} returned nonzero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spent += wall
        log(f"[e2e e] {tag}: launches K1 {eh.launches}, K2 "
            f"{eh.ascii_launches}, minimizer {mh.launches} "
            f"({pipeline.chunk_uploads} chunks uploaded), K3 "
            f"{um.launches}, row estimates {um.estimate_launches}")
        if um.launches == 0 or um.estimate_launches == 0:
            fail(f"e2e (e) {tag}: the compare kernels were not launched")
        # -w 50 takes the minimizer kernel once a chunk; -s, -g and ntHash
        # keep the PyTorch ops
        minimizer = tag == "-w 50"
        if (mh.launches != pipeline.chunk_uploads if minimizer
                else mh.launches) or pipeline.chunk_uploads == 0:
            fail(f"e2e (e) {tag}: {mh.launches} minimizer launches for "
                 f"{pipeline.chunk_uploads} chunks")
        if minimizer:
            counts["minimizer_regs"] = mh.launches
        n, cond = _read_condensed(out)
        if n != len(use) or cond.shape != (n * (n - 1) // 2,):
            fail(f"e2e (e) {tag}: matrix n={n} len={cond.shape}")
        if not np.isfinite(cond).all():
            fail(f"e2e (e) {tag}: non-finite distances")
        bases = sum(os.path.getsize(g[0]) for g in use)
        if planted:
            _check_planted(out, use, f"(e) {tag}", wall, bases)
        else:
            log(f"[e2e (e) {tag}] {n} genomes: {cond.size} finite distances;"
                f" wall {wall:.2f}s, {bases / wall / 1e6:.1f} M bases/s end "
                f"to end")
        # two genomes through `sketch` on the card vs the port on the CPU
        two = (paths[0], paths[7])
        out_s = os.path.join(tmp, "e.hll")
        if main(["sketch", "-S", "16", "-o", out_s, "--avoid-sorting"]
                + [o if o != "-g" else "--by-entropy" for o in opts]
                + list(two)) != 0:
            fail(f"e2e (e) {tag}: sketch returned nonzero")
        with gzip.open(out_s, "rb") as fp:
            got = [HLL.read_record(fp).regs for _ in range(2)]
        params = pipeline.SketchParams(**kw)
        t0 = time.perf_counter()
        for path, regs in zip(two, got):
            cpu = pipeline.sketch_file_hll(path, params, 16,
                                           torch.device("cpu"))
            if not np.array_equal(cpu, regs):
                fail(f"e2e (e) {tag}: {os.path.basename(path)}: "
                     f"{int((cpu != regs).sum())} registers on the card differ"
                     " from the CPU run")
        log(f"[e2e (e) {tag}] two genomes' registers on the card bitwise "
            f"equal to the CPU run ({time.perf_counter() - t0:.1f}s on the "
            "CPU)")


def _check_planted(path, genomes, what, wall, total_bases):
    """The `dist -M -b` matrix of config 2: finite, n(n-1)/2 long, every
    planted pair's Mash distance within 0.25 d + 0.001 of d."""
    n, cond = _read_condensed(path)
    if n != len(genomes) or cond.shape != (n * (n - 1) // 2,):
        fail(f"e2e {what}: matrix n={n} len={cond.shape}")
    if not np.isfinite(cond).all():
        fail(f"e2e {what}: non-finite distances")
    worst, planted = 0.0, 0
    for i in range(n):
        for j in range(i + 1, n):
            if genomes[i][1] != genomes[j][1]:
                continue
            d = _expected_d(RATES[genomes[i][2]], RATES[genomes[j][2]])
            got = float(cond[_cond_index(n, i, j)])
            worst = max(worst, abs(got - d) / (0.25 * d + 0.001))
            planted += 1
            if abs(got - d) > 0.25 * d + 0.001:
                fail(f"e2e {what}: planted pair {i},{j}: Mash {got:.5f} vs "
                     f"d={d:.5f}")
    log(f"[e2e {what}] {n} genomes -M -b: {n * (n - 1) // 2} finite "
        f"distances, {planted} planted pairs within 0.25d+0.001 (worst at "
        f"{worst:.2f} of the bound); wall {wall:.2f}s, "
        f"{total_bases / wall / 1e6:.1f} M bases/s end to end")


def _e2e_joint_bank(bank, tmp):
    """(d) the 1k-genome -J compare: the 1000 p=14 sketches of the K4 bank
    as .hll files, `dist -H -J -M -b` over all 499,500 pairs; then one
    -J-less run for the largest Jaccard difference between the two."""
    import torch
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    regs = bank.cpu().numpy().astype(np.uint8)
    n, p = regs.shape[0], 14
    hdir = os.path.join(tmp, "bank")
    os.makedirs(hdir)
    hlls = []
    for i in range(n):
        hlls.append(os.path.join(hdir, f"s{i:04d}.hll"))
        HLL(p, est.ERTL_MLE, est.ERTL_JOINT_MLE, regs[i]).write(hlls[-1])
    out = {}
    for tag, extra in (("J", ["-J"]), ("m", [])):
        path = os.path.join(tmp, f"d_{tag}.bin")
        js.launches = js.cum_union_launches = jm.launches = um.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if main(["dist", "-k", "31", "-H", "-M", "-b", "-O", path, "-o",
                 path + ".sizes"] + extra + hlls) != 0:
            fail(f"e2e (d) -{tag} returned nonzero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m_, cond = _read_condensed(path)
        if m_ != n or cond.shape != (n * (n - 1) // 2,):
            fail(f"e2e (d): matrix n={m_} len={cond.shape}")
        if not np.isfinite(cond).all():
            fail(f"e2e (d) -{tag}: non-finite distances")
        out[tag] = cond
        form = js.launches if extra else js.cum_union_launches
        if form == 0:
            fail(f"e2e (d) -{tag}: K4's {'joint' if extra else 'X-only'} "
                 "form was not launched")
        if (jm.launches if extra else um.launches) == 0:
            fail(f"e2e (d) -{tag}: {'K5' if extra else 'K3'} was not "
                 "launched")
        log(f"[e2e d] dist -H {' '.join(extra + ['-M', '-b'])} over {n} p={p}"
            f" sketches: {cond.size} finite distances, wall {wall:.3f}s "
            f"({cond.size / wall:.0f} pairs/s, sketch load and -o included);"
            f" K4 joint launches {js.launches}, X-only "
            f"{js.cum_union_launches}, K3 {um.launches}, K5 {jm.launches}")
    # Mash d = -ln(2J / (1 + J)) / k  =>  J = r / (2 - r), r = exp(-k d)
    ji = {t: (lambda r: r / (2.0 - r))(np.exp(-31.0 * c.astype(np.float64)))
          for t, c in out.items()}
    log(f"[e2e d] largest |JI(-J) - JI(-m)| over the pairs: "
        f"{float(np.abs(ji['J'] - ji['m']).max()):.6f}")
    return hlls, out["m"]


def write_query_bank(qdir: str, other, hlls):
    """N_QUERIES query .hll files: byte copies of the references in
    QUERY_COPIES, the rest rows of the `other` bank.  Returns their paths."""
    import shutil as sh
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    regs = other.cpu().numpy().astype(np.uint8)
    os.makedirs(qdir)
    out, row = [], 0
    for i in range(N_QUERIES):
        out.append(os.path.join(qdir, f"q{i:03d}.hll"))
        if i in QUERY_COPIES:
            sh.copyfile(hlls[QUERY_COPIES[i]], out[-1])
        else:
            HLL(14, est.ERTL_MLE, est.ERTL_MLE, regs[row]).write(out[-1])
            row += 1
    return out


def _write_list(path: str, paths) -> str:
    with open(path, "w") as fp:
        fp.write("".join(x + "\n" for x in paths))
    return path


def _read_nn_tsv(path: str):
    """(names, ids (n, nn), values (n, nn)) of a --nearest-neighbors TSV."""
    lines = open(path).read().splitlines()
    if lines[0] != "#File\tNeighbor ID:distance\t...":
        fail(f"{path}: NN header {lines[0]!r}")
    rows = [l.split("\t") for l in lines[1:]]
    ids = np.array([[int(f.split(":")[0]) for f in r[1:]] for r in rows])
    vals = np.array([[float(f.split(":")[1]) for f in r[1:]] for r in rows])
    return [r[0] for r in rows], ids, vals


def _read_nn_bin(path: str):
    raw = open(path, "rb").read()
    n, nn = np.frombuffer(raw[:8], "<u4")
    rec = np.frombuffer(raw[8:], dtype=[("v", "<f4"), ("i", "<u4")])
    if rec.shape != (n * nn,):
        fail(f"{path}: {rec.shape} records for {n} x {nn}")
    return rec["i"].reshape(n, nn).astype(np.int64), rec["v"].reshape(n, nn)


_J_BINS = ((0, 1e-3), (1e-3, 1e-2), (1e-2, 1e-1), (1e-1, 1.01))


def _by_jaccard(ji, **errs) -> str:
    """'J in [lo, hi): n pairs, <name> <max err>, ...' over _J_BINS; an
    error array may be NaN where it does not apply."""
    out = []
    for lo, hi in _J_BINS:
        sel = (ji >= lo) & (ji < hi)
        if sel.any():
            out.append(f"J in [{lo:g}, {hi:g}): {int(sel.sum())} pairs" + "".join(
                f", {k.replace('_', ' ')} {float(np.nanmax(v[sel], initial=0)):.3g}"
                for k, v in errs.items()))
    return "; ".join(out)


def _corner_vs_cpu(hlls, queries, mash, mash_j, rows=64, cols=48):
    """The first rows x cols of the -Q Mash matrices (queries x references;
    `mash` from -M, `mash_j` from -J -M) against the port's plain versions
    on the CPU, over the same tile window as the card's one 1000 x 500
    tile.  Jaccard from the distance: J = r / (2 - r), r = exp(-k d).
    -M: pairs with J >= 1e-3 within Jaccard 2e-6 and Mash rtol 1e-4, every
    pair within Jaccard 1e-3 (an eighth of a p = 14 sketch's standard error
    1/sqrt(m)); below 1e-3 the shared count is a difference of estimates
    of up to ~4 million and carries the devices' last-bit differences in
    exp and log.  -J: _joint_corner_cause."""
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    import torch
    rr = pw._stack_regs([HLL.read(h) for h in hlls])
    qq = pw._stack_regs([HLL.read(q) for q in queries])
    p = 14
    kmax, kmin = pw._pair_window(
        pw._block_minmax(rr, len(rr), pw.DEFAULT_TILE)[0],
        pw._block_minmax(qq, len(qq), pw.DEFAULT_TILE)[0], 64 - p)
    cpu = torch.device("cpu")
    a = pw._device_regs(rr[:cols], cpu)
    b = pw._device_regs(qq[:rows], cpu)
    want = pw.compare_tile(a, b, p, pw.MASH_DIST, 1.0 / 31, est.ERTL_MLE,
                           est.ERTL_MLE, kmax, kmin).T.numpy()
    got = mash[:rows, :cols]
    ji = [_mash_ji(x) for x in (got, want)]
    ji_err = np.abs(ji[0] - ji[1])
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    log(f"[e2e g] -M {rows}x{cols} corner vs the plain versions on the CPU "
        f"(window kmin={kmin} K={kmax - kmin + 1}), by Jaccard: "
        + _by_jaccard(ji[1], Jaccard_err=ji_err, Mash_rel_err=rel))
    sure = ji[1] >= 1e-3
    bad = int((sure & ((ji_err > 2e-6) | (rel > 1e-4))).sum()
              + (ji_err > 1e-3).sum())
    if bad:
        fail(f"e2e (g) -M: {bad} pairs of the corner beyond the bars "
             "(Jaccard 2e-6 and Mash rtol 1e-4 where J >= 1e-3, Jaccard "
             "1e-3 everywhere)")
    log(f"[e2e g] -M corner: the {int(sure.sum())} pairs with Jaccard >= "
        f"1e-3 within Jaccard 2e-6 and Mash rtol 1e-4, all {got.size} "
        "within Jaccard 1e-3")
    _joint_corner_cause(a, b, mash_j[:rows, :cols], p, kmax, kmin)


def _mash_ji(d):
    """Jaccard (float64) from Mash distances at k = 31."""
    r = np.exp(-31.0 * d.astype(np.float64))
    return r / (2.0 - r)


def _joint_corner_cause(a, b, got, p, kmax, kmin):
    """The -J corner (`got`, queries b x references a) against the CPU.
    First on the card: K5's plain version over the corner's statistics must
    give the main path's distances bit for bit, the statistics (exact
    counts) must equal the CPU's.  Then the plain version on the two
    devices, each from its own marginal estimates, and on the CPU from the
    card's (which leaves K5's own arithmetic).  K5 keeps its Newton result
    only if its log-likelihood is not below the start's, else the start
    (the inclusion-exclusion triple); for a near-disjoint pair the two
    values can lie within float32 rounding of each other, so a last-bit
    difference can flip that choice and move Jaccard by ~1e-5.  Pairs that
    take the same branch on both devices must agree within Jaccard 2e-6
    and, where J >= 1e-3, Mash rtol 1e-4; pairs that flip, within Jaccard
    1e-3.  The log counts the flips and gives the errors by Jaccard."""
    import torch
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est

    def inputs(x, y):
        st = pw.pair_stats(x, y, kmax, kmin, joint=True)
        return ([st[k].permute(2, 0, 1).contiguous()
                 for k in ("eq", "gt_a", "gt_b")]
                + [st["hist_a"].T.contiguous(), st["hist_b"].T.contiguous()]
                + [um.estimate_rows(st[h], p=p, kmin=kmin,
                                    method=est.ERTL_MLE)
                   for h in ("hist_a", "hist_b")])

    def mash(tri):
        """(3, na, nb) triples -> (nb, na) Mash distances on the host."""
        return pw.measure_from_triples(tri.permute(1, 2, 0), pw.MASH_DIST,
                                       1.0 / 31).T.cpu().numpy()

    card = inputs(a.cuda(), b.cuda())
    host = inputs(a, b)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(card[:5], host[:5])):
        fail("e2e (g) -J corner: the joint statistics or marginal "
             "histograms differ between the card and the CPU")
    plain = jm.joint_triples_plain(*card, p=p, kmin=kmin)
    if not np.array_equal(mash(plain).view(np.uint32), got.view(np.uint32)):
        fail("e2e (g) -J corner: the main path's distances differ from K5's "
             "plain version on the card")
    dc = [float(((x.cpu() - y).abs() / y).max()) for x, y in
          zip(card[5:], host[5:])]
    card_cpu = [t.cpu() for t in card]
    runs = {"card": (plain.cpu(), jm.joint_triples_plain(
        *card, p=p, kmin=kmin, iters=0).cpu())}
    for tag, args in (("CPU", host), ("CPU from the card's marginals",
                                      card_cpu)):
        runs[tag] = (jm.joint_triples_plain(*args, p=p, kmin=kmin),
                     jm.joint_triples_plain(*args, p=p, kmin=kmin, iters=0))

    def ji(t):
        t = t.double()
        return (t[2] / t.sum(0)).numpy().T

    kept = {k: ~(v == s).all(0).numpy().T for k, (v, s) in runs.items()}
    J = ji(runs["card"][0])
    log(f"[e2e g] -J -M {got.shape[0]}x{got.shape[1]} corner: bit for bit "
        "equal to K5's plain version on the card; joint statistics equal "
        "the CPU's; marginal estimates card vs CPU max rel diff "
        f"{dc[0]:.3g} (references), {dc[1]:.3g} (queries); Newton result "
        f"kept for {int(kept['card'].sum())} of {J.size} pairs on the card")
    bad = 0
    for tag in ("CPU", "CPU from the card's marginals"):
        err = np.abs(ji(runs[tag][0]) - J)
        rel = np.abs(mash(runs[tag][0]) - got) / np.maximum(np.abs(got),
                                                            1e-30)
        flip = kept[tag] != kept["card"]
        log(f"[e2e g] -J -M corner, {tag} vs the card: {int(flip.sum())} "
            "pairs keep the Newton result on one device only; by Jaccard: "
            + _by_jaccard(J, same_branch_Jaccard_err=np.where(flip, np.nan,
                                                             err),
                          same_branch_Mash_rel_err=np.where(flip, np.nan,
                                                            rel),
                          flipped_Jaccard_err=np.where(flip, err, np.nan)))
        bad += int((~flip & ((err > 2e-6) | ((J >= 1e-3) & (rel > 1e-4))))
                   .sum() + (err > 1e-3).sum())
    if bad:
        fail(f"e2e (g) -J corner: {bad} pairs beyond the bars (same branch: "
             "Jaccard 2e-6, Mash rtol 1e-4 where J >= 1e-3; every pair "
             "Jaccard 1e-3)")


def _e2e_query(dev, other, hlls, cond_m, genomes, tmp, counts):
    """(g) query/reference `dist` on the card: e2e (d)'s 1000 .hll files as
    references, N_QUERIES queries (rows of the `other` bank, and byte
    copies of ten references).  -Q -M, --containment-index, -J -Q -M,
    --nearest-neighbors 5 with and without -Q in TSV and binary,
    --containment-dist without -Q (a 1000 x 1000 rect; with -H the query
    half is read again, as the JAX CLI does), the same over 20 FASTA
    genomes (the aliased half: each file sketched once), and -Q with the
    references as queries against e2e (d)'s condensed -M matrix, bit for
    bit.  Each run's kernels must launch; every value finite; a 64 x 48
    corner of the -M and -J matrices against the port's plain versions on
    the card and the CPU (_corner_vs_cpu, _joint_corner_cause)."""
    import torch
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    t_all = time.perf_counter()
    nr, nq = len(hlls), N_QUERIES
    queries = write_query_bank(os.path.join(tmp, "queries"), other, hlls)
    qfile = _write_list(os.path.join(tmp, "q.txt"), queries)
    rfile = _write_list(os.path.join(tmp, "r.txt"), hlls)
    base = ["dist", "-k", "31", "-H"]

    def run(tag, argv, pairs, kernels):
        """Run the CLI with the counts at 0; fail unless each named
        kernel launched; return (output path, launches)."""
        out = os.path.join(tmp, f"g_{tag}.out")
        eh.launches = um.launches = um.estimate_launches = 0
        js.launches = js.cum_union_launches = jm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if main(argv + ["-O", out, "-o", out + ".sizes"]) != 0:
            fail(f"e2e (g) {tag} returned nonzero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"encode_hash": eh.launches, "estimate_rows":
               um.estimate_launches, "cum_union_counts": js.cum_union_launches,
               "union_triples": um.launches, "joint_pair_stats": js.launches,
               "joint_triples": jm.launches}
        missing = [k for k in kernels if got[k] == 0]
        if missing:
            fail(f"e2e (g) {tag}: {missing} not launched ({got})")
        log(f"[e2e g] {tag}: wall {wall:.3f}s, {pairs / wall:.0f} pairs/s "
            f"(sketch load and -o included); launches " + ", ".join(
                f"{k} {v}" for k, v in got.items() if v))
        return out, got

    def rect(path, rows, cols):
        mat = np.fromfile(path, np.float32)
        if mat.shape != (rows * cols,) or not np.isfinite(mat).all():
            fail(f"e2e (g) {path}: {mat.shape} values, expected finite "
                 f"{rows} x {cols}")
        return mat.reshape(rows, cols)

    x_only = ("estimate_rows", "cum_union_counts", "union_triples")
    joint = ("estimate_rows", "joint_pair_stats", "joint_triples")
    path, got = run("-Q -M -b", base + ["-Q", qfile, "-M", "-b"] + hlls,
                    nq * nr, x_only)
    for k in ("cum_union_counts", "union_triples"):
        counts["rect " + k] = got[k]
    mash = rect(path, nq, nr)
    path, _ = run("-Q --containment-index -b", base + [
        "-Q", qfile, "--containment-index", "-b"] + hlls, nq * nr, x_only)
    ci = rect(path, nq, nr)
    worst = max(abs(float(ci[q, r]) - 1.0) for q, r in QUERY_COPIES.items())
    if worst > 1e-5:
        fail(f"e2e (g): a copied query's containment in its reference is "
             f"{1 - worst}")
    log(f"[e2e g] the {len(QUERY_COPIES)} copied queries: containment index "
        f"in their reference within {worst:.3g} of 1")
    path, got = run("-J -Q -M -b", base + ["-J", "-Q", qfile, "-M", "-b"]
                    + hlls, nq * nr, joint)
    for k in ("joint_pair_stats", "joint_triples"):
        counts["rect " + k] = got[k]
    mash_j = rect(path, nq, nr)
    nn_out = {}
    for tag, extra, rows in (("-Q", ["-Q", qfile], nq), ("", [], nr)):
        for fmt in ("tsv", "bin"):
            path, _ = run(f"--nearest-neighbors 5 {tag} {fmt}", base + [
                "--nearest-neighbors", "5"] + extra
                + (["-b"] if fmt == "bin" else []) + hlls, rows * nr, x_only)
            nn_out[tag, fmt] = (_read_nn_tsv(path) if fmt == "tsv"
                                else _read_nn_bin(path))
        names, ids, vals = nn_out[tag, "tsv"]
        ids_b, vals_b = nn_out[tag, "bin"]
        if ids.shape != (rows, 5) or not np.array_equal(ids, ids_b) \
                or not np.isfinite(vals_b).all():
            fail(f"e2e (g) NN {tag}: TSV ids {ids.shape} differ from the "
                 "binary ones or values are not finite")
        if names != (queries if tag else hlls):
            fail(f"e2e (g) NN {tag}: row names differ from the inputs")
    ids = nn_out["-Q", "bin"][0]
    for q, r in QUERY_COPIES.items():
        if ids[q, 0] != r:
            fail(f"e2e (g): query {q} (a copy of reference {r}) has first "
                 f"neighbour {ids[q, 0]}")
    if (nn_out["", "bin"][0] == np.arange(nr)[:, None]).any():
        fail("e2e (g): an all-pairs neighbour list holds its own sketch")
    log(f"[e2e g] NN: every copied query's first neighbour is its "
        f"reference; no all-pairs row lists itself")
    path, _ = run("--containment-dist -b (no -Q)", base + [
        "--containment-dist", "-b"] + hlls, nr * nr, x_only)
    cd = rect(path, nr, nr)
    if (np.diag(cd) != 0).any():
        fail("e2e (g): --containment-dist of a sketch against itself != 0")
    path, got = run("--containment-dist -b, 20 FASTA genomes (aliased)", [
        "dist", "-k", "31", "-S", "16", "--containment-dist", "-b",
        "--avoid-sorting"] + genomes, len(genomes) ** 2,
        ("encode_hash",) + x_only)
    rect(path, len(genomes), len(genomes))
    per_file = counts["encode_hash"] / 100    # e2e (b): 100 genomes, no -Q
    if got["encode_hash"] > 1.01 * per_file * len(genomes):
        fail(f"e2e (g): the aliased half launched K1 {got['encode_hash']} "
             f"times for {len(genomes)} files (~{per_file:.0f} a file)")
    path, _ = run("-Q references -M -b", base + ["-Q", rfile, "-M", "-b"]
                  + hlls, nr * nr, x_only)
    self_q = rect(path, nr, nr)
    iu = np.triu_indices(nr, 1)
    upper = np.ascontiguousarray(self_q.T[iu])
    if not np.array_equal(upper.view(np.uint32), cond_m.view(np.uint32)):
        diff = int((upper.view(np.uint32) != cond_m.view(np.uint32)).sum())
        fail(f"e2e (g): -Q with the references as queries differs from e2e "
             f"(d)'s condensed -M matrix in {diff} of {cond_m.size} pairs "
             f"(max abs {float(np.abs(upper - cond_m).max())})")
    log(f"[e2e g] -Q references x references: its {cond_m.size} pairs bit "
        "for bit equal to e2e (d)'s condensed -M matrix")
    _corner_vs_cpu(hlls, queries, mash, mash_j)
    log(f"[e2e g] total {time.perf_counter() - t_all:.1f}s")


# e2e (n): the set sketches over config 2's genomes
SET_P, SET_KK = 15, 8192   # what make_typed gives -S 16 (b = 16)
SET_CHECK = 8              # genomes whose device routes meet the host route
# genomes of the host-route families (Bloom filter, the counting forms):
# their numpy builders take 0.43-2.52 s a 5 Mbp genome on the H100
# machine's host (the counting b-bit form's lexsort the most), so all 100
# would hold the phase for over five minutes; 6 take about 22 s
SET_CUT = 6
# genomes sketched to a file and compared again (`sketch -o`, `dist -H`):
# the first 20, whose matrix is a corner of the 100 genomes' (each pair's
# value depends on that pair alone); `sketch -o -8` writes 256 KiB of
# random minima a genome at gzip level 9, ~0.14 s a genome
SET_RELOAD = 20
SET_DEVICE_RUNS = (("-8", "b-bit MinHash"),
                   ("--use-range-minhash", "bottom-k"))
SET_HOST_RUNS = (("--use-bloom-filter", "Bloom filter"),
                 ("--use-counting-range-minhash", "counting bottom-k"),
                 ("--use-counting-bb-minhash", "counting b-bit MinHash"))
SET_QUERIES = {3 + 10 * i: i for i in range(10)}   # reference: query


def _metrics_run(argv, what):
    """_timed with the metrics buckets on: (wall, buckets)."""
    from dashing_tpu_torch import metrics
    metrics._ENABLED = True
    metrics._totals.clear()
    try:
        wall = _timed(argv, what)
        return wall, dict(metrics._totals)
    finally:
        metrics._ENABLED = False
        metrics._totals.clear()
        metrics._counts.clear()


def _buckets(b) -> str:
    return ", ".join(f"{k} {v:.3f}s" for k, v in sorted(b.items())
                     if k.startswith(("sketch", "host", "compare",
                                      "cardinality", "dist.")))


def _setsketch_tile_check(dev):
    """The scatter-min and the bottom-k merge on the card against their
    plain numpy versions on one synthetic 256 x 8192 tile: a quarter of
    the hashes with the top bit set, zero, all ones, 1 << 63, a run of
    100,000 copies of one value, a fifth of the lanes invalid."""
    import torch
    from dashing_tpu_torch.ops import minhash_update as mu
    rng = np.random.default_rng(SEED + 9)
    h = rng.integers(-2 ** 63, 2 ** 63 - 1, (256, 8192), dtype=np.int64,
                     endpoint=True)
    h[:64] |= np.int64(-2 ** 63)
    h[0, :3] = (0, -1, -2 ** 63)
    h.reshape(-1)[1000:101000] = h[5, 5]
    valid = rng.random(h.shape) > 0.2
    valid[0, :3] = True
    hu = h.view(np.uint64)
    bank = mu.empty_bank(SET_P, dev)
    mu.bbmh_update(bank, torch.from_numpy(h).to(dev),
                   torch.from_numpy(valid).to(dev), SET_P)
    want = mu.bbmh_update_np(np.full(1 << SET_P, np.uint64(2 ** 64 - 1)),
                             hu, valid, SET_P)
    if not np.array_equal(mu.to_numpy(bank), want):
        fail("e2e (n): the scatter-min on the card differs from "
             "np.minimum.at on the synthetic tile")
    run = mu.bottomk_update(mu.empty_values(dev), torch.from_numpy(h).to(dev),
                            torch.from_numpy(valid).to(dev), SET_KK)
    if not np.array_equal(mu.to_numpy(run),
                          mu.bottomk_update_np(np.zeros(0, np.uint64), hu,
                                               valid, SET_KK)):
        fail("e2e (n): the bottom-k merge on the card differs from "
             "np.union1d on the synthetic tile")
    log("[e2e n] synthetic tile (top bit, 0, all ones, a run of 100,000 "
        "copies): scatter-min and bottom-k on the card bitwise equal to "
        "their plain versions")


def _setsketch_device_ms(dev, paths):
    """Each tile of `paths` through the encoders, the scatter-min and the
    bottom-k merge, CUDA events around each step: (tiles, encoder ms,
    scatter-min ms, bottom-k ms) summed.  A span between two events also
    holds the device's wait for the host (the encoders' ~200 launches a
    tile; the bottom-k mask's sync)."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import minhash_update as mu
    params = pipeline.SketchParams(k=31)
    sp = params.spacer()
    kw = pipeline._encode_kw(params, sp)

    def spans(path):
        out, tiles = np.zeros(3), 0
        bank = mu.empty_bank(SET_P, dev)
        run = mu.empty_values(dev)
        for tile in pipeline.InputFile(0, path, sp).tiles():
            t = torch.from_numpy(tile).to(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            h, valid = pipeline.tile_hashes(t, **kw)
            ev[1].record()
            mu.bbmh_update(bank, h, valid, SET_P)
            ev[2].record()
            run = mu.bottomk_update(run, h, valid, SET_KK)
            ev[3].record()
            torch.cuda.synchronize()
            out += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
            tiles += 1
        return tiles, out

    spans(paths[0])                               # warm-up
    tiles, tot = 0, np.zeros(3)
    for path in paths:
        n, ms = spans(path)
        tiles, tot = tiles + n, tot + ms
    return tiles, tot


def _e2e_setsketch(dev, genomes, tmp):
    """e2e (n): the set sketches over config 2's 100 genomes, k31 S16."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.sketch.setsketches import BBitMinHash, BottomK
    paths = [g[0] for g in genomes]
    total_bases = sum(os.path.getsize(q) for q in paths)
    sizes = os.path.join(tmp, "n.sizes")
    params = pipeline.SketchParams(k=31)
    # the device routes against the host route (file_raw_kmers, addh_np)
    check = paths[::len(paths) // SET_CHECK][:SET_CHECK]
    secs = dict.fromkeys(("device b-bit", "device bottom-k", "raw k-mers",
                          "host b-bit", "host bottom-k"), 0.0)

    def step(what, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[what] += time.perf_counter() - t
        return out

    for path in check:
        mins = step("device b-bit", lambda: pipeline.sketch_file_bbmh_mins(
            path, params, SET_P, dev))
        vals = step("device bottom-k",
                    lambda: pipeline.sketch_file_bottomk_values(
                        path, params, SET_KK, dev))
        raw = step("raw k-mers",
                   lambda: pipeline.file_raw_kmers(path, params, dev))
        host, got = BBitMinHash(SET_P), BBitMinHash(SET_P, mins=mins)
        step("host b-bit", lambda: host.addh_np(raw))
        for sk in (host, got):
            sk.finalize()
        if (not np.array_equal(mins, host.mins)
                or got.est_cardinality_ != host.est_cardinality_):
            fail(f"e2e (n) {os.path.basename(path)}: device b-bit minima "
                 "or est_cardinality_ differ from the host route")
        hk = BottomK(SET_KK)
        step("host bottom-k", lambda: hk.addh_np(raw))
        hk.finalize()
        if not np.array_equal(vals, hk.values):
            fail(f"e2e (n) {os.path.basename(path)}: device bottom-k values "
                 "differ from the host route")
    log(f"[e2e n] {len(check)} genomes at p={SET_P}, kk={SET_KK}: b-bit "
        "minima, est_cardinality_ and bottom-k values of the device routes "
        "bitwise equal to the host addh_np route; seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in secs.items()))
    _setsketch_tile_check(dev)
    tiles, ms = _setsketch_device_ms(dev, check)
    log(f"[e2e n] device spans over {tiles} tiles of {len(check)} genomes "
        f"(CUDA events): encoders {ms[0] / 1e3:.4f}s, scatter-min "
        f"{ms[1] / 1e3:.4f}s, bottom-k {ms[2] / 1e3:.4f}s "
        f"({ms[0] / tiles:.3f} / {ms[1] / tiles:.3f} / {ms[2] / tiles:.3f} "
        "ms a tile)")
    for flag, what in SET_DEVICE_RUNS:
        base = ["dist", "-k", "31", "-S", "16", flag, "-M", "-b"]
        out = os.path.join(tmp, f"n{flag}.bin")
        wall, b = _metrics_run(base + ["-O", out, "-o", sizes,
                                       "--avoid-sorting"] + paths,
                               f"e2e (n) dist {flag}")
        _check_planted(out, genomes, f"n {flag}", wall, total_bases)
        log(f"[e2e n] dist {flag} ({what}) over {len(paths)} genomes: wall "
            f"{wall:.3f}s; buckets {_buckets(b)}")
        # save, reload: the matrix of the sketch files is the in-memory
        # matrix's corner of the first SET_RELOAD genomes, bit for bit
        stream = os.path.join(tmp, f"n{flag}.stream")
        sk_wall = _timed(["sketch", "-k", "31", "-S", "16", flag, "-o",
                          stream, "--avoid-sorting"] + paths[:SET_RELOAD],
                         f"e2e (n) sketch -o {flag}")
        again = os.path.join(tmp, f"n{flag}.H.bin")
        h_wall = _timed(["dist", "-k", "31", "-H", flag, "-M", "-b", "-O",
                         again, "-o", sizes, stream],
                        f"e2e (n) dist -H {flag}")
        n = len(paths)
        corner = [_cond_index(n, i, j) for i in range(SET_RELOAD)
                  for j in range(i + 1, SET_RELOAD)]
        if _read_condensed(again)[1].tobytes() != \
                _read_condensed(out)[1][corner].tobytes():
            fail(f"e2e (n) dist -H {flag}: the reloaded sketches' matrix "
                 "differs from the one sketched in memory")
        log(f"[e2e n] sketch -o {flag} of {SET_RELOAD} genomes "
            f"{sk_wall:.3f}s, dist -H over the stream {h_wall:.3f}s: matrix "
            "bit for bit the in-memory one's corner")
    # queries: byte copies of references, each at Jaccard 1 to its own
    qpaths = []
    for ref, qi in SET_QUERIES.items():
        qpaths.append(os.path.join(tmp, f"nq{qi}.fa"))
        shutil.copyfile(paths[ref], qpaths[-1])
    qfile = _write_list(os.path.join(tmp, "nq.txt"), qpaths)
    base = ["dist", "-k", "31", "-S", "16", "-8", "--avoid-sorting", "-Q",
            qfile, "-b", "-o", sizes]
    out = os.path.join(tmp, "nQ.bin")
    wall = _timed(base + ["-O", out] + paths, "e2e (n) dist -8 -Q")
    mat = np.fromfile(out, "<f4").reshape(len(qpaths), len(paths))
    if not np.isfinite(mat).all():
        fail("e2e (n) dist -8 -Q: non-finite values")
    for ref, qi in SET_QUERIES.items():
        if mat[qi, ref] != 1.0 or mat[qi].argmax() != ref:
            fail(f"e2e (n) dist -8 -Q: query {qi} at {mat[qi, ref]} to its "
                 f"reference {ref} (row max at {mat[qi].argmax()})")
    out_nn = os.path.join(tmp, "nNN.bin")
    nn_wall = _timed(base + ["--nearest-neighbors", "5", "-O", out_nn]
                     + paths, "e2e (n) dist -8 -Q --nearest-neighbors 5")
    ids, vals = _read_nn_bin(out_nn)
    for ref, qi in SET_QUERIES.items():
        if ids[qi, 0] != ref or vals[qi, 0] != 1.0:
            fail(f"e2e (n) --nearest-neighbors: query {qi}'s first "
                 f"neighbour {ids[qi, 0]} at {vals[qi, 0]}, not {ref} at 1")
    log(f"[e2e n] dist -8 -Q, 10 byte copies x {len(paths)} references: "
        f"each copy at Jaccard 1 to its reference ({wall:.3f}s); "
        f"--nearest-neighbors 5 its first neighbour ({nn_wall:.3f}s)")
    cut = paths[:SET_CUT]
    for flag, what in SET_HOST_RUNS:
        out = os.path.join(tmp, f"n{flag}.bin")
        wall, b = _metrics_run(["dist", "-k", "31", "-S", "16", flag, "-M",
                                "-b", "-O", out, "-o", sizes,
                                "--avoid-sorting"] + cut,
                               f"e2e (n) dist {flag}")
        n, cond = _read_condensed(out)
        if n != len(cut) or not np.isfinite(cond).all():
            fail(f"e2e (n) dist {flag}: bad matrix n={n}")
        log(f"[e2e n] dist {flag} ({what}, host route) over {len(cut)} "
            f"genomes: wall {wall:.3f}s; buckets {_buckets(b)}")


# e2e (o): the wide HLL, HyperMinHash and SuperMinHash over config 2's
# genomes (phase `extra`).  HyperMinHash and SuperMinHash are host numpy
# builders and compare engines, as in the JAX package: over SET_CUT genomes
# and a byte copy of the first
EXTRA_HOST_RUNS = (("--use-hyperminhash", "HyperMinHash (p = 15, r = 10)"),
                   ("--use-superminhash", "SuperMinHash (p = 15, b = 16)"))


def _e2e_extra(dev, genomes, tmp, out_b, out_c):
    """e2e (o), phase `extra`: the wide HLL through the HLL engine and
    kernels over (b)'s 100 genomes, k31 S16 (registers bitwise the host
    route's, matrices bit for bit (b)'s and (c)'s), and the host-route
    HyperMinHash and SuperMinHash."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli import core
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch.setsketches import make_typed
    t_phase = time.perf_counter()
    paths = [g[0] for g in genomes]
    sizes = os.path.join(tmp, "o.sizes")
    # the build routes: the HLL engine's registers, widened, against the
    # JAX package's host route (raw k-mers into WideHLL.addh_np)
    check = paths[::len(paths) // SET_CHECK][:SET_CHECK]
    opts = core.CommonOpts(k=31, sketch_size=16, sketch_type="wide_hll",
                           sketch_type_explicit=True)
    params = core.sketch_params(opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_sk = core.sketch_paths(check, opts, dev)
    t_dev = time.perf_counter() - t0
    t_raw = t_ins = 0.0
    for path, got in zip(check, dev_sk):
        t0 = time.perf_counter()
        raw = pipeline.file_raw_kmers(path, params, dev)
        t_raw += time.perf_counter() - t0
        t0 = time.perf_counter()
        host = make_typed("wide_hll", opts)
        host.addh_np(raw)
        t_ins += time.perf_counter() - t0
        if got.regs.dtype != np.uint16 or \
                not np.array_equal(got.regs, host.regs):
            fail(f"e2e (o) {os.path.basename(path)}: the wide HLL's device "
                 "registers differ from the host route's")
    log(f"[e2e o] {len(check)} genomes --use-wide-hll -S 16: the HLL "
        "engine's registers (K1) bitwise equal to the host route "
        f"(file_raw_kmers + WideHLL.addh_np); seconds a genome: device "
        f"{t_dev / len(check):.4f}, host {(t_raw + t_ins) / len(check):.4f}"
        f" (raw k-mers {t_raw / len(check):.4f}, insert "
        f"{t_ins / len(check):.4f})")
    base = ["dist", "-k", "31", "-S", "16", "--use-wide-hll", "-b",
            "--avoid-sorting"]
    for tag, extra, want, kernels in (
            ("-M", ["-M"], out_b,
             {"K1": (eh, "launches"), "K4 X-only": (js, "cum_union_launches"),
              "K3": (um, "launches"),
              "row estimates": (um, "estimate_launches")}),
            ("-J", ["-J", "-M"], out_c,
             {"K1": (eh, "launches"), "K4 joint": (js, "launches"),
              "K5": (jm, "launches")})):
        for mod, name in kernels.values():
            setattr(mod, name, 0)
        out = os.path.join(tmp, f"o{tag}.bin")
        wall, b = _metrics_run(base + extra + ["-O", out, "-o", sizes]
                               + paths, f"e2e (o) dist --use-wide-hll {tag}")
        got = {k: getattr(mod, name) for k, (mod, name) in kernels.items()}
        if min(got.values()) == 0:
            fail(f"e2e (o) dist --use-wide-hll {tag}: a kernel of the path "
                 f"was not launched: {got}")
        if open(out, "rb").read() != open(want, "rb").read():
            fail(f"e2e (o) dist --use-wide-hll {tag}: the matrix differs "
                 f"from the HLL's ({os.path.basename(want)})")
        log(f"[e2e o] dist --use-wide-hll {tag} -b over {len(paths)} "
            f"genomes: wall {wall:.3f}s, launches {got}; matrix bit for bit "
            f"the HLL's ({os.path.basename(want)}); buckets {_buckets(b)}")
    stream = os.path.join(tmp, "o.stream")
    sk_wall = _timed(["sketch", "-k", "31", "-S", "16", "--use-wide-hll",
                      "-o", stream, "--avoid-sorting"] + paths[:SET_RELOAD],
                     "e2e (o) sketch -o --use-wide-hll")
    again = os.path.join(tmp, "o.H.bin")
    h_wall = _timed(["dist", "-k", "31", "-H", "--use-wide-hll", "-M", "-b",
                     "-O", again, "-o", sizes, stream],
                    "e2e (o) dist -H --use-wide-hll")
    n = len(paths)
    corner = [_cond_index(n, i, j) for i in range(SET_RELOAD)
              for j in range(i + 1, SET_RELOAD)]
    if _read_condensed(again)[1].tobytes() != \
            _read_condensed(os.path.join(tmp, "o-M.bin"))[1][corner].tobytes():
        fail("e2e (o) dist -H --use-wide-hll: the reloaded sketches' matrix "
             "differs from the one sketched in memory")
    log(f"[e2e o] sketch -o --use-wide-hll of {SET_RELOAD} genomes "
        f"{sk_wall:.3f}s, dist -H over the stream {h_wall:.3f}s: matrix bit "
        "for bit the in-memory one's corner")
    # e2e (n)'s byte copies of references as queries
    qfile = os.path.join(tmp, "nq.txt")
    qbase = base + ["-Q", qfile, "-o", sizes]
    out = os.path.join(tmp, "oQ.bin")
    wall = _timed(qbase + ["-O", out] + paths, "e2e (o) dist -Q")
    mat = np.fromfile(out, "<f4").reshape(len(SET_QUERIES), len(paths))
    if not np.isfinite(mat).all():
        fail("e2e (o) dist --use-wide-hll -Q: non-finite values")
    for ref, qi in SET_QUERIES.items():
        if mat[qi, ref] != 1.0 or mat[qi].argmax() != ref:
            fail(f"e2e (o) dist --use-wide-hll -Q: query {qi} at "
                 f"{mat[qi, ref]} to its reference {ref} (row max at "
                 f"{mat[qi].argmax()})")
    out_nn = os.path.join(tmp, "oNN.bin")
    nn_wall = _timed(qbase + ["--nearest-neighbors", "5", "-O", out_nn]
                     + paths, "e2e (o) dist -Q --nearest-neighbors 5")
    ids, vals = _read_nn_bin(out_nn)
    for ref, qi in SET_QUERIES.items():
        if ids[qi, 0] != ref or vals[qi, 0] != 1.0:
            fail(f"e2e (o) --use-wide-hll --nearest-neighbors: query {qi}'s "
                 f"first neighbour {ids[qi, 0]} at {vals[qi, 0]}, not {ref} "
                 "at 1")
    log(f"[e2e o] dist --use-wide-hll -Q, 10 byte copies x {len(paths)} "
        f"references: each copy at Jaccard 1 to its reference ({wall:.3f}s);"
        f" --nearest-neighbors 5 (the host k-NN over K4/K3 tiles) its first "
        f"neighbour ({nn_wall:.3f}s)")
    copy = os.path.join(tmp, "o_copy_of_0.fa")
    shutil.copyfile(paths[0], copy)
    cut = paths[:SET_CUT] + [copy]
    for flag, what in EXTRA_HOST_RUNS:
        out = os.path.join(tmp, f"o{flag}.bin")
        wall, b = _metrics_run(["dist", "-k", "31", "-S", "16", flag, "-M",
                                "-b", "-O", out, "-o", sizes,
                                "--avoid-sorting"] + cut,
                               f"e2e (o) dist {flag}")
        n, cond = _read_condensed(out)
        if n != len(cut) or cond.size != n * (n - 1) // 2 or \
                not np.isfinite(cond).all():
            fail(f"e2e (o) dist {flag}: bad matrix n={n} ({cond.size})")
        if cond[_cond_index(n, 0, n - 1)] != 0.0:
            fail(f"e2e (o) dist {flag}: the byte copy is at Mash distance "
                 f"{cond[_cond_index(n, 0, n - 1)]} from its genome, not 0 "
                 "(Jaccard 1)")
        log(f"[e2e o] dist {flag} -M ({what}, host route) over {len(cut)} "
            f"genomes: wall {wall:.3f}s; the copy at Jaccard 1; builder "
            f"{b.get('sketch.host_insert', 0.0) / len(cut):.3f}s a genome; "
            f"buckets {_buckets(b)}")
    log(f"[e2e o] phase extra: {time.perf_counter() - t_phase:.1f}s")


# e2e (p), phase `khset`: the exact k-mer hash sets over config 2's genomes
# (k31, their length not cut) on KHS_CUT genomes and a byte copy of the
# first, the weighted set sketches on WJ_CUT genomes and the copy, gf64_mul
# on the card; its HeavyKeeper half runs in e2e (f), over the reads made
# there (_e2e_hk).  A hash set makes numpy 2.3's np.unique of ~5 M uint64
# at 4.475 s a genome on the H100 machine's host, at least twice more
# for a set written and read back, and `union -H` four more of up to
# 10 M: at SET_CUT (6) genomes and the copy the phase took 311.4 s on an
# H100 machine (PERF.md section 6), so the hash sets take 3 genomes and
# the copy
KHS_CUT = 3
WJ_CUT = 4
HK_HEAD = 50_000           # reads of the HeavyKeeper run held to the CPU's
HK_Q = 22                  # log2 slots (counters) a row of both filters
KHSET_SECONDS = {}


def _e2e_khset(dev, genomes, tmp, out_b):
    """e2e (p), phase `khset`: `dist --use-full-khash-sets -M -b` (the copy
    at Jaccard 1; each pair's exact Jaccard within 0.02 of (b)'s HLL
    Jaccard), `sketch -o` then `dist -H` bit for bit, `union -H` the union
    of two key sets, the builder (raw k-mers, np.unique) and the compare
    timed; `--wj-exact -8` and `--wj-exact --use-wide-hll` (K4's X-only
    form and K3 launch) with the copy at Jaccard 1; gf64_mul on 2^20
    pairs on the card equal to gf64_mul_np."""
    import torch
    from dashing_tpu_torch import hashes, pipeline
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch.khset import KSet
    t_phase = time.perf_counter()
    paths = [g[0] for g in genomes]
    copy = os.path.join(tmp, "p_copy_of_0.fa")
    shutil.copyfile(paths[0], copy)
    cut = paths[:KHS_CUT] + [copy]
    n = len(cut)
    sizes = os.path.join(tmp, "p.sizes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = pipeline.file_raw_kmers(paths[0], pipeline.SketchParams(k=31), dev)
    t_raw = time.perf_counter() - t0
    out = os.path.join(tmp, "p.bin")
    wall, b = _metrics_run(["dist", "-k", "31", "--use-full-khash-sets",
                            "-M", "-b", "--avoid-sorting", "-O", out, "-o",
                            sizes] + cut, "e2e (p) dist --use-full-khash-sets")
    m, cond = _read_condensed(out)
    if m != n or cond.size != n * (n - 1) // 2 or not np.isfinite(cond).all():
        fail(f"e2e (p) dist --use-full-khash-sets: bad matrix n={m} "
             f"({cond.size})")
    if cond[_cond_index(n, 0, n - 1)] != 0.0:
        fail("e2e (p) dist --use-full-khash-sets: the byte copy is at Mash "
             f"distance {cond[_cond_index(n, 0, n - 1)]}, not 0 (Jaccard 1)")
    pairs = [(i, j) for i in range(KHS_CUT) for j in range(i + 1, KHS_CUT)]
    exact = _mash_ji(cond[[_cond_index(n, i, j) for i, j in pairs]])
    hll = _mash_ji(_read_condensed(out_b)[1][
        [_cond_index(len(paths), i, j) for i, j in pairs]])
    worst = float(np.abs(exact - hll).max())
    if worst > 0.02:
        fail(f"e2e (p): an HLL Jaccard of (b) is {worst} from the exact one")
    log(f"[e2e p] dist --use-full-khash-sets -M -b over {n} genomes: wall "
        f"{wall:.3f}s; the copy at Jaccard 1; (b)'s HLL Jaccard (-S 16) "
        f"within {worst:.5f} of the exact one over {len(pairs)} pairs "
        f"(bar 0.02); buckets {_buckets(b)}")
    log(f"[e2e p] hash-set builder (k31, {raw.size:,} raw k-mers a genome): "
        f"raw k-mers {t_raw:.3f}s a genome, np.unique (sketch.host_insert) "
        f"{b['sketch.host_insert'] / n:.3f}s a genome; compare "
        f"(compare.host, np.intersect1d) {b['compare.host'] / len(cond):.3f}"
        "s a pair")
    stream = os.path.join(tmp, "p.stream.khs")
    sk_wall = _timed(["sketch", "-k", "31", "--use-full-khash-sets", "-o",
                      stream, "--avoid-sorting"] + cut,
                     "e2e (p) sketch -o --use-full-khash-sets")
    again = os.path.join(tmp, "p.H.bin")
    h_wall = _timed(["dist", "-H", "--use-full-khash-sets", "-M", "-b", "-O",
                     again, "-o", sizes, stream], "e2e (p) dist -H")
    if _read_condensed(again)[1].tobytes() != cond.tobytes():
        fail("e2e (p) dist -H --use-full-khash-sets: the stream's matrix "
             "differs from the one sketched in memory")
    log(f"[e2e p] sketch -o --use-full-khash-sets of {n} genomes "
        f"{sk_wall:.3f}s ({os.path.getsize(stream) / 1e6:.1f} MB), dist -H "
        f"over the stream {h_wall:.3f}s: matrix bit for bit the first")
    # union -H of two genomes of two families, each set cut to its keys
    # below 2^60 (a quarter of the 31-mers) to spare np.unique's seconds:
    # |A u B| = |A| + |B| - |A n B|
    two, parts = [], []
    for i in (1, SET_CUT - 1):
        got = pipeline.file_raw_kmers(paths[i], pipeline.SketchParams(k=31),
                                      dev)
        parts.append(KSet.from_values(got[got < np.uint64(1 << 60)]))
        two.append(os.path.join(tmp, f"p{i}.khs"))
        parts[-1].write(two[-1])
    union = os.path.join(tmp, "p.union.khs")
    u_wall = _timed(["union", "-H", "-o", union] + two, "e2e (p) union -H")
    a, b = parts[0].keys, parts[1].keys
    want = a.size + b.size - np.intersect1d(a, b, assume_unique=True).size
    with gzip.open(union, "rb") as fp:
        got = np.frombuffer(fp.read(), "<u8")
    keys = got[1:]
    if got[0] != want or keys.size != want or \
            not (keys[1:] > keys[:-1]).all() or \
            not np.isin(a, keys, assume_unique=True).all() or \
            not np.isin(b, keys, assume_unique=True).all():
        fail("e2e (p) union -H: the keys are not the union of the two sets'")
    log(f"[e2e p] union -H of two sets of two families (keys < 2^60): "
        f"{want:,} keys = |A u B| ({u_wall:.3f}s)")
    # the weighted set sketches (host route)
    wcut = paths[:WJ_CUT] + [copy]
    for flag, what in (("-8", "b-bit MinHash"), ("--use-wide-hll",
                                                  "wide HLL")):
        js.cum_union_launches = um.launches = 0
        out = os.path.join(tmp, f"p_wj{flag}.bin")
        wall, b = _metrics_run(["dist", "-k", "31", "-S", "16", "--wj-exact",
                                flag, "-M", "-b", "--avoid-sorting", "-O",
                                out, "-o", sizes] + wcut,
                               f"e2e (p) dist --wj-exact {flag}")
        m, wc = _read_condensed(out)
        if m != len(wcut) or wc.size != m * (m - 1) // 2 or \
                not np.isfinite(wc).all():
            fail(f"e2e (p) dist --wj-exact {flag}: bad matrix n={m}")
        if wc[_cond_index(m, 0, m - 1)] != 0.0:
            fail(f"e2e (p) dist --wj-exact {flag}: the byte copy is at Mash "
                 f"distance {wc[_cond_index(m, 0, m - 1)]}, not 0")
        launched = (js.cum_union_launches, um.launches)
        if flag == "--use-wide-hll" and min(launched) == 0:
            fail(f"e2e (p) --wj-exact --use-wide-hll: K4 X-only / K3 "
                 f"launches {launched}")
        log(f"[e2e p] dist --wj-exact {flag} -M ({what}, host route) over "
            f"{m} genomes: wall {wall:.3f}s, wj.host "
            f"{b.get('wj.host', 0.0) / m:.3f}s a genome; the copy at "
            f"Jaccard 1; K4 X-only / K3 launches {launched}")
    rng = np.random.default_rng(SEED + 11)
    a, b = (rng.integers(0, 2 ** 64, 1 << 20, dtype=np.uint64)
            for _ in range(2))
    ta = torch.from_numpy(a.view(np.int64)).to(dev)
    tb = torch.from_numpy(b.view(np.int64)).to(dev)
    ms = cuda_ms(lambda: hashes.gf64_mul(ta, tb), 5)
    got = hashes.gf64_mul(ta, tb).cpu().numpy().view(np.uint64)
    if not np.array_equal(got, hashes.gf64_mul_np(a, b)):
        fail("e2e (p): gf64_mul on the card differs from gf64_mul_np")
    log(f"[e2e p] gf64_mul of 2^20 int64 pairs on the card ({ms:.3f} ms) "
        "equal to gf64_mul_np")
    KHSET_SECONDS["sets"] = time.perf_counter() - t_phase
    log(f"[e2e p] phase khset, hash sets, weighted and gf64: "
        f"{KHSET_SECONDS['sets']:.1f}s")


def _e2e_hk(dev, fq, twice, tmp):
    """e2e (p), phase `khset`, its HeavyKeeper half over (f)'s reads: the
    native structure; DASHING_TPU_USE_HK=1 `sketch -b -n 2` of the first
    HK_HEAD reads on the card bitwise equal to a CPU run in a subprocess;
    then over all the reads HeavyKeeper against the count-min at one
    geometry (HK_Q), walls, buckets and each filtered cardinality's error
    against the exact count of k-mers seen at least twice."""
    from dashing_tpu_torch.sketch.heavykeeper import HeavyKeeper
    from dashing_tpu_torch.sketch.hll import HLL, batch_reports
    t_phase = time.perf_counter()
    if not HeavyKeeper(4, 20).native:
        fail("e2e (p): the native HeavyKeeper did not build")
    head = os.path.join(tmp, "hk_head.fq")
    with open(fq, "rb") as src, open(head, "wb") as dst:
        dst.write(src.read(HK_HEAD * FQ_RECORD))
    argv = ["sketch", "-k", "31", "-S", "16", "-b", "-n", "2"]
    os.environ["DASHING_TPU_USE_HK"] = "1"
    try:
        card = os.path.join(tmp, "hk_card.hll")
        wall = _timed(argv + ["-o", card, head], "e2e (p) sketch -b HK")
        cpu = os.path.join(tmp, "hk_cpu.hll")
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, DASHING_TPU_TORCH_DEVICE="cpu",
                   PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "dashing_tpu_torch.cli"]
                             + argv + ["-o", cpu, head], env=env, cwd=here,
                             capture_output=True, text=True, timeout=600)
        t_cpu = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"e2e (p): the CPU HeavyKeeper run failed: "
                 f"{res.stderr[-500:]}")
        got, want = HLL.read(card).regs, HLL.read(cpu).regs
        if not got.any() or not np.array_equal(got, want):
            fail(f"e2e (p): HeavyKeeper-filtered registers on the card differ "
                 f"from the CPU run in {int((got != want).sum())} places")
        log(f"[e2e p] DASHING_TPU_USE_HK=1 sketch -b -n 2 of {HK_HEAD:,} "
            f"reads: registers on the card ({wall:.3f}s) bitwise equal to a "
            f"CPU run in a subprocess ({t_cpu:.1f}s)")
    finally:
        del os.environ["DASHING_TPU_USE_HK"]
    for tag, hk in (("HeavyKeeper", True), ("count-min", False)):
        if hk:
            os.environ["DASHING_TPU_USE_HK"] = "1"
        try:
            out = os.path.join(tmp, f"hk_{hk}.hll")
            wall, b = _metrics_run(argv + ["-q", str(HK_Q), "-o", out, fq],
                                   f"e2e (p) sketch -b {tag}")
        finally:
            os.environ.pop("DASHING_TPU_USE_HK", None)
        sk = HLL.read(out)
        batch_reports([sk], dev)
        rel = sk.report() / twice - 1.0
        log(f"[e2e p] {tag} sketch -b -n 2 -q {HK_Q} (4 rows) of "
            f"{FQ_READS:,} reads: wall {wall:.3f}s, filtered cardinality "
            f"{sk.report():,.0f} ({rel:+.3%} of the {twice:,} k-mers seen "
            f"at least twice); buckets {_buckets(b)}")
    KHSET_SECONDS["hk"] = time.perf_counter() - t_phase
    log(f"[e2e p] phase khset, HeavyKeeper: {KHSET_SECONDS['hk']:.1f}s; "
        f"the phase in all {sum(KHSET_SECONDS.values()):.1f}s")


def _phase_times(dev, paths, total_bases):
    """Sketch and compare phases of config 2 timed apart (after the CLI
    run, so the build and first-touch costs are out).  Returns the
    sketches."""
    import torch
    from dashing_tpu_torch.cli import core
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    opts = core.CommonOpts(k=31, sketch_size=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sketches = core.sketch_paths(paths, opts, dev)
    t_sketch = time.perf_counter() - t0
    n = len(sketches)
    t0 = time.perf_counter()
    pw.all_pairs_condensed(sketches, pw.MASH_DIST, 31, est.ERTL_MLE,
                           est.ERTL_MLE, dev)
    torch.cuda.synchronize()
    t_cmp = time.perf_counter() - t0
    npairs = n * (n - 1) // 2
    log(f"[e2e b] sketch {t_sketch:.3f}s ({total_bases / t_sketch / 1e6:.1f} "
        f"M bases/s incl. parse), compare {t_cmp:.4f}s "
        f"({npairs / t_cmp:.0f} pairs/s)")
    return sketches


def _config2_kernels(dev, sketches, records):
    """K3, the row-estimate kernel, both forms of K4 and K5 against their
    plain versions on the inputs config 2's `dist` gives them: the one 100 x 100 tile,
    built the way all_pairs_condensed builds it, and the -o full
    histograms."""
    import torch
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    regs = pw._stack_regs(sketches)
    n, p = regs.shape[0], sketches[0].p
    mm = pw._block_minmax(regs, n, pw.DEFAULT_TILE)
    kmax, kmin = pw._pair_window(mm[0], mm[0], 64 - p)
    regs_d = pw._device_regs(regs, dev)
    stats = pw.pair_stats(regs_d, regs_d, kmax, kmin, same=True)
    cumT = stats["cum_union"].permute(2, 0, 1).contiguous()
    K = cumT.shape[0]
    c_a = _check_estimates(stats["hist_a"], p, kmin, est.ERTL_MLE,
                           est.WINDOW_MLE_ITERS, "marginals MLE config 2",
                           f"{n} rows p={p} kmin={kmin} K={K}", records,
                           chain=True)
    _check_triples(cumT, c_a, c_a, p, kmin, est.ERTL_MLE, "MLE config 2",
                   f"{n}x{n} pairs p={p} kmin={kmin} K={K}", 50, 5, records)
    hists = torch.from_numpy(np.stack([s.histogram() for s in sketches]))
    _check_estimates(hists.to(dev), p, 0, est.ERTL_MLE, est.FULL_MLE_ITERS,
                     "-o sizes MLE config 2", f"{n} rows p={p} K={64 - p + 2}",
                     records)
    # one sketch's full histogram: HLL.report, union_triple_incl_excl
    _check_estimates(hists[:1].to(dev), p, 0, est.ERTL_MLE,
                     est.FULL_MLE_ITERS, "HLL.report config 2",
                     f"1 row p={p} K={64 - p + 2}", records)
    check_cum_union(regs_d, regs_d, kmin, kmax, True, "config 2", records)
    st = check_k4(regs_d, regs_d, kmin, kmax, True, "config 2", records)
    ha = stats["hist_a"].T
    # the -J start takes the direct MLE marginals
    c_j = _check_estimates(stats["hist_a"], p, kmin, est.ERTL_MLE,
                           est.WINDOW_MLE_ITERS, "-J start config 2",
                           f"{n} rows p={p} kmin={kmin} K={K}", records)
    check_k5(st, slice(None), ha, ha.contiguous(), c_j, c_j, p, kmin,
             "config 2", records)


# e2e (f), BASELINE.json config 3: FASTQ reads drawn from one genome, with
# substitution errors for the count-min filter to remove
FQ_READS = 1_000_000        # the config's 10 M cut to 1 M (PERF.md section 4)
FQ_LEN = 100
FQ_GENOME = 5_000_000
FQ_ERR = 0.005              # planted substitutions a base
FQ_RECORD = 1 + 7 + 1 + FQ_LEN + 1 + 2 + FQ_LEN + 1    # @id\nseq\n+\nqual\n
FQ_CM_LOG2 = 28             # count-min counters a row: sketch -q, dist -t


def write_reads(path: str, rng, n_reads: int, batch: int = 250_000):
    """n_reads reads of FQ_LEN bases from one seeded FQ_GENOME-base genome,
    half reverse-complemented, with FQ_ERR substitutions a base, as FASTQ
    records of fixed width (`@` and a 7-digit id) written array by array.
    Returns the reads' 2-bit codes, (n_reads, FQ_LEN) uint8."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, FQ_GENOME).astype(np.uint8)
    codes = np.empty((n_reads, FQ_LEN), np.uint8)
    with open(path, "wb") as fp:
        for b0 in range(0, n_reads, batch):
            n = min(batch, n_reads - b0)
            starts = rng.integers(0, FQ_GENOME - FQ_LEN, n)
            c = genome[starts[:, None] + np.arange(FQ_LEN)]
            flip = rng.random(n) < 0.5
            c[flip] = 3 - c[flip, ::-1]
            flat = c.reshape(-1)
            hit = rng.integers(0, flat.size, rng.binomial(flat.size, FQ_ERR))
            flat[hit] = (flat[hit] + rng.integers(1, 4, hit.size)) & 3
            codes[b0:b0 + n] = c
            rec = np.empty((n, FQ_RECORD), np.uint8)
            rec[:, 0] = ord("@")
            ids = np.arange(b0, b0 + n)
            for d in range(7):
                rec[:, 7 - d] = ord("0") + (ids // 10 ** d) % 10
            rec[:, 8] = ord("\n")
            rec[:, 9:9 + FQ_LEN] = lut[c]
            tail = 9 + FQ_LEN
            rec[:, tail:tail + 3] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, tail + 3:tail + 3 + FQ_LEN] = ord("I")
            rec[:, -1] = ord("\n")
            fp.write(rec.tobytes())
    return codes


def kmer_truth(codes: np.ndarray, k: int, dev):
    """(distinct, seen at least twice) canonical k-mers of the reads: 2-bit
    k-mers and reverse complements by shifts on the card, counted by
    torch.unique; independent of the port's encoder."""
    import torch
    n = codes.shape[1] - k + 1
    c = torch.from_numpy(codes).to(dev).long()
    fwd = torch.zeros((codes.shape[0], n), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[:, j:j + n]
        rc |= (3 - c[:, j:j + n]) << (2 * j)
    _, counts = torch.unique(torch.minimum(fwd, rc), return_counts=True)
    return counts.numel(), int((counts >= 2).sum())


def _cli_regs(path: str) -> np.ndarray:
    from dashing_tpu_torch.sketch.hll import HLL
    return HLL.read(path).regs


def _step(tag: str, wall: float, reads: int) -> None:
    log(f"[e2e f] {tag}: wall {wall:.3f}s, {reads / wall:,.0f} reads/s")


def phase_e2e_fastq(dev, counts):
    """(f) BASELINE.json config 3 at 1 M reads through the CLI entry, k=31:
    plain and count-min filtered `sketch` (-b -n 2 -q 28: 2^28 x 4 int32
    counters, 4 GiB; each count-min kernel once a tile, its launches into
    `counts`) checked against the exact k-mer counts, `card` and `union`
    of the two, `hll` at p=24, `dist -y` over the read set's four
    quarters, and the filtered registers on the card against the CPU."""
    import contextlib
    import io
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli.main import main
    from dashing_tpu_torch.ops import countmin as cm
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    rng = np.random.default_rng(SEED + 3)
    tmp = tempfile.mkdtemp(prefix="dtt_fastq_")
    try:
        t0 = time.perf_counter()
        fq = os.path.join(tmp, "reads.fq")
        codes = write_reads(fq, rng, FQ_READS)
        size = os.path.getsize(fq)
        if size <= pipeline.STREAM_THRESHOLD:
            fail(f"e2e (f): {size} B of FASTQ does not stream")
        quarters = []
        with open(fq, "rb") as src:
            for q in range(4):
                quarters.append(os.path.join(tmp, f"q{q}.fq"))
                with open(quarters[-1], "wb") as dst:
                    dst.write(src.read(size // 4))
        distinct, twice = kmer_truth(codes, 31, dev)
        log(f"[e2e f] {FQ_READS} reads x {FQ_LEN} ({size / 1e6:.1f} MB FASTQ, "
            f"{FQ_ERR:.1%} errors): {distinct:,} distinct canonical 31-mers, "
            f"{twice:,} seen at least twice ({time.perf_counter() - t0:.1f}s "
            "to write and count)")

        def run(argv, what):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = main(argv)
            torch.cuda.synchronize()
            if rc != 0:
                fail(f"e2e (f) {what} returned nonzero")
            return time.perf_counter() - t, out.getvalue()

        # 1. plain and filtered sketches of the whole read set
        dirs = {t: os.path.join(tmp, t) for t in ("plain", "filt")}
        for tag, extra in (("plain", []),
                           ("filt", ["-b", "-n", "2", "-q", str(FQ_CM_LOG2)])):
            os.makedirs(dirs[tag])
            eh.launches = cm.add_launches = cm.admit_launches = 0
            tiles0 = pipeline.cm_tiles
            wall, _ = run(["sketch", "-k", "31", "-S", "16", "-P", dirs[tag]]
                          + extra + [fq], f"sketch {tag}")
            tiles = pipeline.cm_tiles - tiles0
            _step(" ".join(["sketch -S 16"] + extra)
                  + (f" (cm_add {cm.add_launches} and cm_admit "
                     f"{cm.admit_launches} launches, {tiles} tiles)"
                     if tag == "filt" else ""),
                  wall, FQ_READS)
            if tag == "plain" and eh.launches == 0:
                fail("e2e (f): the plain sketch did not launch K1")
            if tag == "filt":
                if tiles == 0 or not (cm.add_launches == cm.admit_launches
                                      == tiles):
                    fail(f"e2e (f): {cm.add_launches} cm_add and "
                         f"{cm.admit_launches} cm_admit launches for "
                         f"{tiles} tiles, not one a tile a pass")
                counts["cm_add"] = cm.add_launches
                counts["cm_admit"] = cm.admit_launches
        hlls = [os.path.join(dirs[t], "reads.fq.w.31.spacing.16.hll")
                for t in ("plain", "filt")]
        plain, filt = map(_cli_regs, hlls)
        if not (filt <= plain).all():
            fail("e2e (f): a filtered register exceeds the plain one")
        um.estimate_launches = 0
        cards_txt = os.path.join(tmp, "cards.txt")
        wall, _ = run(["card", "-H", "-o", cards_txt] + hlls, "card")
        if um.estimate_launches == 0:
            fail("e2e (f): card did not launch the row-estimate kernel")
        cards = [float(l.split("\t")[1])
                 for l in open(cards_txt).read().splitlines()[1:]]
        for what, got, want, tol in (("plain", cards[0], distinct, 0.02),
                                     ("filtered", cards[1], twice, 0.03)):
            rel = got / want - 1.0
            log(f"[e2e f] card {what}: {got:,.0f} vs exact {want:,} "
                f"({rel:+.3%}, bound {tol:.0%})")
            if abs(rel) > tol:
                fail(f"e2e (f): {what} cardinality {got} vs {want}")
        if not cards[0] > 1.5 * cards[1]:
            fail(f"e2e (f): the filter removed too little ({cards})")
        _step(f"card -H of both sketches (row-estimate launches "
              f"{um.estimate_launches})", wall, FQ_READS)

        # 2. union of the two sketches = the plain sketch
        union = os.path.join(tmp, "union.hll")
        wall, _ = run(["union", "-o", union] + hlls, "union")
        if not np.array_equal(_cli_regs(union), plain):
            fail("e2e (f): union registers differ from the plain sketch's")
        _step("union of plain and filtered, registers equal the plain "
              "sketch's", wall, FQ_READS)

        # 3. hll at its default p = 24
        eh.launches = 0
        wall, out = run(["hll", "-k", "31", fq], "hll")
        est_hll = float(out.strip().rsplit(" ", 1)[1])
        rel = est_hll / distinct - 1.0
        _step(f"hll -S 24 (K1 launches {eh.launches}), estimate "
              f"{est_hll:,.0f} ({rel:+.3%} of exact)", wall, FQ_READS)
        if eh.launches == 0:
            fail("e2e (f): hll did not launch K1")
        if abs(rel) > 0.01:
            fail(f"e2e (f): hll estimate {est_hll} vs exact {distinct}")

        # 4. dist -y over the four quarters, and without -y
        mats = {}
        for tag, extra in (("y", ["-y", "-c", "2", "-t", str(FQ_CM_LOG2)]),
                           ("plain", [])):
            out_d = os.path.join(tmp, f"dist_{tag}.bin")
            js.cum_union_launches = um.launches = 0
            wall, _ = run(["dist", "-k", "31", "-S", "14", "-M", "-b", "-O",
                           out_d, "--avoid-sorting"] + extra + quarters,
                          f"dist {tag}")
            n, cond = _read_condensed(out_d)
            if n != 4 or cond.shape != (6,) or not np.isfinite(cond).all():
                fail(f"e2e (f) dist {tag}: bad matrix n={n} {cond}")
            if tag == "y" and (js.cum_union_launches == 0 or um.launches == 0):
                fail("e2e (f): dist -y did not launch K4's X-only form and "
                     "K3")
            mats[tag] = cond
            _step(" ".join(["dist -S 14 -M"] + extra)
                  + f" over 4 quarters (K4 X-only {js.cum_union_launches}, "
                  f"K3 {um.launches})", wall, FQ_READS)
        if not (mats["y"] < mats["plain"]).all():
            fail(f"e2e (f): a filtered distance is not below the plain one: "
                 f"{mats['y']} vs {mats['plain']}")
        log("[e2e f] Mash, filtered "
            + " ".join(f"{v:.5f}" for v in mats["y"]) + " < plain "
            + " ".join(f"{v:.5f}" for v in mats["plain"]))

        # 5. the filtered path on the card and on the CPU, bitwise
        head = os.path.join(tmp, "head.fq")
        with open(fq, "rb") as src, open(head, "wb") as dst:
            dst.write(src.read(20_000 * FQ_RECORD))
        params = pipeline.SketchParams(k=31, use_counting_filter=True,
                                       min_count=2,
                                       cm_size_log2=FQ_CM_LOG2)
        t = time.perf_counter()
        got = pipeline.sketch_file_hll(head, params, 16, dev)
        wall = time.perf_counter() - t
        t = time.perf_counter()
        want = pipeline.sketch_file_hll(head, params, 16, torch.device("cpu"))
        if not np.array_equal(got, want) or not got.any():
            fail(f"e2e (f): filtered registers on the card differ from the "
                 f"CPU run in {int((got != want).sum())} places")
        _step(f"20,000 reads filtered at 2^{FQ_CM_LOG2} x 4 counters in "
              f"process, registers bitwise equal to the CPU run "
              f"({time.perf_counter() - t:.1f}s on the CPU)", wall, 20_000)
        _e2e_weighted(dev, quarters)
        _e2e_hk(dev, fq, twice, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# readfilt: kernel phase `sparse` and e2e (l); weighted Jaccard: e2e (m)
# ---------------------------------------------------------------------------

RF_PAIRS = 500_000          # e2e (l): 1,000,000 reads in two FASTQ files
RF_LEN = 150                # bases a mate
RF_INSERT = 400             # fragment: mate 2 is its end, reverse-complemented
RF_K, RF_P = 21, 16         # readfilt -k, the reference's sketch -S
RF_CHECK_BATCHES = 2        # readfilt batches of e2e (l) held against the CPU
# of those pairs (16,384), card against CPU, at most: pairs further apart
# than 1e-3 in CI where both devices took the same keep-or-restart branch
# (189 on these pairs on an H100; 246 of the first 20,000 in batches of
# 4,096), and pairs kept on one device only with CI further than 1e-3
# from the cut (7 on these pairs)
RF_NONFLIP_FAR_MAX = 300
RF_KEPT_DIFFER_MAX = 16
RF_WIDE = 20                # FASTA records of 70-150 kbp (ertl_joint each)
RF_BATCHES = (1024, 4096, 8192)     # records a batch, timed in turns
# foreign pairs kept at most: on the CPU the port keeps 0.105 of such
# pairs, the JAX package 0.11 (tests/test_torch_readfilt.py::
# test_readfilt_5mbp_witness)
RF_FOREIGN_MAX = 0.2
LUT = np.frombuffer(b"ACGT", np.uint8)


def fq_genome() -> np.ndarray:
    """e2e (f)'s 5 Mbp genome: the first draw of write_reads from its
    seed."""
    return np.random.default_rng(SEED + 3).integers(0, 4, FQ_GENOME).astype(
        np.uint8)


def foreign_genome() -> np.ndarray:
    return np.random.default_rng(SEED + 8).integers(0, 4, FQ_GENOME).astype(
        np.uint8)


def read_pairs(rng, genome, foreign, b0: int, n: int):
    """Pairs b0..b0+n of RF_LEN-base mates from RF_INSERT-base fragments:
    even pairs from `genome`, odd ones from `foreign`, FQ_ERR
    substitutions a base; mate 2 is the fragment's end reverse-
    complemented.  Returns (mate 1, mate 2) codes, (n, RF_LEN) uint8."""
    mates = np.empty((2, n, RF_LEN), np.uint8)
    src = (b0 + np.arange(n)) % 2
    starts = rng.integers(0, FQ_GENOME - RF_INSERT, n)
    ar = np.arange(RF_LEN)
    for s, g in ((0, genome), (1, foreign)):
        st = starts[src == s][:, None]
        mates[0, src == s] = g[st + ar]
        mates[1, src == s] = 3 - g[st + RF_INSERT - 1 - ar]
    flat = mates.reshape(-1)
    hit = rng.integers(0, flat.size, rng.binomial(flat.size, FQ_ERR))
    flat[hit] = (flat[hit] + rng.integers(1, 4, hit.size)) & 3
    return mates[0], mates[1]


def pair_seqs(m1, m2):
    """The engine's records: mates joined by N x (k - 1), as readfilt
    joins them."""
    sep = b"N" * (RF_K - 1)
    return [LUT[a].tobytes() + sep + LUT[b].tobytes() for a, b in zip(m1, m2)]


def write_pairs(paths, rng, genome, foreign, n, keep, batch=100_000):
    """Two FASTQ files of n pairs (`@R<7 digits>/1` for a pair from the
    genome, `@F...` from the foreign one), array by array.  Returns the
    first `keep` pairs' codes."""
    width = 1 + 8 + 2 + 1 + RF_LEN + 3 + RF_LEN + 1
    kept = None
    fps = [open(p, "wb") for p in paths]
    try:
        for b0 in range(0, n, batch):
            nb = min(batch, n - b0)
            mates = read_pairs(rng, genome, foreign, b0, nb)
            if kept is None:
                kept = tuple(m[:keep].copy() for m in mates)
            ids = np.arange(b0, b0 + nb)
            for mate, (codes, fp) in enumerate(zip(mates, fps)):
                rec = np.empty((nb, width), np.uint8)
                rec[:, 0] = ord("@")
                rec[:, 1] = np.where(ids % 2 == 0, ord("R"), ord("F"))
                for d in range(7):
                    rec[:, 8 - d] = ord("0") + (ids // 10 ** d) % 10
                rec[:, 9:12] = np.frombuffer(b"/%d\n" % (mate + 1), np.uint8)
                rec[:, 12:12 + RF_LEN] = LUT[codes]
                tail = 12 + RF_LEN
                rec[:, tail:tail + 3] = np.frombuffer(b"\n+\n", np.uint8)
                rec[:, tail + 3:tail + 3 + RF_LEN] = ord("I")
                rec[:, -1] = ord("\n")
                fp.write(rec.tobytes())
    finally:
        for fp in fps:
            fp.close()
    return kept


def reference_registers(dev, genome):
    """The genome sketched at k=RF_K, p=RF_P in process (what `sketch -k
    21 -S 16` of its FASTA writes): uint8 registers."""
    from dashing_tpu_torch import pipeline
    return pipeline.sketch_joined_hll(LUT[genome], pipeline.SketchParams(
        k=RF_K), RF_P, dev)


def phase_sparse(dev, records, genome):
    """Kernel phase `sparse`: one readfilt batch (READFILT_BATCH pairs of
    2 x RF_LEN bases, half of them from a foreign genome) against the
    genome sketched at p = 16, at the shapes the engine gives its
    kernels: K2's keys bitwise equal to the plain version; the sparse
    statistics on the card bitwise equal to the same code on the CPU; the
    row-estimate kernel's direct form on hist_a and hist_u, the
    reference's one row and a last batch's 288 rows, bit for bit; K5 given c_u, (kb, READFILT_BATCH, 1), and without
    c_u, bit for bit; K4's joint form on one 100 kbp record against the
    reference (ertl_joint's 1 x 1 tile over [0, q+1]) bitwise.  Their
    records count launches from e2e (l)."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch import sparse
    t0 = time.perf_counter()
    n0 = len(records)
    p, k, q = RF_P, RF_K, 64 - RF_P
    regs = reference_registers(dev, genome)
    rng = np.random.default_rng(SEED + 7)
    B = pipeline.READFILT_BATCH
    seqs = pair_seqs(*read_pairs(rng, genome, foreign_genome(), 0, B))
    (_, tiles), = list(pipeline._record_batches(seqs, k - 1, B))
    t = torch.from_numpy(tiles).to(dev)
    R, C = tiles.shape
    log(f"[sparse] reference: {FQ_GENOME} bases at k={k} p={p} "
        f"({int((regs > 0).sum())} registers set); batch {R} pairs as a "
        f"({R}, {C}) tile ({time.perf_counter() - t0:.1f}s)")
    keys = eh.encode_hash_keys(t, k=k, p=p)
    if not torch.equal(keys, eh.encode_hash_keys_plain(t, k=k, p=p)):
        fail("K2 keys (readfilt batch): differ from the plain version")
    ms, paced = kernel_alone_ms(lambda i: eh.encode_hash_keys(t, k=k, p=p),
                                lambda: None, "K2 keys readfilt")
    plain_ms = cuda_ms(lambda: eh.encode_hash_keys_plain(t, k=k, p=p), 3)
    W = R * (C - k + 1)
    _enc_log("K2 keys readfilt", k, p, R, C, tiles.nbytes + 4 * W,
             enc_ops(R, C, k, W, True), ms, paced, plain_ms, eh)
    record(records, f"encode_hash_keys readfilt batch ({R}x{C} k={k} p={p})",
           K1_SRC, K2_REPLACES, "encode_hash_keys", 0.0, ms, plain_ms,
           tiles.nbytes + 4 * W, enc_ops(R, C, k, W, True), INT32_OPS)
    idx, rank = keys >> 6, keys & 63
    kb = sparse.level_window_bins(max(int(rank.max()), int(regs.max())), q)
    regs_d = torch.from_numpy(regs.astype(np.int32)).to(dev)
    hist_d = torch.from_numpy(np.bincount(regs, minlength=q + 2).astype(
        np.float32)).to(dev)[:kb].contiguous()
    st = sparse.stats_kfirst(idx, rank, regs_d, hist_d, p, kb)
    cpu = torch.device("cpu")
    st_cpu = sparse.stats_kfirst(idx.to(cpu), rank.to(cpu), regs_d.to(cpu),
                                 hist_d.to(cpu), p, kb)
    for key, v in st.items():
        if not torch.equal(v.cpu(), st_cpu[key]):
            fail(f"sparse statistics {key}: the card differs from the CPU")
    st_ms = cuda_ms(lambda: sparse.stats_kfirst(idx, rank, regs_d, hist_d, p,
                                                kb), 10)
    t1 = time.perf_counter()
    sparse.stats_kfirst(idx.to(cpu), rank.to(cpu), regs_d.to(cpu),
                        hist_d.to(cpu), p, kb)
    log(f"[sparse] statistics ({R} pairs x {keys.shape[1]} windows, window "
        f"kb={kb}): bitwise equal to the CPU run; PyTorch ops on the card "
        f"{st_ms:.4f} ms (sort, run ends, gather, 7 scatter_add_), on the "
        f"CPU {(time.perf_counter() - t1) * 1e3:.1f} ms")
    shape = f"{R} rows p={p} K={kb}"
    c_a = _check_estimates(st["hist_a"].T.contiguous(), p, 0, est.ERTL_MLE,
                           est.WINDOW_MLE_ITERS, "readfilt hist_a", shape,
                           records)
    c_u = _check_estimates(st["hist_u"].T.contiguous(), p, 0, est.ERTL_MLE,
                           est.WINDOW_MLE_ITERS, "readfilt hist_u", shape,
                           records)
    c_b = _check_estimates(hist_d[None], p, 0, est.ERTL_MLE,
                           est.WINDOW_MLE_ITERS, "readfilt reference",
                           f"1 row p={p} K={kb}", records)
    # e2e (l)'s last batch: 500,000 pairs leave 288 rows of 8,192
    _check_estimates(st["hist_a"].T[:288].contiguous(), p, 0, est.ERTL_MLE,
                     est.WINDOW_MLE_ITERS, "readfilt last batch",
                     f"288 rows p={p} K={kb}", records)
    kst = {key: st[key][:, :, None] for key in ("eq", "gt_a", "gt_b")}
    hb = hist_d[:, None].contiguous()
    tri = check_k5(kst, slice(None), st["hist_a"], hb, c_a, c_b, p, 0,
                   "readfilt batch with c_u", records, c_u=c_u[:, None])
    args = [kst[key] for key in ("eq", "gt_a", "gt_b")]
    args += [st["hist_a"], hb, c_a, c_b]
    got = jm.joint_triples(*args, p=p, kmin=0)
    if not torch.equal(got, jm.joint_triples_plain(*args, p=p, kmin=0)):
        fail("K5 without c_u (readfilt batch): not bit for bit its plain "
             "version")
    ci = (tri[2] / (tri[0] + tri[2]).clamp(min=1e-30))[:, 0].cpu().numpy()
    log(f"[sparse] K5 without c_u on the same statistics: bit for bit; kept "
        f"at CI >= 0.5: {(ci[0::2] >= 0.5).mean():.3f} of the genome's "
        f"pairs, {(ci[1::2] >= 0.5).mean():.3f} of the foreign ones")
    # ertl_joint's statistics: one record of 100 kbp against the reference
    rec = torch.zeros((1, 1 << p), dtype=torch.int32, device=dev)
    one = torch.from_numpy(LUT[genome[:100_000]][None].copy()).to(dev)
    eh.ascii_to_registers(one, rec[0], k=k, p=p)
    check_k4(rec.to(torch.int8), regs_d.to(torch.int8)[None], 0, q + 1,
             False, "1x1 ertl_joint", records)
    for r in records[n0:]:
        r["counter"] = "readfilt " + r["counter"]


def _rf_starts(seqs, regs_d, hist_d, dev):
    """Per pair, the start of the joint MLE (its inclusion-exclusion
    point from the three direct-MLE cardinalities) as the engine computes
    it on `dev`: the engine's batches (all of one length, so in order)."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch import sparse
    p, q = RF_P, 64 - RF_P
    ref_max = int(regs_d.max())
    out = []
    for _, tiles in pipeline._record_batches(seqs, RF_K - 1,
                                             pipeline.READFILT_BATCH):
        keys = eh.encode_hash_keys(torch.from_numpy(tiles).to(dev), k=RF_K,
                                   p=p)
        idx, rank = keys >> 6, keys & 63
        kb = sparse.level_window_bins(max(int(rank.max()), ref_max), q)
        hist = hist_d[:kb].contiguous()
        st = sparse.stats_kfirst(idx, rank, regs_d, hist, p, kb)
        mle = lambda h: um.estimate_rows(h.contiguous(), p=p, kmin=0,  # noqa
                                         method=est.ERTL_MLE)
        start = jm.joint_triples_plain(
            st["eq"][:, :, None], st["gt_a"][:, :, None],
            st["gt_b"][:, :, None], st["hist_a"], hist[:, None],
            mle(st["hist_a"].T), mle(hist[None]), mle(st["hist_u"].T)[:, None],
            p=p, kmin=0, iters=0)
        out.append(start[:, :, 0].T.cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def _ci(t):
    d = t[:, 0] + t[:, 2]
    return np.where(d > 0, t[:, 2] / np.maximum(d, 1e-300), 0.0)


def phase_e2e_readfilt(dev, counts, genome):
    """e2e (l): `readfilt -k 21 -s ref.hll -f 0.5 r1.fq r2.fq -o out.fq` of
    RF_PAIRS pairs of 2 x RF_LEN bases (half from the genome at FQ_ERR
    substitutions, half from a foreign 5 Mbp genome) against the genome's
    `sketch -k 21 -S 16`: reads/s, the metrics buckets, the kept share of
    each half; K2's keys form, the row-estimate kernel and K5 must
    launch.  The first RF_CHECK_BATCHES batches on the card against the
    CPU run of the same code; RF_WIDE FASTA records of 70-150 kbp cut from
    the genome, each through ertl_joint (K4's joint form on a 1 x 1 tile, K5
    given c_u), each contained at CI >= 0.95; records a batch timed in
    turns."""
    import torch
    from dashing_tpu_torch import metrics, pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    tmp = tempfile.mkdtemp(prefix="dtt_readfilt_")
    try:
        t0 = time.perf_counter()
        ref_fa = os.path.join(tmp, "ref.fa")
        with open(ref_fa, "wb") as fp:
            fp.write(b">ref\n" + LUT[genome].tobytes() + b"\n")
        wall = _timed(["sketch", "-k", str(RF_K), "-S", str(RF_P), "-P",
                       tmp + "/", ref_fa], "e2e (l) sketch of the reference")
        ref_hll = os.path.join(tmp, f"ref.fa.w.{RF_K}.spacing.{RF_P}.hll")
        rng = np.random.default_rng(SEED + 9)
        r1, r2 = (os.path.join(tmp, f"r{m}.fq") for m in (1, 2))
        m1, m2 = write_pairs((r1, r2), rng, genome, foreign_genome(),
                             RF_PAIRS, 100_000)
        size = os.path.getsize(r1) + os.path.getsize(r2)
        log(f"[e2e l] reference sketched in {wall:.3f}s; {2 * RF_PAIRS:,} "
            f"reads ({RF_PAIRS:,} pairs of 2 x {RF_LEN}, {size / 1e6:.1f} MB "
            f"of FASTQ) written ({time.perf_counter() - t0:.1f}s)")
        from dashing_tpu_torch.sketch.hll import HLL
        ref = HLL.read(ref_hll)
        regs_d = torch.from_numpy(ref.regs.astype(np.int32)).to(dev)
        hist_d = torch.from_numpy(ref.histogram()).to(dev)
        params = pipeline.SketchParams(k=RF_K)

        # 1. records a batch, in turns, on 100,000 pairs in process
        seqs = pair_seqs(m1, m2)
        walls = {b: [] for b in RF_BATCHES}
        for b in RF_BATCHES + RF_BATCHES[::-1]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipeline.records_joint_triples(seqs, params, regs_d, hist_d, RF_P,
                                           dev, batch=b)
            walls[b].append(time.perf_counter() - t)
        log(f"[e2e l] records_joint_triples of {len(seqs):,} pairs by batch "
            "size (in turns): " + "; ".join(
                f"{b}: " + " ".join(f"{w:.3f}s" for w in ws)
                for b, ws in walls.items()) + f"; the engine's batch "
            f"{pipeline.READFILT_BATCH}")

        # 2. the CLI over the whole read set, buckets on
        out = os.path.join(tmp, "out.fq")
        metrics._ENABLED = True
        metrics._totals.clear()
        eh.keys_launches = um.estimate_launches = jm.launches = 0
        js.launches = 0
        try:
            wall = _timed(["readfilt", "-k", str(RF_K), "-s", ref_hll, "-f",
                           "0.5", "-o", out, r1, r2], "e2e (l) readfilt")
            buckets = dict(metrics._totals)
        finally:
            metrics._ENABLED = False
            metrics._totals.clear()
            metrics._counts.clear()
        counts["readfilt encode_hash_keys"] = eh.keys_launches
        counts["readfilt estimate_rows"] = um.estimate_launches
        counts["readfilt joint_triples"] = jm.launches
        if 0 in (eh.keys_launches, um.estimate_launches, jm.launches):
            fail(f"e2e (l): readfilt launched K2 keys {eh.keys_launches}, "
                 f"row estimates {um.estimate_launches}, K5 {jm.launches}")
        if js.launches:
            fail("e2e (l): a read took the dense ertl_joint path")
        # c_a and c_u a batch (one K5 launch each), the reference's c_b
        # once a level window (at most 7: multiples of 8 up to q+2)
        windows = um.estimate_launches - 2 * jm.launches
        if not 1 <= windows <= (64 - RF_P + 2 + 7) // 8:
            fail(f"e2e (l): {um.estimate_launches} row-estimate launches "
                 f"for {jm.launches} batches: not 2 a batch and 1 a window")
        log(f"[e2e l] row-estimate launches {um.estimate_launches} = 2 x "
            f"{jm.launches} batches + {windows} level window(s)")
        kept = {"R": 0, "F": 0}
        cis = {}
        with open(out) as fp:
            for line in fp:
                if line.startswith("@") and "/1 |CI:" in line:
                    kept[line[1]] += 1
                    cis[int(line[2:9])] = float(line.split("|CI:")[1]
                                                .split("|")[0])
        share = {s: kept[s] / (RF_PAIRS // 2) for s in kept}
        log(f"[e2e l] readfilt -k {RF_K} -f 0.5 of {2 * RF_PAIRS:,} reads: "
            f"wall {wall:.3f}s, {2 * RF_PAIRS / wall:,.0f} reads/s; kept "
            f"{share['R']:.4f} of the genome's pairs, {share['F']:.4f} of the "
            f"foreign ones; launches K2 keys {eh.keys_launches}, row "
            f"estimates {um.estimate_launches}, K5 {jm.launches}; buckets "
            + ", ".join(f"{k} {v:.3f}s" for k, v in sorted(buckets.items())))
        if share["R"] < 0.8 or share["F"] > RF_FOREIGN_MAX:
            fail(f"e2e (l): kept {share['R']} of the genome's pairs (at "
                 f"least 0.8), {share['F']} of the foreign ones (at most "
                 f"{RF_FOREIGN_MAX})")

        # 3. the first pairs on the card against the CPU: whole CLI
        # batches, so that the CLI's windows are the engine's
        n_check = RF_CHECK_BATCHES * pipeline.READFILT_BATCH
        seqs = seqs[:n_check]
        cpu = torch.device("cpu")
        tri = {}
        devs = {"card": dev, "cpu": cpu}
        for name, d in devs.items():
            t = time.perf_counter()
            tri[name] = pipeline.records_joint_triples(
                seqs, params, regs_d.to(d), hist_d.to(d), RF_P, d)
            log(f"[e2e l] {n_check} pairs on the {name}: "
                f"{time.perf_counter() - t:.2f}s")
        if not np.isfinite(tri["card"]).all():
            fail("e2e (l): a triple on the card is not finite")
        ci_g, ci_c = _ci(tri["card"]), _ci(tri["cpu"])
        cli = np.array([cis.get(i, -1.0) for i in range(n_check)])
        emitted = cli >= 0
        if not (np.abs(cli[emitted] - ci_g[emitted]) <= 5e-7).all() or \
                not (emitted == (ci_g >= 0.5)).all():
            fail("e2e (l): the CLI's output differs from the engine's "
                 "triples on the card")
        # K5 and the sparse statistics equal their plain versions on the
        # card bit for bit (phase `sparse`); the CPU's plain version runs
        # the CPU's exp, log and expm1, and the row estimates part at
        # rtol ~1e-6.  A read's 8 Newton steps against a 5 Mbp reference
        # do not converge (its start, c_u - c_b of two estimates near
        # 5e6, moves by units with them), and its float32 likelihood
        # guard ties, so last-bit differences move some reads' CI far
        # (the JAX package parts from the port alike on the CPU:
        # tests/test_torch_readfilt.py::test_readfilt_5mbp_witness).
        # Held by count: the pairs further than 1e-3 that took the same
        # branch on both devices, and the kept sets outside 1e-3 of the
        # cut
        err = np.abs(ci_g - ci_c)
        far = err > 1e-3
        at_start = {name: (tri[name] == _rf_starts(
            seqs, regs_d.to(d), hist_d.to(d), d)).all(1)
            for name, d in devs.items()}
        flip = at_start["card"] ^ at_start["cpu"]
        near = np.abs(ci_c - 0.5) < 1e-3
        differ = (ci_g >= 0.5) != (ci_c >= 0.5)
        nonflip_far = int((far & ~flip).sum())
        differ_far = int((differ & ~near).sum())
        log(f"[e2e l] {n_check} pairs, card against CPU: CI within 1e-3 for "
            f"{int((~far).sum())}, within 1e-2 for {int((err <= 1e-2).sum())}"
            f" (max difference {err.max():.4f}); {int(flip.sum())} pairs "
            f"where one device kept its start ({int((far & flip).sum())} of "
            f"them further than 1e-3), {nonflip_far} further than 1e-3 on "
            f"the same branch (max {err[~flip].max():.4f}); at their start "
            f"{int(at_start['card'].sum())} on the card, "
            f"{int(at_start['cpu'].sum())} on the CPU; kept sets differ in "
            f"{int(differ.sum())} pairs ({int((differ & near).sum())} within "
            f"1e-3 of the cut, {int((differ & flip).sum())} flips)")
        if nonflip_far > RF_NONFLIP_FAR_MAX or \
                differ_far > RF_KEPT_DIFFER_MAX:
            fail(f"e2e (l): {nonflip_far} pairs on the same branch further "
                 f"than 1e-3 in CI from the CPU's (at most "
                 f"{RF_NONFLIP_FAR_MAX}); kept sets differ in {differ_far} "
                 f"pairs away from the cut (at most {RF_KEPT_DIFFER_MAX})")

        # 4. FASTA records above MAX_RECORD_WIDTH: ertl_joint each
        lens = np.exp(rng.uniform(np.log(70_000), np.log(150_000),
                                  RF_WIDE)).astype(int)
        wide = os.path.join(tmp, "wide.fa")
        with open(wide, "wb") as fp:
            for i, m in enumerate(lens):
                s = int(rng.integers(0, FQ_GENOME - m))
                fp.write(b">w%d cut\n%s\n" % (i, LUT[genome[s:s + m]]
                                              .tobytes()))
        if lens.min() <= pipeline.MAX_RECORD_WIDTH:
            fail("e2e (l): a wide record is not above MAX_RECORD_WIDTH")
        out = os.path.join(tmp, "wide.out")
        js.launches = jm.launches = 0
        wall = _timed(["readfilt", "-k", str(RF_K), "-s", ref_hll, "-f",
                       "0.0", "-o", out, wide], "e2e (l) readfilt wide")
        counts["readfilt joint_pair_stats"] = js.launches
        ci_w = [float(line.rsplit("|", 1)[1]) for line in open(out)
                if line.startswith(">")]
        log(f"[e2e l] {RF_WIDE} FASTA records of {lens.min()}-{lens.max()} "
            f"bases through ertl_joint: wall {wall:.3f}s, K4 joint "
            f"launches {js.launches}, K5 {jm.launches}; CI min "
            f"{min(ci_w):.6f}")
        if len(ci_w) != RF_WIDE or min(ci_w) < 0.95 or \
                js.launches != RF_WIDE or jm.launches != RF_WIDE:
            fail(f"e2e (l): wide records {ci_w}, K4 joint {js.launches}, K5 "
                 f"{jm.launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _e2e_weighted(dev, quarters):
    """e2e (m): `dist -k 31 -S 14 --wj-exact -M -b` (the device route) and
    `--wj` (count-min counts, the host route) over e2e (f)'s four
    quarters: walls, finite matrices of n(n-1)/2, K4's X-only form and K3
    launched, each flag's route alone (metrics buckets `wj.device` /
    `wj.host`); one quarter's --wj-exact registers on the card bitwise
    equal to the host route's (weighted_elements + HLL.add_np), its peak
    device memory a valid k-mer within WJ_BYTES_PER_WINDOW."""
    import torch
    from dashing_tpu_torch import metrics, pipeline
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import union_mle as um
    from dashing_tpu_torch.sketch.hll import HLL
    from dashing_tpu_torch.sketch.weighted import weighted_elements
    tmp = os.path.dirname(quarters[0])
    for flag in ("--wj-exact", "--wj"):
        out = os.path.join(tmp, f"wj{flag}.bin")
        js.cum_union_launches = um.launches = 0
        metrics._ENABLED = True
        metrics._totals.clear()
        try:
            wall = _timed(["dist", "-k", "31", "-S", "14", flag, "-M", "-b",
                           "-O", out, "--avoid-sorting"] + quarters,
                          f"e2e (m) dist {flag}")
            buckets = dict(metrics._totals)
        finally:
            metrics._ENABLED = False
            metrics._totals.clear()
            metrics._counts.clear()
        n, cond = _read_condensed(out)
        if n != 4 or cond.shape != (6,) or not np.isfinite(cond).all():
            fail(f"e2e (m) dist {flag}: bad matrix n={n} {cond}")
        if js.cum_union_launches == 0 or um.launches == 0:
            fail(f"e2e (m) dist {flag}: K4's X-only form or K3 did not "
                 "launch")
        route = "wj.device" if flag == "--wj-exact" else "wj.host"
        other = "wj.host" if flag == "--wj-exact" else "wj.device"
        if route not in buckets or other in buckets:
            fail(f"e2e (m) dist {flag}: the {route} route must run alone; "
                 f"buckets {sorted(buckets)}")
        log(f"[e2e m] dist -k 31 -S 14 {flag} -M over 4 x 250,000 reads: "
            f"wall {wall:.3f}s; Mash " + " ".join(f"{v:.5f}" for v in cond)
            + "; buckets " + ", ".join(
                f"{k} {v:.3f}s" for k, v in sorted(buckets.items())
                if k.startswith(("wj", "host", "sketch", "cardinality"))))
    params = pipeline.SketchParams(k=31)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics._ENABLED = True
    metrics._counts.clear()
    t = time.perf_counter()
    try:
        got = pipeline.sketch_file_wj_hll(quarters[0], params, 14, dev)
        windows = metrics._counts.get("wj.device", 0.0)
    finally:
        metrics._ENABLED = False
        metrics._totals.clear()
        metrics._counts.clear()
    dev_s = time.perf_counter() - t
    if got is None or not windows:
        fail("e2e (m): a quarter did not fit the --wj-exact device route")
    peak = torch.cuda.max_memory_allocated(dev) - base
    t = time.perf_counter()
    raw = pipeline.file_raw_kmers(quarters[0], params, dev)
    h = HLL(14)
    h.add_np(weighted_elements(raw, exact=True))
    # the route is chosen by WJ_BYTES_PER_WINDOW before any launch, as if
    # every window held a k-mer: the peak a valid k-mer must stay within it
    log(f"[e2e m] --wj-exact device route of one quarter: {windows:,.0f} "
        f"windows, {raw.size:,} valid k-mers, peak {peak:,} bytes above "
        f"what was allocated before: {peak / windows:.2f} a window, "
        f"{peak / max(raw.size, 1):.2f} a valid k-mer (WJ_BYTES_PER_WINDOW "
        f"{pipeline.WJ_BYTES_PER_WINDOW})")
    if peak > pipeline.WJ_BYTES_PER_WINDOW * raw.size:
        fail(f"e2e (m): --wj-exact took {peak / raw.size:.2f} bytes a valid "
             f"k-mer, above WJ_BYTES_PER_WINDOW "
             f"{pipeline.WJ_BYTES_PER_WINDOW}")
    if not np.array_equal(got, h.regs) or not got.any():
        fail(f"e2e (m): --wj-exact registers on the card differ from the "
             f"host route in {int((got != h.regs).sum())} places")
    log(f"[e2e m] one quarter's --wj-exact registers: device route "
        f"{dev_s:.3f}s, host route {time.perf_counter() - t:.3f}s, bitwise "
        "equal")


# e2e (h)-(k): BASELINE.md's 1k-genome row (benchmarks/e2e_100.py:21-22),
# 1,000 genomes of 200 kbp (200 ancestors x the 5 RATES copies), k21 S14
SMALL_ANC, SMALL_LEN = 200, 200_000
N_RECORDS, N_WIDE, N_OTHER = 5000, 20, 1000     # e2e (j)
REC_LEN, WIDE_LEN = (500, 50_000), (70_000, 150_000)   # bases, log-uniform
RECORD_COPIES = {3 + 100 * i: 11 + 500 * i for i in range(10)}   # other: rec
PANEL_COPIES, PANEL_FRESH = 40, 10               # e2e (k)


def _timed(argv, what):
    """Run the CLI entry, synchronised; fail on a nonzero return.  Returns
    the wall seconds."""
    import torch
    from dashing_tpu_torch.cli.main import main
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if main(list(argv)) != 0:
        fail(f"{what} returned nonzero")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_e2e_small(dev, counts):
    """e2e (h)-(k) over BASELINE.md's 1k-genome collection as FASTA."""
    rng = np.random.default_rng(SEED + 5)
    tmp = tempfile.mkdtemp(prefix="dtt_small_")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        ancestors: list = []
        genomes = _write_genomes(tmp, SMALL_ANC, SMALL_LEN, rng, ancestors)
        paths = [g[0] for g in genomes]
        log(f"[e2e h] wrote {len(paths)} genomes of {SMALL_LEN} bases, "
            f"{sum(os.path.getsize(q) for q in paths) / 1e6:.1f} MB of FASTA "
            f"({time.perf_counter() - t0:.1f}s)")
        os.chdir(tmp)                 # mkdist writes its matrices here
        db = _e2e_small_sketch(dev, genomes, tmp, counts)
        _e2e_mkdist(genomes, tmp)
        _e2e_records(dev, paths, tmp, counts, rng)
        _e2e_panel(genomes, ancestors, db, tmp, rng)
        _e2e_parallel(genomes, tmp, rng)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def _e2e_small_sketch(dev, genomes, tmp, counts):
    """(h) `sketch -k 21 -S 14 -o db.gz` of the 1,000 files: about
    ceil(1000 / 64) banked K1 launches, no single-file launch, ten files'
    registers equal to each sketched alone; `dist -M -b` with and without
    -J (planted pairs within 0.25 d + 0.001); `dist -W -P` twice (the
    second loads every sketch, launches no K1 and writes the same bytes);
    the sketch phase in turns, the per-file engine (sketch_file_hll a
    file) against the banked one (core.sketch_paths); the compare walls
    with and without -J.  Returns the database path."""
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.cli import core
    from dashing_tpu_torch.ops import encode_hash as eh
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    paths = [g[0] for g in genomes]
    n = len(paths)
    total = sum(os.path.getsize(q) for q in paths)
    db = os.path.join(tmp, "db.gz")
    eh.launches = eh.banks_launches = 0
    wall = _timed(["sketch", "-k", "21", "-S", "14", "-o", db,
                   "--avoid-sorting"] + paths, "e2e (h) sketch")
    counts["encode_hash_banks"] = eh.banks_launches
    want = -(-n // pipeline.small_batch_size(14))
    log(f"[e2e h] sketch -k 21 -S 14 -o of {n} files: banked K1 launches "
        f"{eh.banks_launches} (ceil({n}/{pipeline.small_batch_size(14)}) = "
        f"{want}), single-file K1 {eh.launches}; wall {wall:.3f}s "
        f"({n / wall:.0f} files/s)")
    if eh.banks_launches != want or eh.launches:
        fail("e2e (h): the small files did not go through the banked K1 "
             "in batches")
    with gzip.open(db, "rb") as fp:
        regs = [HLL.read_record(fp).regs for _ in range(n)]
    params = pipeline.SketchParams(k=21)
    for i in range(0, n, n // 10):
        alone = pipeline.sketch_file_hll(paths[i], params, 14, dev)
        if not np.array_equal(alone, regs[i]) or not alone.any():
            fail(f"e2e (h): {os.path.basename(paths[i])}: "
                 f"{int((alone != regs[i]).sum())} registers differ from "
                 "the file sketched alone")
    log("[e2e h] ten files' registers bitwise equal to each sketched alone "
        "(pipeline.sketch_file_hll)")
    for tag, extra in (("-M", []), ("-J -M", ["-J"])):
        out = os.path.join(tmp, "h.bin")
        wall = _timed(["dist", "-k", "21", "-S", "14", "-M", "-b", "-O", out,
                       "-o", out + ".sizes", "--avoid-sorting"] + extra
                      + paths, f"e2e (h) {tag}")
        _check_planted(out, genomes, f"(h) {tag}", wall, total)
    cdir = os.path.join(tmp, "cache")
    os.makedirs(cdir)
    outs = []
    for rep in range(2):
        out = os.path.join(tmp, f"w{rep}.bin")
        eh.launches = eh.banks_launches = 0
        wall = _timed(["dist", "-k", "21", "-S", "14", "-M", "-b", "-W",
                       "-P", cdir, "-O", out, "-o", out + ".sizes",
                       "--avoid-sorting"] + paths, f"e2e (h) -W run {rep}")
        launched = eh.launches + eh.banks_launches
        log(f"[e2e h] dist -W -P run {rep + 1}: K1 launches {launched}, "
            f"{len(os.listdir(cdir))} cache files; wall {wall:.3f}s")
        if (launched == 0) != (rep == 1):
            fail(f"e2e (h): -W run {rep + 1} launched K1 {launched} times")
        outs.append(open(out, "rb").read())
    if outs[0] != outs[1] or len(os.listdir(cdir)) != n:
        fail("e2e (h): the -W rerun wrote other bytes, or the cache does "
             "not hold every file")
    log("[e2e h] the -W rerun loaded every sketch and wrote the same bytes")
    opts = core.CommonOpts(k=21, sketch_size=14)
    engines = {
        "per-file": lambda: [pipeline.sketch_file_hll(q, params, 14, dev)
                             for q in paths],
        "banked": lambda: core.sketch_paths(paths, opts, dev)}
    walls: dict = {"per-file": [], "banked": []}
    for which in ("per-file", "banked", "banked", "per-file"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[which]()
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
    log("[e2e h] sketch phase in turns (per-file, banked, banked, per-file): "
        + "; ".join(f"{k} " + " ".join(f"{w:.3f}s ({n / w:.0f} files/s)"
                                       for w in v) for k, v in walls.items()))
    sketches = core.sketch_paths(paths, opts, dev)
    for tag, jestim in (("-M", est.ERTL_MLE), ("-J -M", est.ERTL_JOINT_MLE)):
        run = lambda: pw.all_pairs_condensed(  # noqa: E731
            sketches, pw.MASH_DIST, 21, est.ERTL_MLE, jestim, dev)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[e2e h] compare {tag} of the {n} sketches: {wall:.4f}s "
            f"({n * (n - 1) / 2 / wall:.0f} pairs/s)")
    return db


MKDIST_FILES = 250          # e2e (i): the first 50 ancestors' copies of (h)


def _e2e_mkdist(genomes, tmp):
    """(i) `mkdist --multik mk,17,33,4 -S 14 --jukes-cantor` over the first
    MKDIST_FILES of (h)'s files (writing 4,000 gzip cache files at level 9
    took 39 s for all 1,000): each chunk uploaded once for four K1
    launches; each per-k
    matrix bit for bit a separate `dist -k K -S 14 -b` with the options
    mkdist gives its passes (--jukes-cantor makes them --sizes
    --avoid-sorting); mk.bin finite, and mk.jcd finite for every pair of
    one ancestor's copies at a planted d >= 0.005 (nearer pairs' size
    estimates can rise with k, where the model has no distance: NaN, as
    for unrelated genomes).  The working directory is the scratch
    directory."""
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.io import distmat
    from dashing_tpu_torch.ops import encode_hash as eh
    ks = (17, 21, 25, 29)
    genomes = genomes[:MKDIST_FILES]
    paths = [g[0] for g in genomes]
    n = len(paths)
    sizes = ["-o", os.path.join(tmp, "sizes.txt")]
    eh.launches = eh.banks_launches = 0
    pipeline.chunk_uploads = 0
    wall = _timed(["mkdist", "--multik", "mk,17,33,4", "-S", "14",
                   "--jukes-cantor"] + sizes + paths, "e2e (i) mkdist")
    log(f"[e2e i] mkdist --multik mk,17,33,4 -S 14 --jukes-cantor over {n} "
        f"files: {pipeline.chunk_uploads} chunk uploads, K1 launches "
        f"{eh.launches} ({eh.launches / max(pipeline.chunk_uploads, 1):.2f} "
        f"an upload), banked {eh.banks_launches}; wall {wall:.3f}s")
    if pipeline.chunk_uploads != n or eh.launches != len(ks) * n:
        fail("e2e (i): not one upload a chunk and four K1 launches on it")
    t_sep = 0.0
    for k in ks:
        out = f"d{k}.bin"
        t_sep += _timed(["dist", "-k", str(k), "-S", "14", "--sizes", "-b",
                         "-O", out, "--avoid-sorting"] + sizes + paths,
                        f"e2e (i) dist k={k}")
        if open(f"_mk_{k}", "rb").read() != open(out, "rb").read():
            fail(f"e2e (i): mkdist's k={k} matrix differs from dist -k {k}")
    log(f"[e2e i] the four per-k matrices bit for bit equal to separate "
        f"dist -k K -S 14 --sizes -b runs ({t_sep:.3f}s for the four)")
    nsets, got_ks, data = distmat.read_flattened("mk.bin")
    m, jc = distmat.read_binary("mk.jcd")
    if (nsets != n or list(got_ks) != list(ks) or m != n
            or jc.shape != (n * (n - 1) // 2,)
            or not np.isfinite(data).all()):
        fail(f"e2e (i): mk.bin ({nsets}, {list(got_ks)}) or mk.jcd ({m}) "
             "malformed, or a size not finite")
    iu = np.triu_indices(n, 1)
    fam = np.array([g[1] for g in genomes])
    rate = np.array([RATES[g[2]] for g in genomes])
    same = fam[iu[0]] == fam[iu[1]]
    d = _expected_d(rate[iu[0]], rate[iu[1]])
    far = same & (d >= 0.005)
    bad = far & ~np.isfinite(jc)
    if bad.any():
        fail(f"e2e (i): {int(bad.sum())} Jukes-Cantor distances of related "
             f"genomes at d >= 0.005 not finite (d {d[bad][:5]})")
    near = same & ~far
    ok = far & np.isfinite(jc)
    log(f"[e2e i] mk.bin {data.shape} finite; mk.jcd: the {int(far.sum())} "
        f"related pairs at d >= 0.005 finite, |JC - d| at most "
        f"{float(np.abs(jc[ok] - d[ok]).max()):.5f}; "
        f"{int(np.isfinite(jc[near]).sum())} of the {int(near.sum())} "
        f"nearer pairs finite; {int(np.isnan(jc[~same]).sum())} of "
        f"{int((~same).sum())} unrelated pairs NaN")


def _fasta_seq(path: str) -> bytes:
    with open(path, "rb") as fp:
        return b"".join(line for line in fp.read().split(b"\n")
                        if not line.startswith(b">"))


def _e2e_records(dev, paths, tmp, counts, rng):
    """(j) 5,000 records of 500-50,000 bases (log-uniform) and 20 above
    MAX_RECORD_WIDTH, cut from (h)'s genomes: `sketch_by_seq -k 21 -S 10`
    (the .names sidecar and the record count right, 20 records' registers
    equal to each sketched alone on the card), `dist_by_seq -b` over all
    pairs, and its -q form against 1,000 other records, ten of them byte
    copies of records (Jaccard 1)."""
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import encode_hash as eh
    pool = [_fasta_seq(paths[i]) for i in range(0, len(paths), 10)]

    def cut(lo, hi, n):
        lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(int)
        out = []
        for m in lens:
            g = pool[int(rng.integers(len(pool)))]
            s = int(rng.integers(0, len(g) - m))
            out.append(g[s:s + m])
        return out

    recs = cut(*REC_LEN, N_RECORDS) + cut(*WIDE_LEN, N_WIDE)
    other = cut(*REC_LEN, N_OTHER)
    if min(map(len, recs[N_RECORDS:])) <= pipeline.MAX_RECORD_WIDTH:
        fail("e2e (j): a wide record is not above MAX_RECORD_WIDTH")
    for o, r in RECORD_COPIES.items():
        other[o] = recs[r]
    files = {}
    for tag, seqs in (("rec", recs), ("other", other)):
        files[tag] = os.path.join(tmp, f"{tag}.fa")
        with open(files[tag], "wb") as fp:
            for i, seq in enumerate(seqs):
                fp.write(b">%s%d some words\n%s\n" % (tag.encode(), i, seq))
    n = len(recs)
    sbs = os.path.join(tmp, "rec.sbs")
    eh.ascii_banks_launches = 0
    wall = _timed(["sketch_by_seq", "-k", "21", "-S", "10", "-o", sbs,
                   files["rec"]], "e2e (j) sketch_by_seq")
    counts["ascii_hash_banks"] = eh.ascii_banks_launches
    names = open(sbs + ".names").read().splitlines()
    with gzip.open(sbs, "rb") as fp:
        stream = fp.read()
    if (names[0] != "#k=21:Names for sequences sketched"
            or names[1:] != [f"rec{i}" for i in range(n)]
            or len(stream) != n * (16 + 1024)):
        fail(f"e2e (j): {len(names) - 1} names, {len(stream)} bytes of "
             f"sketches for {n} records")
    bases = sum(len(r) for r in recs)
    log(f"[e2e j] sketch_by_seq -k 21 -S 10 of {n} records "
        f"({bases / 1e6:.1f} Mbases, {N_WIDE} above MAX_RECORD_WIDTH): "
        f"banked K2 launches {eh.ascii_banks_launches}; wall {wall:.3f}s "
        f"({n / wall:.0f} records/s)")
    if eh.ascii_banks_launches == 0:
        fail("e2e (j): sketch_by_seq did not launch the banked K2")
    params = pipeline.SketchParams(k=21)
    idx = list(rng.choice(N_RECORDS, 10, replace=False)) + list(
        range(N_RECORDS, n, 2))
    for i in idx:
        alone = pipeline.sketch_file_seq(recs[i], params, 10, dev)
        off = 16 + i * (16 + 1024)
        got = np.frombuffer(stream[off:off + 1024], np.uint8)
        if not np.array_equal(alone, got) or not alone.any():
            fail(f"e2e (j): record {i}: {int((alone != got).sum())} "
                 "registers differ from the record sketched alone")
    log(f"[e2e j] {len(idx)} records' registers ({N_WIDE // 2} of them "
        "above MAX_RECORD_WIDTH) bitwise equal to each sketched alone")
    out = os.path.join(tmp, "dbs.bin")
    wall = _timed(["dist_by_seq", "-n", sbs + ".names", "-b", "-o", out,
                   sbs], "e2e (j) dist_by_seq")
    m, cond = _read_condensed(out)
    if m != n or cond.shape != (n * (n - 1) // 2,) or \
            not np.isfinite(cond).all():
        fail(f"e2e (j): dist_by_seq matrix n={m} len={cond.shape}")
    log(f"[e2e j] dist_by_seq -b over {cond.size:,} pairs: wall {wall:.3f}s "
        f"({cond.size / wall:,.0f} pairs/s)")
    osbs = os.path.join(tmp, "other.sbs")
    _timed(["sbs", "-k", "21", "-S", "10", "-o", osbs, files["other"]],
           "e2e (j) sbs of the queries")
    out = os.path.join(tmp, "dbs_q.bin")
    wall = _timed(["cmp_by_seq", "-n", sbs + ".names", "-q", osbs, "-b", "-o",
                   out, sbs], "e2e (j) dist_by_seq -q")
    mat = np.fromfile(out, "<f4")
    if mat.shape != (N_OTHER * n,) or not np.isfinite(mat).all():
        fail(f"e2e (j): dist_by_seq -q gave {mat.shape} values")
    mat = mat.reshape(N_OTHER, n)
    for o, r in RECORD_COPIES.items():
        if abs(float(mat[o, r]) - 1.0) > 1e-5:
            fail(f"e2e (j): query {o}, a copy of record {r}: Jaccard "
                 f"{mat[o, r]}")
    log(f"[e2e j] dist_by_seq -q of {N_OTHER} records x {n}: wall "
        f"{wall:.3f}s ({mat.size / wall:,.0f} pairs/s); the ten copies at "
        "Jaccard 1")


def _e2e_panel(genomes, ancestors, db, tmp, rng):
    """(k) `panel -k 21 -F` of 50 queries against (h)'s database: 40 byte
    copies of database genomes (each one's best match the genome it
    copies, containment 1 within 1e-5) and 10 fresh copies of ancestors
    (best match a genome of that ancestor); K4's joint form and K5 must
    launch."""
    from dashing_tpu_torch.ops import joint_mle as jm
    from dashing_tpu_torch.ops import joint_stats as js
    qdir = os.path.join(tmp, "panel")
    os.makedirs(qdir)
    lut = np.frombuffer(b"ACGT", np.uint8)
    queries, expect = [], []
    step = len(genomes) // PANEL_COPIES
    for j in range(PANEL_COPIES):
        path, _, _ = genomes[j * step + j % 5]
        queries.append(os.path.join(qdir, f"copy{j}.fa"))
        shutil.copyfile(path, queries[-1])
        expect.append(("copy", path))
    for j in range(PANEL_FRESH):
        a = j * (len(ancestors) // PANEL_FRESH)
        g = ancestors[a].copy()
        hit = np.flatnonzero(rng.random(g.size) < 0.01)
        g[hit] = (g[hit] + 1) & 3
        queries.append(os.path.join(qdir, f"fresh{j}.fa"))
        with open(queries[-1], "wb") as fp:
            fp.write(b">fresh\n" + lut[g].tobytes() + b"\n")
        expect.append(("fresh", a))
    qlist = _write_list(os.path.join(tmp, "panel.txt"), queries)
    out = os.path.join(tmp, "panel.tsv")
    js.launches = jm.launches = 0
    wall = _timed(["panel", "-k", "21", "-F", "-o", out, db, qlist],
                  "e2e (k) panel")
    rows = [line.split("\t") for line in open(out).read().splitlines()[1:]]
    family = {g[0]: g[1] for g in genomes}
    if len(rows) != len(queries):
        fail(f"e2e (k): {len(rows)} rows for {len(queries)} queries")
    worst = 0.0
    for (kind, want), (q, best, cont, ji) in zip(expect, rows):
        if kind == "copy":
            worst = max(worst, abs(float(cont) - 1.0))
            if best != want or abs(float(cont) - 1.0) > 1e-5:
                fail(f"e2e (k): {q} (a copy of {want}): best {best} "
                     f"containment {cont}")
        elif family[best] != want:
            fail(f"e2e (k): {q} (ancestor {want}): best {best}")
    log(f"[e2e k] panel of {len(queries)} queries x {len(genomes)} genomes: "
        f"every copy's best match the genome it copies (containment within "
        f"{worst:.1e} of 1), every fresh copy's a genome of its ancestor; "
        f"K4 joint launches {js.launches}, K5 {jm.launches}; wall "
        f"{wall:.3f}s")
    if js.launches == 0 or jm.launches == 0:
        fail("e2e (k): panel did not launch K4's joint form and K5")


# ---------------------------------------------------------------------------
# phase `parallel`, e2e (q): the port's CLI as 2 and 3 gloo ranks sharing
# the one card over (h)'s collection, against one process; its mesh half is
# in phase_e2e (the mesh pinned to (cuda:0, cuda:0) over config 2)
# ---------------------------------------------------------------------------

PAR_TILE = "256"          # compare tile rows: 4 blocks of (h)'s 1,000, so
#                           every one of 3 ranks owns stripes (the default
#                           1,024 gives rank 0 the only block)
PAR_FRESH, PAR_COPIES = 490, 10      # -Q: fresh genomes, byte copies
PAR_TIMEOUT = 420                    # seconds a rank set may take
_PAR_COUNTERS = (("K1 banked", "encode_hash", "banks_launches"),
                 ("K1", "encode_hash", "launches"),
                 ("K4 X-only", "joint_stats", "cum_union_launches"),
                 ("K3", "union_mle", "launches"),
                 ("row estimates", "union_mle", "estimate_launches"),
                 ("K4 joint", "joint_stats", "launches"),
                 ("K5", "joint_mle", "launches"))


def _par_rank(rank, nprocs, port, runs, cwd, results):
    """One process of a rank set (spawned): the runs in order through the
    CLI entry on cuda:0, each with the counters and the metrics buckets
    reset before it; puts (rank, [(wall, counters, buckets, stdout)]) or
    (rank, error text) on `results`."""
    import contextlib
    import importlib
    import io
    import traceback
    os.environ.update(DASHING_TPU_TORCH_DEVICE="cuda:0",
                      DASHING_TPU_COMPARE_TILE=PAR_TILE)
    if nprocs > 1:
        os.environ.update(DASHING_TPU_DISTRIBUTED="1",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(nprocs), RANK=str(rank))
    try:
        import torch
        from dashing_tpu_torch import metrics
        from dashing_tpu_torch.cli.main import main
        os.chdir(cwd)
        mods = {m: importlib.import_module(f"dashing_tpu_torch.ops.{m}")
                for m in ("encode_hash", "joint_stats", "union_mle",
                          "joint_mle")}
        out = []
        for argv in runs:
            for _, m, attr in _PAR_COUNTERS:
                setattr(mods[m], attr, 0)
            metrics._ENABLED = True
            metrics._totals.clear()
            text = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = main([a.replace("{P}", str(nprocs)) for a in argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"{argv[0]} returned {rc}")
            out.append((wall, {name: getattr(mods[m], attr)
                               for name, m, attr in _PAR_COUNTERS},
                        dict(metrics._totals), text.getvalue()))
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def _par_spawn(nprocs, runs, cwd):
    """Run `runs` as nprocs spawned processes (gloo on 127.0.0.1 when
    nprocs > 1), each on cuda:0; every process must end within
    PAR_TIMEOUT seconds with its results, or the phase fails (and the
    processes are killed).  Returns the per-rank results in rank order."""
    import queue
    import socket
    import torch.multiprocessing as tmp_mp
    ctx = tmp_mp.get_context("spawn")
    results = ctx.Queue()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = [ctx.Process(target=_par_rank,
                         args=(r, nprocs, port, runs, cwd, results))
             for r in range(nprocs)]
    for pr in procs:
        pr.start()
    got = {}
    deadline = time.perf_counter() + PAR_TIMEOUT
    try:
        while len(got) < nprocs:
            try:
                rank, res = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                fail(f"e2e (q): {nprocs} ranks: no result from ranks "
                     f"{sorted(set(range(nprocs)) - set(got))} within "
                     f"{PAR_TIMEOUT}s (a hung rank or a deadlock)")
            if isinstance(res, str):
                fail(f"e2e (q): {nprocs} ranks: rank {rank} failed:\n{res}")
            got[rank] = res
        for pr in procs:
            pr.join(timeout=max(1.0, deadline - time.perf_counter()))
            if pr.exitcode != 0:
                fail(f"e2e (q): {nprocs} ranks: a rank exited with "
                     f"{pr.exitcode}")
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    return [got[r] for r in range(nprocs)]


MESH_TILE = 16            # compare tile rows of the mesh's direct check


def _e2e_mesh(dev, paths, sketches, tmp, out_b, out_c):
    """(q)'s mesh half: the mesh pinned to (cuda:0, cuda:0) by the test
    hook, `dist -k 31 -S 16 -M -b` and `-J` over config 2's 100 genomes
    in process, bit for bit (b)'s and (c)'s matrices, each genome's chunks
    spread over both shards (K1 into each shard's registers); then, as
    the CLI's 100 x 100 compare is one tile (one shard), the condensed
    compare of the same sketches at MESH_TILE-row tiles with and without
    the mesh, bit for bit, with tiles on both shards.  A second card is
    not exercised: one H100 cannot show a kernel launched on cuda:1."""
    import collections
    import torch
    from dashing_tpu_torch import pipeline
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.parallel import mesh as pmesh
    from dashing_tpu_torch.sketch import estimators as est
    cuda0 = torch.device("cuda", 0)
    since, streams, shard_tiles = set(), [], collections.Counter()
    orig_k1, orig_rr = pipeline.packed_to_registers, pw._round_robin
    orig_merge = pmesh.max_merge

    def k1(packed, vbits, regs, **kw):
        since.add(regs.data_ptr())
        return orig_k1(packed, vbits, regs, **kw)

    def merge(parts):
        # a stream's end: how many of its shards' registers K1 filled
        streams.append(sum(q.data_ptr() in since for q in parts))
        since.clear()
        return orig_merge(parts)

    def round_robin(keys, reps, one):
        ids = [id(r) for r in reps]

        def counted(banks, *key):
            shard_tiles[ids.index(id(banks))] += 1
            return one(banks, *key)
        return orig_rr(keys, reps, counted)

    pipeline.packed_to_registers, pw._round_robin = k1, round_robin
    pmesh.max_merge = merge
    pmesh._set_local_mesh_for_tests((cuda0, cuda0))
    try:
        for tag, extra, want in (("-M", [], out_b), ("-J -M", ["-J"], out_c)):
            out = os.path.join(tmp, f"mesh{len(extra)}.bin")
            streams.clear()
            shard_tiles.clear()
            wall = _timed(["dist", "-k", "31", "-S", "16", "-M", "-b", "-O",
                           out, "-o", out + ".sizes", "--avoid-sorting"]
                          + extra + paths, f"e2e (q) mesh {tag}")
            if open(out, "rb").read() != open(want, "rb").read():
                fail(f"e2e (q): the (cuda:0, cuda:0) mesh's dist {tag} "
                     "differs from the one-card matrix")
            if streams != [2] * len(paths):
                fail(f"e2e (q): mesh {tag}: K1 filled both shards' "
                     f"registers in {streams.count(2)} of {len(paths)} "
                     f"genomes' streams ({len(streams)} streams)")
            log(f"[e2e q] mesh (cuda:0, cuda:0) dist -k 31 -S 16 {tag} -b: "
                f"bit for bit the one-card matrix; K1 into both shards' "
                f"registers in each of the {len(paths)} genomes' chunk "
                f"streams; compare tiles by shard {dict(shard_tiles)} (one "
                f"tile); wall {wall:.3f}s")
        for tag, jestim in (("-M", est.ERTL_MLE),
                            ("-J -M", est.ERTL_JOINT_MLE)):
            run = lambda: pw.all_pairs_condensed(  # noqa: E731
                sketches, pw.MASH_DIST, 31, est.ERTL_MLE, jestim, dev,
                tile=MESH_TILE)
            shard_tiles.clear()
            on = run()
            tiles = dict(shard_tiles)
            pmesh._set_local_mesh_for_tests(None, frozen=True)
            off = run()
            pmesh._set_local_mesh_for_tests((cuda0, cuda0))
            if not np.array_equal(on, off) or min(
                    tiles.get(0, 0), tiles.get(1, 0)) == 0:
                fail(f"e2e (q): mesh compare {tag} at {MESH_TILE}-row tiles:"
                     f" equal {np.array_equal(on, off)}, tiles by shard "
                     f"{tiles}")
            log(f"[e2e q] mesh compare {tag} of the {len(sketches)} sketches "
                f"at {MESH_TILE}-row tiles: bit for bit one card's; tiles by "
                f"shard {tiles}")
    finally:
        pipeline.packed_to_registers, pw._round_robin = orig_k1, orig_rr
        pmesh.max_merge = orig_merge
        pmesh._set_local_mesh_for_tests(None, frozen=False)
    log(f"[e2e q] torch.cuda.device_count() = {torch.cuda.device_count()}: "
        "the mesh ran as two shards of one card")


def _par_bytes(path: str) -> bytes:
    with open(path, "rb") as fp:
        data = fp.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _e2e_parallel(genomes, tmp, rng):
    """(q) phase `parallel` over (h)'s 1,000 genomes, k21 S14: as one
    process, then 2 and 3 gloo ranks on the one card
    (DASHING_TPU_DISTRIBUTED=1, each rank on cuda:0, started with
    torch.multiprocessing's spawn, compare tiles of PAR_TILE rows): `dist
    -M -b -O` (rank-local mmap stripes) and the same as TSV at 2 and 3
    ranks; at 2 ranks also `-J -M -b -O`, `-Q` with 500 queries (490
    fresh genomes, ten byte copies of references) as `-M -b` and
    `--nearest-neighbors 5`, `hll`, `sketch -P` (each rank its stride of
    per-file sketches) and `union` over the one-process sketches.  Each
    output is byte-identical to one process's (gzip files once
    decompressed); on every rank banked K1, K4's X-only form and K3 launch
    (K4's joint form and K5 under -J); the copies sit at distance 0 from
    their references; rank 0's walls and buckets printed."""
    qdir = os.path.join(tmp, "parq")
    os.makedirs(qdir)
    fresh = [g[0] for g in _write_genomes(qdir, PAR_FRESH // len(RATES),
                                          SMALL_LEN, rng)]
    paths = [g[0] for g in genomes]
    copies = [3 + j * (len(paths) // PAR_COPIES) for j in range(PAR_COPIES)]
    for j, i in enumerate(copies):
        fresh.append(os.path.join(qdir, f"copy{j}.fa"))
        shutil.copyfile(paths[i], fresh[-1])
    qlist = _write_list(os.path.join(tmp, "parq.txt"), fresh)
    for d in ("sk1", "sk2"):
        os.makedirs(os.path.join(tmp, d))
    dist = ["dist", "-k", "21", "-S", "14", "--avoid-sorting"]
    runs = {
        "-M -b -O (mmap stripes)": (dist + ["-M", "-b", "-O", "m{P}.bin"]
                                    + paths, ["m{P}.bin"]),
        "-M TSV": (dist + ["-M", "-O", "m{P}.tsv"] + paths, ["m{P}.tsv"]),
        "-J -M -b -O": (dist + ["-J", "-M", "-b", "-O", "j{P}.bin"] + paths,
                        ["j{P}.bin"]),
        "-Q -M -b": (dist + ["-Q", qlist, "-M", "-b", "-O", "q{P}.bin"]
                     + paths, ["q{P}.bin"]),
        "-Q --nearest-neighbors 5": (
            dist + ["-Q", qlist, "--nearest-neighbors", "5", "-O",
                    "nn{P}.tsv"] + paths, ["nn{P}.tsv"]),
        "hll": (["hll", "-k", "21", "-S", "14"] + paths, []),
        "sketch -P": (["sketch", "-k", "21", "-S", "14", "--avoid-sorting",
                       "-P", "sk{P}"] + paths,
                      [os.path.join("sk{P}", os.path.basename(q)
                                    + ".w.21.spacing.14.hll")
                       for q in paths]),
        "union": (["union", "-o", "u{P}.hll"] + [
            os.path.join("sk1", os.path.basename(q) + ".w.21.spacing.14.hll")
            for q in paths], ["u{P}.hll"]),
    }
    names = list(runs)
    t_phase = time.perf_counter()
    one = _par_spawn(1, [runs[k][0] for k in names], tmp)[0]
    for key, (wall, _, buckets, _) in zip(names, one):
        log(f"[e2e q] {key}, one process (spawned, cuda:0): wall "
            f"{wall:.3f}s; buckets: {_buckets(buckets)}")
    q = np.frombuffer(open(os.path.join(tmp, "q1.bin"), "rb").read(),
                      "<f4").reshape(len(fresh), len(paths))
    worst = max(abs(float(q[len(fresh) - PAR_COPIES + j, i]))
                for j, i in enumerate(copies))
    if worst != 0.0:
        fail(f"e2e (q): a byte copy's Mash distance to its reference is "
             f"{worst}, not 0")
    for nprocs, which in ((2, names), (3, names[:2])):
        t0 = time.perf_counter()
        ranks = _par_spawn(nprocs, [runs[k][0] for k in which], tmp)
        spawn = time.perf_counter() - t0
        for i, key in enumerate(which):
            files = runs[key][1]
            for f in files:
                a = _par_bytes(os.path.join(tmp, f.replace("{P}", "1")))
                b = _par_bytes(os.path.join(tmp, f.replace(
                    "{P}", str(nprocs))))
                if a != b:
                    fail(f"e2e (q): {key} at {nprocs} ranks: {f} differs "
                         "from one process's")
            if ranks[0][i][3] != one[names.index(key)][3]:
                fail(f"e2e (q): {key} at {nprocs} ranks: rank 0 printed "
                     "other text than one process")
            if any(r[i][3] for r in ranks[1:]):
                fail(f"e2e (q): {key} at {nprocs} ranks: a rank but 0 "
                     "printed")
            need = {"hll": ("K1 banked",), "union": (), "sketch -P": (
                "K1 banked",), "-J -M -b -O": ("K1 banked", "K4 joint",
                                               "K5")}.get(
                key, ("K1 banked", "K4 X-only", "K3"))
            for r, res in enumerate(ranks):
                missing = [c for c in need if res[i][1][c] == 0]
                if missing:
                    fail(f"e2e (q): {key} at {nprocs} ranks: rank {r} "
                         f"launched no {missing}: {res[i][1]}")
            wall, cnt, buckets, _ = ranks[0][i]
            log(f"[e2e q] {key} at {nprocs} ranks sharing one card "
                f"(walls of {nprocs} processes on one card, not scaling): "
                f"byte-identical to one process ({len(files)} files); "
                f"rank 0 wall {wall:.3f}s (one process "
                f"{one[names.index(key)][0]:.3f}s); launches by rank "
                + " | ".join(", ".join(f"{c} {v}" for c, v in
                                       res[i][1].items() if v)
                             for res in ranks)
                + f"; rank 0 buckets: {_buckets(buckets)}")
        log(f"[e2e q] {nprocs} ranks: {len(which)} runs, spawn to last "
            f"result {spawn:.1f}s")
    log(f"[e2e q] phase parallel: {time.perf_counter() - t_phase:.1f}s")


def main() -> int:
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch unavailable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        import dashing_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here: {e}")
    os.environ["DASHING_TPU_TORCH_DEVICE"] = "cuda"
    from dashing_tpu_torch import device as devmod
    dev = devmod.from_env()          # the CLI's device and matmul policy
    phase_device()
    phase_build()
    phase_b1_peak(dev)
    empty_launch_floor(dev)
    records: list = []
    counts: dict = {}
    phase_k1(dev, records)
    phase_k2(dev, records)
    phase_minimizer(dev, records)
    phase_countmin(dev, records)
    phase_banks(dev, records)
    phase_k3(dev, records)
    bank = phase_k4_k5(dev, records)
    other = phase_rect(dev, bank, records)
    genome = fq_genome()
    phase_sparse(dev, records, genome)
    phase_e2e(dev, bank, other, counts, records)
    phase_e2e_fastq(dev, counts)
    phase_e2e_readfilt(dev, counts, genome)
    phase_e2e_small(dev, counts)
    for r in records:
        r["launches"] = counts[r["counter"]]
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
