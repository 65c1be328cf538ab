"""The `sketch_reads` job kind: a FASTQ read set sketched, through the
count-min filter where the mix asks for it, then its size read from the
sketch.

Set-up writes one read set (reads.py) under $TMPDIR.  A unit is
`dashing_tpu_torch sketch -k K -S P <args> -P <dir> reads.fq` then
`card -H -o <sizes> <the .hll>`, both in this process, each inside a
profiler range of its own (`pb.sketch`, `pb.card`), the mix's `args`
between.  Where `-b` is among them, the filter's options `-n -q -H -R`
are read from the args, and one the mix leaves out is added from the
configuration (`min_count`, `cm_size_log2`, `cm_rows`, `cm_seed`), so
that the program and the check run with the same filter: a mix says
whether to filter and at what count, the configuration sizes the table
for its read set.  Its work is
the reads' bases.  Each unit records the program's count-min counters
(`cm_tiles`, `cm_rehashed_tiles`; absent from a program that lacks them)
in `unit_counts`.  The check reads the last unit's `.hll` and sizes and
works both out again with the plain reference (reference/countmin.py):
the registers bit for bit, filtered or plain as the args say, the size
against Ertl's MLE in float64.  The control computes that MLE in
bfloat16, and, on a filtered mix, the filter with one row fewer.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import shutil
import sys
import tempfile
from typing import Dict, List

import numpy as np

from portbench import reads
from portbench.jobs import Job

COUNTERS = ("cm_tiles", "cm_rehashed_tiles")
# the filter's options and the configuration keys that give their values
FILTER_OPTIONS = (("-n", "min_count"), ("-q", "cm_size_log2"),
                  ("-H", "cm_rows"), ("-R", "cm_seed"))
HLL_HEADER = 16               # magic (8), p, estimators, flags, reserved


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def read_hll(path: str):
    """(p, registers uint8) of a one-record `.hll` file: a gzip member of
    b"DTPUHLL1", p, two estimator bytes, a flags byte, 4 reserved bytes,
    then 2^p register bytes."""
    with gzip.open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != b"DTPUHLL1":
        raise ValueError(f"{path}: not an HLL sketch")
    p = data[8]
    regs = np.frombuffer(data, np.uint8, 1 << p, HLL_HEADER)
    if len(data) != HLL_HEADER + (1 << p):
        raise ValueError(f"{path}: {len(data)} bytes for p = {p}")
    return p, regs


def filter_options(args: List[str], config: dict) -> Dict[str, int]:
    """{} where `-b` is not among the args; else the filter's parameters
    under their configuration keys: each option's value in the args, or
    the configuration's where the args leave it out."""
    if "-b" not in args:
        return {}
    return {key: int(args[args.index(opt) + 1]) if opt in args
            else int(config[key]) for opt, key in FILTER_OPTIONS}


class SketchReads(Job):
    rate_metric = "bases_per_s"

    def setup(self) -> None:
        cfg = self.config
        self.k, self.p = int(cfg["k"]), int(cfg["p"])
        self.dir = tempfile.mkdtemp(prefix="portbench-")
        need = reads.file_bytes(cfg) + (64 << 20)
        free = shutil.disk_usage(self.dir).free
        if free < need:
            raise SystemExit(f"{self.dir}: {free} bytes free, the read set "
                             f"needs {need}")
        self.fastq = os.path.join(self.dir, "reads.fq")
        self.bases = reads.write_fastq(cfg, self.seed, self.fastq)
        os.sync()           # write-back happens now, not in the window
        self.out = os.path.join(self.dir, "out")
        os.mkdir(self.out)
        self.sizes = os.path.join(self.dir, "sizes.tsv")
        args = list(self.traffic["args"])
        self.cm = filter_options(args, cfg)
        if self.cm:
            args += [w for opt, key in FILTER_OPTIONS if opt not in args
                     for w in (opt, str(self.cm[key]))]
        self.argv = (["sketch", "-k", str(self.k), "-S", str(self.p)]
                     + args + ["-P", self.out, self.fastq])
        self.hll = ""
        self.digests: List[str] = []
        self.unit_counts: List[Dict[str, int]] = []
        self.work = {"bases": self.bases, "reads": int(cfg["reads"])}

    def cm_counts(self) -> Dict[str, int]:
        from dashing_tpu_torch import pipeline
        return {name: getattr(pipeline, name) for name in COUNTERS
                if hasattr(pipeline, name)}

    def counters(self) -> Dict[str, int]:
        return {**super().counters(), **self.cm_counts()}

    def run(self) -> int:
        from torch.profiler import record_function
        from dashing_tpu_torch.cli.main import main
        c0 = self.cm_counts()
        with record_function("pb.sketch"):
            rc = main(list(self.argv))
        if rc != 0:
            raise RuntimeError(f"sketch returned {rc}")
        if not self.hll:
            found = [f for f in os.listdir(self.out) if f.endswith(".hll")]
            if len(found) != 1:
                raise RuntimeError(f"sketch wrote {found}, not one .hll")
            self.hll = os.path.join(self.out, found[0])
        with record_function("pb.card"):
            rc = main(["card", "-H", "-o", self.sizes, self.hll])
        if rc != 0:
            raise RuntimeError(f"card returned {rc}")
        c1 = self.cm_counts()
        self.unit_counts.append({name: c1[name] - c0[name] for name in c1})
        return self.bases

    def after(self) -> None:
        h = hashlib.blake2b()
        with gzip.open(self.hll, "rb") as fp:
            h.update(fp.read())
        with open(self.sizes, "rb") as fp:
            h.update(fp.read())
        self.digests.append(h.hexdigest())

    def registers(self, hashes, rows: int):
        """The reference's registers: filtered with `rows` rows where the
        mix filters, else every window's."""
        from portbench.reference import countmin
        cm = self.cm
        if not cm:
            return countmin.plain_registers(hashes, self.p, self.device)
        return countmin.filtered_registers(
            hashes, self.p, rows, cm["cm_size_log2"], cm["cm_seed"],
            cm["min_count"], self.device)

    def check(self, control: bool = False) -> Dict[str, float]:
        import torch
        from portbench.reference import compare, countmin
        from portbench.reference import estimators as est
        rows = self.cm.get("cm_rows", 0)
        hashes = countmin.window_hashes(countmin.read_fastq(self.fastq),
                                        self.k, self.device)
        regs = self.registers(hashes, rows)
        want = est.mle(est.histogram(regs[None], self.p), self.p)
        none = torch.zeros(0, dtype=torch.float64)
        if control:
            got = est.mle(est.histogram(regs[None], self.p, torch.bfloat16),
                          self.p)
            out = {"size_rel_gap": compare.gaps(got, none, want,
                                                none)["size_rel_gap"]}
            if self.cm:
                fewer = self.registers(hashes, rows - 1)
                out["regs_differing"] = int((fewer != regs).sum())
            return out
        twice = countmin.twice_seen(hashes)
        del hashes
        p, got_regs = read_hll(self.hll)
        if p != self.p:
            raise ValueError(f"{self.hll}: p = {p}, not {self.p}")
        got_regs = torch.from_numpy(got_regs.astype(np.int32)).to(
            regs.device)
        sizes = compare.read_sizes(self.sizes)
        if list(sizes) != [self.hll]:
            raise ValueError(f"{self.sizes} names {list(sizes)}")
        got = torch.tensor([sizes[self.hll]], dtype=torch.float64)
        size = float(want[0])
        log(f"read set: {twice} distinct canonical k-mers seen at least "
            f"twice; the sketch's size (float64 MLE) {size:.1f} lies "
            f"{100.0 * (size / max(twice, 1) - 1.0):+.3f} % from it")
        return {"regs_differing": int((got_regs != regs).sum()),
                "size_rel_gap": compare.gaps(got, none, want,
                                             none)["size_rel_gap"],
                "jobs_differing": sum(d != self.digests[-1]
                                      for d in self.digests)}

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


make = SketchReads
