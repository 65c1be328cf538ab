"""The `dist` job kind: whole `dist` runs over a genome collection.

Set-up writes the collection (genomes.py) once as FASTA files under
$TMPDIR; a unit is one `dashing_tpu_torch dist -k K -S P <args> -O <out>
-o <sizes> <files>` run in this process, the mix's `args` between.  Its
work is the files' bases.  The check reads the `-o` sizes and the `-b`
matrix of the last unit and works both out again with the plain
reference; `-J` among the args selects the joint MLE there, and the
mix's `window` the minimizer window of `-w`.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from typing import Dict, List

from portbench import genomes as gen
from portbench.jobs import Job


class Dist(Job):
    rate_metric = "bases_per_s"

    def setup(self) -> None:
        k, p = int(self.config["k"]), int(self.config["p"])
        self.k, self.p = k, p
        self.genomes = gen.make_genomes(self.config, self.seed)
        self.dir = tempfile.mkdtemp(prefix="portbench-")
        self.paths = gen.write_fasta(self.genomes, self.dir)
        os.sync()           # write-back happens now, not in the window
        self.out = os.path.join(self.dir, "dist.bin")
        self.sizes = os.path.join(self.dir, "sizes.tsv")
        self.argv = (["dist", "-k", str(k), "-S", str(p)]
                     + list(self.traffic["args"])
                     + ["-O", self.out, "-o", self.sizes] + self.paths)
        self.bases = sum(g.bases for g in self.genomes)
        self.digests: List[str] = []
        self.work = {"bases": self.bases, "files": len(self.paths)}

    def run(self) -> int:
        from dashing_tpu_torch.cli.main import main
        rc = main(list(self.argv))
        if rc != 0:
            raise RuntimeError(f"dist returned {rc}")
        return self.bases

    def after(self) -> None:
        h = hashlib.blake2b()
        for path in (self.out, self.out + ".labels", self.sizes):
            with open(path, "rb") as fp:
                h.update(fp.read())
        self.digests.append(h.hexdigest())

    def check(self, control: bool = False) -> Dict[str, float]:
        import torch
        from portbench.reference import compare
        joint = "-J" in self.traffic["args"]
        window = int(self.traffic.get("window", 0))
        regs = compare.registers_of_files(self.paths, self.k, self.p, window,
                                          self.device)
        want_sizes, want_ji = compare.expected(regs, self.p, joint)
        if control:
            got_sizes, got_ji = compare.expected(regs, self.p, joint,
                                                 torch.bfloat16)
        else:
            got_sizes, got_ji = compare.read_outputs(
                self.paths, self.out, self.sizes, self.k)
        out = compare.gaps(got_sizes, got_ji, want_sizes, want_ji)
        if not control:
            out["jobs_differing"] = sum(d != self.digests[-1]
                                        for d in self.digests)
        return out

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


make = Dist
