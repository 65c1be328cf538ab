"""The `dist_small` job kind: whole `dist` runs over a large collection of
small genomes (phages.py), every file one chunk, so that the program's
small-file batch engine sketches them and its compare runs a grid of
tiles.

A unit is the `dist` kind's unit (kinds/dist.py): `dashing_tpu_torch dist
-k K -S P <args> -O <out> -o <sizes> <files>` in this process, its work
the files' bases.  Each unit records the program's small-file batch
counter (`small_batches`; absent from a program that lacks it) in
`unit_counts`.  Traced, the CLI's phases run inside the harness's ranges
(`pb.sketch`, `pb.sizes`, `pb.compare`), as the `dist` kind's do.

The check never holds an array over every pair: the reference's
registers (reference/condensed.py, built for many genomes at once from
the files read again) are put once in the order of the job's `.labels`
file, and the matrix is compared a block of rows at a time with the
reference's float64 estimators, keeping the widest gap.  The sizes (the
`-o` file) and `jobs_differing` are checked as the `dist` kind checks
them.  The control streams the same way, with the estimators in
bfloat16.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List

from portbench import phages
from portbench.genomes import write_fasta
from portbench.kinds.dist import Dist

COUNTERS = ("small_batches",)


class DistSmall(Dist):

    def setup(self) -> None:
        k, p = int(self.config["k"]), int(self.config["p"])
        self.k, self.p = k, p
        genomes = phages.make_phages(self.config, self.seed)
        self.dir = tempfile.mkdtemp(prefix="portbench-")
        self.paths = write_fasta(genomes, self.dir)
        os.sync()           # write-back happens now, not in the window
        self.out = os.path.join(self.dir, "dist.bin")
        self.sizes = os.path.join(self.dir, "sizes.tsv")
        self.argv = (["dist", "-k", str(k), "-S", str(p)]
                     + list(self.traffic["args"])
                     + ["-O", self.out, "-o", self.sizes] + self.paths)
        self.bases = sum(g.bases for g in genomes)
        self.digests: List[str] = []
        self.unit_counts: List[Dict[str, int]] = []
        self.work = {"bases": self.bases, "files": len(self.paths)}
        from dashing_tpu_torch import metrics
        if metrics.enabled():       # traced: run.py wraps only `dist` jobs
            from portbench import run
            run._spans()

    def batch_counts(self) -> Dict[str, int]:
        from dashing_tpu_torch import pipeline
        return {name: getattr(pipeline, name) for name in COUNTERS
                if hasattr(pipeline, name)}

    def counters(self) -> Dict[str, int]:
        return {**super().counters(), **self.batch_counts()}

    def run(self) -> int:
        c0 = self.batch_counts()
        done = super().run()
        c1 = self.batch_counts()
        self.unit_counts.append({name: c1[name] - c0[name] for name in c1})
        return done

    def check(self, control: bool = False) -> Dict[str, float]:
        import torch
        from portbench.reference import compare, condensed
        from portbench.reference import estimators as est
        regs = condensed.registers_of_files(self.paths, self.k, self.p,
                                            self.device)
        want = est.mle(est.histogram(regs, self.p), self.p)
        if control:
            got = est.mle(est.histogram(regs, self.p, torch.bfloat16),
                          self.p)
            order = regs
            cond = None
        else:
            sizes = compare.read_sizes(self.sizes)
            if sorted(sizes) != sorted(self.paths):
                raise ValueError("the sizes file does not name every input")
            got = torch.tensor([sizes[x] for x in self.paths],
                               dtype=torch.float64)
            labels = compare.read_labels(self.out + ".labels")
            if sorted(labels) != sorted(self.paths):
                raise ValueError(f"the matrix is labelled with {len(labels)}"
                                 f" names, not the {len(self.paths)} inputs")
            index = {path: i for i, path in enumerate(self.paths)}
            order = regs[torch.tensor([index[x] for x in labels],
                                      device=regs.device)]
            cond = condensed.open_condensed(self.out)
            if cond.size != len(labels) * (len(labels) - 1) // 2:
                raise ValueError(f"{self.out}: {cond.size} entries for "
                                 f"{len(labels)} labels")
        none = torch.zeros(0, dtype=torch.float64)
        out = {"size_rel_gap": compare.gaps(got, none, want,
                                            none)["size_rel_gap"],
               "jaccard_gap": condensed.jaccard_gap(
                   order, self.p, self.k, cond, torch.bfloat16)}
        if not control:
            out["jobs_differing"] = sum(d != self.digests[-1]
                                        for d in self.digests)
        return out


make = DistSmall
