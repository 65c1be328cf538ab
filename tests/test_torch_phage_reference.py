"""The port's all-vs-all `dist` over a small collection of phage-sized
genomes against the benchmark's plain reference (portbench/reference) on
the CPU: 200 one-record genomes of 2-40 kbp from portbench/phages.py, so
that every file takes the small-file batch and the batches of 64 end in a
partial one; the compare in tiles of 64 rows, so that its grid has
off-diagonal and partial tiles.  The registers of the engine `dist` calls
(`pipeline.sketch_hll_files`) equal the reference's bit for bit; the
`-o` sizes and the Jaccard index each `-b` distance stands for lie within
the benchmark cell's limits of the float64 reference; the job folds
ceil(files / 64) small-file batches."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from portbench import genomes as gen, phages
from portbench.reference import compare

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P, TILE = 21, 12, 64
CONFIG = {"collection": {"genomes": 200, "ancestors": 50,
                         "rates": [0.001, 0.01, 0.03, 0.08],
                         "length_median": 12000, "length_sigma": 0.6,
                         "length_min": 2000, "length_max": 40000}}
LIMITS = json.load(open(os.path.join(ROOT, "portbench", "limits",
                                     "phage16k.dist_small.json")))

DIST = """
import json, sys
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli.main import main
before = pipeline.small_batches
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "small_batches": pipeline.small_batches
                  - before}))
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The collection as FASTA files, the reference's registers, and the
    outputs of one `dist -M -b` run in a fresh process."""
    root = tmp_path_factory.mktemp("phages")
    paths = gen.write_fasta(phages.make_phages(CONFIG, 2**33 + 77),
                            str(root))
    out, sizes = str(root / "d.bin"), str(root / "sizes.tsv")
    env = dict(os.environ, DASHING_TPU_TORCH_DEVICE="cpu",
               DASHING_TPU_COMPARE_TILE=str(TILE), OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", DIST, "dist", "-k", str(K), "-S", str(P),
         "-M", "-b", "-O", out, "-o", sizes] + paths,
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    ran = json.loads(res.stdout.strip().splitlines()[-1])
    regs = compare.registers_of_files(paths, K, P, 0, CPU)
    return paths, out, sizes, ran, regs


def test_collection_shape(job):
    paths, *_ = job
    rows = [pipeline.joined_rows(os.path.getsize(x)) for x in paths]
    assert len(paths) == 200 and max(rows) <= pipeline.MAX_ROWS
    assert len(paths) % pipeline.small_batch_size(P) != 0
    assert len(paths) > 2 * TILE and len(paths) % TILE != 0


def test_engine_registers_equal_reference(job):
    paths, *_, regs = job
    got = {}
    before = pipeline.small_batches
    pipeline.sketch_hll_files(list(enumerate(paths)),
                              pipeline.SketchParams(k=K), P, CPU,
                              land=got.__setitem__)
    assert pipeline.small_batches - before == -(-len(paths) // 64)
    assert sorted(got) == list(range(len(paths)))
    want = regs.numpy().astype(np.uint8)
    for i in range(len(paths)):
        np.testing.assert_array_equal(got[i], want[i], err_msg=paths[i])


def test_dist_within_cell_limits(job):
    paths, out, sizes, ran, regs = job
    assert ran["rc"] == 0
    want_sizes, want_ji = compare.expected(regs, P, False)
    got_sizes, got_ji = compare.read_outputs(paths, out, sizes, K)
    gaps = compare.gaps(got_sizes, got_ji, want_sizes, want_ji)
    assert gaps["size_rel_gap"] <= LIMITS["size_rel_gap"], gaps
    assert gaps["jaccard_gap"] <= LIMITS["jaccard_gap"], gaps
    # the families' copies are near, other pairs near-disjoint
    assert float(want_ji.max()) > 0.5 and float(want_ji.median()) < 0.01


def test_dist_folds_one_batch_a_64_files(job):
    paths, _, _, ran, _ = job
    assert ran["small_batches"] == -(-len(paths) // 64) == 4
