"""The multi-process run and the mesh on the card.  Two ranks sharing
cuda:0 (gloo) write a `dist -M -b -O` matrix byte-identical to one
process's; every kernel wrapper launches through ops/_build.launch with
its tensors' card as the current device; the mesh pinned to (cuda:0,
cuda:0) compares bit for bit as one card.  What the launch helper does
on a second card is not checked here: these run on one card.  Marked
`cuda`: they skip without a card.  Run them on one:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import _build, pairwise as pw
from dashing_tpu_torch.parallel import mesh as tmesh
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch.hll import HLL

from test_torch_distributed_cli import write_genomes
from torch_ranks import assert_ok, run_batch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def test_two_ranks_share_one_card(cuda, tmp_path):
    names = write_genomes(tmp_path, np.random.default_rng(3),
                          (0.0, 0.01, 0.02, 0.04, 0.06), length=40_000)
    case = [(["dist", "-k", "21", "-S", "14", "-M", "-b", "-O", "m{P}.bin",
              "--avoid-sorting"] + names, {})]
    env = {"DASHING_TPU_COMPARE_TILE": "2"}
    for nprocs in (1, 2):
        _, status = run_batch(case, str(tmp_path), nprocs, timeout=300,
                              extra_env=env, device="cuda:0")
        assert_ok(status)
    assert (tmp_path / "m1.bin").read_bytes() == \
        (tmp_path / "m2.bin").read_bytes()


def test_launches_run_on_their_card(cuda, monkeypatch):
    seen = []
    orig = _build.launch

    def spy(lib, entry, device, *args):
        assert torch.device(device).index == 0
        seen.append(entry)
        return orig(lib, entry, device, *args)
    monkeypatch.setattr(_build, "launch", spy)
    rng = np.random.default_rng(1)
    tile = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(8, 4096))
    params = pipeline.SketchParams(k=21)
    regs = pipeline.sketch_chunk_stream([tile], params, 12, cuda, True)
    pipeline.sketch_chunk_stream([tile], pipeline.SketchParams(k=21, w=25),
                                 12, cuda, False)
    pipeline.sketch_small_batch_async([tile[:4], tile[4:]], params, 12, cuda,
                                      True)
    hlls = [HLL(12, regs=pipeline.registers_to_numpy(regs))] * 3
    for jestim in (est.ERTL_MLE, est.ERTL_JOINT_MLE):
        pw.all_pairs_condensed(hlls, pw.JI, 21, est.ERTL_MLE, jestim, cuda)
    torch.cuda.synchronize()
    assert {"dtt_encode_hash_regs", "dtt_encode_hash_banks",
            "dtt_cum_union", "dtt_union_triples", "dtt_estimate_rows",
            "dtt_joint_pair_stats", "dtt_joint_mle"} <= set(seen)


def test_mesh_of_one_card_twice(cuda):
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 2 ** 62, 20000, dtype=np.uint64)
    hlls = []
    for i in range(7):
        h = HLL(12)
        h.addh_np(np.concatenate([shared, rng.integers(
            0, 2 ** 62, 500 * i, dtype=np.uint64)]))
        hlls.append(h)
    for jestim in (est.ERTL_MLE, est.ERTL_JOINT_MLE):
        off = pw.all_pairs_condensed(hlls, pw.MASH_DIST, 21, est.ERTL_MLE,
                                     jestim, cuda, tile=2)
        tmesh._set_local_mesh_for_tests((cuda, cuda))
        try:
            on = pw.all_pairs_condensed(hlls, pw.MASH_DIST, 21, est.ERTL_MLE,
                                        jestim, cuda, tile=2)
        finally:
            tmesh._set_local_mesh_for_tests(None, frozen=False)
        np.testing.assert_array_equal(on, off)
