"""dashing_tpu_torch.parallel.distributed against the JAX package's
module: the stripe ownership (owned_blocks, condensed_stripe) equal over
a grid of (P, n, tile) and partitioning every regime exactly; the
collectives at P = 2 over gloo (64-bit payloads kept whole, the uint8
register max); the launch variables (a missing one stops the run naming
it; a process group that cannot form stops it with an error); a rank's
card; and that every kernel launch of the port goes through
ops/_build.launch, which makes the tensors' card the current device."""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dashing_tpu.parallel import distributed as jdist
from dashing_tpu_torch.parallel import distributed as tdist

from torch_ranks import REPO, free_port

GRID_N = (1, 2, 5, 7, 16, 33, 100)
GRID_TILE = (1, 2, 3, 8, 64)
GRID_P = (1, 2, 3, 4, 5, 7)


@pytest.mark.parametrize("n", GRID_N)
def test_owned_blocks_equal_jax_and_partition(n):
    for tile in GRID_TILE:
        want = list(range(0, n, tile))
        for p in GRID_P:
            got = []
            for rank in range(p):
                blocks = tdist.owned_blocks(rank, p, n, tile)
                assert blocks == jdist.owned_blocks(rank, p, n, tile)
                assert len(set(blocks)) == len(blocks)
                got += blocks
            assert sorted(got) == want, (n, tile, p)


@pytest.mark.parametrize("n", GRID_N)
def test_condensed_stripes_equal_jax_and_tile_the_vector(n):
    for tile in GRID_TILE:
        stripes = [tdist.condensed_stripe(i0, n, tile)
                   for i0 in range(0, n, tile)]
        assert stripes == [jdist.condensed_stripe(i0, n, tile)
                           for i0 in range(0, n, tile)]
        covered = np.concatenate([np.arange(s.start, s.stop)
                                  for s in stripes] or [np.zeros(0, int)])
        np.testing.assert_array_equal(covered, np.arange(n * (n - 1) // 2))


def test_one_process_is_the_identity():
    """Without a process group every helper is the single-process one."""
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.is_main()
    items = list(range(7))
    assert tdist.my_shard(items) == items
    assert tdist.my_shard(items, strided=False) == items
    regs = np.arange(12, dtype=np.uint8)
    assert tdist.global_register_max(regs) is regs
    cond = np.arange(10, dtype=np.float32)
    assert tdist.combine_condensed(cond, 5, 2) is cond
    assert tdist.combine_columns(cond.reshape(2, 5), 5, 2).shape == (2, 5)
    v, i = np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64)
    assert tdist.combine_nn(v, i, 3, True)[0] is v
    tdist.barrier()
    assert tdist.maybe_initialize() is False


_COLLECTIVES = r"""
import os, sys
import numpy as np
from dashing_tpu_torch.parallel import distributed as d
assert d.maybe_initialize() and d.maybe_initialize()     # idempotent
r, p = d.process_index(), d.process_count()
assert p == 2
big = np.array([-(2 ** 62) - r, 2 ** 62 + 7 * r], np.int64)
got = d.allgather_np(big)
assert got.dtype == np.int64 and got.tolist() == [[-(2 ** 62), 2 ** 62],
                                                  [-(2 ** 62) - 1, 2 ** 62 + 7]]
u = np.array([2 ** 64 - 1 - r], np.uint64)
assert d.allgather_np(u)[:, 0].tolist() == [2 ** 64 - 1, 2 ** 64 - 2]
f = np.array([1e300 * (r + 1)], np.float64)
assert d.allgather_np(f)[:, 0].tolist() == [1e300, 2e300]
regs = np.zeros((3, 8), np.uint8)
regs[r] = np.arange(8) + 10 * r
regs[2, r] = 200 + r
m = d.global_register_max(regs)
assert m.dtype == np.uint8 and m[0].tolist() == list(range(8))
assert m[1].tolist() == list(range(10, 18)) and m[2, :2].tolist() == [200, 201]
assert d.my_shard(list(range(5))) == [[0, 2, 4], [1, 3]][r]
assert d.my_shard(list(range(5)), strided=False) == [[0, 1, 2], [3, 4]][r]
d.barrier()
print("OK", r)
"""


def _procs(nprocs, env_of, code, timeout=60):
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], env=env_of(r), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"the processes did not end within {timeout}s")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _env(rank, world, port, **extra):
    env = dict(os.environ, PYTHONPATH=REPO, DASHING_TPU_DISTRIBUTED="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank))
    env.update(extra)
    return env


def test_collectives_keep_64_bits_and_max_registers():
    port = free_port()
    outs = _procs(2, lambda r: _env(r, 2, port), _COLLECTIVES)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-1500:]
        assert out.strip() == f"OK {rank}"


@pytest.mark.parametrize("missing", ["MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK"])
def test_missing_launch_variable_is_named(monkeypatch, missing):
    monkeypatch.setenv("DASHING_TPU_DISTRIBUTED", "1")
    for var, val in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500"),
                     ("WORLD_SIZE", "2"), ("RANK", "0")):
        monkeypatch.setenv(var, val)
    monkeypatch.delenv(missing)
    with pytest.raises(SystemExit) as e:
        tdist.maybe_initialize()
    assert missing in str(e.value.code)
    assert tdist.process_count() == 1      # nothing was joined


def test_group_that_cannot_form_stops_the_run(tmp_path):
    """Rank 0 of 2 whose rendezvous port is taken: init_process_group
    fails and the CLI exits non-zero; it does not run as one process."""
    (tmp_path / "a.fa").write_text(">a\nACGTACGTTTGACCA\n")
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        env = _env(0, 2, busy.getsockname()[1],
                   DASHING_TPU_TORCH_DEVICE="cpu")
        res = subprocess.run([sys.executable, "-m", "dashing_tpu_torch.cli",
                              "dist", "-k", "5", "a.fa", "a.fa"],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=90)
    assert res.returncode != 0
    assert "##Names" not in res.stdout and "#Path" not in res.stdout


def test_rank_device(monkeypatch):
    cpu = torch.device("cpu")
    assert tdist.rank_device(cpu) == cpu
    monkeypatch.setattr(tdist, "process_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.rank_device(torch.device("cuda")) == torch.device("cuda", 1)
    assert tdist.rank_device(torch.device("cuda", 3)) == torch.device("cuda",
                                                                     3)
    assert tdist.rank_device(cpu) == cpu
    monkeypatch.delenv("LOCAL_RANK")
    assert tdist.rank_device(torch.device("cuda")) == torch.device("cuda")


# C entry points that launch nothing (sizes, geometry, messages); the
# banked geometry reads the current device, which its caller sets
_HOST_ENTRIES = {"dtt_joint_plane_words", "dtt_encode_hash_geometry",
                 "dtt_banks_geometry", "dtt_minimizer_geometry",
                 "dtt_error_string"}


def test_every_kernel_launch_goes_through_build_launch():
    """Each `dtt_` entry point of ops/*.py is called only by name through
    _build.launch (or is a host-only query), and _build.launch enters
    torch.cuda.device(device) around the call."""
    ops = os.path.join(REPO, "dashing_tpu_torch", "ops")
    launched = set()
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py") or name == "_build.py":
            continue
        src = open(os.path.join(ops, name)).read()
        direct = set(re.findall(r"\.(dtt_\w+)\(", src)) - _HOST_ENTRIES
        assert not direct, (name, direct)
        launched |= set(re.findall(r"_build\.launch\([^\"]*\"(dtt_\w+)\"",
                                   src, re.S))
        launched |= set(re.findall(r"\"(dtt_\w+)\" if joint else "
                                   r"\"(dtt_\w+)\"", src)[0]
                        if "if joint else" in src else ())
    assert launched == {
        "dtt_encode_hash_regs", "dtt_ascii_hash_keys", "dtt_ascii_hash_regs",
        "dtt_encode_hash_banks", "dtt_ascii_hash_banks", "dtt_union_triples",
        "dtt_estimate_rows", "dtt_joint_mle", "dtt_joint_pair_stats",
        "dtt_cum_union", "dtt_minimizer_regs", "dtt_cm_add", "dtt_cm_admit"}
    build = open(os.path.join(ops, "_build.py")).read()
    body = build[build.index("def launch("):build.index("def check(")]
    assert "with torch.cuda.device(device):" in body
