"""The port's CLI at P = 3 and 4 gloo processes on the CPU against one
process, byte for byte: the regimes two processes cannot reach, one case
for each such case of tests/test_distributed.py.  With 2-row compare
tiles: 8 genomes over 3 ranks (blocks {0, 4}, {2}, {6}: ragged stripes,
TSV and binary); 4 genomes over 3 ranks (rank 2 owns no block and still
joins every collective); 6 genomes over 4 ranks (more ranks than blocks);
--nearest-neighbors 3 over 8 genomes at P = 3 (ranks 1 and 2 own two
references each, fewer than nn: their candidate lists carry sentinels);
-Q with 7 references at P = 3 (ragged column stripes); gather chunks of a
few floats (DASHING_TPU_GATHER_CHUNK_MB=0.00002) for the condensed and the
column merges.  Then the fault: a rank killed before a merge, and the others exit
non-zero within the test's timeout."""
import numpy as np
import pytest

from test_torch_distributed_cli import TILE_ENV, unzipped, write_genomes
from torch_ranks import assert_ok, run_batch

TINY = {"DASHING_TPU_GATHER_CHUNK_MB": "0.00002"}


def _cases(names):
    dist = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"]
    return {
        "ragged": (dist + names, {}),
        "ragged_bin": (dist + ["-b", "-O", "r{P}.bin"] + names, {}),
        "zero_blocks": (dist + names[:4], {}),
        "zero_blocks_bin": (dist + ["-b", "-O", "z{P}.bin"] + names[:4], {}),
        "nn_below_nn": (dist + ["--nearest-neighbors", "3"] + names, {}),
        "rect_ragged": (dist + ["-Q", "q3.txt"] + names[:7], {}),
        "tiny_chunks": (dist + names, TINY),
        "tiny_chunks_rect": (dist + ["-Q", "q3.txt"] + names[:7], TINY),
        "host_ragged_bin": (dist + ["-8", "-b", "-O", "h{P}.bin"] + names,
                            {}),
        "more_ranks": (dist + names[:6], {}),
    }


FILES = {"ragged_bin": "r{P}.bin", "zero_blocks_bin": "z{P}.bin",
         "host_ragged_bin": "h{P}.bin"}
P4 = ("more_ranks", "zero_blocks", "zero_blocks_bin")


@pytest.fixture(scope="module")
def genomes8(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_p3")
    names = write_genomes(root, np.random.default_rng(31),
                          (0.0, 0.005, 0.01, 0.02, 0.03, 0.04, 0.06, 0.08),
                          length=5000)
    (root / "q3.txt").write_text("\n".join(names[:2]) + "\n")
    return root, names


@pytest.fixture(scope="module")
def runs(genomes8):
    root, names = genomes8
    cases = _cases(names)
    keys = list(cases)
    out = {}
    for nprocs, which in ((1, keys), (3, keys), (4, P4)):
        got, status = run_batch([cases[k] for k in which], str(root),
                                nprocs, extra_env=TILE_ENV)
        assert_ok(status)
        out[nprocs] = dict(zip(which, got))
    return root, out


@pytest.mark.parametrize("nprocs,case", [(3, c) for c in _cases(
    [f"s{i}.fa" for i in range(8)])] + [(4, c) for c in P4])
def test_ranks_match_one_process(runs, nprocs, case):
    root, out = runs
    assert out[nprocs][case][0] == out[1][case][0], case
    assert all(o == b"" for o in out[nprocs][case][1:]), case
    if case in FILES:
        f = FILES[case]
        assert (unzipped(root / f.replace("{P}", "1"))
                == unzipped(root / f.replace("{P}", str(nprocs))))
    if case.startswith("nn"):
        # after the sizes, 3 neighbours a row, each id:value
        text = out[1][case][0].decode()
        rows = text[text.index("#File"):].splitlines()[1:]
        assert len(rows) == 8 and all(r.count(":") == 3 for r in rows)


def test_killed_rank_fails_the_others(genomes8):
    """Rank 1 dies (SIGKILL) as the condensed merge begins: ranks 0 and 2
    stop with an error (a closed connection) instead of waiting or
    carrying on as fewer processes."""
    root, names = genomes8
    env = dict(TILE_ENV, TEST_RANK_FAULT="1")
    _, status = run_batch([(["dist", "-k", "17", "-S", "12",
                             "--avoid-sorting"] + names, {})], str(root), 3,
                          timeout=60, extra_env=env, wait_ranks=(0, 2))
    for rank in (0, 2):
        rc, err = status[rank]
        assert rc not in (0, None), err[-800:]
        assert "Traceback" in err or "Error" in err, err[-800:]
