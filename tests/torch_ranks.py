"""Run batches of the port's CLI as P gloo processes on the CPU, for the
multi-process tests (tests/test_torch_distributed*.py).

Each process runs every case of a batch in order through
`dashing_tpu_torch.cli.main.main`, joining the process group once; a
case's stdout (fd 1, text and binary alike) goes to its own file.  "{P}"
in an argument becomes the process count, so runs at several counts write
different files.  A batch that outlives its timeout FAILS the test: a
deadlock in the distributed path is what these tests exist to catch.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = r"""
import json, os, sys
cases, out_dir = json.loads(sys.argv[1]), sys.argv[2]
rank = int(os.environ.get("RANK", "0"))
from dashing_tpu_torch.cli.main import main
from dashing_tpu_torch.parallel import distributed
fault = os.environ.get("TEST_RANK_FAULT")       # the rank to kill
if fault and int(fault) == rank:
    def faulty(*a, **kw):
        os.kill(os.getpid(), 9)
    distributed.combine_condensed = faulty
for i, (argv, env) in enumerate(cases):
    os.environ.update(env)
    sys.stdout.flush()
    with open(os.path.join(out_dir, f"case{i}.rank{rank}.out"), "wb") as fp:
        saved = os.dup(1)
        os.dup2(fp.fileno(), 1)
        try:
            rc = main(list(argv))
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
    for key in env:
        del os.environ[key]
    if rc:
        sys.exit(f"case {i} returned {rc}")
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_batch(cases, cwd, nprocs, timeout=180, extra_env=None,
              wait_ranks=None, device="cpu"):
    """Run `cases` ([(argv, per-case env)], "{P}" substituted) as
    `nprocs` processes in `cwd`, the process group only when nprocs > 1.
    Returns [per case [(stdout bytes) per rank]] and [(rc, stderr) per
    rank].  With `wait_ranks`, only those ranks must end in time; the
    others are killed then, their rc None.  Every rank runs on `device`."""
    cases = [([a.replace("{P}", str(nprocs)) for a in argv], env)
             for argv, env in cases]
    out_dir = os.path.join(cwd, f"out.p{nprocs}.{free_port()}")
    os.makedirs(out_dir)
    port = free_port()
    procs = []
    for rank in range(nprocs):
        # one thread a rank: several ranks share the test's cores
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   DASHING_TPU_TORCH_DEVICE=device)
        env.pop("DASHING_TPU_DISTRIBUTED", None)
        if nprocs > 1:
            env.update(DASHING_TPU_DISTRIBUTED="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                       RANK=str(rank))
        env.update(extra_env or {})
        err = open(os.path.join(out_dir, f"rank{rank}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _RUNNER, json.dumps(cases), out_dir],
            stdout=subprocess.DEVNULL, stderr=err, cwd=cwd, env=env), err))
    status = []
    try:
        for rank, (p, err) in enumerate(procs):
            if wait_ranks is None or rank in wait_ranks:
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    pytest.fail(f"{nprocs}-process run timed out after "
                                f"{timeout}s (a deadlock in the "
                                "distributed path?)")
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                status.append((None, ""))
            else:
                err.seek(0)
                status.append((p.returncode, err.read()))
            err.close()
    outs = [[open(os.path.join(out_dir, f"case{i}.rank{r}.out"), "rb").read()
             if os.path.exists(os.path.join(out_dir,
                                            f"case{i}.rank{r}.out"))
             else None for r in range(nprocs)] for i in range(len(cases))]
    return outs, status


def assert_ok(status):
    assert all(rc == 0 for rc, _ in status), \
        [(rc, err[-1500:]) for rc, err in status]
