"""Multi-process runs (port of dashing_tpu/parallel/distributed.py).

One process a card (or a host): `maybe_initialize()` joins the process
group that torch's standard variables describe, the sketch phase splits the
genome list across processes and merges the registers with one max
all-reduce, and the compare phase splits tile-row blocks across processes
and lands them on rank 0.

    DASHING_TPU_DISTRIBUTED=1 torchrun --nproc-per-node N \
        -m dashing_tpu_torch.cli dist ...

or, on several hosts, MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK set by
hand for each process.  Every collective takes and returns numpy arrays on
the host, so the process group is gloo over CPU tensors: the registers are
pulled to the host before the merge, as in the JAX package, and several
ranks may share one card (NCCL refuses that).  Without the process group
every function is the single-process identity, so one code path serves one
process and many.  Under DASHING_TPU_METRICS=1 the buckets
`dist.register_max`, `dist.gather` (each with the bytes this rank sent)
and `dist.barrier` hold each rank's seconds in the collectives.  A
failed init, a dead rank or a collective past the process group's timeout
(gloo's default) raises on every rank: a run never carries on as a single
process.

Within one process, the cards of a host are parallel/mesh.py's.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from .. import metrics

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def maybe_initialize() -> bool:
    """Join the gloo process group when DASHING_TPU_DISTRIBUTED is set
    (idempotent); stop naming any of torch's variables that is missing."""
    if os.environ.get("DASHING_TPU_DISTRIBUTED", "") in ("", "0"):
        return False
    if _initialized():
        return True
    missing = [v for v in _ENV if not os.environ.get(v)]
    if missing:
        raise SystemExit(
            f"DASHING_TPU_DISTRIBUTED: {', '.join(missing)} not set (torchrun "
            "sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    return True


def process_index() -> int:
    if not _initialized():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if not _initialized():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def is_main() -> bool:
    return process_index() == 0


def rank_device(device: torch.device) -> torch.device:
    """A rank's card: under the process group, the bare `cuda` with
    LOCAL_RANK set (torchrun) becomes cuda:{LOCAL_RANK % cards}; an
    explicit index or the CPU is honoured as given."""
    if (process_count() > 1 and device.type == "cuda"
            and device.index is None and os.environ.get("LOCAL_RANK")):
        return torch.device(
            "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return device


def my_shard(items: Sequence, strided: bool = True) -> List:
    """This process's share of a work list.

    Strided keeps the size-descending balance of sort_paths_by_fsize:
    after the one global sort, process i takes items i, i+P, i+2P, ..."""
    p, n = process_index(), process_count()
    if n == 1:
        return list(items)
    if strided:
        return list(items[p::n])
    chunk = -(-len(items) // n)
    return list(items[p * chunk:(p + 1) * chunk])


def global_register_max(regs: np.ndarray) -> np.ndarray:
    """Every process's registers merged by one max all-reduce (a copy;
    the JAX package's allgather-then-max)."""
    if process_count() == 1:
        return regs
    import torch.distributed as dist
    t = torch.from_numpy(np.array(regs, copy=True))
    with metrics.accum("dist.register_max", items=regs.nbytes):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.numpy()


# ---------------------------------------------------------------------------
# The sharded compare phase: every process has every sketch (the register
# max above); tile-row blocks are split across processes (strided, so the
# shrinking upper-triangle rows balance), and the results land by
# rank-local mmap stripe writes into one shared file (binary) or by a
# gather of the stripes to rank 0 (TSV and the others).
# ---------------------------------------------------------------------------


def barrier(name: str = "dashing_tpu_barrier") -> None:
    """Cross-process sync point (around the shared-file mmap stripes).
    `name` documents the call site."""
    if process_count() == 1:
        return
    import torch.distributed as dist
    with metrics.accum("dist.barrier"):
        dist.barrier()


def allgather_np(arr: np.ndarray) -> np.ndarray:
    """(P, *arr.shape) stack of every process's same-shaped array.  gloo
    carries 64-bit types as they are; uint64 travels as its int64 view."""
    if process_count() == 1:
        return np.ascontiguousarray(arr)[None]
    if arr.dtype == np.uint64:
        return allgather_np(arr.view(np.int64)).view(np.uint64)
    import torch.distributed as dist
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    out = [torch.empty_like(t) for _ in range(process_count())]
    with metrics.accum("dist.gather", items=arr.nbytes):
        dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])


def owned_blocks(rank: int, nprocs: int, n: int, tile: int) -> List[int]:
    """Tile-row starts owned by `rank`: the one definition of stripe
    ownership, which owned_tile_rows (compute side) and the combine_*
    merges both call.  Strided: row block i0 carries ~(n - i0) columns of
    upper-triangle work, so round-robin keeps every process within one
    block of even."""
    return list(range(0, n, tile))[rank::nprocs]


def owned_tile_rows(n: int, tile: int) -> List[int]:
    """This process's share of tile-row starts (see owned_blocks)."""
    return owned_blocks(process_index(), process_count(), n, tile)


def _condensed_row_start(i: int, n: int) -> int:
    return (i * (2 * n - i - 1)) // 2


def condensed_stripe(i0: int, n: int, tile: int) -> slice:
    """Condensed index range of tile-row block i0: rows [i0, min(i0 +
    tile, n)) pack contiguously, so the blocks' ranges are disjoint."""
    hi = min(i0 + tile, n)
    return slice(_condensed_row_start(i0, n), _condensed_row_start(hi, n))


def _gather_chunk(itemsize: int) -> int:
    """Elements a rank sends per gather step: DASHING_TPU_GATHER_CHUNK_MB
    (default 64) megabytes."""
    return max(1, int(float(os.environ.get(
        "DASHING_TPU_GATHER_CHUNK_MB", "64")) * 1e6) // max(itemsize, 1))


def combine_condensed(local: np.ndarray, n: int, tile: int) -> np.ndarray:
    """Every process's condensed stripes merged into the full vector.

    Every process passes its locally filled vector (entries outside its
    blocks are ignored); ownership is recomputed on every rank, so no
    index is exchanged.  Each rank packs only its own stripes into one
    payload, and the payloads are gathered in chunks of
    DASHING_TPU_GATHER_CHUNK_MB per rank, so the transient is P chunks
    whatever n is; every rank makes the same number of collectives."""
    p = process_count()
    if p == 1:
        return local
    slices = {r: [condensed_stripe(i0, n, tile)
                  for i0 in owned_blocks(r, p, n, tile)]
              for r in range(p)}
    maxlen = max(sum(s.stop - s.start for s in ss) for ss in slices.values())
    payload = np.zeros(maxlen, local.dtype)
    off = 0
    for s in slices[process_index()]:
        payload[off:off + s.stop - s.start] = local[s]
        off += s.stop - s.start
    chunk = _gather_chunk(local.dtype.itemsize)
    out = np.empty_like(local)
    for start in range(0, maxlen, chunk):
        piece = allgather_np(payload[start:start + chunk])   # (P, c)
        c = piece.shape[1]
        for r in range(p):
            off_r = 0
            for s in slices[r]:
                ln = s.stop - s.start
                a, b = max(off_r, start), min(off_r + ln, start + c)
                if a < b:
                    out[s.start + a - off_r:s.start + b - off_r] = \
                        piece[r, a - start:b - start]
                off_r += ln
    return out


def combine_columns(local: np.ndarray, nr: int, tile: int) -> np.ndarray:
    """Every process's column stripes of an (nq, nr, ...) rectangle merged
    (-Q: reference tile columns are split; trailing dims ride along, as
    panel's (nq, nr, 3) triples).  One owned block per rank a round, so
    the transient is (P, nq, tile); a rank with fewer blocks sends zeros
    in the rounds it lacks, so every rank makes the same collectives."""
    p = process_count()
    if p == 1:
        return local
    nq = local.shape[0]
    blocks = {r: owned_blocks(r, p, nr, tile) for r in range(p)}
    rounds = max(len(b) for b in blocks.values())
    mine = blocks[process_index()]
    out = np.empty_like(local)
    buf = np.zeros((nq, tile) + local.shape[2:], local.dtype)
    for j in range(rounds):
        buf[:] = 0
        if j < len(mine):
            i0 = mine[j]
            w = min(i0 + tile, nr) - i0
            buf[:, :w] = local[:, i0:i0 + w]
        piece = allgather_np(buf)        # (P, nq, tile, ...)
        for r in range(p):
            if j < len(blocks[r]):
                i0 = blocks[r][j]
                w = min(i0 + tile, nr) - i0
                out[:, i0:i0 + w] = piece[r, :, :w]
    return out


def combine_nn(vals: np.ndarray, order: np.ndarray, nn: int, sim: bool):
    """Every process's k-NN candidates merged: one (P, nq, nn) gather of
    (values, global reference ids), then the best nn of the P * nn per
    query.  Sentinels (id -1, the worst value) of a process owning fewer
    than nn references sort last.  Equal values order by ascending
    reference id, the single-process rule, so the merge is byte-identical
    to one process."""
    if process_count() == 1:
        return vals, order
    gv = allgather_np(vals.astype(np.float32, copy=False))
    gi = allgather_np(order.astype(np.int64, copy=False))
    nq = vals.shape[0]
    cv = gv.transpose(1, 0, 2).reshape(nq, -1)
    ci = gi.transpose(1, 0, 2).reshape(nq, -1)
    worst = np.float32(-np.inf if sim else np.inf)
    cv = np.where(ci < 0, worst, cv)
    sort_idx = np.lexsort((np.where(ci < 0, np.int64(2 ** 62), ci),
                           -cv if sim else cv), axis=1)[:, :nn]
    return (np.take_along_axis(cv, sort_idx, 1),
            np.take_along_axis(ci, sort_idx, 1))
