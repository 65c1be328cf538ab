"""The cards of one host (port of dashing_tpu/parallel/mesh.py).

A mesh is a tuple of torch devices, one a card, not a communicator: the
work is handed out in whole units, each computed on one card by the same
kernels as on one card, and merged on the first card.  Register max is
associative and each compare tile's window comes from its own blocks, so
every result is bitwise the one-card result by construction:

  sketch chunks (pipeline.sketch_chunk_stream, the count-min filtered
  pass)        round-robin; each card keeps its own partial (2^p,)
               registers, merged by torch.maximum once, at the end of the
               stream
  small-file batches (cli/core.sketch_jobs)   round-robin, each banked on
               one card
  compare tiles (ops/pairwise)    round-robin, the register bank copied
               once to each card

`union` is not a mesh hook: it folds its files on the host as it reads
them, which a copy to the cards could only slow.

The JAX package splits rows within one chunk or tile instead, because a
jitted step must divide evenly; the power-of-two mesh size and the row
padding that this needs are not ported.

`local_mesh()` takes every visible card when the CLI's device is the bare
`cuda`; a rank under torchrun is given an explicit index
(distributed.rank_device) and so no mesh: one card a rank, or one mesh a
host with one process a host.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Mesh = Tuple[torch.device, ...]

_LOCAL_MESH: Optional[Mesh] = None
_LOCAL_MESH_SET = False


def local_mesh(device: Union[str, torch.device, None] = None
               ) -> Optional[Mesh]:
    """Every visible card, for `device` (default: DASHING_TPU_TORCH_DEVICE,
    unresolved, so the host-only tools never touch a card) when it is the
    bare `cuda`; None with fewer than 2 cards, an explicit device index,
    the CPU, or DASHING_TPU_NO_MESH=1."""
    if _LOCAL_MESH_SET:
        return _LOCAL_MESH
    if os.environ.get("DASHING_TPU_NO_MESH", "") not in ("", "0"):
        return None
    if device is None:
        from ..device import ENV_VAR
        device = os.environ.get(ENV_VAR, "cuda") or "cuda"
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return None
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", i) for i in range(n)) if n > 1 else None


def _set_local_mesh_for_tests(mesh: Optional[Sequence[torch.device]],
                              frozen: bool = True) -> None:
    """Test hook: pin (or, with frozen=False, release) the local mesh."""
    global _LOCAL_MESH, _LOCAL_MESH_SET
    _LOCAL_MESH = None if mesh is None else tuple(mesh)
    _LOCAL_MESH_SET = frozen


def cards(device: torch.device) -> Mesh:
    """The devices a production hook spreads `device`'s work over: the
    local mesh, or `device` alone."""
    return local_mesh(device) or (device,)


def make_mesh(n_devices: int = 0, axes: Tuple[str, ...] = ("d",),
              devices: Optional[Sequence[torch.device]] = None):
    """The first n_devices of `devices` (default: every visible card): a
    1-D tuple, or for two axes a near-square grid, a tuple of rows."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    n = n_devices or len(devs)
    if not 0 < n <= len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axes) == 1:
        return devs[:n]
    rows = next(r for r in range(int(n ** 0.5), 0, -1) if n % r == 0)
    cols = n // rows
    return tuple(devs[i * cols:(i + 1) * cols] for i in range(rows))


def replicate(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """`t` on every card of the mesh (t itself where it already lies)."""
    return tuple(t.to(d) for d in mesh)


def shard_rows(mesh: Mesh, arr) -> Tuple[torch.Tensor, ...]:
    """Contiguous row blocks of `arr` (numpy or torch), one a card, as
    np.array_split cuts them."""
    t = torch.from_numpy(np.ascontiguousarray(arr)) \
        if isinstance(arr, np.ndarray) else arr
    return tuple(block.to(d) for block, d in
                 zip(torch.tensor_split(t, len(mesh)), mesh))


def max_merge(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise max of same-shaped tensors on several cards, on the
    first one's card (a new tensor when there are several)."""
    out = parts[0]
    for t in parts[1:]:
        out = torch.maximum(out, t.to(out.device))
    return out


def sharded_sketch_step(mesh: Mesh, *, k: int, p: int, canon: bool = True):
    """A step (row shards of (rows, C) ASCII tiles, (2^p,) int32 registers)
    -> the registers updated with every shard's contiguous k-mers, on the
    first card: each card encodes its shard (the PyTorch encoders,
    WangHash) into its own copy of the registers, then one max."""
    from ..hashes import wang_hash
    from ..ops.encode import encode_tile
    from ..ops.hll_update import update_registers

    def step(shards: Sequence[torch.Tensor], regs: torch.Tensor):
        parts = []
        for tiles, d in zip(shards, mesh):
            km, valid = encode_tile(tiles.to(d), k=k, w=k,
                                    positions=tuple(range(k)), span=k,
                                    canon=canon)
            parts.append(update_registers(regs.to(d, copy=True),
                                          wang_hash(km), valid, p))
        return max_merge(parts)
    return step


def sharded_pair_tile(mesh, *, p: int, kmax: int, result_type: int,
                      ksinv: float, estim: int, jestim: int, kmin: int = 0):
    """A step (a (na, m), b (nb, m) registers) -> the (na, nb) measure
    matrix on the first card of a 2-D mesh: a's rows split over the grid's
    rows, b's over its columns, and each grid cell's block computed on its
    card by pair_stats -> triples_from_stats -> measure_from_triples (K4's
    X-only form -> K3, or K4's joint form -> K5 under the joint MLE)."""
    from ..ops import pairwise as pw
    from ..sketch import estimators as est
    joint = jestim == est.ERTL_JOINT_MLE

    def step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a8 = a.clamp(max=127).to(torch.int8)
        b8 = b.clamp(max=127).to(torch.int8)
        a_blocks = torch.tensor_split(a8, len(mesh))
        b_blocks = torch.tensor_split(b8, len(mesh[0]))
        rows = []
        for ab, grid_row in zip(a_blocks, mesh):
            cells = []
            for bb, d in zip(b_blocks, grid_row):
                stats = pw.pair_stats(ab.to(d), bb.to(d), kmax, kmin,
                                      joint=joint)
                tri = pw.triples_from_stats(stats, p, estim, jestim, kmin)
                cells.append(pw.measure_from_triples(tri, result_type,
                                                     ksinv).to(mesh[0][0]))
            rows.append(torch.cat(cells, dim=1))
        return torch.cat(rows, dim=0)
    return step


def sharded_union(mesh: Mesh):
    """A step (row shards of (n, m) registers) -> the (m,) union on the
    first card: each card's max over its rows, then one max."""
    def step(shards: Sequence[torch.Tensor]) -> torch.Tensor:
        return max_merge([s.max(dim=0).values for s in shards
                          if s.shape[0]]).to(mesh[0])
    return step
