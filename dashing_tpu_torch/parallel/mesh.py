"""The cards of one host (port of dashing_tpu/parallel/mesh.py).

A mesh is a tuple of torch devices, one a card, not a communicator: the
work is handed out in whole units, each computed on one card by the same
kernels as on one card, and merged on the first card.  Register max is
associative and each compare tile's window comes from its own blocks, so
every result is bitwise the one-card result by construction:

  sketch chunks (pipeline.sketch_chunk_stream, the count-min filtered
  passes; both by pipeline._fold_over_cards)   round-robin; each card
               keeps its own partial (2^p,) registers, merged by
               max_merge once, at the end of the stream
  small-file batches (pipeline.sketch_hll_files)   round-robin, each
               banked on one card
  compare tiles (ops/pairwise)    round-robin, the register bank copied
               once to each card (replicate)

`union` is not a mesh hook: it folds its files on the host as it reads
them, which a copy to the cards could only slow.

The JAX package splits rows within one chunk or tile instead
(`sharded_sketch_step`, `sharded_pair_tile`, `sharded_union`), because a
jitted step must divide evenly; those steps, the power-of-two mesh size
and the row padding that they need are not ported.

`local_mesh()` takes every visible card when the CLI's device is the bare
`cuda`; a rank under torchrun is given an explicit index
(distributed.rank_device) and so no mesh: one card a rank, or one mesh a
host with one process a host.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

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


def replicate(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """`t` on every card of the mesh (t itself where it already lies)."""
    return tuple(t.to(d) for d in mesh)


def max_merge(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise max of same-shaped tensors on several cards, on the
    first one's card (a new tensor when there are several)."""
    out = parts[0]
    for t in parts[1:]:
        out = torch.maximum(out, t.to(out.device))
    return out
