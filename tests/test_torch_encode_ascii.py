"""Kernel K2 on raw ASCII tiles: the port's plain versions (PyTorch on the
CPU) against the JAX package, bitwise.

`encode_hash_keys` is held to the TPU kernel itself, run as
tests/test_pallas.py runs it (interpret mode), on tiles with N runs,
lowercase, IUPAC bytes, 0x00 separators and bytes >= 0x80 (whose bit 7
survives the case mask).  `ascii_to_registers` is held to the register
update the JAX package makes from those keys, and to the port's packed
route (K1) on the same tile.  The CUDA kernel runs only on a card: the
smoke script and tests/test_torch_cuda_kernels.py hold it to these plain
versions there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.ops.hll_update import update_from_idx_rank
from dashing_tpu.ops.pallas_encode import (encode_hash_keys,
                                           keys_to_update_inputs)
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import encode_hash as eh

torch.set_num_threads(1)

ALPHABET = np.frombuffer(b"ACGTacgtNnRY\x00\xc1\xe3\x80", np.uint8)
PROBS = [0.165] * 4 + [0.04] * 4 + [0.0225] * 8


def _tile(rng, R=8, C=300):
    """ASCII tile: any width (no multiple of 8 needed), an N run, one row
    of valid lowercase bases, IUPAC codes, separators and high bytes; the
    bytes 0xC1 and 0xE3 are 'A' and 'C' with bit 7 set."""
    tile = rng.choice(ALPHABET, size=(R, C), p=PROBS)
    tile[0, 10:70] = ord("N")
    tile[1] = rng.choice(np.frombuffer(b"acgt", np.uint8), size=C)
    return tile


@pytest.mark.parametrize("k,p", [(1, 2), (15, 10), (21, 16), (31, 14),
                                 (32, 25)])
@pytest.mark.parametrize("canon", [True, False])
def test_keys_match_jax_kernel(rng, k, p, canon):
    tile = _tile(rng, C=301)
    want = np.asarray(encode_hash_keys(jnp.asarray(tile), k=k, p=p,
                                       canon=canon, interpret=True))
    got = eh.encode_hash_keys(torch.from_numpy(tile), k=k, p=p,
                              canon=canon).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (8, 302 - k)
    assert ((want & 63) == 0).any() and (want & 63).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,p", [(21, 10), (31, 14), (32, 25)])
def test_ascii_registers_match_jax_and_packed(rng, k, p):
    """Fused K2 registers = the JAX update from the TPU kernel's keys = K1
    on the packed form of the same tile (padded to a multiple of 8 with N,
    as the pipeline pads)."""
    tile = _tile(rng, R=16, C=517)
    keys = encode_hash_keys(jnp.asarray(tile), k=k, p=p, interpret=True)
    idx, rank = keys_to_update_inputs(keys)
    want = np.asarray(update_from_idx_rank(jnp.zeros(1 << p, jnp.int32),
                                           idx, rank))
    regs = torch.zeros(1 << p, dtype=torch.int32)
    out = eh.ascii_to_registers(torch.from_numpy(tile), regs, k=k, p=p)
    assert out is regs and int((want > 0).sum()) > 0
    np.testing.assert_array_equal(regs.numpy(), want)
    packed, vbits = pipeline._pack_tile_host(pipeline._pad8(tile))
    k1 = torch.zeros_like(regs)
    eh.packed_to_registers(torch.from_numpy(packed), torch.from_numpy(vbits),
                           k1, k=k, p=p)
    np.testing.assert_array_equal(k1.numpy(), want)


def test_ascii_registers_accumulate(rng):
    """Registers fold chunk after chunk in place, odd row counts and
    widths included, equal to K1's plain version chunk for chunk."""
    tiles = [_tile(rng, R=3, C=96) for _ in range(3)]
    p = 12
    regs = torch.zeros(1 << p, dtype=torch.int32)
    want = torch.zeros_like(regs)
    for t in tiles:
        eh.ascii_to_registers(torch.from_numpy(t), regs, k=17, p=p)
        packed, vbits = pipeline._pack_tile_host(t)
        eh.packed_to_registers_plain(torch.from_numpy(packed),
                                     torch.from_numpy(vbits), want, k=17,
                                     p=p, canon=True)
    assert int((want > 0).sum()) > 100
    assert torch.equal(regs, want)


def test_k2_guards():
    t = torch.zeros((2, 40), dtype=torch.uint8)
    regs = torch.zeros(1 << 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        eh.encode_hash_keys(t, k=5, p=26)          # key would overflow int32
    with pytest.raises(ValueError):
        eh.encode_hash_keys(t, k=33, p=10)
    with pytest.raises(ValueError):
        eh.ascii_to_registers(t, torch.zeros(2, dtype=torch.int32), k=5,
                              p=1)
    with pytest.raises(TypeError):
        eh.ascii_to_registers(t.to(torch.int32), regs, k=5, p=4)
    with pytest.raises(TypeError):
        eh.ascii_to_registers(t, regs.to(torch.int64), k=5, p=4)
    with pytest.raises(TypeError):
        eh.encode_hash_keys(t[0], k=5, p=4)         # not (R, C)
