"""The minimizer kernel's wrapper on the CPU (ops/minimizer_hash): its
plain version against the JAX package's ASCII-route step under -w, the
routing rule of `pipeline.tile_to_registers`, and the wrapper's guards.

The plain version is held bitwise to JAX `_tile_to_registers` (exact
contiguous k-mers, the sliding minimum over w - k + 1 k-mers, WangHash,
the register update) over a grid of k, w, canonical on and off and p, on
tiles with N runs, lowercase, IUPAC codes, 0x00 separators and bytes >=
0x80, from zero registers and from registers that already hold ranks.
The CUDA kernel runs only on a card: tests/test_torch_cuda_kernels.py
and chip_smoke.py hold it to this plain version there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu.pipeline import _tile_to_registers as jax_tile_to_registers
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import minimizer_hash as mh

torch.set_num_threads(1)

# the bytes of test_torch_encode_ascii.py's `_tile`, the invalid ones rare
# enough that windows of 160 bases are often all valid
ALPHABET = np.frombuffer(b"ACGTacgtNnRY\x00\xc1\xe3\x80", np.uint8)
PROBS = [0.2] * 4 + [0.0495] * 4 + [0.00025] * 8
P_CYCLE = [4, 14, 16, 25]
CASES = [(k, w, canon, P_CYCLE[i % len(P_CYCLE)])
         for i, (k, w, canon) in enumerate(
             (k, w, canon) for k in (1, 15, 21, 31, 32)
             for w in sorted({k + 1, k + 19, 50, 128 + k})
             for canon in (True, False))]


def _tile(rng, R=5, C=611):
    """ASCII tile (C not a multiple of 8): an N run in every row, row 0 all
    N, row 1 all lowercase."""
    tile = rng.choice(ALPHABET, size=(R, C), p=PROBS)
    for r in range(R):
        s = int(rng.integers(0, C - 40))
        tile[r, s:s + int(rng.integers(1, 40))] = ord("N")
    tile[0] = ord("N")
    tile[1] = rng.choice(np.frombuffer(b"acgt", np.uint8), size=C)
    return tile


@pytest.mark.parametrize("k,w,canon,p", CASES)
def test_plain_matches_jax_step(rng, k, w, canon, p):
    tile = _tile(rng)
    start = rng.integers(0, 8, 1 << p).astype(np.int32)
    for regs0 in (np.zeros(1 << p, np.int32), start):
        want = np.asarray(jax_tile_to_registers(
            jnp.asarray(tile), jnp.asarray(regs0), k=k, w=w,
            positions=tuple(range(k)), span=k, canon=canon,
            encoding="bonsai", rehash=True, p=p))
        regs = torch.from_numpy(regs0.copy())
        out = mh.ascii_minimizer_registers(torch.from_numpy(tile), regs, k=k,
                                           w=w, p=p, canon=canon)
        assert out is regs
        if not regs0.any():
            assert (want > 0).any()
        np.testing.assert_array_equal(regs.numpy(), want)


# one case a parameter family: (SketchParams, p, whether the kernel takes
# the ASCII route's fold)
ROUTES = [
    (dict(k=31, w=50), 16, True),
    (dict(k=21, w=50, canon=False), 14, True),
    (dict(k=1, w=2), 1, True),
    (dict(k=32, w=32 + 1023), 31, True),     # the widest window taken
    (dict(k=31), 16, False),                 # w == span: packed route, K2
    (dict(k=31, w=31 + 1024), 16, False),    # beyond WIN_MAX
    (dict(k=31, w=50), 32, False),           # p beyond the registers' range
    (dict(k=31, w=50, spacing="1x4"), 16, False),
    (dict(k=31, w=50, entropy=True), 16, False),
    (dict(k=31, w=50, rehash=False), 16, False),
    (dict(k=41, w=60, encoding="nthash"), 16, False),
    (dict(k=31, w=50, encoding="cyclic"), 16, False),
]


@pytest.mark.parametrize("params,p,taken", ROUTES)
def test_routing_rule(params, p, taken):
    sp_params = pipeline.SketchParams(**params)
    kw = pipeline._encode_kw(sp_params, pipeline.check_supported(sp_params))
    assert mh.takes(p, **kw) is taken


@pytest.mark.parametrize("params,p,taken",
                         [r for r in ROUTES if r[1] <= 16])
def test_tile_to_registers_routes_by_arguments(rng, monkeypatch, params, p,
                                               taken):
    """`pipeline.tile_to_registers` calls the wrapper exactly when the rule
    says so, and its registers are the ops chain's (tile_hashes, then the
    register update) in every family."""
    calls = []
    wrapper = mh.ascii_minimizer_registers

    def spy(*a, **kw):
        calls.append(kw)
        return wrapper(*a, **kw)

    monkeypatch.setattr(mh, "ascii_minimizer_registers", spy)
    sp_params = pipeline.SketchParams(**params)
    sp = pipeline.check_supported(sp_params)
    kw = pipeline._encode_kw(sp_params, sp)
    tile = torch.from_numpy(_tile(rng, R=4, C=sp.w + 1200))
    got = torch.zeros(1 << p, dtype=torch.int32)
    assert pipeline.tile_to_registers(tile, got, p=p, **kw) is got
    assert len(calls) == int(taken)
    h, valid = pipeline.tile_hashes(tile, **kw)
    want = torch.zeros_like(got)
    pipeline.update_registers(want, h, valid, p)
    assert int((want > 0).sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,w,p,error", [
    (31, 31, 16, ValueError),              # w == k
    (31, 20, 16, ValueError),
    (31, 31 + 1024, 16, ValueError),       # WIN_MAX + 1 k-mers a window
    (0, 50, 16, ValueError),
    (33, 50, 16, ValueError),
    (31, 50, 0, ValueError),
    (31, 50, 32, ValueError),
])
def test_wrapper_guards_arguments(k, w, p, error):
    tile = torch.full((2, 2000), ord("A"), dtype=torch.uint8)
    regs = torch.zeros(1 << 16, dtype=torch.int32)
    with pytest.raises(error):
        mh.ascii_minimizer_registers(tile, regs, k=k, w=w, p=p)
    assert not regs.any()


@pytest.mark.parametrize("what", ["tile dtype", "tile rank", "regs dtype",
                                  "regs shape", "device"])
def test_wrapper_guards_tensors(what):
    tile = torch.full((2, 200), ord("A"), dtype=torch.uint8)
    regs = torch.zeros(1 << 10, dtype=torch.int32)
    error = TypeError
    if what == "tile dtype":
        tile = tile.to(torch.int32)
    elif what == "tile rank":
        tile = tile.reshape(-1)
    elif what == "regs dtype":
        regs = regs.to(torch.int64)
    elif what == "regs shape":
        regs = torch.zeros(1 << 11, dtype=torch.int32)
    else:
        tile, error = tile.to("meta"), ValueError
    with pytest.raises(error):
        mh.ascii_minimizer_registers(tile, regs, k=21, w=40, p=10)


def test_plain_leaves_registers_without_a_window(rng):
    """A chunk narrower than w has no window: the registers stay as they
    are (the kernel launches no block for it)."""
    regs = torch.from_numpy(rng.integers(0, 5, 1 << 8).astype(np.int32))
    want = regs.clone()
    tile = torch.from_numpy(_tile(rng, R=3, C=49))
    mh.ascii_minimizer_registers(tile, regs, k=31, w=50, p=8)
    assert torch.equal(regs, want)


def test_stream_folds_chunks_in_place(rng):
    """`sketch_chunk_stream` under -w folds chunk after chunk through the
    wrapper into one register array: the registers of the ops chain
    folded chunk by chunk."""
    tiles = [_tile(rng, R=3, C=700) for _ in range(3)]
    params = pipeline.SketchParams(k=21, w=40)
    kw = pipeline._encode_kw(params, pipeline.check_supported(params))
    want = torch.zeros(1 << 12, dtype=torch.int32)
    for t in tiles:
        h, valid = pipeline.tile_hashes(torch.from_numpy(t), **kw)
        pipeline.update_registers(want, h, valid, 12)
    got = pipeline.sketch_chunk_stream(tiles, params, 12, torch.device("cpu"),
                                       False)
    assert int((want > 0).sum()) > 0
    assert torch.equal(got, want)
