"""Port (dashing_tpu_torch, plain PyTorch on the CPU) vs the JAX package:
WangHash, k-mer keys and HLL registers, bitwise.

The CUDA kernel itself (csrc/encode_hash.cu) runs only on a card; the
smoke script at the repo root holds it to the plain version tested here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dashing_tpu import pipeline as jpipe
from dashing_tpu.hashes import clz64_np, wang_hash_np
from dashing_tpu.ops.pallas_encode import (encode_hash_keys_from_codes,
                                           unpack_2bit)
from dashing_tpu_torch import hashes, pipeline
from dashing_tpu_torch.ops import encode_hash as eh
from dashing_tpu_torch.ops import hll_update

torch.set_num_threads(1)

ALPHABET = np.frombuffer(b"ACGTacgtNNRYn", np.uint8)


def _as_i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.uint64).view(np.int64))


def _tile(rng, R=8, C=512):
    """ASCII tile with N runs, lowercase and IUPAC bytes; C % 8 == 0."""
    tile = rng.choice(ALPHABET, size=(R, C),
                      p=[0.15] * 4 + [0.075] * 4 + [0.02] * 5)
    tile[0, 40:90] = ord("N")
    return tile


def test_wang_hash_matches_numpy(rng):
    x = rng.integers(0, 2 ** 64, 1 << 16, dtype=np.uint64)
    x[:4] = [0, 2 ** 63, 2 ** 64 - 1, 2 ** 63 - 1]
    want = wang_hash_np(x)
    got = hashes.wang_hash(_as_i64(x)).numpy().view(np.uint64)
    assert (want >> np.uint64(63)).any()          # top-bit-set hashes covered
    np.testing.assert_array_equal(got, want)


def test_clz64_matches_numpy(rng):
    x = rng.integers(1, 2 ** 64, 4096, dtype=np.uint64)
    shifts = rng.integers(0, 64, 4096).astype(np.uint64)
    x = np.maximum(x >> shifts, np.uint64(1))
    # float log2 would round these up across a power of two
    x[:3] = [2 ** 61 - 1, 2 ** 53 + 1, 2 ** 64 - 1]
    np.testing.assert_array_equal(hashes.clz64(_as_i64(x)).numpy(),
                                  clz64_np(x).astype(np.int64))


def test_pack_matches_jax_packer(rng):
    tile = _tile(rng)
    for got, want in zip(pipeline._pack_tile_host_inner(tile),
                         jpipe._pack_tile_host_inner(tile)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pipeline._pack_tile_host(tile),
                         jpipe._pack_tile_host(tile)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("p", [10, 14, 25])
@pytest.mark.parametrize("canon", [True, False])
def test_keys_match_jax_kernel(rng, k, p, canon):
    tile = _tile(rng)
    C = tile.shape[1]
    packed, vbits = pipeline._pack_tile_host(tile)
    code, valid = unpack_2bit(jnp.asarray(packed), jnp.asarray(vbits), C)
    want = np.asarray(encode_hash_keys_from_codes(
        code, valid, k=k, p=p, canon=canon, interpret=True))
    tcode, tvalid = eh.unpack_2bit(torch.from_numpy(packed),
                                   torch.from_numpy(vbits), C)
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(code))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid) != 0)
    got = eh.encode_hash_keys_from_codes(tcode, tvalid, k=k, p=p,
                                         canon=canon).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (want & 63).any() and ((want & 63) == 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,p", [(21, 10), (31, 14), (32, 25)])
def test_registers_match_jax_keys(rng, k, p):
    tile = _tile(rng, R=16)
    C = tile.shape[1]
    packed, vbits = pipeline._pack_tile_host(tile)
    code, valid = unpack_2bit(jnp.asarray(packed), jnp.asarray(vbits), C)
    keys = np.asarray(encode_hash_keys_from_codes(code, valid, k=k, p=p,
                                                  interpret=True))
    want = np.zeros(1 << p, np.int32)
    np.maximum.at(want, (keys >> 6).ravel(), keys.ravel() & 63)
    regs = torch.zeros(1 << p, dtype=torch.int32)
    out = eh.packed_to_registers(torch.from_numpy(packed),
                                 torch.from_numpy(vbits), regs, k=k, p=p)
    assert out is regs                                 # updated in place
    np.testing.assert_array_equal(regs.numpy(), want)


def test_sketch_matches_jax_pipeline(rng):
    """Whole-file path: joined records -> tiles -> packed -> registers,
    against the JAX pipeline's own registers (its CPU path)."""
    seq = _tile(rng, R=1, C=30000)[0]
    params = jpipe.SketchParams(k=21)
    sp = params.spacer()
    jregs = np.asarray(jpipe._sketch_chunk_stream(
        jpipe._row_chunks(jpipe.tile_sequence(seq, jpipe.CONTENT, sp.halo)),
        params, 12))
    got = pipeline.sketch_joined_hll(seq, pipeline.SketchParams(k=21), 12,
                                     torch.device("cpu"))
    np.testing.assert_array_equal(got, np.clip(jregs, 0, 255).astype(np.uint8))


def test_p_guards():
    h = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        hll_update.bucket_rank(h, 32)
    regs = torch.zeros(1 << 4, dtype=torch.int32)
    packed = torch.zeros((1, 2), dtype=torch.uint8)
    vbits = torch.zeros((1, 1), dtype=torch.uint8)
    with pytest.raises(ValueError):
        eh.packed_to_registers(packed, vbits, regs, k=5, p=32)
    with pytest.raises(ValueError):
        eh.packed_to_registers(packed, vbits, regs, k=33, p=4)
    with pytest.raises(ValueError):
        eh.encode_hash_keys_from_codes(packed.long(), packed.bool(), k=5,
                                       p=26)


def test_streamed_file_matches_whole_file(rng, tmp_path, monkeypatch):
    """Above the stream threshold a file is parsed incrementally and cut
    into fixed windows; the registers equal the whole-file registers."""
    import gzip
    seqs = [_tile(rng, R=1, C=int(n))[0].tobytes()
            for n in rng.integers(2000, 40000, 12)]
    body = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))
    path = tmp_path / "big.fa.gz"
    path.write_bytes(gzip.compress(body))
    monkeypatch.setattr(pipeline, "MAX_ROWS", 4)     # 32 kbp windows
    params = pipeline.SketchParams(k=31)
    whole = pipeline.sketch_file_hll(str(path), params, 12,
                                     torch.device("cpu"))
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    assert pipeline.should_stream(str(path))
    streamed = list(pipeline.InputFile(
        0, str(path), params.spacer()).tiles())
    assert len(streamed) > 3 and all(t.shape[0] <= 4 for t in streamed)
    got = pipeline.sketch_file_hll(str(path), params, 12, torch.device("cpu"))
    assert whole.any()
    np.testing.assert_array_equal(got, whole)
