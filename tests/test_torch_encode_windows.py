"""The encode/hash kernel's window arithmetic (csrc/encode_hash.cu), on the
CPU: its staged streams and its per-window funnel shift, pair reversal and
validity window, as `ops/encode_hash.window_fields` and `staged_ascii`
mirror them on int64 words, bitwise against the port's `kmers_contiguous`
and the JAX package's `_shift_or_kmers_contiguous`, for k = 1..32, windows
at every offset within the stream's words (and streams shifted into their
first word as a staged segment is), on all-valid, all-N and mixed rows.
The kernel itself runs on a card only (test_torch_cuda_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing_tpu.ops.encode import _shift_or_kmers_contiguous
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import encode_hash as eh
from dashing_tpu_torch.ops.encode import base_codes, kmers_contiguous

torch.set_num_threads(1)


def _rows(rng, C):
    """An all-valid row, an all-N row and a mixed row (lowercase, N, IUPAC,
    0x00 and high bytes)."""
    mixed = rng.choice(np.frombuffer(b"ACGTacgtNR\x00\xc1", np.uint8), size=C,
                       p=[0.21] * 4 + [0.02] * 4 + [0.02] * 4)
    return np.stack([rng.choice(np.frombuffer(b"ACGT", np.uint8), size=C),
                     np.full(C, ord("N"), np.uint8), mixed])


def _u64(pair) -> np.ndarray:
    hi, lo = (np.asarray(a).astype(np.uint64) for a in pair)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def _per_row(flat: torch.Tensor, R: int, C: int, k: int) -> np.ndarray:
    """Flat windows (one per stream position) -> the (R, C-k+1) windows
    that lie inside a row."""
    full = torch.cat([flat, flat.new_zeros(k - 1)]).view(R, C)
    return full[:, :C - k + 1].numpy()


@pytest.mark.parametrize("k", range(1, 33))
def test_window_fields_match_kmers(rng, k):
    C = 200                                  # 3 rows: 600 bases, 10 words
    tile = _rows(rng, C)
    R = tile.shape[0]
    t = torch.from_numpy(tile)
    code, valid = base_codes(t)
    fwd, rc, wvalid = kmers_contiguous(code, valid, k)
    jf, jr, jv = _shift_or_kmers_contiguous(
        jnp.asarray(code.numpy().astype(np.int32)), jnp.asarray(valid.numpy()),
        k)
    np.testing.assert_array_equal(_u64(jf), fwd.numpy())
    np.testing.assert_array_equal(_u64(jr), rc.numpy())
    np.testing.assert_array_equal(np.asarray(jv), wvalid.numpy())
    packed, vbits = pipeline._pack_tile_host(tile)
    streams = {"packed": (torch.from_numpy(packed.ravel()),
                          torch.from_numpy(vbits.ravel())),
               "ascii": eh.staged_ascii(t)}
    n = R * C - k + 1
    for name, (sc, sv) in streams.items():
        for lead in (0, 1, 17, 31):          # a segment starts anywhere
            f, r, v = eh.window_fields(sc, sv, n, k, lead)
            ok = _per_row(v, R, C, k)
            np.testing.assert_array_equal(ok, wvalid.numpy(),
                                          err_msg=f"{name} lead {lead}")
            # the codes of invalid bases are 0 in both, so every window's
            # fields agree, valid or not
            np.testing.assert_array_equal(_per_row(f, R, C, k), fwd.numpy(),
                                          err_msg=f"{name} lead {lead}")
            np.testing.assert_array_equal(_per_row(r, R, C, k), rc.numpy(),
                                          err_msg=f"{name} lead {lead}")
    assert wvalid[0].all() and not wvalid[1].any()


@pytest.mark.parametrize("C", [203, 208, 4105])
def test_staged_ascii_is_the_packed_stream(rng, C):
    """The ASCII staging gives the bytes pack2bit gives, rows joined, for
    any row width (pack2bit pads a row to a multiple of 8 with N)."""
    tile = _rows(rng, C)
    codes, valid = eh.staged_ascii(torch.from_numpy(tile.copy()))
    packed, vbits = pipeline._pack_tile_host(pipeline._pad8(tile))
    if C % 8 == 0:
        np.testing.assert_array_equal(codes.numpy()[:packed.size],
                                      packed.ravel())
        np.testing.assert_array_equal(valid.numpy()[:vbits.size],
                                      vbits.ravel())
    else:                                    # row by row, within the row
        bits = np.unpackbits(valid.numpy(), bitorder="little")[:tile.size]
        want = np.unpackbits(vbits, axis=1, bitorder="little")[:, :C]
        np.testing.assert_array_equal(bits.reshape(tile.shape), want)


def test_staged_ascii_classifies_every_byte(rng):
    """Every byte value, at every position within a 4-byte word, as
    `base_codes` classifies it: (b & 0xDF) in {A, C, G, T} -> 0..3,
    anything else invalid with code 0."""
    b = np.concatenate([rng.permutation(256) for _ in range(8)]).astype(
        np.uint8)
    codes, valid = eh.staged_ascii(torch.from_numpy(b[None]))
    code, ok = base_codes(torch.from_numpy(b))
    got_c = np.unpackbits(codes.numpy(), bitorder="little").reshape(-1, 2)
    got_c = (got_c[:, 0] + 2 * got_c[:, 1])[:b.size]
    got_v = np.unpackbits(valid.numpy(), bitorder="little")[:b.size]
    np.testing.assert_array_equal(got_c, code.numpy())
    np.testing.assert_array_equal(got_v.astype(bool), ok.numpy())
    assert ok.sum() == 8 * 8                 # ACGT acgt in each permutation
