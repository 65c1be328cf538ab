"""k-mer encoding (port of dashing_tpu/ops/encode.py).

Semantics are the JAX package's "BONSAI" encoding, exact for k <= 32:
2-bit codes A=0 C=1 G=2 T=3 (case-insensitive), any other byte
invalidates every window that holds it, the first base lands in the most
significant bits, and the canonical k-mer is the unsigned min of the
forward and reverse-complement codes.  k-mers are int64 bit patterns of
the JAX package's uint64 values.

`encode_tile` is the whole encoder of an ASCII tile: contiguous or spaced
k-mers (-s), canonical or not, and minimizer windows wider than the k-mer
span (-w), picked by value or by base-composition entropy (-g).  Invalid
k-mers carry the sentinel 2^64-1; a w-window emits only when every k-mer
in it is valid.  These run as PyTorch ops on the tile's device: they are
the counterparts of XLA code, which no Pallas kernel computed.

Tiling contract (unchanged): rows overlap by the halo, records are joined
with invalid separator bytes, so each k-mer of a record appears in exactly
one row.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hashes import shr

_A, _C, _G, _T = 65, 67, 71, 84  # ASCII, uppercase

_SIGN = -(1 << 63)
# 2^64 - 1 as an int64 bit pattern: larger (unsigned) than any k-mer code,
# so an invalid k-mer never wins a minimizer window
_SENTINEL = -1
_U32 = 0xFFFFFFFF


def base_codes(tile: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ASCII bases (any integer dtype) -> (code in {0..3} as int64, valid)."""
    up = tile.to(torch.int64) & 0xDF
    code = torch.zeros_like(up)
    code = torch.where(up == _C, 1, code)
    code = torch.where(up == _G, 2, code)
    code = torch.where(up == _T, 3, code)
    valid = (up == _A) | (up == _C) | (up == _G) | (up == _T)
    return code, valid


def parse_spacing(spacing: str, k: int) -> List[int]:
    """Parse the -s spacing string into k-1 inter-position gaps."""
    if not spacing:
        return [0] * (k - 1)
    gaps: List[int] = []
    for part in spacing.split(","):
        if not part:
            continue
        if "x" in part:
            skip, times = part.split("x")
            gaps.extend([int(skip)] * int(times))
        else:
            gaps.append(int(part))
    if any(g < 0 for g in gaps):
        raise ValueError(f"spacing gaps must be >= 0, got {gaps}")
    if len(gaps) > k - 1:
        raise ValueError(f"spacing defines {len(gaps)} gaps but k={k} allows {k - 1}")
    gaps.extend([0] * (k - 1 - len(gaps)))
    return gaps


class Spacer:
    """k-mer shape: k sampled positions over a span of c bases, window w
    = max(w, c).  k > 32 is legal for the rolling hashes."""

    def __init__(self, k: int, w: int = 0, gaps: Optional[List[int]] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        gaps = gaps if gaps is not None else [0] * (k - 1)
        self.k = k
        self.positions = [0]
        for g in gaps:
            self.positions.append(self.positions[-1] + 1 + g)
        self.c = self.positions[-1] + 1  # span in bases
        self.w = max(w, self.c)
        self.spaced = any(g for g in gaps)

    @property
    def halo(self) -> int:
        """Bases of overlap adjacent tiles need so no k-mer is missed."""
        return self.w - 1


def kmers_contiguous(code: torch.Tensor, valid: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, C) codes + validity -> forward k-mers, reverse-complement
    k-mers and window validity, each (R, C - k + 1); k <= 32."""
    if not 1 <= k <= 32:
        raise ValueError(f"contiguous 2-bit k-mers need 1 <= k <= 32, got {k}")
    C = code.shape[-1]
    W = C - k + 1
    code = code.to(torch.int64)
    fwd = torch.zeros(code.shape[:-1] + (W,), dtype=torch.int64,
                      device=code.device)
    rc = torch.zeros_like(fwd)
    for t in range(k):
        c_t = code[..., t:t + W]
        fwd = fwd | (c_t << (2 * (k - 1 - t)))
        rc = rc | ((3 - c_t) << (2 * t))
    bad = torch.cumsum((~valid).to(torch.int32), dim=-1)
    bad = torch.nn.functional.pad(bad, (1, 0))
    wvalid = (bad[..., k:] - bad[..., :W]) == 0
    return fwd, rc, wvalid


def _shift_or_kmers(code: torch.Tensor, valid: torch.Tensor,
                    positions: Sequence[int], span: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spaced k-mers: window i samples bases i + positions[t].  The
    reverse complement is that of the PACKED value (complement each
    sampled base, reverse their order: slot t samples positions[k-1-t]),
    as encode_oracle and the reference define it; for an asymmetric seed
    it is not the k-mer of the reverse strand."""
    C = code.shape[-1]
    W = C - span + 1
    k = len(positions)
    code = code.to(torch.int64)
    fwd = torch.zeros(code.shape[:-1] + (W,), dtype=torch.int64,
                      device=code.device)
    rc = torch.zeros_like(fwd)
    wvalid = torch.ones(fwd.shape, dtype=torch.bool, device=code.device)
    for t in range(k):
        p = positions[t]
        wvalid = wvalid & valid[..., p:p + W]
        fwd = fwd | (code[..., p:p + W] << (2 * (k - 1 - t)))
        p_rc = positions[k - 1 - t]
        rc = rc | ((3 - code[..., p_rc:p_rc + W]) << (2 * (k - 1 - t)))
    return fwd, rc, wvalid


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned min of int64 bit patterns (flip the sign bit to compare)."""
    return torch.where((a ^ _SIGN) <= (b ^ _SIGN), a, b)


def canonical(fwd: torch.Tensor, rc: torch.Tensor, canon: bool
              ) -> torch.Tensor:
    return umin(fwd, rc) if canon else fwd


def encode_tile(tile: torch.Tensor, *, k: int, w: int,
                positions: Sequence[int], span: int, canon: bool,
                entropy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) uint8 ASCII tile -> (k-mer codes, valid), both (R, C - w + 1):
    one output per w-window (one per k-mer position when w == span).
    Invalid entries carry the sentinel 2^64-1 (-1 as int64).  entropy=True
    picks each window's k-mer of lowest base-composition entropy instead
    of the smallest value (-g/--by-entropy)."""
    if k > 32:
        raise ValueError("BONSAI exact encoding requires k <= 32 "
                         "(use the nthash/cyclic rolling encoders)")
    code, valid = base_codes(tile)
    if span == k and tuple(positions) == tuple(range(k)):
        fwd, rc, wvalid = kmers_contiguous(code, valid, k)
    else:
        fwd, rc, wvalid = _shift_or_kmers(code, valid, positions, span)
    km = torch.where(wvalid, canonical(fwd, rc, canon), _SENTINEL)
    if w > span:
        win = w - span + 1
        if entropy:
            km = _entropy_sliding_min(km, wvalid, code, positions, win)
        else:
            km = sliding_min(km, win)
        wvalid = full_window_valid(wvalid, win)
    return km, wvalid


def full_window_valid(wvalid: torch.Tensor, win: int) -> torch.Tensor:
    """A w-window emits only when every k-mer inside it is valid (the one
    emission mask of the bonsai and the rolling encoders)."""
    csum = torch.cumsum((~wvalid).to(torch.int32), dim=-1)
    csum = torch.nn.functional.pad(csum, (1, 0))
    return (csum[..., win:] - csum[..., :-win]) == 0


def sliding_min(x: torch.Tensor, win: int) -> torch.Tensor:
    """Unsigned sliding-window minimum over the last axis of int64 bit
    patterns, output width W - win + 1, by log-doubling: mins over spans
    of 2^j, then two overlapping spans cover the window."""
    if win <= 1:
        return x
    big, length, span = x, x.shape[-1], 1
    while span * 2 <= win:
        big = umin(big[..., :length - span], big[..., span:])
        length -= span
        span *= 2
    W = x.shape[-1] - win + 1
    rem = win - span
    return umin(big[..., :W], big[..., rem:rem + W])


# ---------------------------------------------------------------------------
# Entropy minimizers (-g).  The JAX package scores a k-mer by the float32
# entropy of its base counts, quantized as min(uint32(ent * 2^18), 2^20-1).
# A last-bit difference in the float32 sum moves a quantized value across
# an integer, and compositions that are permutations of one another (equal
# entropy in exact arithmetic) land on neighbouring integers depending on
# the order and rounding of the sum.  torch.log2 rounds unlike XLA's, and
# XLA itself rounds the same formula differently where it fuses it into the
# sliding min (the same composition can then score differently at two
# offsets of one row).  So the port's score is a table by base
# composition, computed once on the host with the float32 operations XLA
# runs for the formula op by op on the CPU (log2 = log(x) times the float32
# reciprocal of log(2), log the Cephes polynomial with its multiply-adds
# fused; then pr * log2, the subtractions unfused, A, C, G, T in order), and
# gathered on the tile's device: one score per composition, the same on
# every device and at every offset by construction.
# ---------------------------------------------------------------------------

_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)


def _round32(q: Fraction) -> np.float32:
    """An exact rational rounded once to the nearest float32 (ties to
    even; normal range)."""
    if q == 0:
        return np.float32(0.0)
    m = abs(q)
    e = m.numerator.bit_length() - m.denominator.bit_length() - 23
    s = m / Fraction(2) ** e
    while s >= 1 << 24:
        s, e = s / 2, e + 1
    while s < 1 << 23:
        s, e = s * 2, e - 1
    return np.float32(math.copysign(math.ldexp(round(s), e), q))


def _fma32(a, b, c) -> np.float32:
    """float32 a * b + c with one rounding, as a fused multiply-add."""
    return _round32(Fraction(float(a)) * Fraction(float(b))
                    + Fraction(float(c)))


def _xla_log32(x: np.float32) -> np.float32:
    """Natural log of a positive normal float32 as XLA's CPU backend
    computes it (Cephes: x = 2^e * m, m in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial in Estrin form, multiply-adds fused)."""
    f = np.float32
    bits = int(np.float32(x).view(np.int32))
    e = f(1) + f((bits >> 23) - 0x7F)
    m = np.array([(bits & 0x007FFFFF) | 0x3F000000],
                 np.int32).view(np.float32)[0]
    low = m < f(0.707106781186547524)
    t = (m - f(1)) + (m if low else f(0))
    if low:
        e = e - f(1)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _LOG_Q1 * e)
    t = _fma32(f(-0.5), x2, t)
    t = t + y
    return _fma32(_LOG_Q2, e, t)


@functools.lru_cache(maxsize=None)
def entropy_table(k: int) -> np.ndarray:
    """Quantized entropy of every base composition of a k-mer, as int64
    indexed by (n_A * (k+1) + n_C) * (k+1) + n_G (n_T = k - the rest;
    other entries 0): ent -= pr * log2(pr) over A, C, G, T in that order
    in float32, then min(uint32(ent * 2^18), 2^20 - 1)."""
    f = np.float32
    inv_ln2 = f(1) / _xla_log32(f(2))
    terms = np.zeros(k + 1, np.float32)   # pr * log2(pr) for pr = c / k
    for c in range(1, k + 1):
        pr = f(c) / f(k)
        terms[c] = pr * (_xla_log32(pr) * inv_ln2)
    n = np.arange(k + 1)
    a, c_, g = np.meshgrid(n, n, n, indexing="ij")
    t = k - a - c_ - g
    ok = t >= 0
    ent = np.zeros(a.shape, np.float32)
    for cnt in (a, c_, g, np.where(ok, t, 0)):
        ent = ent - terms[cnt]
    q = np.minimum((ent * f(2.0 ** 18)).astype(np.uint32), (1 << 20) - 1)
    return np.where(ok, q, 0).astype(np.int64).reshape(-1)


_TABLES: Dict[Tuple[int, str], torch.Tensor] = {}


def _entropy_table_on(k: int, device: torch.device) -> torch.Tensor:
    key = (k, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(entropy_table(k)).to(device)
    return _TABLES[key]


def _entropy_sliding_min(km: torch.Tensor, wvalid: torch.Tensor,
                         code: torch.Tensor, positions: Sequence[int],
                         win: int) -> torch.Tensor:
    """Minimizer by entropy: key = (quantized entropy << 32) | in-row
    offset, invalid k-mers at the top, so an unsigned sliding min picks
    the lowest-entropy valid k-mer (ties to the leftmost), whose value is
    then gathered by offset.  Validity comes from the mask, never from the
    value: an all-T 32-mer (canon off) equals the sentinel and must stay
    selectable."""
    k = len(positions)
    W = km.shape[-1]
    counts = [torch.zeros(km.shape, dtype=torch.int64, device=km.device)
              for _ in range(3)]
    for p in positions:
        c_t = code[..., p:p + W]
        for b in range(3):
            counts[b] += c_t == b
    idx = (counts[0] * (k + 1) + counts[1]) * (k + 1) + counts[2]
    entq = _entropy_table_on(k, km.device)[idx]
    offs = torch.arange(W, dtype=torch.int64, device=km.device)
    key = (torch.where(wvalid, entq, _U32) << 32) | offs
    best = sliding_min(key, win)
    chosen = torch.gather(km, -1, best & _U32)
    return torch.where(shr(best, 32) == _U32, _SENTINEL, chosen)


# ---------------------------------------------------------------------------
# Host-side tiling helpers (numpy).
# ---------------------------------------------------------------------------

def tile_sequence(seq: np.ndarray, content: int, halo: int,
                  pad_byte: int = ord("N")) -> np.ndarray:
    """Chop a flat uint8 sequence into rows overlapping by `halo`; row r
    covers seq[r*content : r*content + content + halo], padded with an
    invalid byte so windows past the end are masked."""
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    if n == 0:
        return np.zeros((0, content + halo), np.uint8)
    rows = max(1, -(-n // content))
    padded = np.full(rows * content + halo, pad_byte, np.uint8)
    padded[:n] = seq
    stride = padded.strides[0]
    return np.lib.stride_tricks.as_strided(
        padded, shape=(rows, content + halo),
        strides=(content * stride, stride)).copy()


def join_records(seqs: List[bytes], sep_len: int) -> np.ndarray:
    """Concatenate records with `sep_len` invalid bytes between them so no
    k-mer window spans a record boundary."""
    if not seqs:
        return np.zeros(0, np.uint8)
    sep = b"\x00" * sep_len
    return np.frombuffer(sep.join(seqs), dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Oracle (slow, host): the tests' reference semantics.
# ---------------------------------------------------------------------------

_CODE_LUT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[ord(chr(_b).lower())] = _i


def encode_oracle(seq: bytes, sp: Spacer, canon: bool = True) -> np.ndarray:
    """Python k-mer extraction of one record (uint64 values of the valid
    k-mers, or of the fully valid w-windows' minima)."""
    arr = _CODE_LUT[np.frombuffer(seq, np.uint8)]
    out = []
    for i in range(arr.shape[0] - sp.c + 1):
        picks = arr[i:i + sp.c][np.array(sp.positions)]
        if (picks == 255).any():
            out.append(None)
            continue
        fwd = 0
        for v in picks:
            fwd = (fwd << 2) | int(v)
        rcv = 0
        for v in picks[::-1]:
            rcv = (rcv << 2) | (3 - int(v))
        out.append(min(fwd, rcv) if canon else fwd)
    if sp.w > sp.c:
        wlen = sp.w - sp.c + 1
        out = [min(out[i:i + wlen]) if None not in out[i:i + wlen] else None
               for i in range(max(0, len(out) - wlen + 1))]
    return np.array([v for v in out if v is not None], dtype=np.uint64)
