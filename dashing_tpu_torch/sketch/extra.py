"""The rest of the sketch-type matrix (port of dashing_tpu/sketch/extra.py):
the wide HLL, HyperMinHash, SuperMinHash and the densified MinHash that
SuperMinHash's older files hold, with the JAX package's classes, public
attributes, arithmetic and byte formats (each a gzip member of an 8-byte
magic, two little-endian u32 fields and the payload), so a sketch file
carries across the two packages and `view` prints the same dump.

* WideHLL (--use-wide-hll, `.whll`, DTPUWHL1): HLL's bucket/rank
  semantics in uint16 registers.  It shares HLL's code (sketch/hll.py
  RegisterSketch), so its estimates and compares are HLL's: the CLI
  builds its registers by the HLL engine and compares them by the HLL
  kernels.
* HyperMinHash (--use-hyperminhash, `.hmh`, DTPUHMH1): a bucket keeps
  (rank, sub-hash of the minimizing element) packed in one uint32,
  `rank << rbits | (mask - sub)`, so a register max keeps the highest
  rank and within it the lowest sub-hash.  Jaccard from register
  equality, corrected for collisions of the rbits-bit sub-hashes.
* SuperMinHash (--use-superminhash, `.bbs`, DTPUSMH2): Ertl's algorithm,
  a lazy Fisher-Yates permutation an element (generation counters),
  float64 registers, the Beta-law cardinality MLE.
* DensifiedMinHash (DTPUSMH1): one-permutation MinHash with rotation
  densification; the CLI never builds it, but reads its files.

All four are host numpy, as in the JAX package, apart from the wide
HLL's estimates and compares (torch, on the kernels on a card).
"""
from __future__ import annotations

import struct
from typing import IO

import numpy as np
import torch

from ..hashes import clz64_np, poisson_min_cardinality, wang_hash_np
from . import estimators as est
from .hll import RegisterSketch
from .setsketches import _read_exact, _read_gz, _triple_from_ji, _write_gz

_HDR = struct.Struct("<8sII")


def _read_header(fp, magic: bytes, what: str, bad: str):
    """The two u32 fields after `magic`, with the JAX classes' errors."""
    hdr = fp.read(_HDR.size)
    if len(hdr) < _HDR.size:
        raise EOFError(f"truncated {what} record")
    got, a, b = _HDR.unpack(hdr)
    if got != magic:
        raise ValueError(f"bad {bad} magic {got!r}")
    return a, b


class WideHLL(RegisterSketch):
    """HLL with uint16 registers; same bucket/rank semantics as HLL."""
    MAGIC = b"DTPUWHL1"
    DTYPE = np.uint16
    NAME = "WideHLL"

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p,
                           (self.estim << 8) | self.jestim))
        fp.write(self.regs.astype("<u2").tobytes())

    @classmethod
    def read_record(cls, fp) -> "WideHLL":
        p, ej = _read_header(fp, cls.MAGIC, "WideHLL", "WideHLL")
        regs = np.frombuffer(_read_exact(fp, 2 << p, "WideHLL registers"),
                             "<u2").astype(np.uint16)
        return cls(p, ej >> 8, ej & 0xFF, regs)


class HyperMinHash:
    """m = 2^p buckets of (rank, subhash) packed uint32 registers: key =
    rank << rbits | (mask - subhash), so a register max keeps the max
    rank and, within it, the MIN subhash (mergeable like HLL)."""
    MAGIC = b"DTPUHMH1"

    def __init__(self, p: int, regwidth: int = 16, regs: np.ndarray = None):
        self.p = int(p)
        # the rank (6 bits) and the sub-hash share one uint32, so the
        # width stops at 32; 64 would shift the rank out of the register
        self.regwidth = min(int(regwidth), 32)
        self.rbits = max(self.regwidth - 6, 2)       # sub-hash bits
        self.regs = (np.zeros(1 << p, np.uint32) if regs is None
                     else np.asarray(regs, np.uint32))
        self._card_cache = None

    @property
    def q(self) -> int:
        return 64 - self.p

    def _rank_sub(self, hashes: np.ndarray):
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (hashes << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        rank = clz64_np(rest) + 1
        sub = (hashes & np.uint64((1 << self.rbits) - 1)).astype(np.int64)
        return idx, rank, sub

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx, rank, sub = self._rank_sub(hashes)
        mask = (1 << self.rbits) - 1
        key = (rank << self.rbits | (mask - sub)).astype(np.uint32)
        np.maximum.at(self.regs, idx, key)
        self._card_cache = None

    def finalize(self):
        pass

    def _ranks(self) -> np.ndarray:
        return (self.regs >> np.uint32(self.rbits)).astype(np.uint8)

    def histogram(self) -> np.ndarray:
        return np.bincount(self._ranks(),
                           minlength=self.q + 2).astype(np.float32)

    def getcard(self) -> float:
        """HLL's MLE over the ranks (cached)."""
        if self._card_cache is None:
            C = torch.from_numpy(self.histogram())[None]
            self._card_cache = float(est.estimate(C, self.p,
                                                  est.ERTL_MLE)[0])
        return self._card_cache

    report = getcard
    cardinality_estimate = getcard

    def jaccard_index(self, other: "HyperMinHash") -> float:
        both = (self.regs == other.regs) & (self.regs != 0)
        filled = (self.regs != 0) | (other.regs != 0)
        nf = int(filled.sum())
        if nf == 0:
            return 0.0
        f = float(both.sum()) / nf
        c = 2.0 ** -self.rbits   # collision chance given equal ranks
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "HyperMinHash"):
        return _triple_from_ji(self.jaccard_index(other), self.getcard(),
                               other.getcard())

    def union_size(self, other: "HyperMinHash") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def intersection_size(self, other: "HyperMinHash") -> float:
        return self.full_set_comparison(other)[2]

    def __iadd__(self, other: "HyperMinHash") -> "HyperMinHash":
        np.maximum(self.regs, other.regs, out=self.regs)
        self._card_cache = None
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.regwidth))
        fp.write(self.regs.astype("<u4").tobytes())

    def write(self, pf):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp) -> "HyperMinHash":
        p, w = _read_header(fp, cls.MAGIC, "HMH", "HMH")
        regs = np.frombuffer(_read_exact(fp, 4 << p, "HMH registers"),
                             "<u4").astype(np.uint32)
        return cls(p, w, regs)

    @classmethod
    def read(cls, pf) -> "HyperMinHash":
        return _read_gz(pf, cls.read_record)


_GOLDEN = 0x9E3779B97F4A7C15
_U64 = 0xFFFFFFFFFFFFFFFF


class SuperMinHash:
    """SuperMinHash (Ertl 2017, arXiv:1706.05698).  Each element d drives,
    at round j, a uniform r_j in [0, 1) and one Fisher-Yates swap of a
    permutation of the m registers; register p_d[j] takes min(h, j + r_j).
    Registers lie in [0, m) with P(h_i >= x) = (1 - x/m)^n, which gives
    the cardinality MLE (m - 1) / sum_i(-ln(1 - h_i/m)); equal registers
    of two sketches mark the same minimizing element.

    Rounds run in lockstep over a chunk of elements, the permutations kept
    lazily by generation counters, and stop once j > max(h): a later
    update has v = j + r > max(h), so the registers equal the full m-round
    result exactly, whatever the chunking or the element order."""
    MAGIC = b"DTPUSMH2"
    _CHUNK = 1 << 16

    def __init__(self, p: int, b: int = 16, h: np.ndarray = None):
        self.p = int(p)
        self.b = int(b)
        self.h = (np.full(1 << p, np.inf, np.float64) if h is None
                  else np.asarray(h, np.float64))
        self._gen_state = None

    @property
    def m(self) -> int:
        return 1 << self.p

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        d = np.unique(np.asarray(hashes, np.uint64))
        m = self.m
        if d.size == 0:
            return
        if self._gen_state is None:
            # the (chunk, m) permutation and generation state: 8 B a cell,
            # about 256 MiB in all
            ch = max(1, min(self._CHUNK, (256 << 20) // (8 * m),
                            max(d.size, 1)))
            self._gen_state = (np.zeros((ch, m), np.int32),
                               np.full((ch, m), -1, np.int32), [0])
        perm, gen, counter = self._gen_state
        ch = perm.shape[0]
        for c0 in range(0, d.size, ch):
            dd = d[c0:c0 + ch]
            rows = np.arange(dd.size)
            cur = counter[0]
            counter[0] += 1
            j = 0
            hmax = np.inf
            while j < m:
                # the stop bound, refreshed every 16 rounds: h only falls,
                # so a stale bound only delays the stop
                if j % 16 == 0:
                    hmax = self.h.max()
                if j > hmax:          # v = j + r > max(h): h stays
                    break
                s1 = wang_hash_np(dd ^ np.uint64(2 * j * _GOLDEN & _U64))
                s2 = wang_hash_np(dd ^ np.uint64((2 * j + 1) * _GOLDEN
                                                 & _U64))
                r = s1.astype(np.float64) * (2.0 ** -64)
                k = j + np.minimum((s2.astype(np.float64) * (2.0 ** -64)
                                    * (m - j)).astype(np.int64), m - 1 - j)
                pj = np.where(gen[rows, j] == cur, perm[rows, j], j)
                pk = np.where(gen[rows, k] == cur, perm[rows, k], k)
                perm[rows, j] = pk
                gen[rows, j] = cur
                perm[rows, k] = pj
                gen[rows, k] = cur
                np.minimum.at(self.h, pk, j + r)
                j += 1

    def finalize(self):
        pass

    def report(self) -> float:
        if not np.isfinite(self.h).any():
            return 0.0
        m = float(self.m)
        y = -np.log1p(-self.h / m).sum()
        return (m - 1.0) / y if y > 0 else 0.0

    cardinality_estimate = report

    def _regs_b(self) -> np.ndarray:
        if self.b >= 64:
            # the JAX package's mask (1 << b) - 1 overflows int64 here
            # and its compare dies with an OverflowError
            raise SystemExit(
                f"SuperMinHash sketches of b={self.b} cannot be compared: "
                "b-bit registers take b < 64; re-sketch with -B 8, 16 or 32")
        mask = (1 << self.b) - 1
        safe = np.where(np.isfinite(self.h), self.h, 0.0)
        return (safe * (1 << self.b)).astype(np.int64) & mask

    def jaccard_index(self, other: "SuperMinHash") -> float:
        if not (np.isfinite(self.h).any() and np.isfinite(other.h).any()):
            return 0.0
        f = float((self._regs_b() == other._regs_b()).mean())
        c = 2.0 ** -self.b
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "SuperMinHash"):
        return _triple_from_ji(self.jaccard_index(other), self.report(),
                               other.report())

    def union_size(self, other: "SuperMinHash") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def __iadd__(self, other: "SuperMinHash") -> "SuperMinHash":
        np.minimum(self.h, other.h, out=self.h)
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(np.where(np.isfinite(self.h), self.h, np.inf
                          ).astype("<f8").tobytes())

    def write(self, pf):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp) -> "SuperMinHash":
        p, b = _read_header(fp, cls.MAGIC, "SuperMinHash", "SuperMinHash")
        h = np.frombuffer(_read_exact(fp, 8 << p, "SMH registers"),
                          "<f8").astype(np.float64)
        return cls(p, b, h)

    @classmethod
    def read(cls, pf) -> "SuperMinHash":
        return _read_gz(pf, cls.read_record)


class DensifiedMinHash:
    """One-permutation MinHash with rotation densification (the
    DTPUSMH1 files of the --use-superminhash slot; b-bit registers)."""
    MAGIC = b"DTPUSMH1"
    EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

    def __init__(self, p: int, b: int = 16, mins: np.ndarray = None):
        self.p = int(p)
        self.b = int(b)
        self.mins = (np.full(1 << p, self.EMPTY, np.uint64) if mins is None
                     else np.asarray(mins, np.uint64))
        self._dense = None
        self._card = None

    @property
    def m(self) -> int:
        return 1 << self.p

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        val = hashes << np.uint64(self.p)
        np.minimum.at(self.mins, idx, val)
        self._dense = None
        self._card = None

    def finalize(self):
        self._densified()

    def _densified(self) -> np.ndarray:
        """An empty bucket borrows the minimum of the nearest filled
        bucket to its right, cyclically: the same rule on both sketches
        of a pair, so overlapping sets densify alike."""
        if self._dense is not None:
            return self._dense
        dense = self.mins.copy()
        empty = dense == self.EMPTY
        if empty.all():
            self._dense = dense
            return dense
        filled_idx = np.flatnonzero(~empty)
        nxt = np.searchsorted(filled_idx, np.arange(self.m))
        self._dense = dense[filled_idx[nxt % filled_idx.size]]
        return self._dense

    def report(self) -> float:
        if self._card is None:
            filled = self.mins != self.EMPTY
            self._card = poisson_min_cardinality(self.mins[filled], self.m)
        return self._card

    cardinality_estimate = report

    def _regs_b(self) -> np.ndarray:
        return self._densified() >> np.uint64(64 - self.b)

    def jaccard_index(self, other: "DensifiedMinHash") -> float:
        f = float((self._regs_b() == other._regs_b()).mean())
        c = 2.0 ** -self.b
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "DensifiedMinHash"):
        return _triple_from_ji(self.jaccard_index(other), self.report(),
                               other.report())

    def __iadd__(self, other: "DensifiedMinHash") -> "DensifiedMinHash":
        np.minimum(self.mins, other.mins, out=self.mins)
        self._dense = None
        self._card = None
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(self.mins.astype("<u8").tobytes())

    def write(self, pf):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp) -> "DensifiedMinHash":
        p, b = _read_header(fp, cls.MAGIC, "SMH", "SMH")
        mins = np.frombuffer(_read_exact(fp, 8 << p, "SMH buckets"),
                             "<u8").astype(np.uint64)
        return cls(p, b, mins)

    @classmethod
    def read(cls, pf) -> "DensifiedMinHash":
        return _read_gz(pf, cls.read_record)
