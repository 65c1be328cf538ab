"""The HLL sketch container (port of dashing_tpu/sketch/hll.py).

Registers live on the host as a (2^p,) uint8 numpy array.  What HLL
shares with the wide HLL of sketch/extra.py (its registers uint16, its
record its own) is their base class RegisterSketch.  The on-disk
record is the JAX package's, byte for byte: a gzip member holding
    magic b"DTPUHLL1" | u8 p | u8 estim | u8 jestim | u8 flags | u32 reserved
    | 2^p register bytes
so sketches carry across the two packages in both directions.
"""
from __future__ import annotations

import gzip
import struct
import sys
from typing import IO, Optional, Union

import numpy as np
import torch

from .. import device as devmod
from ..hashes import clz64_np, wang_hash_np
from ..ops.joint_stats import joint_pair_stats
from ..ops.pairwise import marginal_histograms
from ..ops.union_mle import estimate_rows
from . import estimators as est

MAGIC = b"DTPUHLL1"
_HEADER = struct.Struct("<8sBBBBI")


class RegisterSketch:
    """What the HLL and the wide HLL (sketch/extra.py) share: 2^p
    registers of one integer dtype (DTYPE) with HLL's bucket/rank
    semantics, so one estimator stack and one compare engine serve both.
    A subclass gives DTYPE, NAME (the `view` dump's heading) and its
    record format."""

    DTYPE = np.uint8
    NAME = "HLL"

    def __init__(self, p: int, estim: int = est.ERTL_MLE,
                 jestim: int = est.ERTL_MLE,
                 regs: Optional[np.ndarray] = None):
        self.p = int(p)
        self.estim = int(estim)
        self.jestim = int(jestim)
        self.regs = (np.zeros(1 << p, self.DTYPE) if regs is None
                     else np.asarray(regs, self.DTYPE))
        self._card: Optional[float] = None

    @property
    def m(self) -> int:
        return 1 << self.p

    @property
    def q(self) -> int:
        return 64 - self.p

    def clone_empty(self):
        return type(self)(self.p, self.estim, self.jestim)

    def clear(self):
        self.regs[:] = 0
        self._card = None

    def addh_np(self, values: np.ndarray):
        """WangHash raw 64-bit values and insert them (host)."""
        self.add_np(wang_hash_np(values))

    def add_np(self, hashes: np.ndarray):
        """Insert 64-bit hashes (host): bucket = the top p bits, rank =
        the leading zeros of the rest (a guard bit planted) plus one."""
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (hashes << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        rank = clz64_np(rest) + 1
        np.maximum.at(self.regs, idx, rank.astype(self.DTYPE))
        self._card = None

    def finalize(self):
        pass

    def _check_same_p(self, other: "RegisterSketch"):
        if other.p != self.p:
            raise ValueError(f"can't merge or compare HLLs of different p "
                             f"({self.p} vs {other.p}); fold the larger one "
                             "down first")

    def __iadd__(self, other):
        """Merge (register max) in place."""
        self._check_same_p(other)
        np.maximum(self.regs, other.regs, out=self.regs)
        self._card = None
        return self

    def union(self, other):
        self._check_same_p(other)
        return type(self)(self.p, self.estim, self.jestim,
                          np.maximum(self.regs, other.regs))

    def compress(self, new_p: int):
        """Fold exactly to a smaller precision (the `fold` subcommand).
        Dropping the lowest index bit merges buckets 2j and 2j+1 into j:
        the even bucket's suffix gains a leading 0 (rank + 1), the odd
        bucket's a leading 1 (rank 1 when nonempty)."""
        if new_p >= self.p:
            raise ValueError("compress requires new_p < p")
        regs = self.regs.astype(np.int32)
        for _ in range(self.p - new_p):
            lo, hi = regs[0::2], regs[1::2]
            regs = np.maximum(np.where(lo > 0, lo + 1, 0),
                              (hi > 0).astype(np.int32))
        return type(self)(new_p, self.estim, self.jestim,
                          regs.astype(self.DTYPE))

    def histogram(self) -> np.ndarray:
        return np.bincount(self.regs, minlength=self.q + 2).astype(np.float32)

    def report(self) -> float:
        """Cardinality estimate with this sketch's estimator (cached)."""
        if self._card is None:
            C = torch.from_numpy(self.histogram())[None]
            self._card = float(est.estimate(C, self.p, self.estim)[0])
        return self._card

    def union_size(self, other) -> float:
        """Cardinality of the union, with this sketch's estimator."""
        return self.union(other).report()

    def _regs_on(self, device: torch.device) -> torch.Tensor:
        """The registers as the kernels' int8 (a rank is at most 65 - p)."""
        return torch.from_numpy(self.regs.astype(np.int8)).to(device)

    def full_set_comparison(self, other,
                            device: Optional[torch.device] = None):
        """(|A\\B|, |B\\A|, |A&B|) against `other`: the joint MLE when
        this sketch's jestim selects it, else inclusion-exclusion on the
        three cardinalities with this sketch's estimator.  The joint form
        counts the pair's statistics by K4's joint form on a 1 x 1 tile
        over the full window [0, q+1], estimates the three cardinalities
        by the row-estimate kernel (the direct MLE) and solves by K5 given
        the union's.  `device` defaults to the CLI's (`device.from_env`:
        the card unless DASHING_TPU_TORCH_DEVICE says otherwise); on the
        CPU the kernels' plain versions run."""
        self._check_same_p(other)
        device = devmod.or_env(device)
        if self.jestim == est.ERTL_JOINT_MLE:
            a = self._regs_on(device)[None]
            b = other._regs_on(device)[None]
            K = self.q + 2
            st = joint_pair_stats(a, b, kmin=0, kmax=self.q + 1)
            stats = {key: st[key][:, 0, 0] for key in ("eq", "gt_a", "gt_b")}
            stats["hist_u"] = (stats["eq"] + stats["gt_a"]) + stats["gt_b"]
            stats["hist_a"] = marginal_histograms(a, 0, K)[0]
            stats["hist_b"] = marginal_histograms(b, 0, K)[0]
            tri = est.joint_mle(stats, self.p)
        else:
            hu = np.bincount(np.maximum(self.regs, other.regs),
                             minlength=self.q + 2).astype(np.float32)
            tri = est.union_triple_incl_excl(
                *(torch.from_numpy(h).to(device) for h in
                  (self.histogram(), other.histogram(), hu)),
                self.p, self.estim)
        return tuple(float(x) for x in tri.cpu())

    def jaccard_index(self, other,
                      device: Optional[torch.device] = None) -> float:
        a, b, x = self.full_set_comparison(other, device)
        denom = a + b + x
        return x / denom if denom > 0 else 0.0

    def containment_index(self, other,
                          device: Optional[torch.device] = None) -> float:
        a, _, x = self.full_set_comparison(other, device)
        denom = a + x
        return x / denom if denom > 0 else 0.0

    def intersection_size(self, other,
                          device: Optional[torch.device] = None) -> float:
        return self.full_set_comparison(other, device)[2]

    def printf(self, fp=None):
        """Human-readable register dump (the `view` subcommand)."""
        fp = fp or sys.stdout
        fp.write(f"{self.NAME} p={self.p} m={self.m} estim={self.estim} "
                 f"jestim={self.jestim}\n")
        for i in range(0, self.m, 32):
            row = " ".join(str(int(v)) for v in self.regs[i:i + 32])
            fp.write(f"{i}\t{row}\n")

    def write(self, path_or_fp: Union[str, IO[bytes]]):
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(path_or_fp)

    @classmethod
    def read(cls, path_or_fp: Union[str, IO[bytes]]):
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(path_or_fp)


class HLL(RegisterSketch):
    """HyperLogLog sketch with Ertl estimators."""

    def __init__(self, p: int, estim: int = est.ERTL_MLE,
                 jestim: int = est.ERTL_MLE,
                 regs: Optional[np.ndarray] = None):
        if not (4 <= p <= 32):
            raise ValueError(f"p={p} out of range [4, 32]")
        super().__init__(p, estim, jestim, regs)
        if self.regs.shape != (1 << p,):
            raise ValueError(f"registers {self.regs.shape} do not match p={p}")

    @classmethod
    def from_numpy(cls, regs: np.ndarray, p: int, estim: int = est.ERTL_MLE,
                   jestim: int = est.ERTL_MLE) -> "HLL":
        """Wrap existing registers (any integer dtype, clamped to 0..255)."""
        regs = np.clip(np.asarray(regs), 0, 255).astype(np.uint8)
        return cls(p, estim, jestim, regs)

    def write_record(self, fp: IO[bytes]):
        fp.write(_HEADER.pack(MAGIC, self.p, self.estim, self.jestim, 0, 0))
        fp.write(self.regs.tobytes())

    @classmethod
    def read_record(cls, fp: IO[bytes]) -> "HLL":
        hdr = fp.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            raise EOFError("truncated or missing HLL record")
        magic, p, estim, jestim, _flags, _res = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"bad HLL magic {magic!r}")
        data = fp.read(1 << p)
        if len(data) != 1 << p:
            raise EOFError("truncated HLL registers")
        return cls(p, estim, jestim, np.frombuffer(data, np.uint8).copy())


def ertl_joint(a: HLL, b: HLL, device: Optional[torch.device] = None):
    """The joint-MLE comparison of two sketches whatever their jestim (the
    free function of the JAX package): (|A\\B|, |B\\A|, |A&B|)."""
    old = a.jestim
    try:
        a.jestim = est.ERTL_JOINT_MLE
        return a.full_set_comparison(b, device)
    finally:
        a.jestim = old


def batch_reports(sketches, device: torch.device) -> None:
    """Prime every sketch's cached cardinality with one batched estimate
    per (p, estimator) group over the stacked histograms, on `device`
    (the row-estimate kernel of ops/union_mle.py on a card)."""
    groups = {}
    for i, sk in enumerate(sketches):
        if sk._card is None:
            groups.setdefault((sk.p, sk.estim), []).append(i)
    for (p, method), idxs in groups.items():
        hists = torch.from_numpy(np.stack([sketches[i].histogram()
                                           for i in idxs])).to(device)
        cards = estimate_rows(hists, p=p, kmin=0, method=method,
                              iters=est.FULL_MLE_ITERS).cpu().numpy()
        for i, c in zip(idxs, cards):
            sketches[i]._card = float(c)
