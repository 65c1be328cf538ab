"""HeavyKeeper frequency filter (Gong et al., USENIX ATC 2018; port of
dashing_tpu/sketch/heavykeeper.py).

DASHING_TPU_USE_HK=1 routes the count filter of `sketch -b/-f` and
`dist -y` (admit a k-mer once its count reaches the threshold) through
this structure instead of the device count-min sketch
(pipeline._count_filtered_tiles), as the reference does when built with
-DDASHING_USE_HK.

Insertion order matters to HeavyKeeper (each decay decision reads the
running slot state and draws from one xorshift stream), so it is a host
structure: the native C++ of dashing_tpu_torch/native/hk.cpp, with a
pure-Python form, bit for bit the same, where the native library cannot
be built.  Seeded from -R/--seed.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np

from ..hashes import wang_hash_np
from ..io import native as _native


class HeavyKeeper:
    """nrows x 2^size_log2 slots of (uint16 fingerprint, uint32 count);
    query = the largest count of a matching fingerprint over the rows (0
    if unseen or evicted).  It undercounts light keys by design, which
    suits a min-count abundance filter."""

    def __init__(self, nrows: int, size_log2: int, seed: int = 1337,
                 decay_base: float = 1.08, force_python: bool = False):
        # at most 2^27 slots (1 GiB at 8 B a slot): the native create()
        # fills its table at once, so an absurd -t would write tens of GB
        self.nrows = min(max(int(nrows), 1), 64)
        self.size_log2 = min(max(int(size_log2), 1), 30)
        while self.nrows << self.size_log2 > (1 << 27) and self.size_log2 > 1:
            self.size_log2 -= 1
        if (self.nrows, self.size_log2) != (int(nrows), int(size_log2)):
            print(f"note: HeavyKeeper geometry clamped to nrows="
                  f"{self.nrows}, size_log2={self.size_log2}",
                  file=sys.stderr)
        self.seed = np.uint64(seed)
        self.base = float(decay_base)
        self._lib = None
        self._handle = None
        if not force_python:
            lib = _native._load()
            if lib is not None:
                handle = lib.dtpu_hk_create(
                    self.nrows, self.size_log2, int(self.seed), self.base)
                if handle:
                    self._lib, self._handle = lib, handle
            if self._lib is None:
                print(f"note: native HeavyKeeper unavailable or geometry "
                      f"rejected (nrows={self.nrows}, "
                      f"size_log2={self.size_log2}); using the slow "
                      f"pure-Python fallback", file=sys.stderr)
        if self._lib is None:
            m = 1 << self.size_log2
            self._fps = np.zeros((self.nrows, m), np.uint16)
            self._cnts = np.zeros((self.nrows, m), np.uint32)
            self._rng = np.uint64(self._wang(self.seed | np.uint64(1)))

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.dtpu_hk_destroy(self._handle)
            self._handle = None

    # --- the pure-Python form (native/hk.cpp's layout and hashes) ---

    @staticmethod
    def _wang(k: np.uint64) -> np.uint64:
        return wang_hash_np(np.asarray([k], np.uint64))[0]

    def _batch_idx(self, keys: np.ndarray) -> np.ndarray:
        """(nrows, n) slot indices; independent a key, so batched."""
        mask = np.uint64((1 << self.size_log2) - 1)
        rows = []
        for r in range(self.nrows):
            # Python-int arithmetic, wrapped to 64 bits as the C++ wraps
            s = np.uint64((int(self.seed) + r * 0x9E3779B97F4A7C15)
                          & 0xFFFFFFFFFFFFFFFF)
            rows.append((wang_hash_np(keys ^ s) & mask).astype(np.int64))
        return np.stack(rows)

    def _batch_fp(self, keys: np.ndarray) -> np.ndarray:
        s = np.uint64((int(self.seed) * 0xA24BAED4963EE407 + 1)
                      & 0xFFFFFFFFFFFFFFFF)
        return (wang_hash_np(keys ^ s) >> np.uint64(48)).astype(np.uint16)

    def _next_u01(self) -> float:
        s = int(self._rng)
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        self._rng = np.uint64(s)
        return (s >> 11) * 2.0 ** -53

    def add_np(self, keys: np.ndarray):
        keys = np.ascontiguousarray(keys, np.uint64)
        if keys.size == 0:
            return
        if self._lib is not None:
            self._lib.dtpu_hk_add(
                self._handle,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                keys.size)
            return
        # the hashes are independent a key (batched); only the decay
        # recurrence walks the keys in order
        fps = self._batch_fp(keys)
        idxs = self._batch_idx(keys)
        for j in range(keys.size):
            fp = fps[j]
            for r in range(self.nrows):
                i = idxs[r, j]
                if self._cnts[r, i] == 0:
                    self._fps[r, i], self._cnts[r, i] = fp, 1
                elif self._fps[r, i] == fp:
                    if self._cnts[r, i] != 0xFFFFFFFF:
                        self._cnts[r, i] += 1
                elif self._cnts[r, i] < 1024 and \
                        self._next_u01() < self.base ** -float(
                            self._cnts[r, i]):
                    # native/hk.cpp draws nothing at counts >= 1024 (decay
                    # probability below 4e-35 there): the same cutoff
                    # keeps the two xorshift streams in lockstep
                    self._cnts[r, i] -= 1
                    if self._cnts[r, i] == 0:
                        self._fps[r, i], self._cnts[r, i] = fp, 1

    def query_np(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros(keys.size, np.uint32)
        if keys.size == 0:
            return out
        if self._lib is not None:
            self._lib.dtpu_hk_query(
                self._handle,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                keys.size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            return out
        # a query reads the slots only: every key at once
        fps = self._batch_fp(keys)
        idxs = self._batch_idx(keys)
        for r in range(self.nrows):
            slot_fp = self._fps[r, idxs[r]]
            slot_c = self._cnts[r, idxs[r]]
            np.maximum(out, np.where(slot_fp == fps, slot_c, 0), out=out)
        return out

    @property
    def native(self) -> bool:
        return self._lib is not None
