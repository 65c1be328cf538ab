"""Exact k-mer hash sets (--use-full-khash-sets; port of
dashing_tpu/sketch/khset.py, numpy on the host as there).

A set is its sorted uint64 keys: raw k-mer codes, or a weighted sketch's
labelled 64-bit elements.  Both use the top bit, so the keys stay numpy
uint64 (an int64 sort would order them sign first).  A pair compares by
one sorted intersection.  The sets are dashing's ground truth for every
probabilistic sketch.

File format (the reference's khset64, no magic): a gzip stream of
u64 n_keys | n_keys * u64 keys, sorted, little-endian.
"""
from __future__ import annotations

import gzip
import struct
from typing import IO, Tuple, Union

import numpy as np


class KSet:
    def __init__(self, keys: np.ndarray = None):
        # sorted and unique from the start: full_set_comparison intersects
        # with assume_unique=True, so a duplicate key would give JI > 1
        self.keys = (np.zeros(0, np.uint64) if keys is None
                     else np.unique(np.asarray(keys, np.uint64)))

    @classmethod
    def from_values(cls, values: np.ndarray) -> "KSet":
        return cls(values)

    def addh_np(self, values: np.ndarray):
        self.keys = np.union1d(self.keys, np.asarray(values, np.uint64))

    add_np = addh_np

    def finalize(self):
        self.keys = np.unique(self.keys)

    # -- set algebra ---------------------------------------------------------
    def cardinality_estimate(self) -> float:
        return float(self.keys.size)

    report = cardinality_estimate

    def full_set_comparison(self, other: "KSet") -> Tuple[float, float, float]:
        inter = np.intersect1d(self.keys, other.keys, assume_unique=True).size
        return (float(self.keys.size - inter), float(other.keys.size - inter),
                float(inter))

    def jaccard_index(self, other: "KSet") -> float:
        a, b, x = self.full_set_comparison(other)
        denom = a + b + x
        return x / denom if denom else 0.0

    def containment_index(self, other: "KSet") -> float:
        a, _, x = self.full_set_comparison(other)
        return x / (a + x) if (a + x) else 0.0

    def union_size(self, other: "KSet") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def intersection_size(self, other: "KSet") -> float:
        return self.full_set_comparison(other)[2]

    def union(self, other: "KSet") -> "KSet":
        return KSet(np.union1d(self.keys, other.keys))

    def __iadd__(self, other: "KSet") -> "KSet":
        # a real union (`union -H`); the reference's operator+= throws
        self.keys = np.union1d(self.keys, other.keys)
        return self

    # -- io -------------------------------------------------------------------
    def write_record(self, fp: IO[bytes]):
        keys = np.unique(self.keys)
        fp.write(struct.pack("<Q", keys.size))
        fp.write(keys.astype("<u8").tobytes())

    def write(self, path_or_fp: Union[str, IO[bytes]]):
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(path_or_fp)

    @classmethod
    def read_record(cls, fp: IO[bytes]) -> "KSet":
        hdr = fp.read(8)
        if len(hdr) < 8:
            raise EOFError("truncated khset header")
        (n,) = struct.unpack("<Q", hdr)
        data = fp.read(8 * n)
        if len(data) != 8 * n:
            raise EOFError("truncated khset keys")
        # unique, not only sorted: a foreign file may repeat a key
        return cls(np.frombuffer(data, "<u8").astype(np.uint64))

    @classmethod
    def read(cls, path_or_fp: Union[str, IO[bytes]]) -> "KSet":
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(path_or_fp)
