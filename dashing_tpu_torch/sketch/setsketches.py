"""The Bloom filter, bottom-k and b-bit MinHash families (port of
dashing_tpu/sketch/setsketches.py): the JAX CLI's non-HLL sketch types
`bf`, `rmh`, `crmh`, `bbmh` and `cbbmh`, and the type registry
(make_typed, build_typed, read_typed) of those and of sketch/extra.py's,
on the host in numpy, with the
JAX package's classes, public attributes, arithmetic and byte formats
(each a gzip member of an 8-byte magic, two little-endian u32 fields and
the payload), so a sketch file carries across the two packages and
`view` prints the same dump.

Size mapping from the single -S (log2 bytes) knob (`make_typed`):
    BF    : 2^(S+3) bits
    RMH   : 2^(S-3) minimizers (8 bytes each)
    CRMH  : 2^S / 12 entries (8B key + 4B count)
    BBMH  : p = S - log2(bbits/8) buckets exponent
    WHLL  : p = S (uint16 registers)
    HMH   : p = S - {8: 0, 16: 1, 32: 2, 64: 3}[regwidth]
    SMH   : p = S - log2(b/8)

`build_typed` takes the device routes where the JAX package has one
(pipeline.sketch_file_bbmh_mins, sketch_file_bottomk_values) and else
inserts the file's raw k-mers on the host (`sketch_of_values`, which
also builds the exact k-mer hash sets of sketch/khset.py).  The wide HLL,
HyperMinHash and SuperMinHash classes are in sketch/extra.py.
"""
from __future__ import annotations

import gzip
import math
import struct
from typing import IO, Tuple, Union

import numpy as np

from .. import metrics
from ..hashes import poisson_min_cardinality, seeded_wang_hash_np, \
    wang_hash_np

_HDR = struct.Struct("<8sII")


def _write_gz(path_or_fp, fn):
    if isinstance(path_or_fp, str):
        with gzip.open(path_or_fp, "wb") as fp:
            fn(fp)
    else:
        fn(path_or_fp)


def _read_gz(path_or_fp, fn):
    if isinstance(path_or_fp, str):
        with gzip.open(path_or_fp, "rb") as fp:
            return fn(fp)
    return fn(path_or_fp)


def _read_exact(fp, nbytes: int, what: str) -> bytes:
    data = fp.read(nbytes)
    if len(data) != nbytes:
        raise EOFError(f"truncated {what}: wanted {nbytes} payload bytes, "
                       f"got {len(data)}")
    return data


def _expect_magic(fp, magic: bytes):
    hdr = fp.read(_HDR.size)
    if len(hdr) < _HDR.size:
        raise EOFError("truncated sketch record")
    got, a, b = _HDR.unpack(hdr)
    if got != magic:
        raise ValueError(f"bad sketch magic {got!r}, wanted {magic!r}")
    return a, b


def _triple_from_ji(ji: float, ca: float, cb: float
                    ) -> "Tuple[float, float, float]":
    """(onlyA, onlyB, shared) from a Jaccard estimate and two
    cardinalities via the (ca+cb)/(1+ji) union estimate: the shared tail
    of every minhash-family full_set_comparison (reference
    src/dashing.h:554-556)."""
    cu = (ca + cb) / (1.0 + ji)
    shared = ji * cu
    return (max(ca - shared, 0.0), max(cb - shared, 0.0), shared)


class BloomFilter:
    """bf::bf_t replacement: m bits, nh seeded hash functions.

    Jaccard via fill-ratio cardinality estimates on A, B and A|B
    (the BF-Jaccard construction the reference cites, README.md:132).
    """
    MAGIC = b"DTPUBF01"

    def __init__(self, nbits_log2: int, nhashes: int = 1,
                 bits: np.ndarray = None):
        self.nbits_log2 = int(nbits_log2)
        self.nhashes = int(nhashes)
        nwords = (1 << nbits_log2) // 64 or 1
        self.bits = (np.zeros(nwords, np.uint64) if bits is None
                     else np.asarray(bits, np.uint64))

    @property
    def m(self) -> int:
        return 1 << self.nbits_log2

    def addh_np(self, values: np.ndarray):
        values = np.asarray(values, np.uint64)
        for i in range(self.nhashes):
            h = seeded_wang_hash_np(values, 0xA5A5_0000 + i)
            pos = (h >> np.uint64(64 - self.nbits_log2)).astype(np.int64)
            word, bit = pos >> 6, pos & 63
            np.bitwise_or.at(self.bits, word,
                             np.uint64(1) << bit.astype(np.uint64))

    add_np = addh_np

    def finalize(self):
        pass

    def _popcount(self, words: np.ndarray) -> int:
        return int(np.unpackbits(words.view(np.uint8)).sum())

    def _card_from_fill(self, set_bits: int) -> float:
        m, k = float(self.m), float(self.nhashes)
        if set_bits >= self.m:
            return float("inf")
        return -(m / k) * math.log1p(-set_bits / m)

    def report(self) -> float:
        return self._card_from_fill(self._popcount(self.bits))

    cardinality_estimate = report

    def union_size(self, other: "BloomFilter") -> float:
        return self._card_from_fill(self._popcount(self.bits | other.bits))

    def full_set_comparison(self, other: "BloomFilter") -> Tuple[float, float, float]:
        ca, cb = self.report(), other.report()
        cu = self.union_size(other)
        shared = max(0.0, ca + cb - cu)
        return (max(ca - shared, 0.0), max(cb - shared, 0.0), shared)

    def jaccard_index(self, other: "BloomFilter") -> float:
        a, b, x = self.full_set_comparison(other)
        denom = a + b + x
        return x / denom if denom else 0.0

    def __iadd__(self, other: "BloomFilter") -> "BloomFilter":
        self.bits |= other.bits
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.nbits_log2, self.nhashes))
        fp.write(self.bits.astype("<u8").tobytes())

    def write(self, pf: Union[str, IO[bytes]]):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp: IO[bytes]) -> "BloomFilter":
        nbl2, nh = _expect_magic(fp, cls.MAGIC)
        nwords = (1 << nbl2) // 64 or 1
        data = _read_exact(fp, 8 * nwords, "bloom filter")
        return cls(nbl2, nh, np.frombuffer(data, "<u8").astype(np.uint64))

    @classmethod
    def read(cls, pf) -> "BloomFilter":
        return _read_gz(pf, cls.read_record)


class BottomK:
    """Bottom-k (KMV) MinHash == mh::RangeMinHash / BKHash64.

    Stores the k smallest distinct WangHash values.  Jaccard by the standard
    KMV merge estimate; cardinality by the (k-1)/max-normalized-value KMV
    estimator.
    """
    MAGIC = b"DTPURMH1"

    def __init__(self, kk: int, values: np.ndarray = None):
        self.kk = int(kk)
        self.values = (np.zeros(0, np.uint64) if values is None
                       else np.asarray(values, np.uint64))

    def addh_np(self, raw: np.ndarray):
        h = wang_hash_np(np.asarray(raw, np.uint64))
        self.add_np(h)

    def add_np(self, hashes: np.ndarray):
        merged = np.union1d(self.values, np.asarray(hashes, np.uint64))
        self.values = merged[:self.kk]

    def finalize(self):
        self.values = np.unique(self.values)[:self.kk]

    def report(self) -> float:
        n = self.values.size
        if n < self.kk:
            return float(n)
        vmax = float(self.values[-1])
        return (n - 1) * (2.0 ** 64) / max(vmax, 1.0)

    cardinality_estimate = report

    def jaccard_index(self, other: "BottomK") -> float:
        union = np.union1d(self.values, other.values)[:self.kk]
        if union.size == 0:
            return 0.0
        in_both = np.intersect1d(self.values, other.values, assume_unique=True)
        shared = np.intersect1d(union, in_both, assume_unique=True).size
        return shared / union.size

    def full_set_comparison(self, other: "BottomK") -> Tuple[float, float, float]:
        ji = self.jaccard_index(other)
        return _triple_from_ji(ji, self.report(), other.report())

    def union_size(self, other: "BottomK") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def intersection_size(self, other: "BottomK") -> float:
        return self.full_set_comparison(other)[2]

    def __iadd__(self, other: "BottomK") -> "BottomK":
        self.add_np(other.values)
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.kk, self.values.size))
        fp.write(self.values.astype("<u8").tobytes())

    def write(self, pf):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp) -> "BottomK":
        kk, n = _expect_magic(fp, cls.MAGIC)
        vals = np.frombuffer(_read_exact(fp, 8 * n, "minhash values"),
                             "<u8").astype(np.uint64)
        return cls(kk, vals)

    @classmethod
    def read(cls, pf) -> "BottomK":
        return _read_gz(pf, cls.read_record)


class CountingBottomK(BottomK):
    """mh::CountingRangeMinHash: bottom-k values with multiplicities;
    similarity = histogram intersection (reference src/dashing.h:142-144)."""
    MAGIC = b"DTPUCRM1"

    def __init__(self, kk: int, values: np.ndarray = None,
                 counts: np.ndarray = None):
        super().__init__(kk, values)
        self.counts = (np.zeros(0, np.uint32) if counts is None
                       else np.asarray(counts, np.uint32))

    def addh_np(self, raw: np.ndarray):
        h = wang_hash_np(np.asarray(raw, np.uint64))
        vals, cnts = np.unique(h, return_counts=True)
        self._merge(vals, cnts)

    def finalize(self):
        pass

    def histogram_intersection(self, other: "CountingBottomK") -> float:
        union = np.union1d(self.values, other.values)[:self.kk]
        ca = dict(zip(self.values.tolist(), self.counts.tolist()))
        cb = dict(zip(other.values.tolist(), other.counts.tolist()))
        num = den = 0
        for v in union.tolist():
            x, y = ca.get(v, 0), cb.get(v, 0)
            num += min(x, y)
            den += max(x, y)
        return num / den if den else 0.0

    # similarity<CRMFinal> = histogram_intersection (reference dashing.h:142)
    def jaccard_index(self, other: "CountingBottomK") -> float:
        return self.histogram_intersection(other)

    def add_np(self, hashes: np.ndarray):
        # BottomK.add_np would update values without counts; route through
        # the counting insert (each hash counts once)
        self._merge(np.asarray(hashes, np.uint64),
                    np.ones(len(hashes), np.int64))

    def _merge(self, vals: np.ndarray, cnts: np.ndarray):
        allv = np.concatenate([self.values, vals])
        allc = np.concatenate([self.counts.astype(np.int64), cnts])
        uniq, inv = np.unique(allv, return_inverse=True)
        summed = np.zeros(uniq.size, np.int64)
        np.add.at(summed, inv, allc)
        self.values = uniq[:self.kk]
        # saturate instead of wrapping at 2^32 (the same deliberate
        # policy as CountingBBitMinHash's COUNT_MAX clamps)
        self.counts = np.minimum(summed[:self.kk],
                                 0xFFFFFFFF).astype(np.uint32)

    def __iadd__(self, other: "CountingBottomK") -> "CountingBottomK":
        self._merge(np.asarray(other.values, np.uint64),
                    np.asarray(other.counts, np.int64))
        return self

    def full_set_comparison(self, other):
        # triple built so shared/union == histogram_intersection: every
        # emitted measure then derives from the WEIGHTED Jaccard, matching
        # similarity<CRMFinal> (reference src/dashing.h:142-144)
        ji = self.histogram_intersection(other)
        return _triple_from_ji(ji, self.report(), other.report())

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.kk, self.values.size))
        fp.write(self.values.astype("<u8").tobytes())
        fp.write(self.counts.astype("<u4").tobytes())

    @classmethod
    def read_record(cls, fp) -> "CountingBottomK":
        kk, n = _expect_magic(fp, cls.MAGIC)
        vals = np.frombuffer(_read_exact(fp, 8 * n, "minhash values"),
                             "<u8").astype(np.uint64)
        cnts = np.frombuffer(_read_exact(fp, 4 * n, "minhash counts"),
                             "<u4").astype(np.uint32)
        return cls(kk, vals, cnts)


class BBitMinHash:
    """One-permutation b-bit MinHash (mh::BBitMinHasher / FinalBBitMinHash).

    2^p buckets; each keeps the min WangHash value of the elements that land
    in it; finalization truncates to the low b bits.  Jaccard from the
    matched-register fraction with the Li & Koenig collision correction;
    cardinality (est_cardinality_, reference src/dashing.h:493) estimated
    HLL-style from the bucket minima before truncation.
    """
    MAGIC = b"DTPUBBM1"
    EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

    def __init__(self, p: int, b: int = 16, mins: np.ndarray = None,
                 est_card: float = 0.0):
        self.p = int(p)
        self.b = int(b)
        self.mins = (np.full(1 << p, self.EMPTY, np.uint64) if mins is None
                     else np.asarray(mins, np.uint64))
        self.est_cardinality_ = float(est_card)
        self._finalized = mins is not None and est_card > 0.0

    @property
    def m(self) -> int:
        return 1 << self.p

    def addh_np(self, raw: np.ndarray):
        h = wang_hash_np(np.asarray(raw, np.uint64))
        self.add_np(h)

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        # bucket value: the remaining bits (so values are uniform in bucket)
        val = hashes << np.uint64(self.p)
        np.minimum.at(self.mins, idx, val)
        self._finalized = False   # inserts invalidate the cached cardinality

    def finalize(self):
        if self._finalized:
            return
        filled = self.mins != self.EMPTY
        # per-bucket min of N ~ Poisson(lambda) uniforms: invert E[min]
        self.est_cardinality_ = poisson_min_cardinality(
            self.mins[filled], self.m)
        self._finalized = True

    def _regs_b(self) -> np.ndarray:
        shift = np.uint64(64 - self.b)
        return (self.mins >> shift).astype(np.uint64)

    def report(self) -> float:
        self.finalize()
        return self.est_cardinality_

    cardinality_estimate = report

    def jaccard_index(self, other: "BBitMinHash") -> float:
        if self.p != other.p or self.b != other.b:
            raise ValueError(
                f"can't compare b-bit minhash sketches of different "
                f"geometry (p={self.p},b={self.b}) vs "
                f"(p={other.p},b={other.b})")
        # mutually-EMPTY buckets compare equal (both all-ones) but carry no
        # evidence — counting them would report JI ~1 for two tiny disjoint
        # sets; exclude them (a single-empty bucket is a true mismatch)
        occupied = (self.mins != self.EMPTY) | (other.mins != other.EMPTY)
        nocc = int(occupied.sum())
        if nocc == 0:
            return 0.0
        eq = (self._regs_b() == other._regs_b()) & occupied
        f = float(eq.sum()) / nocc
        c = 2.0 ** -self.b
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "BBitMinHash") -> Tuple[float, float, float]:
        ji = self.jaccard_index(other)
        return _triple_from_ji(ji, self.report(), other.report())

    def union_size(self, other: "BBitMinHash") -> float:
        """reference src/dashing.h:554-556: (ca+cb)/(1+ji)."""
        return (self.report() + other.report()) / (1.0 + self.jaccard_index(other))

    def __iadd__(self, other: "BBitMinHash") -> "BBitMinHash":
        np.minimum(self.mins, other.mins, out=self.mins)
        self._finalized = False
        return self

    def write_record(self, fp: IO[bytes]):
        self.finalize()
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(struct.pack("<d", self.est_cardinality_))
        fp.write(self.mins.astype("<u8").tobytes())

    def write(self, pf):
        _write_gz(pf, self.write_record)

    @classmethod
    def read_record(cls, fp) -> "BBitMinHash":
        p, b = _expect_magic(fp, cls.MAGIC)
        (card,) = struct.unpack("<d", _read_exact(fp, 8, "bbmh header"))
        mins = np.frombuffer(_read_exact(fp, 8 * (1 << p), "bbmh buckets"),
                             "<u8").astype(np.uint64)
        return cls(p, b, mins, card)

    @classmethod
    def read(cls, pf) -> "BBitMinHash":
        return _read_gz(pf, cls.read_record)


class CountingBBitMinHash(BBitMinHash):
    """mh::CountingBBitMinHasher<uint64_t, uint16_t> (CBBMinHashType,
    reference src/dashing.h:218).

    The reference registers this type end-to-end — enum COUNTING_BB_MINHASH
    (src/dashing.h:231), cache suffix `.cbmh` (:358), FinalSketch/SketchEnum
    overloads (:315,411) and a sketch_core instantiation stub
    (src/sketchcorecbbmh.cpp) — but ships the stub commented out and no
    subcommand dispatches it, so it is unreachable from the reference CLI.
    Both packages run it behind `--use-counting-bb-minhash`.

    Semantics: one-permutation b-bit minhash whose buckets additionally
    carry the multiplicity of the bucket's minimum element, saturating at
    uint16 (the reference's CountType — "Is counting to 65536 enough for a
    transcriptome?", src/dashing.h:218).  Similarity is the histogram
    intersection over bucket minima — matched b-bit registers contribute
    min/max of the two multiplicities, mismatched ones put both
    multiplicities in the union — the counting analog of
    similarity<CRMFinal> (reference src/dashing.h:142-144), which this
    mirrors exactly as CountingBottomK does for bottom-k.
    """
    MAGIC = b"DTPUCBB1"
    COUNT_MAX = 0xFFFF

    def __init__(self, p: int, b: int = 16, mins: np.ndarray = None,
                 est_card: float = 0.0, counts: np.ndarray = None):
        super().__init__(p, b, mins, est_card)
        self.counts = (np.zeros(1 << self.p, np.uint32) if counts is None
                       else np.asarray(counts, np.uint32))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        if hashes.size == 0:
            return
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        val = hashes << np.uint64(self.p)
        # group (bucket, value): runs are contiguous after the lexsort, so
        # the first run of each bucket is its minimum and the run length is
        # that minimum's multiplicity — one pass, order-invariant
        order = np.lexsort((val, idx))
        si, sv = idx[order], val[order]
        first = np.ones(si.size, bool)
        first[1:] = (si[1:] != si[:-1]) | (sv[1:] != sv[:-1])
        starts = np.flatnonzero(first)
        run_len = np.diff(np.append(starts, si.size))
        uidx, uval = si[first], sv[first]
        bucket_first = np.ones(uidx.size, bool)
        bucket_first[1:] = uidx[1:] != uidx[:-1]
        self._merge_minima(uidx[bucket_first], uval[bucket_first],
                           run_len[bucket_first])

    def _merge_minima(self, bi: np.ndarray, bv: np.ndarray, bc: np.ndarray):
        """Merge per-bucket (min value, multiplicity) candidates; `bi` must
        be unique (one candidate per bucket)."""
        cur = self.mins[bi]
        less, eqs = bv < cur, bv == cur
        li, ei = bi[less], bi[eqs]
        self.mins[li] = bv[less]
        self.counts[li] = np.minimum(bc[less], self.COUNT_MAX)
        self.counts[ei] = np.minimum(
            self.counts[ei].astype(np.int64) + bc[eqs], self.COUNT_MAX
        ).astype(np.uint32)
        self._finalized = False

    def __iadd__(self, other: "CountingBBitMinHash") -> "CountingBBitMinHash":
        less = other.mins < self.mins
        eqs = (other.mins == self.mins) & (self.mins != self.EMPTY)
        merged = np.where(less, other.counts, self.counts).astype(np.int64)
        merged[eqs] = np.minimum(
            self.counts[eqs].astype(np.int64) + other.counts[eqs],
            self.COUNT_MAX)
        self.counts = merged.astype(np.uint32)
        np.minimum(self.mins, other.mins, out=self.mins)
        self._finalized = False
        return self

    def histogram_intersection(self, other: "CountingBBitMinHash") -> float:
        """Ratio estimator of the multiset weighted Jaccard
        sum_e min(a_e, b_e) / sum_e max(a_e, b_e).

        Each occupied bucket samples one element of the UNION support (the
        bucket's combined minimum).  If the b-bit registers match, that
        element is shared: it contributes min/max of the two
        multiplicities.  If they differ, the sampled element lives only in
        the sketch holding the smaller minimum, and only ITS multiplicity
        enters the union sum (unit multiplicities then reduce exactly to
        the one-permutation set-Jaccard match fraction)."""
        occa = self.mins != self.EMPTY
        occb = other.mins != other.EMPTY
        eq = (self._regs_b() == other._regs_b()) & occa & occb
        ca = self.counts.astype(np.int64)
        cb = other.counts.astype(np.int64)
        num = int(np.minimum(ca, cb)[eq].sum())
        # unoccupied buckets hold mins == EMPTY (loses every <) and count 0
        argmin_cnt = np.where(self.mins < other.mins, ca,
                              np.where(other.mins < self.mins, cb,
                                       np.maximum(ca, cb)))
        den = int(np.where(eq, np.maximum(ca, cb), argmin_cnt).sum())
        return num / den if den else 0.0

    # similarity<counting final> = histogram intersection, the CRMFinal
    # precedent (reference src/dashing.h:142-144)
    def jaccard_index(self, other: "CountingBBitMinHash") -> float:
        return self.histogram_intersection(other)

    def full_set_comparison(self, other) -> Tuple[float, float, float]:
        ji = self.histogram_intersection(other)
        return _triple_from_ji(ji, self.report(), other.report())

    def write_record(self, fp: IO[bytes]):
        self.finalize()
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(struct.pack("<d", self.est_cardinality_))
        fp.write(self.mins.astype("<u8").tobytes())
        fp.write(self.counts.astype("<u2").tobytes())

    @classmethod
    def read_record(cls, fp) -> "CountingBBitMinHash":
        p, b = _expect_magic(fp, cls.MAGIC)
        (card,) = struct.unpack("<d", _read_exact(fp, 8, "cbbmh header"))
        m = 1 << p
        mins = np.frombuffer(_read_exact(fp, 8 * m, "cbbmh buckets"),
                             "<u8").astype(np.uint64)
        cnts = np.frombuffer(_read_exact(fp, 2 * m, "cbbmh counts"),
                             "<u2").astype(np.uint32)
        return cls(p, b, mins, card, cnts)


# ---------------------------------------------------------------------------
# Type registry used by the CLI.
# ---------------------------------------------------------------------------

def make_typed(sketch_type: str, opts):
    """Empty sketch of the requested type sized from -S (bytesl2_to_arg)."""
    from .extra import HyperMinHash, SuperMinHash, WideHLL
    S = opts.sketch_size
    if sketch_type == "bf":
        return BloomFilter(S + 3, max(opts.nhashes, 1))
    if sketch_type == "rmh":
        return BottomK(1 << max(S - 3, 1))
    if sketch_type == "crmh":
        return CountingBottomK(max(int((1 << S) / 12), 1))
    if sketch_type in ("bbmh", "cbbmh", "superminhash"):
        # the counting form is sized like bbmh: it keeps u64 minima too
        p = S - int(math.floor(math.log2(max(opts.bbnbits // 8, 1))))
        cls = {"bbmh": BBitMinHash, "cbbmh": CountingBBitMinHash,
               "superminhash": SuperMinHash}[sketch_type]
        return cls(max(p, 4), opts.bbnbits)
    if sketch_type == "wide_hll":
        return WideHLL(S, opts.estim, opts.jestim)
    if sketch_type == "hmh":
        # the register-size table of the reference's sketch_and_cmp.h
        shift = {8: 0, 16: 1, 32: 2, 64: 3}.get(opts.bbnbits, 1)
        return HyperMinHash(max(S - shift, 4), opts.bbnbits)
    raise SystemExit(f"Sketch {sketch_type} not yet supported.")


def sketch_of_values(sketch_type: str, opts, values: np.ndarray):
    """The sketch of the requested type holding `values` (raw k-mers, or
    a weighted sketch's labelled elements): an exact k-mer hash set of
    them (KSet.from_values), or an empty sketch (make_typed) that inserts
    them and is finalised.  Each type hashes them as its addh_np does."""
    if sketch_type == "khset":
        from .khset import KSet
        return KSet.from_values(values)
    sk = make_typed(sketch_type, opts)
    sk.addh_np(values)
    sk.finalize()
    return sk


def build_typed(sketch_type: str, path: str, opts, params, device,
                tiles=None):
    """One path's sketch of a set-sketch type.  The b-bit minima and the
    bottom-k values are made on `device` (only the finished bank is
    pulled); the other types (the exact k-mer hash set, the wide HLL's
    host route; the CLI builds the wide HLL by the HLL engine), and a
    count-min filtered file, insert the path's raw k-mers on the host
    (sketch_of_values, metrics bucket `sketch.host_insert`).
    `tiles()`, if given, yields the path's tiles (a prefetched parse)."""
    from .. import pipeline
    if sketch_type == "bbmh":
        sk = make_typed(sketch_type, opts)
        mins = pipeline.sketch_file_bbmh_mins(path, params, sk.p, device,
                                              tiles)
        if mins is not None:
            sk.mins = mins
            sk.finalize()
            return sk
    if sketch_type == "rmh":
        sk = make_typed(sketch_type, opts)
        vals = pipeline.sketch_file_bottomk_values(path, params, sk.kk,
                                                   device, tiles)
        if vals is not None:
            sk.values = vals
            sk.finalize()
            return sk
    raw = pipeline.file_raw_kmers(path, params, device, tiles)
    with metrics.accum("sketch.host_insert", items=raw.size):
        return sketch_of_values(sketch_type, opts, raw)


TYPES = {"bf": BloomFilter, "rmh": BottomK, "crmh": CountingBottomK,
         "bbmh": BBitMinHash, "cbbmh": CountingBBitMinHash}


def read_typed(path, sketch_type: str):
    from .extra import DensifiedMinHash, HyperMinHash, SuperMinHash, \
        WideHLL
    from .khset import KSet
    if sketch_type == "superminhash":
        # SuperMinHash files are DTPUSMH2; older ones hold the densified
        # MinHash (DTPUSMH1)
        try:
            return SuperMinHash.read(path)
        except ValueError:
            return DensifiedMinHash.read(path)
    cls = dict(TYPES, wide_hll=WideHLL, hmh=HyperMinHash,
               khset=KSet).get(sketch_type)
    if cls is None:
        raise SystemExit(f"Sketch {sketch_type} not yet supported.")
    return cls.read(path)
