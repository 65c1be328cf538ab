"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at edge shapes the smoke run does not reach (k = 1 and 32,
p = 2 to 25 for keys and 31 for registers, ragged rows, widths and pair
blocks, more rows than one grid dimension holds, all-N rows and bytes
>= 0x80 on the ASCII form; for the encode/hash kernel windows across its
segment edges at k = 1, 2, 15, 16, 17, 31, 32, valid runs of exactly k
on the edges, ASCII rows of every width mod 16, chunks that are row-offset
views (unaligned pointers), a ring of fresh registers at p = 16 and 31;
registers at 0 and at q+1, windows reaching
q+1, empty histograms and sketches, the widest joint window, both forms
of K4 bitwise at p = 4 to 18 and 1 to 1000 rows; K3 and K5 bitwise at
every window width, on ragged blocks, single pairs and row-offset
views; both banked forms at one and 64 banks, bank indices in no order,
sorted or out of range, a bank with no row, registers that start nonzero,
rows across segment edges, p = 10 to 16 and 21 (both sides of the
on-chip cut), 256 rows in one bank, and more rows than one grid
dimension); and the set sketches' PyTorch ops on the
card against the CPU (the int64 scatter-min at p = 15 and 26, the
bottom-k merge); the wide HLL's K1 registers through K4, K3 and K5 as
the HLL's, and a wide `-J` pair against its CPU run; raw k-mers at k =
32, HeavyKeeper-filtered registers, a weighted wide HLL pair through K4,
K3 and K5, and gf64_mul/clhash against the CPU; the count-min kernels'
table and registers bitwise their plain versions' at k = 1, 21, 31 and
32, 1, 4 and 5 rows, tables of 2 to 2^28 counters a row (the read-set
cell's tile), ragged and narrow tiles, row-offset views, every card,
their launches in a filtered sketch, and pass 1's tiles kept on the card
for pass 2 within its budget, then freed.  Marked `cuda`: they
skip without a card.  Run them on one:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import encode_hash as eh
from dashing_tpu_torch.ops import joint_mle as jm
from dashing_tpu_torch.ops import joint_stats as js
from dashing_tpu_torch.ops import minimizer_hash as mh
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.ops import union_mle as um
from dashing_tpu_torch.sketch import estimators as est

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# k where a window's bits cross the staged words differently
STRADDLE_K = [1, 2, 15, 16, 17, 31, 32]


def _packed(rng, rows, C, dev):
    tile = rng.choice(np.frombuffer(b"ACGTacgtNR", np.uint8), size=(rows, C),
                      p=[0.22] * 4 + [0.02] * 4 + [0.02, 0.02])
    if C > 200:
        tile[0, 5:60] = ord("N")
    else:                          # a short row: every base valid
        tile[0] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=C)
    packed, vbits = pipeline._pack_tile_host(tile)
    return (torch.from_numpy(packed).to(dev), torch.from_numpy(vbits).to(dev))


@pytest.mark.parametrize("k,p,canon,rows,C", [
    (1, 4, True, 3, 64),           # shortest k-mer, tiny register file
    (21, 2, False, 5, 504),        # smallest p, canonicalization off
    (31, 16, True, 2, 16400),      # two blocks along the row
    (32, 25, True, 4, 1000),       # k = 32 fills 64 bits; widest key p
    (32, 14, False, 1, 40),        # one row, barely longer than k
] + [(k, 12, True, 6, 5000) for k in STRADDLE_K])   # windows across segments
def test_encode_hash_kernel_matches_plain(rng, cuda, k, p, canon, rows, C):
    pk, vb = _packed(rng, rows, C, cuda)
    got = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    before = eh.launches
    eh.packed_to_registers(pk, vb, got, k=k, p=p, canon=canon)
    assert eh.launches == before + 1
    eh.packed_to_registers_plain(pk, vb, want, k=k, p=p, canon=canon)
    torch.cuda.synchronize()
    assert int((want > 0).sum()) > 0
    assert torch.equal(got, want)
    # registers accumulate: a second chunk folds into the same array
    eh.packed_to_registers(pk[:, :8], vb[:, :4], got, k=min(k, 16), p=p,
                           canon=canon)
    eh.packed_to_registers_plain(pk[:, :8], vb[:, :4], want, k=min(k, 16),
                                 p=p, canon=canon)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _runs_at_segment_edges(C, k, seg):
    """All-N rows but for valid runs of exactly k bases at the segment
    edges: in row 0 each run's one window is the last of its segment (it
    straddles the edge), in row 1 the first of the next, in row 2 the run
    ends on the edge.  Returns the rows and each row's run count."""
    rows, counts = [], []
    for shift in (-1, 0, -k):
        row = np.full(C, ord("N"), np.uint8)
        starts = [e + shift for e in range(seg, C - k + 1, seg)
                  if e + shift >= 1 and e + shift + k < C]
        for s in starts:
            row[s:s + k] = np.frombuffer(b"ACGT", np.uint8)[np.arange(k) % 4]
        rows.append(row)
        counts.append(len(starts))
    return np.stack(rows), counts


@pytest.mark.parametrize("k", STRADDLE_K)
def test_valid_run_of_k_on_segment_edges(cuda, k):
    """A valid run exactly k long makes exactly one valid window; placed on
    the segment edges, each still reaches the registers and the keys."""
    C = 6000
    seg = eh.launch_geometry(3, C, k)["segment"]
    rows, counts = _runs_at_segment_edges(C, k, seg)
    assert min(counts) >= 2
    tile = torch.from_numpy(rows).to(cuda)
    keys = eh.encode_hash_keys(tile, k=k, p=12)
    want_keys = eh.encode_hash_keys_plain(tile, k=k, p=12)
    got = torch.zeros(1 << 12, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    eh.ascii_to_registers(tile, got, k=k, p=12)
    eh.ascii_to_registers_plain(tile, want, k=k, p=12, canon=True)
    torch.cuda.synchronize()
    assert torch.equal(keys, want_keys)
    assert ((want_keys & 63) > 0).sum(1).tolist() == counts
    assert torch.equal(got, want)
    # the packed form of the same rows (C % 8 == 0)
    packed, vbits = pipeline._pack_tile_host(tile.cpu().numpy())
    pk, vb = (torch.from_numpy(a).to(cuda) for a in (packed, vbits))
    got.zero_()
    eh.packed_to_registers(pk, vb, got, k=k, p=12)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [8214, 8222])
def test_encode_hash_on_a_row_offset_view(rng, cuda, C):
    """A chunk taken as rows 3.. (packed) or 5.. (ASCII) of a larger
    tensor: its data pointers are not 16-byte aligned."""
    Cp = C + (-C) % 8
    big_pk, big_vb = _packed(rng, 40, Cp, cuda)
    pk, vb = big_pk[3:30], big_vb[3:30]
    assert pk.data_ptr() % 16 or vb.data_ptr() % 16
    t = _ascii(rng, 40, C, cuda)[5:33]
    assert t.data_ptr() % 16
    for k in (16, 31):
        got = torch.zeros(1 << 14, dtype=torch.int32, device=cuda)
        want = torch.zeros_like(got)
        eh.packed_to_registers(pk, vb, got, k=k, p=14)
        eh.packed_to_registers_plain(pk, vb, want, k=k, p=14, canon=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        got.zero_()
        want.zero_()
        eh.ascii_to_registers(t, got, k=k, p=14)
        eh.ascii_to_registers_plain(t, want, k=k, p=14, canon=True)
        keys = eh.encode_hash_keys(t, k=k, p=14)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(keys, eh.encode_hash_keys_plain(t, k=k, p=14))


@pytest.mark.parametrize("p,ring", [(16, 4), (31, 2)])
def test_encode_hash_fresh_register_ring(rng, cuda, p, ring):
    """Launches into a ring of pre-zeroed register arrays, as chip_smoke
    times them: every array equals the plain fold of its chunk."""
    regs = torch.zeros((ring, 1 << p), dtype=torch.int32, device=cuda)
    want = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
    pk, vb = _packed(rng, 8, 4104, cuda)
    t = _ascii(rng, 8, 4111, cuda)
    for form in ("packed", "ascii"):
        regs.zero_()
        for i in range(ring):
            if form == "packed":
                eh.packed_to_registers(pk, vb, regs[i], k=31, p=p)
            else:
                eh.ascii_to_registers(t, regs[i], k=31, p=p)
        want.zero_()
        if form == "packed":
            eh.packed_to_registers_plain(pk, vb, want, k=31, p=p, canon=True)
        else:
            eh.ascii_to_registers_plain(t, want, k=31, p=p, canon=True)
        torch.cuda.synchronize()
        for i in range(ring):
            assert torch.equal(regs[i], want), (form, i)
    del regs, want
    torch.cuda.empty_cache()


def test_encode_hash_rejects_mixed_devices(cuda):
    pk = torch.zeros((1, 4), dtype=torch.uint8, device=cuda)
    vb = torch.zeros((1, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        eh.packed_to_registers(pk, vb, torch.zeros(16, dtype=torch.int32),
                               k=3, p=4)


def _ascii(rng, rows, C, dev):
    """ASCII tile with N, IUPAC, 0x00 and high bytes (0xC1 is 'A' with bit
    7 set); row 0 all N, row 1 all valid lowercase when there are rows."""
    tile = rng.choice(np.frombuffer(b"ACGTacgtNR\x00\xc1", np.uint8),
                      size=(rows, C), p=[0.2] * 4 + [0.03] * 4 + [0.02] * 4)
    tile[0] = ord("N")
    if rows > 1:
        tile[1] = rng.choice(np.frombuffer(b"acgt", np.uint8), size=C)
    return torch.from_numpy(tile).to(dev)


@pytest.mark.parametrize("k,p,canon,rows,C", [
    (1, 2, True, 3, 64),           # shortest k-mer, smallest p
    (32, 25, False, 5, 1001),      # k = 32, widest key p, canon off
    (31, 14, True, 256, 8222),     # the benchmark's chunk (C % 8 != 0)
    (21, 16, True, 7, 8212),       # ragged strips at the row's end
    (12, 10, True, 70000, 40),     # more rows than one grid dimension
] + [(31, 14, True, 9, 3000 + r) for r in range(16)])   # every C mod 16
def test_ascii_keys_kernel_matches_plain(rng, cuda, k, p, canon, rows, C):
    t = _ascii(rng, rows, C, cuda)
    before = eh.keys_launches
    got = eh.encode_hash_keys(t, k=k, p=p, canon=canon)
    assert eh.keys_launches == before + 1
    want = eh.encode_hash_keys_plain(t, k=k, p=p, canon=canon)
    torch.cuda.synchronize()
    assert got.shape == (rows, C - k + 1) and got.dtype == torch.int32
    assert ((want & 63) == 0).any() and (want & 63).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,p,canon,rows,C", [
    (1, 2, True, 3, 64),
    (32, 25, False, 5, 1001),
    (31, 14, True, 256, 8222),
    (21, 31, True, 9, 3000),       # p = 31: registers only (8 GB)
    (12, 10, False, 70000, 40),
] + [(31, 14, True, 9, 3000 + r) for r in range(16)])   # every C mod 16
def test_ascii_regs_kernel_matches_plain(rng, cuda, k, p, canon, rows, C):
    t = _ascii(rng, rows, C, cuda)
    got = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    before = eh.ascii_launches
    eh.ascii_to_registers(t, got, k=k, p=p, canon=canon)
    assert eh.ascii_launches == before + 1
    eh.ascii_to_registers_plain(t, want, k=k, p=p, canon=canon)
    torch.cuda.synchronize()
    assert int((want > 0).sum()) > 0
    assert torch.equal(got, want)
    # an all-N chunk and a chunk of high bytes change nothing
    for fill in (ord("N"), 0xC1):
        eh.ascii_to_registers(torch.full((4, 100), fill, dtype=torch.uint8,
                                         device=cuda), got, k=k, p=p)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del got, want
    torch.cuda.empty_cache()


# bank vectors of the banked test: (order of the rows, what the caller
# says of it to banked K1, incoming registers).  "permuted": in no order,
# so the wrapper orders the rows first (up to ONCHIP_MAX_P); "sorted":
# non-decreasing and said so (the small-file engine's case); "unclaimed":
# non-decreasing, not said so (the ordering on a sorted vector);
# "misclaimed": in no order but said to be sorted (the kernel merges at
# every change of bank, so the banks are the same)
BANK_LAYOUTS = {
    "permuted": (True, False, False),
    "sorted": (False, True, True),
    "unclaimed": (False, False, False),
    "misclaimed": (True, True, True),
}


@pytest.mark.parametrize("layout", list(BANK_LAYOUTS))
@pytest.mark.parametrize("form", ["packed", "ascii"])
@pytest.mark.parametrize("B,p,rows,C,k", [
    (1, 14, 25, 8224, 21),         # one bank: a 200 kbp genome's chunk
    (64, 14, 1600, 8224, 21),      # 64 banks of 25 rows: the 1k-genome batch
    (7, 10, 30, 16400, 31),        # each row across a segment edge
    (8, 21, 16, 4104, 17),         # p = 21, the last p that batches
    (5, 10, 70000, 40, 12),        # more rows than one grid dimension
    (64, 15, 1600, 8224, 21),      # the smallest p of the global route
    (64, 16, 1600, 8224, 21),      # p = 16, the global route
    (1, 12, 256, 8224, 21),        # one bank of 256 rows, split over blocks
    (6, 14, 120, 3000, 15),        # bank 2 gets no row
])
def test_banked_kernels_match_plain(rng, cuda, form, layout, B, p, rows, C,
                                    k):
    """Both banked forms bitwise equal to their plain versions, on both
    sides of banked K1's on-chip cut (p = 14), for bank vectors in no
    order or non-decreasing (BANK_LAYOUTS), with two rows outside [0, B)
    that fold nothing, a bank with no row where B > 2, and registers that
    start at zero or hold values already; and each bank equal to its rows
    folded alone by the single-bank entry into the same start."""
    shuffled, claimed, incoming = BANK_LAYOUTS[layout]
    bank = (np.arange(rows) % B).astype(np.int32)
    if B > 2:
        bank[bank == 2] = 3
    bank = rng.permutation(bank) if shuffled else np.sort(bank)
    if rows > 2:                   # at the ends, so a sorted vector stays so
        bank[[1, rows - 2] if shuffled else [0, rows - 1]] = [-3, B]
    bk = torch.from_numpy(bank).to(cuda)
    start = torch.zeros((B, 1 << p), dtype=torch.int32, device=cuda)
    if incoming:
        start = torch.from_numpy(rng.integers(0, 12, (B, 1 << p),
                                              dtype=np.int32)).to(cuda)
    got, want = start.clone(), start.clone()
    t = _ascii(rng, rows, C, cuda)
    if form == "packed":
        pk, vb = (torch.from_numpy(a).to(cuda)
                  for a in pipeline._pack_tile_host(t.cpu().numpy()))
        before = eh.banks_launches
        eh.packed_to_banks(pk, vb, bk, got, k=k, p=p, bank_sorted=claimed)
        assert eh.banks_launches == before + 1
        eh.packed_to_banks_plain(pk, vb, bk, want, k=k, p=p, canon=True)
    else:
        before = eh.ascii_banks_launches
        eh.ascii_to_banks(t, bk, got, k=k, p=p)
        assert eh.ascii_banks_launches == before + 1
        eh.ascii_to_banks_plain(t, bk, want, k=k, p=p, canon=True)
    torch.cuda.synchronize()
    filled = [j for j in range(B) if (bank == j).any()]
    assert len(filled) == (B - 1 if B > 2 else B)
    assert int((want[filled] > start[filled]).sum(dim=1).min()) > 0
    assert torch.equal(got, want)
    one = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
    for j in range(B):
        rows_j = torch.from_numpy(np.flatnonzero(bank == j)).to(cuda)
        one.copy_(start[j])
        if len(rows_j):
            eh.ascii_to_registers(t[rows_j], one, k=k, p=p)
        torch.cuda.synchronize()
        assert torch.equal(got[j], one), j
    del got, want, one, start
    torch.cuda.empty_cache()


@pytest.mark.parametrize("p", [eh.ONCHIP_MAX_P, eh.ONCHIP_MAX_P + 1])
def test_banks_geometry_cut(cuda, p):
    """The source's on-chip cut is the wrapper's ONCHIP_MAX_P, which
    decides whether the rows are ordered before the launch."""
    geo = eh.banks_geometry(1600, 8224, 21, p, cuda)
    assert geo["onchip"] == (p <= eh.ONCHIP_MAX_P)


def test_banked_kernels_reject_mixed_devices(cuda):
    t = torch.zeros((2, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        eh.ascii_to_banks(t, torch.zeros(2, dtype=torch.int32),
                          torch.zeros((2, 16), dtype=torch.int32,
                                      device=cuda), k=3, p=4)


def test_ascii_kernel_rejects_mixed_devices(cuda):
    t = torch.zeros((2, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        eh.ascii_to_registers(t, torch.zeros(16, dtype=torch.int32), k=3, p=4)


# The minimizer kernel (csrc/minimizer_hash.cu): the bytes of
# tests/test_torch_encode_ascii.py's `_tile` (N, lowercase, IUPAC, 0x00
# separators, bytes >= 0x80), the invalid ones rare enough that windows
# of 160 bases are often all valid
MIN_ALPHABET = np.frombuffer(b"ACGTacgtNnRY\x00\xc1\xe3\x80", np.uint8)
MIN_PROBS = [0.2] * 4 + [0.0495] * 4 + [0.00025] * 8
MIN_P = [4, 14, 16, 25, 31]
MIN_CASES = [(k, w, canon, MIN_P[i % len(MIN_P)])
             for i, (k, w, canon) in enumerate(
                 (k, w, canon) for k in (1, 15, 21, 31, 32)
                 for w in sorted({k + 1, k + 19, 50, 128 + k})
                 for canon in (True, False))]


def _minimizer_ascii(rng, rows, C):
    """(rows, C) uint8 ASCII on the host: an N run in every row of 3 or
    more, row 0 all N and row 1 all lowercase when there are 3 rows or
    more."""
    tile = rng.choice(MIN_ALPHABET, size=(rows, C), p=MIN_PROBS)
    if rows >= 3:
        for r in range(rows):
            s = int(rng.integers(0, max(C - 40, 1)))
            tile[r, s:s + int(rng.integers(1, 40))] = ord("N")
        tile[0] = ord("N")
        tile[1] = rng.choice(np.frombuffer(b"acgt", np.uint8), size=C)
    return tile


@pytest.mark.parametrize("k,w,canon,p", MIN_CASES)
def test_minimizer_kernel_matches_plain(rng, cuda, k, w, canon, p):
    """Registers bitwise the plain version's, from zero registers and
    from registers that already hold ranks."""
    t = torch.from_numpy(_minimizer_ascii(rng, 5, 3001)).to(cuda)
    for start in ("zero", "filled"):
        want = (torch.zeros(1 << p, dtype=torch.int32, device=cuda)
                if start == "zero" else
                torch.randint(0, 8, (1 << p,), dtype=torch.int32,
                              device=cuda))
        got = want.clone()
        before = mh.launches
        mh.ascii_minimizer_registers(t, got, k=k, w=w, p=p, canon=canon)
        assert mh.launches == before + 1
        mh.ascii_minimizer_registers_plain(t, want, k=k, w=w, p=p,
                                           canon=canon)
        torch.cuda.synchronize()
        if start == "zero":
            assert int((want > 0).sum()) > 0
        assert torch.equal(got, want), start
        del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rows,C,k,w,p", [
    (3, 49, 31, 50, 14),           # rows shorter than w: no window
    (3, 50, 31, 50, 14),           # one window a row
    (1, 3001, 1, 2, 4),            # one row, two 1-mers a window
    (256, 8248, 31, 50, 16),       # dist -w 50's chunk
    (4, 20003, 21, 50, 16),        # eight segments a row
    (3, 4000, 31, 31 + 1023, 16),  # the widest window the kernel takes
    (70000, 60, 12, 40, 10),       # more rows than one grid dimension
] + [(9, 2000 + r, 31, 50, 14) for r in range(16)])   # every C mod 16
def test_minimizer_kernel_shapes(rng, cuda, rows, C, k, w, p):
    t = torch.from_numpy(_minimizer_ascii(rng, rows, C)).to(cuda)
    got = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
    want = torch.zeros_like(got)
    mh.ascii_minimizer_registers(t, got, k=k, w=w, p=p)
    mh.ascii_minimizer_registers_plain(t, want, k=k, w=w, p=p, canon=True)
    torch.cuda.synchronize()
    assert (int((want > 0).sum()) > 0) == (C >= w)
    assert torch.equal(got, want)


def test_minimizer_kernel_on_a_row_offset_view(rng, cuda):
    """A chunk taken as rows 5.. of a larger tensor: its data pointer is
    not 16-byte aligned."""
    t = torch.from_numpy(_minimizer_ascii(rng, 40, 3003)).to(cuda)[5:33]
    assert t.data_ptr() % 16
    for k, w in ((16, 40), (31, 50)):
        got = torch.zeros(1 << 14, dtype=torch.int32, device=cuda)
        want = torch.zeros_like(got)
        mh.ascii_minimizer_registers(t, got, k=k, w=w, p=14)
        mh.ascii_minimizer_registers_plain(t, want, k=k, w=w, p=14,
                                           canon=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_minimizer_geometry(cuda):
    """The source's WIN_MAX is the wrapper's, which the routing rule
    reads; the segments cover the row."""
    geo = mh.launch_geometry(256, 8248, 31, 50)
    assert geo["win_max"] == mh.WIN_MAX
    assert geo["grid"] == (-(-8199 // geo["segment"]), 256)
    assert geo["segment"] * geo["grid"][0] >= 8199


@pytest.mark.parametrize("k,w,p", [
    (31, 31, 16),                  # w == k: the packed route's, or K2's
    (31, 20, 16),
    (31, 31 + 1024, 16),           # a window of WIN_MAX + 1 k-mers
    (33, 50, 16),
    (31, 50, 0),
    (31, 50, 32),
])
def test_minimizer_kernel_rejects_unsupported(cuda, k, w, p):
    """On a CUDA tile the wrapper raises outside the kernel's range; it
    never runs the plain version instead."""
    t = torch.full((2, 2000), ord("A"), dtype=torch.uint8, device=cuda)
    regs = torch.zeros(1 << 16, dtype=torch.int32, device=cuda)
    before = mh.launches
    with pytest.raises(ValueError):
        mh.ascii_minimizer_registers(t, regs, k=k, w=w, p=p)
    assert mh.launches == before
    with pytest.raises(ValueError):
        mh.ascii_minimizer_registers(t, torch.zeros(1 << 16,
                                                    dtype=torch.int32),
                                     k=31, w=50, p=16)


@pytest.mark.parametrize("params,launched", [
    (dict(k=31, w=50), 1),
    (dict(k=21, w=50, canon=False), 1),
    (dict(k=31, w=50, spacing="1x4"), 0),
    (dict(k=31, w=50, entropy=True), 0),
    (dict(k=41, w=60, encoding="nthash"), 0),
    (dict(k=31), 0),
])
def test_ascii_route_takes_the_minimizer_kernel(rng, cuda, params, launched):
    """`pipeline.tile_to_registers` on a CUDA tile launches the minimizer
    kernel for exact contiguous minimizers alone, and every family's
    registers equal the CPU run's."""
    params = pipeline.SketchParams(**params)
    kw = pipeline._encode_kw(params, pipeline.check_supported(params))
    tile = torch.from_numpy(_minimizer_ascii(rng, 6, 3001))
    got = torch.zeros(1 << 14, dtype=torch.int32, device=cuda)
    before = mh.launches
    pipeline.tile_to_registers(tile.to(cuda), got, p=14, **kw)
    assert mh.launches - before == launched
    want = torch.zeros(1 << 14, dtype=torch.int32)
    pipeline.tile_to_registers(tile, want, p=14, **kw)
    assert int((want > 0).sum()) > 0
    assert torch.equal(got.cpu(), want)


# The count-min kernels (csrc/countmin.cu): FASTQ-like tiles, 100-base
# reads of a 3,000-base genome (k-mers repeat, so counters reach 2 and
# more) joined by k - 1 zero bytes, half lowercase, with N and bytes
# >= 0x80
CM_LUT = np.frombuffer(b"ACGT", np.uint8)


def _cm_reads(rng, rows, C, k, genome=3000):
    g = rng.integers(0, 4, genome)
    reads, n = [], 0
    while n < rows * C + k - 1:      # the join drops the last separator
        s = int(rng.integers(0, genome - 100))
        r = CM_LUT[g[s:s + 100]].tobytes()
        reads.append(r.lower() if rng.random() < 0.5 else r)
        n += 100 + k - 1
    flat = np.frombuffer((b"\x00" * (k - 1)).join(reads), np.uint8)
    tile = flat[:rows * C].copy().reshape(rows, C)
    tile[rng.random(tile.shape) < 2e-3] = ord("N")
    tile[rng.random(tile.shape) < 1e-3] = 0xC1
    return tile


def _cm_both(tiles, nh, size_log2, p, min_count, dev, regs0=None, **kw):
    """Both passes over `tiles` (on `dev`) by the kernels and by the plain
    versions on the same card: (kernel counts, plain counts, kernel
    registers, plain registers), checking one launch a tile a pass."""
    from dashing_tpu_torch.ops import countmin as cm
    shape = (nh, 1 << size_log2)
    got_c = torch.zeros(shape, dtype=torch.int32, device=dev)
    want_c = torch.zeros_like(got_c)
    kw = dict(kw, nh=nh, size_log2=size_log2)
    adds, admits = cm.add_launches, cm.admit_launches
    for t in tiles:
        cm.ascii_cm_add(t, got_c, **kw)
        cm.ascii_cm_add_plain(t, want_c, **kw)
    got_r = (torch.zeros(1 << p, dtype=torch.int32, device=dev)
             if regs0 is None else regs0.clone())
    want_r = got_r.clone()
    for t in tiles:
        cm.ascii_cm_admit(t, got_c, got_r, min_count=min_count, p=p, **kw)
        cm.ascii_cm_admit_plain(t, want_c, want_r, min_count=min_count, p=p,
                                **kw)
    torch.cuda.synchronize(dev)
    assert cm.add_launches == adds + len(tiles)
    assert cm.admit_launches == admits + len(tiles)
    return got_c, want_c, got_r, want_r


@pytest.mark.parametrize("size_log2,min_count", [(1, 3), (12, 2)])
@pytest.mark.parametrize("nh", [1, 4, 5])
@pytest.mark.parametrize("canon", [True, False])
@pytest.mark.parametrize("k", [1, 21, 31, 32])
def test_countmin_kernels_match_plain(rng, cuda, k, canon, nh, size_log2,
                                      min_count):
    """The whole table after pass 1 and the registers after pass 2 bitwise
    the plain versions', over three tiles; at size_log2 = 1 every counter
    collides."""
    tiles = [torch.from_numpy(_cm_reads(rng, 7, 3001, k)).to(cuda)
             for _ in range(3)]
    p = 14
    got_c, want_c, got_r, want_r = _cm_both(
        tiles, nh, size_log2, p, min_count, cuda, k=k, canon=canon,
        seed=1337 if nh != 5 else -1)
    assert torch.equal(got_c, want_c)
    assert int(want_c.max()) >= min_count
    assert torch.equal(got_r, want_r)
    assert int((want_r > 0).sum()) > 0


def test_countmin_kernels_cell_shape(rng, cuda):
    """The read-set cell's tile and table: two 256 x 8,222 tiles of the
    same reads, k31, 4 x 2^28 counters, p = 16, from zero registers and
    from registers that already hold ranks."""
    tile = torch.from_numpy(_cm_reads(rng, 256, 8222, 31, genome=500_000))
    tiles = [tile.to(cuda), tile.to(cuda)]
    regs0 = torch.randint(0, 6, (1 << 16,), dtype=torch.int32, device=cuda)
    got_c, want_c, got_r, want_r = _cm_both(
        tiles, 4, 28, 16, 2, cuda, regs0=regs0, k=31, canon=True, seed=1337)
    assert torch.equal(got_c, want_c)
    del got_c, want_c
    assert torch.equal(got_r, want_r) and not torch.equal(want_r, regs0)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rows,C,k", [
    (3, 20, 21),                   # narrower than k: no window
    (3, 21, 21),                   # one window a row
    (70000, 60, 12),               # more rows than one grid dimension
    (2, 16400, 31),                # eight segments a row
] + [(5, 2000 + r, 31) for r in range(16)])   # every C mod 16
def test_countmin_kernels_shapes(rng, cuda, rows, C, k):
    tiles = [torch.from_numpy(_cm_reads(rng, rows, C, k)).to(cuda)]
    got_c, want_c, got_r, want_r = _cm_both(
        tiles * 2, 3, 10, 12, 2, cuda, k=k, canon=True, seed=7)
    assert torch.equal(got_c, want_c) and torch.equal(got_r, want_r)
    assert bool(want_c.any()) == (C >= k)


def test_countmin_kernels_on_a_row_offset_view(rng, cuda):
    """A tile taken as rows 5.. of a larger tensor: its data pointer is
    not 16-byte aligned."""
    t = torch.from_numpy(_cm_reads(rng, 40, 3003, 31)).to(cuda)[5:33]
    assert t.data_ptr() % 16
    got_c, want_c, got_r, want_r = _cm_both(
        [t, t], 4, 12, 14, 2, cuda, k=31, canon=True, seed=1337)
    assert torch.equal(got_c, want_c) and torch.equal(got_r, want_r)
    assert int((want_r > 0).sum()) > 0


def test_countmin_kernels_on_every_card(rng, cuda):
    """Each card of the host runs both kernels on its own tensors (a
    launch on the card the tensors lie on, whichever is current)."""
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        tiles = [torch.from_numpy(_cm_reads(rng, 6, 3001, 31)).to(dev)] * 2
        got_c, want_c, got_r, want_r = _cm_both(
            tiles, 4, 14, 14, 2, dev, k=31, canon=True, seed=1337)
        assert torch.equal(got_c, want_c) and torch.equal(got_r, want_r)


def test_countmin_wrappers_reject(cuda):
    """On the card the wrappers raise on tensors of two devices and
    outside the kernels' range, and launch nothing."""
    from dashing_tpu_torch.ops import countmin as cm
    t = torch.full((2, 100), ord("A"), dtype=torch.uint8, device=cuda)
    counts = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    regs = torch.zeros(1 << 10, dtype=torch.int32, device=cuda)
    kw = dict(k=21, nh=2, size_log2=8, seed=1)
    before = cm.add_launches, cm.admit_launches
    with pytest.raises(ValueError):
        cm.ascii_cm_add(t, counts.cpu(), **kw)
    with pytest.raises(ValueError):
        cm.ascii_cm_add(t.cpu(), counts, **kw)
    with pytest.raises(ValueError):
        cm.ascii_cm_admit(t, counts, regs.cpu(), min_count=2, p=10, **kw)
    for bad in (dict(k=33), dict(nh=0), dict(size_log2=33)):
        with pytest.raises(ValueError):
            cm.ascii_cm_add(t, counts, **dict(kw, **bad))
    with pytest.raises(ValueError):
        cm.ascii_cm_admit(t, counts, regs, min_count=2, p=32, **kw)
    assert (cm.add_launches, cm.admit_launches) == before


def _cm_fastq(rng, path, reads):
    """A FASTQ of `reads` 100-base reads of _cm_reads' genome, less those
    with an N or a high byte."""
    reads = _cm_reads(rng, 1, reads * 100, 1).reshape(-1, 100)
    reads = reads[(np.isin(reads & 0xDF, CM_LUT)).all(axis=1)]
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(),
                                                       b"I" * 100)
                              for i, r in enumerate(reads)))


@pytest.mark.parametrize("params,kernels", [
    (dict(k=31), True),
    (dict(k=21, canon=False, cm_nhashes=5, cm_seed=-1), True),
    (dict(k=31, spacing="1x4"), False),
    (dict(k=31, w=50), False),
])
def test_filtered_sketch_launches(rng, cuda, tmp_path, monkeypatch, params,
                                  kernels):
    """A filtered `sketch_file_hll` on the card launches each kernel once
    a tile (`cm_tiles` tiles, every one kept on the card for pass 2, so
    none hashed again) where `countmin.takes` its arguments, and neither
    elsewhere; its registers equal the CPU run's."""
    from dashing_tpu_torch.ops import countmin as cm
    path = tmp_path / "r.fq"
    _cm_fastq(rng, path, 60000)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 64)
    params = pipeline.SketchParams(use_counting_filter=True, min_count=2,
                                   cm_size_log2=20, **params)
    tiles0, rehashed0 = pipeline.cm_tiles, pipeline.cm_rehashed_tiles
    adds, admits = cm.add_launches, cm.admit_launches
    got = pipeline.sketch_file_hll(str(path), params, 14, cuda)
    tiles = pipeline.cm_tiles - tiles0
    assert tiles >= 3
    if kernels:
        assert cm.add_launches - adds == tiles
        assert cm.admit_launches - admits == tiles
        assert pipeline.cm_rehashed_tiles - rehashed0 == 0
    else:
        assert (cm.add_launches, cm.admit_launches) == (adds, admits)
    want = pipeline.sketch_file_hll(str(path), params, 14,
                                    torch.device("cpu"))
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("budget", ["all", "two", "none"])
def test_countmin_kept_tiles(rng, cuda, tmp_path, monkeypatch, budget):
    """Pass 1's uploads stay on the card for pass 2 as far as half of the
    free memory that `torch.cuda.mem_get_info` reports allows: all of a
    streamed FASTQ's tiles (full tiles and a tail), two tiles' bytes
    (two kept), or none.  The registers are bitwise the CPU run's, the
    tiles not kept are uploaded again (`cm_rehashed_tiles`), and the kept
    tiles are freed: after the call the card holds the registers and
    nothing more than before it."""
    path = tmp_path / "r.fq"
    _cm_fastq(rng, path, 6000)
    monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 16)
    params = pipeline.SketchParams(use_counting_filter=True, min_count=2,
                                   cm_size_log2=20)
    src = pipeline.InputFile(0, str(path), params.spacer())
    tiles = list(src.tiles())
    assert len(tiles) >= 4 and tiles[-1].shape[0] < tiles[0].shape[0]
    want = pipeline.sketch_file_hll(str(path), params, 14,
                                    torch.device("cpu"))
    total = torch.cuda.mem_get_info(cuda)[1]
    free = {"two": 2 * 2 * tiles[0].nbytes, "none": 0}.get(budget)
    if free is not None:
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None: (free, total))
    kept = {"all": len(tiles), "two": 2, "none": 0}[budget]
    torch.cuda.synchronize(cuda)
    before = torch.cuda.memory_allocated(cuda)
    t0, r0 = pipeline.cm_tiles, pipeline.cm_rehashed_tiles
    regs = pipeline.sketch_hll_async(src.tiles, params, 14, cuda)
    torch.cuda.synchronize(cuda)
    assert torch.cuda.memory_allocated(cuda) == before + regs.nbytes
    assert pipeline.cm_tiles - t0 == len(tiles)
    assert pipeline.cm_rehashed_tiles - r0 == len(tiles) - kept
    np.testing.assert_array_equal(pipeline.registers_to_numpy(regs), want)
    assert want.any()


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
@pytest.mark.parametrize("p,kmin,kmax,hi", [
    (10, 0, 11, 10),     # bin 0 in the window, empty rows
    (12, 4, 27, 20),     # interior window, K = 24
    (10, 0, 55, 12),     # window reaching q+1 with saturated registers
])
def test_union_kernel_matches_plain(rng, cuda, method, p, kmin, kmax, hi):
    na, nb = 37, 131                 # ragged: no padding anywhere
    a = rng.integers(kmin, hi + 1, size=(na, 1 << p))
    b = rng.integers(kmin, hi + 1, size=(nb, 1 << p))
    a[0] = kmin
    b[0] = kmin
    if kmax == 64 - p + 1:
        a[1::3, :4] = kmax
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    tb = torch.from_numpy(b).to(cuda, torch.int8)
    stats = pw.pair_stats(ta, tb, kmax, kmin)
    c_a = est.estimate_windowed(stats["hist_a"], p, kmin, method)
    c_b = est.estimate_windowed(stats["hist_b"], p, kmin, method)
    cumT = stats["cum_union"].permute(2, 0, 1).contiguous()
    before = um.launches
    got = um.union_triples(cumT, c_a, c_b, p=p, kmin=kmin, method=method)
    assert um.launches == before + 1
    want = um.union_triples_plain(cumT, c_a, c_b, p=p, kmin=kmin,
                                  method=method)
    torch.cuda.synchronize()
    # bit for bit, NaN and infinity in the same places
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _window_bank(rng, n, p, kmin, kmax):
    """kmin + Geometric(1/2) - 1 registers clipped to the window, with an
    empty row (all at kmin), and with a window reaching q+1 a fully
    saturated row and a few top-bin registers in others."""
    r = np.clip(rng.geometric(0.5, size=(n, 1 << p)) - 1 + kmin
                + rng.integers(0, 4, size=(n, 1)), kmin, kmax)
    r[0] = kmin
    if kmax == 64 - p + 1:
        r[-1] = kmax
        r[1::4, :3] = kmax
    return r


# every bucketed window width (pairwise._K_BUCKETS up to 58) and the
# widest clipped one, with and without bin 0 and the top bin q+1
BUCKET_WINDOWS = [
    (12, 0, 8),      # bin 0, the narrowest bucket
    (14, 3, 16),
    (14, 5, 24),
    (14, 2, 32),     # the measured compare shape
    (16, 0, 32),     # config 2's p
    (12, 4, 44),     # interior
    (16, 6, 44),     # reaching q+1 = 49 with kmin > 0
    (8, 0, 58),      # 0..q+1
    (10, 1, 55),     # 1..q+1: a width outside the buckets
    (4, 0, 62),      # 0..q+1 at p=4, the widest window a kernel takes
]


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
@pytest.mark.parametrize("p,kmin,K", BUCKET_WINDOWS)
def test_union_kernel_bitwise_every_window(rng, cuda, method, p, kmin, K):
    """K3 against its plain version bit for bit at every window width, on
    ragged pair blocks, a single pair and a row-offset view."""
    kmax = kmin + K - 1
    a = torch.from_numpy(_window_bank(rng, 45, p, kmin, kmax)).to(
        cuda, torch.int8)
    b = torch.from_numpy(_window_bank(rng, 259, p, kmin, kmax)).to(
        cuda, torch.int8)
    stats = pw.pair_stats(a, b, kmax, kmin)
    c_a = um.estimate_rows(stats["hist_a"], p=p, kmin=kmin, method=method,
                           chain=True)
    c_b = um.estimate_rows(stats["hist_b"], p=p, kmin=kmin, method=method,
                           chain=True)
    cumT = stats["cum_union"].permute(2, 0, 1)
    for rows, cols in ((slice(None), slice(None)),     # 45 x 259
                       (slice(3, 40), slice(7, 200)),  # row-offset view
                       (slice(1, 2), slice(0, 1))):    # one pair
        view = cumT[:, rows, cols]
        got = um.union_triples(view, c_a[rows], c_b[cols], p=p, kmin=kmin,
                               method=method)
        want = um.union_triples_plain(view, c_a[rows], c_b[cols], p=p,
                                      kmin=kmin, method=method)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    rows = um.estimate_rows_plain(stats["hist_a"], p=p, kmin=kmin,
                                  method=method, chain=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(c_a.cpu().numpy(), rows.cpu().numpy())


def test_union_kernel_exact_beside_empty_and_identical(rng, cuda):
    """On the card as on the CPU: the marginals (row kernel, chain) and the
    union (K3) of an empty or identical sketch agree to the last bit, so
    a pair beside an empty sketch shares exactly 0 and identical sketches
    share exactly all."""
    p, kmin, kmax = 14, 0, 31
    a = _window_bank(rng, 40, p, kmin, kmax)
    a[2] = a[1]
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    st = pw.pair_stats(ta, ta, kmax, kmin, same=True)
    tri = pw.triples_from_stats(st, p, est.ERTL_MLE, est.ERTL_MLE, kmin)
    torch.cuda.synchronize()
    tri = tri.cpu()
    assert torch.equal(tri[0, :, 2], torch.zeros(40))
    assert tri[1, 2, 0] == 0 and tri[1, 2, 1] == 0 and tri[1, 2, 2] > 0


# Row-estimate windows (p, kmin, K): every bucket width of the row kernel
# and three between (12; 50, the -o sizes' full histogram at p=16; 62, the
# widest window, 0..q+1 at p=4, which runs the 66-level instantiation: no
# window holds 66 levels)
ROW_WINDOWS = [
    (14, 3, 8),      # interior
    (10, 0, 12),     # bin 0 in the window
    (12, 0, 16),
    (16, 0, 24),     # readfilt's batches
    (14, 0, 32),     # the compare marginals
    (10, 2, 44),     # interior, kmin > 0
    (16, 0, 50),     # full histograms at p=16 (config 2's -o sizes)
    (6, 2, 58),      # 2..q+1: top bin, no bin 0
    (4, 0, 62),      # 0..q+1 at p=4
]
ROW_COUNTS = (1, 31, 100, 1024, 8193)    # ragged against blocks and warps


def _row_hists(rng, n, p, kmin, K):
    """(n, K) float32 histograms of 2^p registers over levels
    kmin..kmin+K-1, drawn from the Poisson model (P(register <= k) =
    exp(-x 2^-k)) at x = cardinality / 2^p log-uniform in [1e-3,
    2^(kmin+K)], the mass below the window at its floor and above it at
    its top; row 3 at the floor (empty when kmin = 0), row 4 at the top
    (saturated when the window holds q+1), row 5 with no mass."""
    m = 1 << p
    x = np.exp(rng.uniform(np.log(1e-3), (kmin + K) * np.log(2.0), n))
    cdf = np.exp(-x[:, None] * 2.0 ** -np.arange(kmin, kmin + K)[None])
    cdf[:, -1] = 1.0
    pmf = np.clip(np.diff(cdf, prepend=0.0, axis=1), 0.0, None)
    h = rng.multinomial(m, pmf / pmf.sum(1, keepdims=True)).astype(np.float32)
    h[3:6] = 0
    h[3, 0] = h[4, -1] = m
    return h


@pytest.mark.parametrize("code", [0, 1, 2, 3])
@pytest.mark.parametrize("p,kmin,K", ROW_WINDOWS)
def test_estimate_kernel_matches_plain(rng, cuda, code, p, kmin, K):
    """The row-estimate kernel bit for bit against its plain version:
    ORIGINAL (code 0), IMPROVED (1), the MLE by the direct form (2) and by
    the chain (3), at every window of ROW_WINDOWS, for the first n of 8193
    rows (ROW_COUNTS), with 0, 12 and 24 Newton steps, through the wrapper
    and in every form of the kernel (a thread a row for ORIGINAL and
    IMPROVED; 8 and 32 lanes a row for the MLE); empty, saturated and
    massless rows included."""
    method, chain = min(code, est.ERTL_MLE), code == 3
    hist = torch.from_numpy(_row_hists(rng, ROW_COUNTS[-1], p, kmin,
                                       K)).to(cuda)
    mle = method == est.ERTL_MLE
    for n in ROW_COUNTS:
        h = hist[:n]
        for iters in (0, 12, 24) if mle else (12,):
            want = um.estimate_rows_plain(h, p=p, kmin=kmin, method=method,
                                          iters=iters, chain=chain)
            for lanes in (None, 8, 32) if mle else (None, 1):
                before = um.estimate_launches
                if lanes is None:
                    got = um.estimate_rows(h, p=p, kmin=kmin, method=method,
                                           iters=iters, chain=chain)
                else:
                    got = um._launch_rows(h, p=p, kmin=kmin, method=method,
                                          iters=iters, chain=chain,
                                          lanes=lanes)
                assert um.estimate_launches == before + 1
                torch.cuda.synchronize()
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"n={n} iters={iters} lanes={lanes}")


def test_union_kernel_empty_histograms(cuda):
    cum = torch.zeros((8, 3, 5), device=cuda)
    z = torch.zeros(3, device=cuda), torch.zeros(5, device=cuda)
    tri = um.union_triples(cum, *z, p=10, kmin=0, method=est.ERTL_MLE)
    torch.cuda.synchronize()
    assert torch.equal(tri.cpu(), torch.zeros((3, 3, 5)))


@pytest.mark.parametrize("p,na,nb,kmin,K", [
    (4, 5, 70, 0, 62),       # 16 registers, the window 0..q+1
    (18, 65, 130, 0, 48),    # 2^18 registers, registers at 0 and q+1 = 47
    (12, 100, 37, 6, 16),    # kmin > 0 with registers below the window
    (14, 1, 1, 3, 8),        # one pair
])
def test_joint_stats_kernel_matches_plain(rng, cuda, p, na, nb, kmin, K):
    kmax = kmin + K - 1
    q = 64 - p
    a = np.minimum(rng.geometric(0.5, size=(na, 1 << p)) + kmin, q + 1)
    b = np.minimum(rng.geometric(0.5, size=(nb, 1 << p)) + kmin, q + 1)
    a[0, :3] = 0
    b[-1, :5] = 0
    a[-1, -4:] = q + 1
    b[0, :2] = q + 1
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    tb = torch.from_numpy(b).to(cuda, torch.int8)
    before = js.launches
    got = js.joint_pair_stats(ta, tb, kmin=kmin, kmax=kmax)
    assert js.launches == before + 1
    want = js.joint_pair_stats_plain(ta, tb, kmin=kmin, kmax=kmax)
    torch.cuda.synchronize()
    for key in want:
        assert got[key].shape == (K, na, nb)
        assert torch.equal(got[key], want[key]), key
    # a same-bank tile, as the diagonal tiles of dist are
    got = js.joint_pair_stats(ta, ta, kmin=kmin, kmax=kmax, same=True)
    want = js.joint_pair_stats_plain(ta, ta, kmin=kmin, kmax=kmax, same=True)
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("p,kmin,K", [
    (10, 0, 8),      # narrowest bucket, 10 Newton steps, empty sketches
    (14, 5, 24),     # interior window, 8 Newton steps
    (4, 0, 62),      # the widest window a kernel takes: 0..q+1 at p=4
    (12, 38, 16),    # window reaching q+1 = 53, saturated registers
])
def test_joint_mle_kernel_matches_plain(rng, cuda, p, kmin, K):
    """66 levels (the widest bucket) cannot occur: a window ends at q+1 =
    65 - p <= 61, so the widest is 62 levels at p=4."""
    kmax = kmin + K - 1
    m = 1 << p
    shared = rng.geometric(0.5, size=m) - 1 + kmin
    a = np.maximum(rng.geometric(0.5, size=(19, m)) - 3 + kmin, shared)
    b = np.maximum(rng.geometric(0.5, size=(150, m)) - 3 + kmin, shared)
    a, b = np.clip(a, kmin, kmax), np.clip(b, kmin, kmax)
    a[0] = kmin                       # empty sketch when kmin = 0
    b[1] = kmin
    if kmax == 64 - p + 1:
        b[2] = kmax                   # fully saturated
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    tb = torch.from_numpy(b).to(cuda, torch.int8)
    st = pw.pair_stats(ta, tb, kmax, kmin, joint=True)
    ca = um.estimate_rows(st["hist_a"], p=p, kmin=kmin, method=est.ERTL_MLE)
    cb = um.estimate_rows(st["hist_b"], p=p, kmin=kmin, method=est.ERTL_MLE)
    args = [st[key].permute(2, 0, 1) for key in ("eq", "gt_a", "gt_b")]
    args += [st["hist_a"].T, st["hist_b"].T, ca, cb]
    before = jm.launches
    got = jm.joint_triples(*args, p=p, kmin=kmin)
    assert jm.launches == before + 1
    want = jm.joint_triples_plain(*args, p=p, kmin=kmin)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    # bit for bit, NaN and infinity in the same places
    np.testing.assert_array_equal(got, want)
    if kmin == 0:
        assert (got[[0, 2], 0] == 0).all()       # A empty: la = lx = 0


@pytest.mark.parametrize("p,kmin,K", BUCKET_WINDOWS)
def test_joint_mle_kernel_bitwise_every_window(rng, cuda, p, kmin, K):
    """K5 against its plain version bit for bit at every window width, on
    ragged pair blocks, a single pair and a row-offset view of the
    statistics; empty and saturated sketches included."""
    kmax = kmin + K - 1
    m = 1 << p
    shared = np.minimum(rng.geometric(0.5, size=m) - 1 + kmin, kmax)
    a = np.maximum(_window_bank(rng, 21, p, kmin, kmax), shared)
    b = np.maximum(_window_bank(rng, 133, p, kmin, kmax), shared)
    a[0] = kmin                       # empty sketch when kmin = 0
    b[1] = kmin
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    tb = torch.from_numpy(b).to(cuda, torch.int8)
    st = pw.pair_stats(ta, tb, kmax, kmin, joint=True)
    ca = um.estimate_rows(st["hist_a"], p=p, kmin=kmin, method=est.ERTL_MLE)
    cb = um.estimate_rows(st["hist_b"], p=p, kmin=kmin, method=est.ERTL_MLE)
    kf = [st[key].permute(2, 0, 1) for key in ("eq", "gt_a", "gt_b")]
    ha, hb = st["hist_a"].T, st["hist_b"].T
    for rows, cols in ((slice(None), slice(None)),     # 21 x 133
                       (slice(5, 20), slice(3, 130)),  # row-offset view
                       (slice(2, 3), slice(4, 5))):    # one pair
        args = [t[:, rows, cols] for t in kf]
        args += [ha[:, rows], hb[:, cols], ca[rows], cb[cols]]
        before = jm.launches
        got = jm.joint_triples(*args, p=p, kmin=kmin)
        assert jm.launches == before + 1
        want = jm.joint_triples_plain(*args, p=p, kmin=kmin)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_joint_dist_through_the_kernels(cuda, rng):
    """compare_tile on the -J path launches K4 and K5 once each."""
    a = torch.from_numpy(np.minimum(rng.geometric(0.5, size=(70, 1 << 12))
                                    + 2, 30)).to(cuda, torch.int8)
    b4, b5 = js.launches, jm.launches
    tile = pw.compare_tile(a, a, 12, pw.MASH_DIST, 1 / 21, est.ERTL_MLE,
                           est.ERTL_JOINT_MLE, 31, 0, same=True)
    torch.cuda.synchronize()
    assert (js.launches, jm.launches) == (b4 + 1, b5 + 1)
    assert tile.shape == (70, 70) and torch.isfinite(tile).all()


def _k4_bank(rng, n, p, kmin):
    """kmin + Geometric(1/2) - 1 registers clipped to q+1, with registers
    at 0 and at q+1 in the first and last rows."""
    q = 64 - p
    r = np.minimum(rng.geometric(0.5, size=(n, 1 << p)) - 1 + kmin, q + 1)
    r[0, :3] = 0
    r[-1, -5:] = q + 1
    return r


@pytest.mark.parametrize("p,na,nb,kmin,K", [
    (4, 63, 65, 0, 62),      # m = 16: one word in a 4-word stage
    (10, 129, 1, 0, 16),     # one row of b
    (14, 1000, 1000, 2, 32), # j1000's and n1024's widths
    (16, 65, 129, 8, 24),    # config 2's p, a window above 0
    (18, 1, 63, 0, 48),      # 2^18 registers, one row of a
    (14, 5, 7, 0, 65),       # the widest window the kernel takes
    (16, 3, 2, 3, 32),       # a tiny tile: split along the register axis
])
def test_k4_forms_match_plain_bitwise(rng, cuda, p, na, nb, kmin, K):
    """Both forms of K4 (joint statistics, X-only cum_union) equal to
    their plain versions bit for bit, on distinct banks and on one bank.
    (kmin + K - 1 <= 64 bounds a window, so 66 levels need kmin < 0: the
    widest the kernel takes is 65 levels at kmin = 0.)"""
    kmax = kmin + K - 1
    ta = torch.from_numpy(_k4_bank(rng, na, p, kmin)).to(cuda, torch.int8)
    tb = torch.from_numpy(_k4_bank(rng, nb, p, kmin)).to(cuda, torch.int8)
    for a, b, same in ((ta, tb, False), (ta, ta, True)):
        before = (js.launches, js.cum_union_launches)
        got = js.cum_union_counts(a, b, kmin=kmin, kmax=kmax)
        st = js.joint_pair_stats(a, b, kmin=kmin, kmax=kmax, same=same)
        assert (js.launches, js.cum_union_launches) == (before[0] + 1,
                                                       before[1] + 1)
        want = js.cum_union_counts_plain(a, b, kmin=kmin, kmax=kmax)
        want_st = js.joint_pair_stats_plain(a, b, kmin=kmin, kmax=kmax,
                                            same=same)
        torch.cuda.synchronize()
        assert got.shape == (K, a.shape[0], b.shape[0])
        assert torch.equal(got, want), int((got != want).sum())
        for key in want_st:
            assert torch.equal(st[key], want_st[key]), key
        del got, st, want, want_st
    torch.cuda.empty_cache()


def test_pair_stats_on_the_card_calls_no_matmul(rng, cuda, monkeypatch):
    """The main path's cum_union on the card is K4's X-only form: no
    torch.matmul (the plain version's), one launch, the marginals from its
    diagonal equal to the bincount ones."""
    a = torch.from_numpy(_k4_bank(rng, 70, 12, 2)).to(cuda, torch.int8)
    want = js.cum_union_counts_plain(a, a, kmin=0, kmax=31)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.matmul on the card's main path")

    monkeypatch.setattr(torch, "matmul", refuse)
    before = js.cum_union_launches
    st = pw.pair_stats(a, a, 31, 0, same=True)
    assert js.cum_union_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(st["cum_union"].permute(2, 0, 1), want)
    assert torch.equal(st["hist_a"], pw.marginal_histograms(a, 0, 32))
    tile = pw.compare_tile(a, a, 12, pw.MASH_DIST, 1 / 21, est.ERTL_MLE,
                           est.ERTL_MLE, 31, 0, same=True)
    torch.cuda.synchronize()
    assert js.cum_union_launches == before + 2
    assert tile.shape == (70, 70) and torch.isfinite(tile).all()


def _hll_bank(rng, n, p):
    """n HLLs of overlapping content (a shared register vector under each
    sketch's own), cardinalities spread by a per-sketch offset; sketch 0
    repeated at 7 and 19."""
    from dashing_tpu_torch.sketch.hll import HLL
    m = 1 << p
    shared = rng.geometric(0.5, size=m) - 1
    own = rng.geometric(0.5, size=(n, m)) - 1 + rng.integers(0, 4, (n, 1))
    regs = np.minimum(np.maximum(own, shared), 64 - p + 1).astype(np.uint8)
    regs[7] = regs[19] = regs[0]
    return [HLL.from_numpy(r, p) for r in regs]


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_rect_on_the_card_matches_cpu(rng, cuda, jestim):
    """rect_pairs and rect_triples on the card (references and queries two
    uploads, ragged 32-wide tiles) against their runs on the CPU through
    the plain versions: the tile's counts exactly, triples at rtol=2e-4
    atol=5e-2, their Jaccard and the measures within 2e-6; the path's
    kernels launch."""
    refs = _hll_bank(rng, 70, 12)
    queries = _hll_bank(rng, 45, 12)
    cpu = torch.device("cpu")
    before = (js.cum_union_launches, js.launches, um.launches, jm.launches)
    got = pw.rect_triples(refs, queries, est.ERTL_MLE, jestim, cuda, tile=32)
    after = (js.cum_union_launches, js.launches, um.launches, jm.launches)
    tiles = 3 * 2
    if jestim == est.ERTL_JOINT_MLE:
        assert (after[1] - before[1], after[3] - before[3]) == (tiles, tiles)
    else:
        assert (after[0] - before[0], after[2] - before[2]) == (tiles, tiles)
    want = pw.rect_triples(refs, queries, est.ERTL_MLE, jestim, cpu, tile=32)
    assert got.shape == (45, 70, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-2)
    ji = [t[..., 2] / t.sum(-1) for t in (got, want)]
    np.testing.assert_allclose(ji[0], ji[1], atol=2e-6)
    for rt in (pw.JI, pw.CONTAINMENT_INDEX):
        np.testing.assert_allclose(
            pw.rect_pairs(refs, queries, rt, 21, est.ERTL_MLE, jestim, cuda,
                          tile=32),
            pw.rect_pairs(refs, queries, rt, 21, est.ERTL_MLE, jestim, cpu,
                          tile=32), atol=2e-6)
    a = pw._device_regs(pw._stack_regs(refs[32:64]), cuda)
    b = pw._device_regs(pw._stack_regs(queries[:32]), cuda)
    st = pw.pair_stats(a, b, 40, 0, joint=jestim == est.ERTL_JOINT_MLE)
    st_cpu = pw.pair_stats(a.cpu(), b.cpu(), 40, 0,
                           joint=jestim == est.ERTL_JOINT_MLE)
    for key in st_cpu:
        assert torch.equal(st[key].cpu(), st_cpu[key]), key


@pytest.mark.parametrize("result_type", [pw.JI, pw.MASH_DIST])
def test_nn_on_the_card_matches_cpu(rng, cuda, result_type):
    """nn_topk on the card against its CPU run, all-pairs (self excluded)
    and query x reference, one tile and several: the same neighbours,
    values within rtol 1e-4 atol 2e-6; the copies of sketch 0 lead its
    row in index order."""
    sk = _hll_bank(rng, 60, 12)
    cpu = torch.device("cpu")
    for refs, queries, excl in ((sk, sk, True), (sk[:41], sk[41:], False)):
        for tile in (1024, 16):
            got = pw.nn_topk(refs, queries, result_type, 21, est.ERTL_MLE,
                             est.ERTL_MLE, 6, excl, cuda, tile=tile)
            want = pw.nn_topk(refs, queries, result_type, 21, est.ERTL_MLE,
                              est.ERTL_MLE, 6, excl, cpu, tile=tile)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=2e-6)
            if excl:
                assert list(got[1][0, :2]) == [7, 19]
                assert list(got[1][7, :2]) == [0, 19]


def test_tile_topk_on_the_card_keeps_the_lower_index(rng, cuda):
    """The device top-k on tie-heavy blocks (equal values, both signed
    zeros, the ±inf self sentinel, a ragged tile padded with (worst, -1))
    equals its CPU run, values bit for bit; an all-equal row lists the
    references in index order."""
    vals = rng.choice(np.array([0.0, -0.0, 1.0, 0.5], np.float32),
                      size=(300, 40))
    vals[:, 3] = 0.5
    block = torch.from_numpy(vals)
    for sim in (True, False):
        for nn, exclude in ((7, True), (300, False), (320, True)):
            got = pw.tile_topk(block.to(cuda), 10, 4, nn, sim, exclude)
            want = pw.tile_topk(block, 10, 4, nn, sim, exclude)
            assert torch.equal(got[1].cpu(), want[1])
            assert torch.equal(got[0].cpu().view(torch.int32),
                               want[0].view(torch.int32))
    flat = torch.full((50, 2), 0.25)
    _, idx = pw.tile_topk(flat.to(cuda), 0, 100, 50, True, False)
    assert idx.cpu().tolist() == [list(range(100, 150))] * 2


def test_diagonal_nn_tile_one_bank_equals_two_banks(rng, cuda, monkeypatch):
    """All-pairs NN on one list (one uploaded bank: the diagonal tiles take
    K4's one-bank form and the marginals from its diagonal) equals the
    same scan over a copy of the list (two banks) bit for bit."""
    sk = _hll_bank(rng, 50, 12)
    seen = []
    real = pw.pair_stats

    def spy(a, b, kmax, kmin=0, same=False, joint=False):
        seen.append((a.data_ptr() == b.data_ptr(), same))
        return real(a, b, kmax, kmin, same, joint)

    monkeypatch.setattr(pw, "pair_stats", spy)
    for result_type in (pw.JI, pw.MASH_DIST):
        for tile in (1024, 16):
            seen.clear()
            one = pw.nn_topk(sk, sk, result_type, 21, est.ERTL_MLE,
                             est.ERTL_MLE, 5, True, cuda, tile=tile)
            assert (True, True) in seen
            seen.clear()
            two = pw.nn_topk(sk, list(sk), result_type, 21, est.ERTL_MLE,
                             est.ERTL_MLE, 5, True, cuda, tile=tile)
            assert not any(s for _, s in seen)
            np.testing.assert_array_equal(one[1], two[1])
            np.testing.assert_array_equal(one[0].view(np.uint32),
                                          two[0].view(np.uint32))


@pytest.mark.parametrize("p,kmin,K", BUCKET_WINDOWS)
def test_joint_mle_kernel_with_c_u_bitwise(rng, cuda, p, kmin, K):
    """K5 given the union seeds c_u (the sparse read filter's and
    ertl_joint's start: the union's direct MLE) bit for bit against its
    plain version given the same c_u, at every window width 8-62, on a
    ragged tile and on the read filter's layout (K, B, 1); without c_u it
    still derives the IMPROVED seed."""
    kmax = kmin + K - 1
    m = 1 << p
    shared = np.minimum(rng.geometric(0.5, size=m) - 1 + kmin, kmax)
    a = np.maximum(_window_bank(rng, 37, p, kmin, kmax), shared)
    b = np.maximum(_window_bank(rng, 70, p, kmin, kmax), shared)
    ta = torch.from_numpy(a).to(cuda, torch.int8)
    tb = torch.from_numpy(b).to(cuda, torch.int8)
    st = pw.pair_stats(ta, tb, kmax, kmin, joint=True)
    ca = um.estimate_rows(st["hist_a"], p=p, kmin=kmin, method=est.ERTL_MLE)
    cb = um.estimate_rows(st["hist_b"], p=p, kmin=kmin, method=est.ERTL_MLE)
    kf = [st[key].permute(2, 0, 1).contiguous()
          for key in ("eq", "gt_a", "gt_b")]
    hu = (kf[0] + kf[1] + kf[2]).permute(1, 2, 0).reshape(-1, K)
    cu = um.estimate_rows(hu.contiguous(), p=p, kmin=kmin,
                          method=est.ERTL_MLE).reshape(37, 70)
    ha, hb = st["hist_a"].T.contiguous(), st["hist_b"].T.contiguous()
    for cols in (slice(None), slice(3, 4)):        # a tile; (K, 37, 1)
        args = [t[:, :, cols].contiguous() for t in kf]
        args += [ha, hb[:, cols].contiguous(), ca, cb[cols].contiguous()]
        c_u = cu[:, cols].contiguous()
        before = jm.launches
        got = jm.joint_triples(*args, c_u, p=p, kmin=kmin)
        assert jm.launches == before + 1
        want = jm.joint_triples_plain(*args, c_u, p=p, kmin=kmin)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        derived = jm.joint_triples(*args, p=p, kmin=kmin)
        np.testing.assert_array_equal(
            derived.cpu().numpy(),
            jm.joint_triples_plain(*args, p=p, kmin=kmin).cpu().numpy())


@pytest.mark.parametrize("p,B,L", [(12, 300, 128), (16, 4096, 300),
                                   (25, 64, 200)])
def test_sparse_read_filter_on_the_card(rng, cuda, p, B, L):
    """The sparse statistics on the card bitwise equal to the CPU run of
    the same code, and its triples (row estimates + K5 given c_u) within
    the row-estimate kernel's rtol 1e-5 of the cardinalities: the starts
    of the two devices may differ in the last bit, and where the guard
    then decides differently (a float32 likelihood tie) a read's triple
    moves by one Newton correction; CI within 5e-2 there, 1e-3 elsewhere."""
    from dashing_tpu_torch.hashes import wang_hash
    from dashing_tpu_torch.ops.hll_update import bucket_rank
    from dashing_tpu_torch.sketch import sparse
    m = 1 << p
    pool = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 200_000,
                                         dtype=np.int64))
    regs = torch.zeros(m, dtype=torch.int32)
    i, r = bucket_rank(wang_hash(pool), p)
    regs.scatter_reduce_(0, i, r.to(torch.int32), "amax")
    hist = torch.bincount(regs.long(), minlength=64 - p + 2).float()
    take = torch.from_numpy(rng.integers(0, pool.numel(), (B, L)))
    h = wang_hash(torch.where(torch.from_numpy(rng.random((B, L)) < 0.7),
                              pool[take], take * 7919 + 1))
    idx, rank = bucket_rank(h, p)
    rank[:, -L // 10:] = 0
    kb = sparse.level_window_bins(int(max(rank.max(), regs.max())), 64 - p)
    cpu = sparse.sparse_pair_stats(idx, rank, regs, hist[:kb], p, kb)
    dev = [t.to(cuda) for t in (idx, rank, regs, hist[:kb])]
    got = sparse.sparse_pair_stats(*dev, p, kb)
    for key in cpu:
        assert torch.equal(got[key].cpu(), cpu[key]), key
    b3, b5 = um.estimate_launches, jm.launches
    tri = sparse.sparse_joint_triples(*dev, p, kb).cpu().numpy()
    assert (um.estimate_launches, jm.launches) == (b3 + 3, b5 + 1)
    want = sparse.sparse_joint_triples(idx, rank, regs, hist[:kb], p,
                                       kb).numpy()
    assert np.isfinite(tri).all()
    ci = [t[:, 2] / np.maximum(t[:, 0] + t[:, 2], 1e-30) for t in (tri, want)]
    err = np.abs(ci[0] - ci[1])
    assert err.max() <= 5e-2 and (err > 1e-3).mean() <= 0.05


def test_weighted_labels_on_the_card(rng, cuda):
    """The occurrence labels and the --wj-exact registers on the card
    equal the CPU's bitwise."""
    from dashing_tpu_torch.sketch import weighted
    vals = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 5000,
                                         dtype=np.int64))
    h = vals[torch.from_numpy(rng.integers(0, 5000, (400, 1000)))]
    h[0, :5] = -1
    valid = torch.from_numpy(rng.random((400, 1000)) < 0.9)
    lab, sv = weighted.occurrence_labels_device(h.to(cuda), valid.to(cuda))
    want, wsv = weighted.occurrence_labels_device(h, valid)
    assert torch.equal(sv.cpu(), wsv)
    assert torch.equal(lab.cpu()[wsv], want[wsv])
    regs = pipeline._wj_label_update(h.to(cuda), valid.to(cuda), 14)
    assert torch.equal(regs.cpu(), pipeline._wj_label_update(h, valid, 14))


def _set_hashes(rng, shape):
    """int64 hash tiles with the top bit set on a quarter, zero, all ones
    (EMPTY), 1 << 63, and every value repeated (a pool of a third)."""
    pool = rng.integers(-2 ** 63, 2 ** 63 - 1, shape[0] * shape[1] // 3,
                        dtype=np.int64, endpoint=True)
    pool[: pool.size // 4] |= np.int64(-2 ** 63)
    pool[:3] = (0, -1, -2 ** 63)
    h = pool[rng.integers(0, pool.size, shape)]
    h[0, :3] = pool[:3]
    return torch.from_numpy(h)


@pytest.mark.parametrize("p", [15, 26])
def test_scatter_min_on_the_card_matches_cpu(rng, cuda, p):
    """The b-bit MinHash scatter-min (int64 scatter_reduce_ "amin") on the
    card equals the CPU bank bitwise; p = 26 passes the JAX route's
    int32 limit."""
    from dashing_tpu_torch.ops import minhash_update as mu
    banks = [mu.empty_bank(p, dev) for dev in (cuda, torch.device("cpu"))]
    want = np.full(1 << p, np.uint64(2 ** 64 - 1), np.uint64)
    for _ in range(3):
        h = _set_hashes(rng, (256, 4096))
        valid = torch.from_numpy(rng.random(h.shape) < 0.8)
        valid[0, :3] = True
        for bank in banks:
            mu.bbmh_update(bank, h.to(bank.device), valid.to(bank.device), p)
        mu.bbmh_update_np(want, h.numpy().view(np.uint64), valid.numpy(), p)
    assert torch.equal(banks[0].cpu(), banks[1])
    np.testing.assert_array_equal(mu.to_numpy(banks[0]), want)


@pytest.mark.parametrize("kk", [1, 8192])
def test_bottomk_on_the_card_matches_cpu(rng, cuda, kk):
    """The bottom-k merge (torch.unique of the flipped hashes) on the card
    equals the CPU's, over duplicates, the top bit, zero and all ones."""
    from dashing_tpu_torch.ops import minhash_update as mu
    runs = [mu.empty_values(dev) for dev in (cuda, torch.device("cpu"))]
    want = np.zeros(0, np.uint64)
    for _ in range(3):
        h = _set_hashes(rng, (256, 4096))
        valid = torch.from_numpy(rng.random(h.shape) < 0.8)
        valid[0, :3] = True
        runs = [mu.bottomk_update(r, h.to(r.device), valid.to(r.device), kk)
                for r in runs]
        want = mu.bottomk_update_np(want, h.numpy().view(np.uint64),
                                    valid.numpy(), kk)
    assert torch.equal(runs[0].cpu(), runs[1])
    np.testing.assert_array_equal(mu.to_numpy(runs[0]), want)


def _nested_wide_and_hll(rng, cuda, p, n=6):
    """n sketches of nested row prefixes of one packed chunk, made by K1
    on the card at p: as wide HLLs (uint16) and as HLLs (uint8)."""
    from dashing_tpu_torch.sketch.extra import WideHLL
    from dashing_tpu_torch.sketch.hll import HLL
    packed, vbits = _packed(rng, 64, 2048, cuda)
    wide, hll = [], []
    for i in range(n):
        rows = 24 + 8 * i
        regs = torch.zeros(1 << p, dtype=torch.int32, device=cuda)
        eh.packed_to_registers(packed[:rows], vbits[:rows], regs, k=21, p=p)
        host = pipeline.registers_to_numpy(regs)
        wide.append(WideHLL(p, regs=host.astype(np.uint16)))
        hll.append(HLL(p, regs=host))
    return wide, hll


@pytest.mark.parametrize("p", [4, 18])
def test_wide_registers_through_the_kernels(rng, cuda, p):
    """Wide HLL registers made by K1 on the card reach K4's X-only form
    and K3 (`dist -M`) and K4's joint form and K5 (`-J`) as the int8 bank
    of the HLL path: both matrices bit for bit the HLL path's, each kernel
    launched."""
    before = eh.launches
    wide, hll = _nested_wide_and_hll(rng, cuda, p)
    assert eh.launches == before + len(wide)
    for jestim, counters in ((est.ERTL_MLE, ("cum_union_launches",
                                             "launches")),
                             (est.ERTL_JOINT_MLE, ("launches", "launches"))):
        mods = (js, um) if jestim == est.ERTL_MLE else (js, jm)
        start = [getattr(m, c) for m, c in zip(mods, counters)]
        got = pw.all_pairs_condensed(wide, pw.MASH_DIST, 21, est.ERTL_MLE,
                                     jestim, cuda)
        mid = [getattr(m, c) for m, c in zip(mods, counters)]
        want = pw.all_pairs_condensed(hll, pw.MASH_DIST, 21, est.ERTL_MLE,
                                      jestim, cuda)
        assert all(b > a for a, b in zip(start, mid)), (jestim, start, mid)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_wide_joint_pair_on_the_card_matches_cpu(rng, cuda):
    """One wide HLL pair under -J through WideHLL.full_set_comparison (K4's
    joint form on a 1 x 1 tile and K5 given c_u): on the card bit for bit
    the HLL's, and within the north-star bars of its CPU run."""
    from dashing_tpu_torch.sketch.extra import WideHLL
    wide, hll = _nested_wide_and_hll(rng, cuda, 14, n=2)
    for sk in wide + hll:
        sk.jestim = est.ERTL_JOINT_MLE
    b4, b5 = js.launches, jm.launches
    got = np.array(wide[0].full_set_comparison(wide[1], cuda))
    assert (js.launches, jm.launches) == (b4 + 1, b5 + 1)
    assert isinstance(wide[0], WideHLL)
    np.testing.assert_array_equal(
        got, np.array(hll[0].full_set_comparison(hll[1], cuda)))
    cpu = np.array(wide[0].full_set_comparison(wide[1], torch.device("cpu")))
    np.testing.assert_allclose(got, cpu, rtol=2e-4, atol=5e-2)
    assert abs(got[2] / got.sum() - cpu[2] / cpu.sum()) <= 2e-6


def _genome_files(rng, root, n=2, length=20000, rate=0.02):
    """n FASTAs of one ancestor at a planted substitution rate, each two
    records, with a run of N."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, length).astype(np.uint8)
    paths = []
    for i in range(n):
        g = anc.copy()
        hit = np.flatnonzero(rng.random(g.size) < rate * i)
        g[hit] = (g[hit] + 1) & 3
        seq = lut[g].copy()
        seq[1000:1100] = ord("N")
        cut = seq.size // 2
        path = root / f"g{i}.fa"
        path.write_bytes(b">a\n%s\n>b\n%s\n" % (seq[:cut].tobytes(),
                                                 seq[cut:].tobytes()))
        paths.append(str(path))
    return paths


def test_raw_kmers_k32_on_the_card_match_cpu(rng, cuda, tmp_path):
    """A file's raw k-mers at k = 32 (the exact hash sets' keys, the top
    bit set on a quarter of them) pulled from the card in the CPU's
    order, and the hash set of them equal."""
    from dashing_tpu_torch.sketch.khset import KSet
    path = _genome_files(rng, tmp_path, n=1)[0]
    params = pipeline.SketchParams(k=32)
    got = pipeline.file_raw_kmers(path, params, cuda)
    want = pipeline.file_raw_kmers(path, params, torch.device("cpu"))
    assert got.dtype == np.uint64 and got.size > 19000
    np.testing.assert_array_equal(got, want)
    assert (got >= np.uint64(1 << 63)).any()
    np.testing.assert_array_equal(KSet.from_values(got).keys,
                                  KSet.from_values(want).keys)


@pytest.mark.parametrize("streamed", [False, True])
def test_hk_filtered_registers_on_the_card_match_cpu(rng, cuda, tmp_path,
                                                     monkeypatch, streamed):
    """DASHING_TPU_USE_HK=1: the HeavyKeeper-filtered registers of reads
    (hashed on the card, added on the host in the tiles' row-major order)
    bitwise the CPU run's, whole and streamed in 2-row windows."""
    from dashing_tpu_torch.sketch.heavykeeper import HeavyKeeper
    assert HeavyKeeper(2, 8).native
    lut = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    starts = rng.integers(0, g.size - 100, 3000)
    codes = g[starts[:, None] + np.arange(100)]
    hit = rng.random(codes.shape) < 0.005
    codes[hit] = (codes[hit] + 1) & 3
    path = tmp_path / "r.fq"
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, lut[c].tobytes(),
                                                      b"I" * 100)
                              for i, c in enumerate(codes)))
    monkeypatch.setenv("DASHING_TPU_USE_HK", "1")
    if streamed:
        monkeypatch.setattr(pipeline, "STREAM_THRESHOLD", 0)
        monkeypatch.setattr(pipeline, "MAX_ROWS", 2)
    params = pipeline.SketchParams(k=31, use_counting_filter=True,
                                   min_count=2, cm_size_log2=14)
    got = pipeline.sketch_file_hll(str(path), params, 14, cuda)
    want = pipeline.sketch_file_hll(str(path), params, 14,
                                    torch.device("cpu"))
    assert 0 < int(got.sum())
    np.testing.assert_array_equal(got, want)


def test_weighted_wide_pair_through_the_kernels(rng, cuda, tmp_path):
    """A `--wj-exact --use-wide-hll` pair (built on the host route, its
    registers the CPU's) through K4's X-only form and K3 on the card
    (`dist`), and K4's joint form and K5 (`-J`): each kernel launched,
    Jaccard within 2e-6 of the CPU run's."""
    from dashing_tpu_torch.cli import core
    from dashing_tpu_torch.sketch.extra import WideHLL
    paths = _genome_files(rng, tmp_path)
    opts = core.CommonOpts(k=21, sketch_size=14, sketch_type="wide_hll",
                           exact_weighted=True)
    assert not core.hll_engine(opts)
    built = {}
    for dev in (cuda, torch.device("cpu")):
        built[dev.type] = [core.build_sketch(
            p, None, opts, core.sketch_params(opts), dev) for p in paths]
    for a, b in zip(built["cuda"], built["cpu"]):
        assert isinstance(a, WideHLL)
        np.testing.assert_array_equal(a.regs, b.regs)
    for jestim, mods in ((est.ERTL_MLE, ((js, "cum_union_launches"),
                                         (um, "launches"))),
                         (est.ERTL_JOINT_MLE, ((js, "launches"),
                                               (jm, "launches")))):
        before = [getattr(m, c) for m, c in mods]
        got = pw.all_pairs_condensed(built["cuda"], pw.JI, 21, est.ERTL_MLE,
                                     jestim, cuda)
        assert all(getattr(m, c) > b for (m, c), b in zip(mods, before))
        want = pw.all_pairs_condensed(built["cpu"], pw.JI, 21, est.ERTL_MLE,
                                      jestim, torch.device("cpu"))
        assert np.isfinite(got).all() and 0.1 < got[0] < 1
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_gf64_on_the_card(rng, cuda):
    """gf64_mul and clhash on int64 tensors on the card equal the numpy
    forms on 2^16 random pairs."""
    from dashing_tpu_torch import hashes
    a = rng.integers(0, 2**64, 1 << 16, dtype=np.uint64)
    b = rng.integers(0, 2**64, 1 << 16, dtype=np.uint64)
    ta = torch.from_numpy(a.view(np.int64)).to(cuda)
    tb = torch.from_numpy(b.view(np.int64)).to(cuda)
    got = hashes.gf64_mul(ta, tb).cpu().numpy().view(np.uint64)
    np.testing.assert_array_equal(got, hashes.gf64_mul_np(a, b))
    got = hashes.clhash(ta, 11).cpu().numpy().view(np.uint64)
    np.testing.assert_array_equal(got, hashes.clhash_np(a, 11))
