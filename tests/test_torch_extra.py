"""The port's wide HLL, HyperMinHash, SuperMinHash and densified MinHash
(dashing_tpu_torch/sketch/extra.py) against their JAX twins on the CPU:
the same numpy-seeded values into both packages' classes.  Registers,
`h` and `mins` bitwise; written records byte for byte (each package reads
the other's); cardinalities within rtol 1e-5 where the JAX package
estimates in float32 on a device (the wide HLL, HyperMinHash) and exactly
where both are the same float64 numpy (SuperMinHash, densified MinHash);
Jaccard within 2e-6 and triples within rtol 2e-4 / atol 5e-2 (the
north-star bars).  The batched compare engines of the three types equal
the JAX package's float64 triples exactly (HyperMinHash's given the same
cardinalities), and SuperMinHash's b = 64
compare, which dies on an OverflowError in the JAX package, stops here by
name."""
import io

import numpy as np
import pytest
import torch

from dashing_tpu.sketch import batch_compare as jbc
from dashing_tpu.sketch import extra as jx
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.sketch import batch_compare as tbc
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch import extra as tx
from dashing_tpu_torch.sketch.hll import HLL

CPU = torch.device("cpu")
TRI_RTOL, TRI_ATOL, JI_ATOL = 2e-4, 5e-2, 2e-6


def _sets(rng, n=4, base_n=6000):
    """Raw 64-bit k-mer sets sharing a core (every pair related), with
    repeats, a zero and a top-bit value."""
    core = rng.integers(0, 2 ** 64 - 1, base_n, dtype=np.uint64,
                        endpoint=True)
    out = []
    for i in range(n):
        own = rng.integers(0, 2 ** 64 - 1, 500 + 400 * i, dtype=np.uint64,
                           endpoint=True)
        out.append(np.concatenate([core[:3000 + 700 * i], own,
                                   core[:300], np.array([0, 1 << 63],
                                                        np.uint64)]))
    return out


def _pair(cls_name, args, sets):
    t = [getattr(tx, cls_name)(*args) for _ in sets]
    j = [getattr(jx, cls_name)(*args) for _ in sets]
    for a, b, v in zip(t, j, sets):
        a.addh_np(v)
        b.addh_np(v)
        a.finalize()
        b.finalize()
    return t, j


def _record(sk):
    buf = io.BytesIO()
    sk.write_record(buf)
    return buf.getvalue()


def _public(sk):
    return {k: v for k, v in vars(sk).items() if not k.startswith("_")}


def _assert_same(t, j):
    """Equal class name and public attributes (`view` dumps these)."""
    assert type(t).__name__ == type(j).__name__
    pt, pj = _public(t), _public(j)
    assert sorted(pt) == sorted(pj)
    for name, v in pj.items():
        if isinstance(v, np.ndarray):
            assert pt[name].dtype == v.dtype, name
            np.testing.assert_array_equal(pt[name], v, err_msg=name)
        else:
            assert pt[name] == v and type(pt[name]) is type(v), name


def _roundtrip(t, j):
    """Each package reads the other's record back to the same sketch."""
    tr, jr = _record(t), _record(j)
    assert tr == jr
    _assert_same(type(t).read_record(io.BytesIO(jr)), j)
    _assert_same(type(j).read_record(io.BytesIO(tr)), t)


# ---------------------------------------------------------------------------
# WideHLL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 12])
@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_wide_hll_matches_jax(rng, p, jestim):
    """Registers, records, report, full_set_comparison (inclusion-exclusion
    and the joint MLE), Jaccard, union_size, merge and the `view` dump."""
    sets = _sets(rng)
    t, j = _pair("WideHLL", (p, est.ERTL_MLE, jestim), sets)
    for a, b in zip(t, j):
        _assert_same(a, b)
        _roundtrip(a, b)
        assert a.report() == pytest.approx(b.report(), rel=1e-5)
    for x in range(len(sets)):
        for y in range(x + 1, len(sets)):
            got = np.array(t[x].full_set_comparison(t[y], CPU))
            want = np.array(j[x].full_set_comparison(j[y]))
            np.testing.assert_allclose(got, want, rtol=TRI_RTOL,
                                       atol=TRI_ATOL)
            assert abs(t[x].jaccard_index(t[y], CPU)
                       - j[x].jaccard_index(j[y])) <= JI_ATOL
            assert t[x].union_size(t[y]) == pytest.approx(
                j[x].union_size(j[y]), rel=1e-5)
    t[0] += t[1]
    j[0] += j[1]
    _assert_same(t[0], j[0])
    assert t[0].report() == pytest.approx(j[0].report(), rel=1e-5)
    tp, jp = io.StringIO(), io.StringIO()
    t[0].printf(tp)
    j[0].printf(jp)
    assert tp.getvalue() == jp.getvalue()
    assert tp.getvalue().startswith(f"WideHLL p={p} m={1 << p} ")


@pytest.mark.parametrize("p,new_p", [(12, 11), (12, 6), (10, 4)])
def test_wide_hll_compress_is_hll_compress_widened(rng, p, new_p):
    """fold: the JAX WideHLL's and the port HLL's fold, widened."""
    v = _sets(rng, 1)[0]
    t, j, h = tx.WideHLL(p), jx.WideHLL(p), HLL(p)
    for sk in (t, j, h):
        sk.addh_np(v)
    got, want = t.compress(new_p), j.compress(new_p)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.regs,
                                  h.compress(new_p).regs.astype(np.uint16))
    with pytest.raises(ValueError):
        t.compress(p)


def test_wide_registers_reach_the_kernels_as_hll_registers(rng):
    """A wide rank is at most 65 - p, so _device_regs' int8 clamp never
    bites: the wide bank is the HLL bank, and so is every compare."""
    sets = _sets(rng)
    wide, hll = [], []
    for v in sets:
        w, h = tx.WideHLL(4), HLL(4)
        w.addh_np(v)
        h.addh_np(v)
        wide.append(w)
        hll.append(h)
    wide[0].regs[:] = 61                       # the top rank at p = 4
    hll[0].regs[:] = 61
    ra, rb = pw._stack_regs(wide), pw._stack_regs(hll)
    assert torch.equal(pw._device_regs(ra, CPU), pw._device_regs(rb, CPU))
    for jestim in (est.ERTL_MLE, est.ERTL_JOINT_MLE):
        got = pw.all_pairs_condensed(wide, pw.MASH_DIST, 21, est.ERTL_MLE,
                                     jestim, CPU)
        want = pw.all_pairs_condensed(hll, pw.MASH_DIST, 21, est.ERTL_MLE,
                                      jestim, CPU)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# HyperMinHash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regwidth", [8, 16, 32, 64])
def test_hyperminhash_matches_jax(rng, regwidth):
    """Packed registers, regwidth clamped at 32, rbits; records; getcard;
    the collision-corrected Jaccard and triples; merge."""
    sets = _sets(rng)
    t, j = _pair("HyperMinHash", (10, regwidth), sets)
    assert t[0].regwidth == min(regwidth, 32)
    assert t[0].rbits == max(t[0].regwidth - 6, 2)
    for a, b in zip(t, j):
        _assert_same(a, b)
        _roundtrip(a, b)
        assert a.getcard() == pytest.approx(b.getcard(), rel=1e-5)
    for x in range(len(sets)):
        for y in range(len(sets)):
            assert t[x].jaccard_index(t[y]) == j[x].jaccard_index(j[y])
            np.testing.assert_allclose(t[x].full_set_comparison(t[y]),
                                       j[x].full_set_comparison(j[y]),
                                       rtol=TRI_RTOL, atol=TRI_ATOL)
    assert t[0].jaccard_index(t[0]) == 1.0
    empty = tx.HyperMinHash(10, regwidth)
    assert empty.jaccard_index(tx.HyperMinHash(10, regwidth)) == 0.0
    t[0] += t[2]
    j[0] += j[2]
    _assert_same(t[0], j[0])


# ---------------------------------------------------------------------------
# SuperMinHash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [8, 16, 32])
def test_superminhash_matches_jax(rng, b):
    """float64 registers bitwise (the lazy permutation and its early stop
    copied loop for loop); records; report, Jaccard and triples exactly
    (the same float64 numpy)."""
    sets = _sets(rng)
    t, j = _pair("SuperMinHash", (8, b), sets)
    for a, b_ in zip(t, j):
        _assert_same(a, b_)
        _roundtrip(a, b_)
        assert a.report() == b_.report()
    for x in range(len(sets)):
        for y in range(len(sets)):
            assert t[x].jaccard_index(t[y]) == j[x].jaccard_index(j[y])
            assert t[x].full_set_comparison(t[y]) == \
                j[x].full_set_comparison(j[y])
    assert t[1].jaccard_index(t[1]) == 1.0
    assert tx.SuperMinHash(8, b).report() == 0.0
    assert tx.SuperMinHash(8, b).jaccard_index(t[0]) == 0.0


def test_superminhash_order_chunk_and_merge_invariance(rng):
    """The registers do not depend on the element order, on the chunking
    (inserted in pieces, or with a chunk of 7), and a merge is the union's
    sketch."""
    a, b = _sets(rng, 2)
    whole = tx.SuperMinHash(7, 16)
    whole.addh_np(np.concatenate([a, b]))
    shuffled = tx.SuperMinHash(7, 16)
    shuffled.addh_np(rng.permutation(np.concatenate([b, a])))
    pieces = tx.SuperMinHash(7, 16)
    for part in np.array_split(np.concatenate([a, b]), 5):
        pieces.addh_np(part)
    small = tx.SuperMinHash(7, 16)
    small._CHUNK = 7
    small.addh_np(np.concatenate([a, b]))
    merged = tx.SuperMinHash(7, 16)
    merged.addh_np(a)
    other = tx.SuperMinHash(7, 16)
    other.addh_np(b)
    merged += other
    for sk in (shuffled, pieces, small, merged):
        np.testing.assert_array_equal(sk.h, whole.h)


def test_superminhash_b64_stops_by_name(rng, tmp_path):
    """At b = 64 the JAX package's compare dies on an OverflowError; the
    port stops with a SystemExit that names the limit.  Both write the
    same file."""
    sets = _sets(rng, 2)
    t, j = _pair("SuperMinHash", (6, 64), sets)
    assert _record(t[0]) == _record(j[0])
    with pytest.raises(OverflowError):
        j[0].jaccard_index(j[1])
    with pytest.raises(OverflowError):
        jbc.batch_triples(j, j)
    for fn in (lambda: t[0].jaccard_index(t[1]),
               lambda: tbc.batch_triples(t, t)):
        with pytest.raises(SystemExit, match="b < 64"):
            fn()


# ---------------------------------------------------------------------------
# DensifiedMinHash (DTPUSMH1, read-only in the CLI)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [8, 16])
def test_densified_minhash_matches_jax(rng, b):
    """Bucket minima, densification, records, the Poisson cardinality,
    Jaccard and triples exactly; a near-empty sketch densifies from its
    few filled buckets."""
    sets = _sets(rng) + [rng.integers(0, 2 ** 64 - 1, 5, dtype=np.uint64)]
    t, j = _pair("DensifiedMinHash", (9, b), sets)
    for a, b_ in zip(t, j):
        _assert_same(a, b_)
        _roundtrip(a, b_)
        np.testing.assert_array_equal(a._densified(), b_._densified())
        assert a.report() == b_.report()
    for x in range(len(sets)):
        for y in range(len(sets)):
            assert t[x].full_set_comparison(t[y]) == \
                j[x].full_set_comparison(j[y])
    t[0] += t[1]
    j[0] += j[1]
    _assert_same(t[0], j[0])
    assert t[0].report() == j[0].report()


# ---------------------------------------------------------------------------
# The batched engines
# ---------------------------------------------------------------------------

ENGINE_CASES = [("HyperMinHash", (9, 16)), ("HyperMinHash", (8, 32)),
                ("SuperMinHash", (7, 16)), ("SuperMinHash", (7, 8)),
                ("DensifiedMinHash", (9, 16))]


@pytest.mark.parametrize("name,args", ENGINE_CASES)
def test_batch_triples_equal_jax(rng, monkeypatch, name, args):
    """batch_triples of the port equals the JAX engine's float64 triples
    exactly, rectangular and square, with the B axis tiled by a tiny
    DASHING_TPU_HOST_TILE_MB too; an empty sketch among them (SuperMinHash:
    Jaccard 0 against everything).  HyperMinHash's cardinality is each
    package's float32 MLE (equal within rtol 1e-5, not bitwise): its
    triples are held within that bar, and bitwise once the port's sketches
    hold the JAX package's cardinalities."""
    sets = _sets(rng, 5) + [np.zeros(0, np.uint64)]
    t, j = _pair(name, args, sets)
    hmh = name == "HyperMinHash"
    if hmh:
        np.testing.assert_allclose(tbc.batch_triples(t[:3], t),
                                   jbc.batch_triples(j[:3], j), rtol=1e-5)
        for a, b in zip(t, j):
            a._card_cache = b.getcard()
    want = jbc.batch_triples(j[:3], j)
    got = tbc.batch_triples(t[:3], t)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("DASHING_TPU_HOST_TILE_MB", "0.001")
    np.testing.assert_array_equal(tbc.batch_triples(t, t),
                                  jbc.batch_triples(j, j))
    assert tbc.supports(t)
    for x in range(3):
        assert tuple(got[x, 4]) == t[x].full_set_comparison(t[4])
