"""The port's set sketches (dashing_tpu_torch/sketch/setsketches.py) against
their JAX twins on the CPU: the same numpy-seeded k-mers into both
packages' Bloom filter, bottom-k, counting bottom-k, b-bit MinHash and
counting b-bit MinHash.  Public attributes, cardinalities, Jaccard
indices and triples must be exactly equal (both are the same float64
numpy arithmetic), and so must the decompressed bytes of every written
file; each package reads the other's files.  One test a property,
parametrised over the five families."""
import gzip
import io

import numpy as np
import pytest

from dashing_tpu import hashes as jhashes
from dashing_tpu.cli.core import CommonOpts as JOpts
from dashing_tpu.sketch import setsketches as jss
from dashing_tpu_torch import hashes as thashes
from dashing_tpu_torch.cli.core import CommonOpts as TOpts
from dashing_tpu_torch.sketch import setsketches as tss

FAMILIES = {
    "bf": ("BloomFilter", dict(nbits_log2=13, nhashes=3)),
    "rmh": ("BottomK", dict(kk=256)),
    "crmh": ("CountingBottomK", dict(kk=170)),
    "bbmh": ("BBitMinHash", dict(p=10, b=16)),
    "cbbmh": ("CountingBBitMinHash", dict(p=10, b=8)),
}


def _public(sk):
    return {k: v for k, v in vars(sk).items() if not k.startswith("_")}


def _assert_same(t, j):
    """Equal class name and public attributes (arrays bitwise, with their
    dtypes; the view subcommand dumps exactly these)."""
    assert type(t).__name__ == type(j).__name__
    pt, pj = _public(t), _public(j)
    assert sorted(pt) == sorted(pj)
    for name, v in pj.items():
        if isinstance(v, np.ndarray):
            assert pt[name].dtype == v.dtype, name
            np.testing.assert_array_equal(pt[name], v, err_msg=name)
        else:
            assert pt[name] == v and type(pt[name]) is type(v), name


def _kmers(rng, n_sets=4):
    """Sets of raw 64-bit k-mers sharing a core, with repeats (so the
    counting forms count above 1), top-bit values and a zero."""
    core = rng.integers(0, 2 ** 64 - 1, 3000, dtype=np.uint64,
                        endpoint=True)
    out = []
    for i in range(n_sets):
        own = rng.integers(0, 2 ** 64 - 1, 400 + 300 * i, dtype=np.uint64,
                           endpoint=True)
        vals = np.concatenate([core[:2000 + 300 * i], own,
                               core[:200 * (i + 1)],
                               np.array([0, 1 << 63], np.uint64)])
        out.append(vals)
    return out


def _pair(family, rng_seed=7):
    name, kw = FAMILIES[family]
    rng = np.random.default_rng(rng_seed)
    sets = _kmers(rng)
    js, ts = [], []
    for vals in sets:
        j, t = getattr(jss, name)(**kw), getattr(tss, name)(**kw)
        for part in np.array_split(vals, 3):      # three inserts
            j.addh_np(part)
            t.addh_np(part)
        j.finalize()
        t.finalize()
        js.append(j)
        ts.append(t)
    return js, ts


def test_hash_helpers_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 64 - 1, 5000, dtype=np.uint64, endpoint=True)
    for seed in (0, 0xA5A50000, 0xA5A50003, 2 ** 64 - 1):
        np.testing.assert_array_equal(thashes.seeded_wang_hash_np(x, seed),
                                      jhashes.seeded_wang_hash_np(x, seed))
    for m, n in ((16, 3), (1024, 1024), (1024, 7), (1 << 15, 20000)):
        mins = np.sort(x[:n])
        got = thashes.poisson_min_cardinality(mins, m)
        assert got == jhashes.poisson_min_cardinality(mins, m)
        assert np.isfinite(got) and got > 0
    assert thashes.poisson_min_cardinality(np.zeros(0, np.uint64), 64) == 0.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_inserts_and_reports_equal_jax(family):
    """addh_np in three parts, finalize, report; add_np of hashed values
    (the route of the weighted elements in the JAX package)."""
    js, ts = _pair(family)
    for j, t in zip(js, ts):
        _assert_same(t, j)
        assert t.report() == j.report()
        assert t.cardinality_estimate() == j.cardinality_estimate()
    name, kw = FAMILIES[family]
    h = jhashes.wang_hash_np(_kmers(np.random.default_rng(1))[0])
    j, t = getattr(jss, name)(**kw), getattr(tss, name)(**kw)
    j.add_np(h)
    t.add_np(h)
    j.finalize()
    t.finalize()
    _assert_same(t, j)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_comparisons_equal_jax(family):
    """jaccard_index and full_set_comparison of every ordered pair, the
    sketch with itself and an empty sketch included, exactly equal."""
    js, ts = _pair(family)
    name, kw = FAMILIES[family]
    js.append(getattr(jss, name)(**kw))
    ts.append(getattr(tss, name)(**kw))
    for i in range(len(js)):
        for k in range(len(js)):
            assert ts[i].jaccard_index(ts[k]) == js[i].jaccard_index(js[k])
            assert (ts[i].full_set_comparison(ts[k])
                    == js[i].full_set_comparison(js[k])), (i, k)
    if family in ("rmh", "crmh", "bf"):
        assert ts[0].union_size(ts[1]) == js[0].union_size(js[1])
    if family == "bbmh":
        assert ts[0].union_size(ts[1]) == js[0].union_size(js[1])
        with pytest.raises(ValueError, match="different geometry"):
            ts[0].jaccard_index(tss.BBitMinHash(p=10, b=8))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_merge_equal_jax(family):
    """`+=` (union) in both packages, then the merged sketch's report."""
    js, ts = _pair(family)
    for k in (1, 2, 3):
        js[0] += js[k]
        ts[0] += ts[k]
        _assert_same(ts[0], js[0])
    js[0].finalize()
    ts[0].finalize()
    assert ts[0].report() == js[0].report()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_files_equal_jax(family, tmp_path):
    """write (a path) and write_record (a stream of records): the
    decompressed bytes equal; each package reads the other's files."""
    js, ts = _pair(family)
    for i, (j, t) in enumerate(zip(js, ts)):
        pj, pt = str(tmp_path / f"j{i}"), str(tmp_path / f"t{i}")
        j.write(pj)
        t.write(pt)
        with gzip.open(pj) as a, gzip.open(pt) as b:
            assert a.read() == b.read()
        _assert_same(type(t).read(pj), j)
        _assert_same(type(j).read(pt), t)
    bj, bt = io.BytesIO(), io.BytesIO()
    for j, t in zip(js, ts):
        j.write_record(bj)
        t.write_record(bt)
    assert bt.getvalue() == bj.getvalue()
    bt.seek(0)
    back = [type(ts[0]).read_record(bt) for _ in ts]
    for b, j in zip(back, js):
        _assert_same(b, j)
    with pytest.raises(EOFError):
        type(ts[0]).read_record(bt)
    bt = io.BytesIO(bj.getvalue()[:40])
    with pytest.raises(EOFError, match="truncated"):
        type(ts[0]).read_record(bt)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_make_typed_sizes_equal_jax(family):
    """make_typed over -S 4..24 and -B 8/16/32/64 (and -q hash counts for
    the Bloom filter): the same empty sketch in both packages."""
    for S in (4, 6, 10, 16, 24):
        for bb in (8, 16, 32, 64):
            for nh in ((0, 1, 3) if family == "bf" else (1,)):
                jo, to = JOpts(), TOpts()
                for o in (jo, to):
                    o.sketch_size, o.bbnbits, o.nhashes = S, bb, nh
                _assert_same(tss.make_typed(family, to),
                             jss.make_typed(family, jo))


def test_extra_types_make_and_read_like_jax(tmp_path):
    """make_typed of the wide HLL, HyperMinHash (its register-size table)
    and SuperMinHash over -S and -B: the JAX package's empty sketch; each
    read back by read_typed from the JAX package's file, a DTPUSMH1 file
    as the densified MinHash; an unknown type stops as in the JAX
    package."""
    from dashing_tpu.sketch import extra as jx
    for t in ("wide_hll", "hmh", "superminhash"):
        for S in (4, 6, 10):
            for bb in (8, 16, 32, 64):
                jo, to = JOpts(), TOpts()
                for o in (jo, to):
                    o.sketch_size, o.bbnbits = S, bb
                got, want = tss.make_typed(t, to), jss.make_typed(t, jo)
                _assert_same(got, want)
                path = str(tmp_path / f"{t}.{S}.{bb}")
                want.write(path)
                _assert_same(tss.read_typed(path, t), want)
    old = jx.DensifiedMinHash(5, 16)
    old.addh_np(np.arange(100, dtype=np.uint64))
    old.write(str(tmp_path / "old.bbs"))
    _assert_same(tss.read_typed(str(tmp_path / "old.bbs"), "superminhash"),
                 old)
    with pytest.raises(SystemExit, match="not yet supported"):
        tss.make_typed("nope", TOpts())
    with pytest.raises(SystemExit, match="not yet supported"):
        tss.read_typed(str(tmp_path / "old.bbs"), "nope")