"""Register banks on the CPU: the banked forms of K1 and K2
(`ops/encode_hash.packed_to_banks` / `ascii_to_banks`, their plain
versions here), the small-file batches (`pipeline.sketch_small_batch_async`)
and the per-record sketches (`pipeline.sketch_records_hll`), held bitwise
against the JAX package's `sketch_small_batch_async`, `sketch_records_hll`
and single-file folds, and against folding each bank's rows alone."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py keeps JAX on the CPU)

from dashing_tpu import pipeline as jpipe
from dashing_tpu_torch import pipeline
from dashing_tpu_torch.ops import encode_hash as eh
from dashing_tpu_torch.ops.hll_update import update_banks

torch.set_num_threads(1)
CPU = torch.device("cpu")

# encoder parameters of both packages' SketchParams: the packed route
# (K1 here), a spaced seed, a minimizer window and ntHash (the PyTorch
# encoders and a banked scatter-max)
PARAMS = {
    "exact": dict(k=21),
    "spaced": dict(k=15, spacing="1x2"),
    "window": dict(k=17, w=30),
    "nthash": dict(k=40, encoding="nthash"),
}


def _ascii(rng, shape, n_rate=0.01):
    tile = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=shape,
                      p=[0.22] * 4 + [0.03] * 4)
    tile[rng.random(shape) < n_rate] = ord("N")
    return tile


def _both(name):
    kw = PARAMS[name]
    return pipeline.SketchParams(**kw), jpipe.SketchParams(**kw)


def _chunk(rng, rows, params, tail=None):
    """A single-chunk file's tile, as pipeline._joined_tiles cuts it."""
    sp = params.spacer()
    n = rows * pipeline.CONTENT if tail is None else tail
    seq = _ascii(rng, (n,))
    tiles = list(pipeline._joined_tiles(seq, sp.halo))
    assert len(tiles) == 1
    return tiles[0]


@pytest.mark.parametrize("p", [2, 10, 14, 21, 22, 25, 31])
def test_small_batch_size_matches_jax(p):
    assert pipeline.small_batch_size(p) == jpipe.small_batch_size(p)
    assert (pipeline.small_batch_size(p) == 0) == (p >= 22)


@pytest.mark.parametrize("form", ["packed", "ascii"])
def test_banked_plain_equals_each_bank_alone(rng, form):
    """Banks from one call: rows of non-monotone bank indices, one bank
    left empty, rows whose bank lies outside [0, B) folding nothing;
    each bank equals its rows folded alone by the single-bank entry."""
    k, p, B, R = 13, 10, 5, 23
    tile = _ascii(rng, (R, 200))
    bank = rng.integers(0, B, R).astype(np.int32)
    bank[bank == 3] = 1                       # bank 3 gets no row
    bank[[4, 9]] = [-1, B]                    # dropped rows
    t, b = torch.from_numpy(tile), torch.from_numpy(bank)
    regs = torch.zeros((B, 1 << p), dtype=torch.int32)
    if form == "packed":
        pk, vb = (torch.from_numpy(a) for a in pipeline._pack_tile_host(tile))
        eh.packed_to_banks(pk, vb, b, regs, k=k, p=p)
    else:
        eh.ascii_to_banks(t, b, regs, k=k, p=p)
    assert not regs[3].any()
    for j in range(B):
        rows = torch.from_numpy(np.flatnonzero(bank == j))
        want = torch.zeros(1 << p, dtype=torch.int32)
        if len(rows):
            eh.ascii_to_registers(t[rows], want, k=k, p=p)
        assert torch.equal(regs[j], want), j
    # the same rows through the generic banked scatter-max
    h, valid = pipeline.tile_hashes(t, **pipeline._encode_kw(
        pipeline.SketchParams(k=k), pipeline.SketchParams(k=k).spacer()))
    again = update_banks(torch.zeros_like(regs), h, valid, b, p)
    assert torch.equal(again, regs)


def test_banked_wrappers_check_their_arguments():
    t = torch.zeros((3, 40), dtype=torch.uint8)
    regs = torch.zeros((2, 1 << 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        eh.ascii_to_banks(t, torch.zeros(2, dtype=torch.int32), regs, k=5,
                          p=8)
    with pytest.raises(TypeError):
        eh.ascii_to_banks(t, torch.zeros(3, dtype=torch.int64), regs, k=5,
                          p=8)
    with pytest.raises(TypeError):
        eh.ascii_to_banks(t, torch.zeros(3, dtype=torch.int32),
                          torch.zeros((2, 1 << 7), dtype=torch.int32), k=5,
                          p=8)
    with pytest.raises(ValueError):
        eh.ascii_to_banks(t, torch.zeros(3, dtype=torch.int32), regs, k=5,
                          p=32)


@pytest.mark.parametrize("kind", ["permuted", "interleaved", "outside"])
def test_row_order_groups_each_bank(rng, kind):
    """`row_order` on a bank vector in no order: a permutation of the rows
    under which the banks are non-decreasing (each bank one run, rows
    outside [0, B) at the ends) and a bank's rows keep their order; the
    banks folded in that order are the same."""
    B, R, p = 6, 40, 10
    bank = (np.arange(R) % B).astype(np.int32)
    if kind == "permuted":
        bank = rng.permutation(bank)
    elif kind == "outside":
        bank = rng.permutation(bank)
        bank[[3, 17, 30]] = [-1, B, -7]
    b = torch.from_numpy(bank)
    order = eh.row_order(b, bank_sorted=False, p=p)
    assert order.dtype == torch.int32 and order.shape == (R,)
    o = order.numpy()
    assert sorted(o.tolist()) == list(range(R))
    assert (np.diff(bank[o]) >= 0).all()
    for j in np.unique(bank):
        assert (np.diff(o[bank[o] == j]) > 0).all(), j
    tile = _ascii(rng, (R, 120))
    t = torch.from_numpy(tile)
    want = eh.ascii_to_banks(t, b, torch.zeros((B, 1 << p), dtype=torch.int32),
                             k=11, p=p)
    got = eh.ascii_to_banks(t[order.long()], b[order.long()],
                            torch.zeros((B, 1 << p), dtype=torch.int32),
                            k=11, p=p)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bank,sorted_,p", [
    ([0, 0, 1, 1, 2], True, eh.ONCHIP_MAX_P),   # said to be sorted
    ([2, 0, 1], True, eh.ONCHIP_MAX_P),         # said so, wrongly
    ([3], False, eh.ONCHIP_MAX_P),              # one row
    ([], False, eh.ONCHIP_MAX_P),               # no row
    ([2, 0, 1], False, eh.ONCHIP_MAX_P + 1),    # the global form's p
])
def test_row_order_none(bank, sorted_, p):
    """No ordering where the rows are taken as they come: a vector the
    caller says is sorted (the kernel gives the same banks if it is not),
    fewer than two rows, a p above ONCHIP_MAX_P."""
    b = torch.tensor(bank, dtype=torch.int32)
    assert eh.row_order(b, bank_sorted=sorted_, p=p) is None


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("p", [10, 14, 21])
def test_small_batch_matches_jax(rng, name, p):
    """B equal-shape single-chunk files: the port's (B, 2^p) banks equal
    the JAX package's, bit for bit (p = 21: the last p that batches)."""
    params, jparams = _both(name)
    # 7 files: the JAX package's CPU mesh of 8 shards only a multiple of 8
    B = 7
    chunks = [_chunk(rng, 1, params, tail=int(rng.integers(300, 900)))
              for _ in range(B)]
    width = max(c.shape[1] for c in chunks)
    assert all(c.shape[1] == width for c in chunks)
    packed = pipeline.packed_ok(params, params.spacer(), p)
    got = pipeline.sketch_small_batch_async(chunks, params, p, CPU, packed)
    want = np.asarray(jpipe.sketch_small_batch_async(
        np.stack(chunks), jparams, p))
    assert got.shape == (B, 1 << p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum(axis=1).min() > 0


@pytest.mark.parametrize("name", ["exact", "window"])
def test_small_batch_mixed_rows_and_empty(rng, name):
    """One launch over files of different row counts (1, 2 and 3 rows, and
    an all-N file): each bank equals the JAX package's fold of that file
    alone."""
    params, jparams = _both(name)
    p = 12
    chunks = [_chunk(rng, 1, params, tail=500),
              _chunk(rng, 3, params, tail=2 * pipeline.CONTENT + 77),
              np.full_like(_chunk(rng, 1, params, tail=100), ord("N")),
              _chunk(rng, 2, params, tail=pipeline.CONTENT + 5)]
    assert [c.shape[0] for c in chunks] == [1, 3, 1, 2]
    packed = pipeline.packed_ok(params, params.spacer(), p)
    got = pipeline.sketch_small_batch_async(chunks, params, p, CPU,
                                            packed).numpy()
    for j, c in enumerate(chunks):
        want = np.asarray(jpipe._sketch_chunk_stream([c], jparams, p))
        np.testing.assert_array_equal(got[j], want)
    assert not got[2].any()


def _records(rng, n, halo):
    """Records of many lengths: empty, shorter than k, a few bases past
    the batch width, lowercase and N runs."""
    lens = [0, 5, 30, 200, 1000, 1500, 1024 - halo, 1025 - halo, 3000, 40]
    lens += list(rng.integers(1, 2000, n - len(lens)))
    return [_ascii(rng, (int(m),), 0.02).tobytes() for m in lens]


@pytest.mark.parametrize("name", list(PARAMS))
def test_records_match_jax(rng, monkeypatch, name):
    """Per-record registers, bitwise the JAX package's; records wider than
    MAX_RECORD_WIDTH (set to 1024 in both packages) take the single-
    sequence path; a batch of 7 records a launch."""
    params, jparams = _both(name)
    p = 10
    monkeypatch.setattr(pipeline, "MAX_RECORD_WIDTH", 1024)
    monkeypatch.setattr(jpipe, "MAX_RECORD_WIDTH", 1024)
    seqs = _records(rng, 40, params.spacer().halo)
    got = pipeline.sketch_records_hll(seqs, params, p, CPU, batch=7)
    want = jpipe.sketch_records_hll(seqs, jparams, p, batch=7)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and got.any(axis=1).sum() > 30
    wide = [i for i, s in enumerate(seqs)
            if len(s) + params.spacer().halo > 1024]
    assert wide
    for i in wide[:3]:
        np.testing.assert_array_equal(
            got[i], pipeline.sketch_file_seq(seqs[i], params, p, CPU))


def test_records_use_banked_k2(rng, monkeypatch):
    """The exact contiguous k-mers take the banked K2 entry (its plain
    version on the CPU), once a batch."""
    calls = []
    real = eh.ascii_to_banks_plain
    monkeypatch.setattr(eh, "ascii_to_banks_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    params = pipeline.SketchParams(k=21)
    seqs = _records(rng, 30, params.spacer().halo)
    pipeline.sketch_records_hll(seqs, params, 10, CPU, batch=8)
    assert len(calls) == 4


@pytest.mark.parametrize("name", ["exact", "spaced", "nthash"])
def test_record_kmer_hashes_match_jax(rng, monkeypatch, name):
    params, jparams = _both(name)
    monkeypatch.setattr(pipeline, "MAX_RECORD_WIDTH", 1024)
    monkeypatch.setattr(jpipe, "MAX_RECORD_WIDTH", 1024)
    seqs = _records(rng, 20, params.spacer().halo)
    raw = dict(rehash=False)
    import dataclasses
    got = pipeline.records_kmer_hashes(
        seqs, dataclasses.replace(params, **raw), CPU, batch=6)
    want = jpipe.records_kmer_hashes(
        seqs, dataclasses.replace(jparams, **raw), batch=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.sort(g), np.sort(w))
    seq = seqs[8]
    np.testing.assert_array_equal(
        np.sort(pipeline.seq_kmer_hashes(seq, params, CPU)),
        np.sort(jpipe.seq_kmer_hashes(seq, jparams)))


def test_multik_matches_per_k(rng, tmp_path):
    """One upload a chunk for four k (the largest halo): each k's
    registers equal the JAX package's sketch of the file at that k, and
    the int8 device rows their clamp; K1 runs once per k a chunk."""
    seq = _ascii(rng, (pipeline.CONTENT * 2 + 3000,))
    path = tmp_path / "g.fa"
    path.write_bytes(b">a\n" + seq[:9000].tobytes() + b"\n>b\n"
                     + seq[9000:].tobytes() + b"\n")
    ks, p = (9, 17, 25, 31), 12
    params = [pipeline.SketchParams(k=k) for k in ks]
    before = pipeline.chunk_uploads
    host, dev = pipeline.sketch_file_hll_multik(str(path), params, p, CPU,
                                                keep_device=True)
    assert pipeline.chunk_uploads - before == 1      # one 3-row chunk
    for k, h, d in zip(ks, host, dev):
        want = jpipe.sketch_file_hll(str(path), jpipe.SketchParams(k=k), p)
        np.testing.assert_array_equal(h, want)
        assert d.dtype == torch.int8
        np.testing.assert_array_equal(d.numpy(), np.minimum(h, 127))
    # a spaced seed beside them takes the ASCII upload, once
    mixed = params[:2] + [pipeline.SketchParams(k=15, spacing="1x2")]
    before = pipeline.chunk_uploads
    host = pipeline.sketch_file_hll_multik(str(path), mixed, p, CPU)
    assert pipeline.chunk_uploads - before == 2
    np.testing.assert_array_equal(host[2], jpipe.sketch_file_hll(
        str(path), jpipe.SketchParams(k=15, spacing="1x2"), p))
