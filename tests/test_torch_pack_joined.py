"""The packed route read straight from a file's joined bytes, on the CPU.

`pipeline._pack_joined_host` (the native `dtt_pack_joined`, and its numpy
fallback) must give, chunk by chunk, the bytes that tiling and padding the
join and then packing the tile give (`_pack_tile_host_inner` of the rows
of `_pad8(tile_sequence(...))`), at both kinds of halo, on every byte
value, lowercase, N runs and record separators, at the lengths where rows
and chunks begin and end.  The word-at-a-time `dtpu_pack2bit` is held to
the same numpy packer.  End to end, `dist` on multi-chunk files gives
bitwise what the ASCII-tile route gives, `joined_packs` counts each such
chunk and reads 0 where the route does not apply, and the golden fixtures
hold with their genomes cut into several chunks."""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.io import distmat, native
from dashing_tpu_torch.ops.encode import join_records, tile_sequence
from dashing_tpu_torch.parallel import mesh
from dashing_tpu_torch.sketch.hll import HLL

CPU = torch.device("cpu")
C, R = pipeline.CONTENT, pipeline.MAX_ROWS
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# k = 25: CONTENT + halo is a multiple of 8; k = 31: _pad8 adds 2 columns
HALOS = {"k25": 24, "k31": 30}


def _lengths(halo):
    return [0, 1, C - 1, C, C + 1, R * C, R * C + halo - 1, R * C + halo,
            R * C + halo + 1, 611 * C - 4321]


def _joined(kind, n, halo, rng):
    """n joined bytes of one kind: every byte value; ACGT in both cases
    with runs of N and n; or records of ACGT joined by `halo` zero bytes
    (the parser's separators)."""
    if kind == "bytes":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "lower_n":
        seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), n)
        for start in rng.integers(0, max(n, 1), max(1, n // 5000)):
            seq[start:start + int(rng.integers(1, 300))] = \
                ord("N") if start % 2 else ord("n")
        return seq
    recs, total = [], 0
    while total < n:
        size = int(rng.integers(1, 3 * C))
        recs.append(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               size).tobytes())
        total += size + halo
    return join_records(recs, halo)[:n]


def _tiled_chunks(joined, halo):
    """Today's chunks: tile, pad to %8, cut into MAX_ROWS rows, pack."""
    tiles = pipeline._pad8(tile_sequence(joined, C, halo))
    return [pipeline._pack_tile_host_inner(t)
            for t in pipeline._row_chunks(tiles)]


def _fused_chunks(joined, halo):
    rows = pipeline.joined_rows(joined.size)
    return [pipeline._pack_joined_host(joined, halo, r0, min(R, rows - r0))
            for r0 in range(0, rows, R)]


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for (gp, gv), (wp, wv) in zip(got, want):
        assert gp.dtype == wp.dtype == np.uint8
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("kind", ["bytes", "lower_n", "separators"])
@pytest.mark.parametrize("k", sorted(HALOS))
def test_fused_chunks_equal_tiled(kind, k, rng):
    halo = HALOS[k]
    assert native.available()
    for n in _lengths(halo):
        joined = _joined(kind, n, halo, rng)
        assert joined.size == n
        want = _tiled_chunks(joined, halo)
        assert pipeline.joined_rows(n) == sum(p.shape[0] for p, _ in want)
        _assert_chunks_equal(_fused_chunks(joined, halo), want)


@pytest.mark.parametrize("k", sorted(HALOS))
def test_fused_rows_mid_file(k, rng):
    """Any run of rows, not only whole chunks: row0 mid-file, and runs
    that end on the file's short last row."""
    halo = HALOS[k]
    joined = _joined("bytes", 611 * C - 4321, halo, rng)
    tiles = pipeline._pad8(tile_sequence(joined, C, halo))
    for row0, rows in [(100, 37), (255, 2), (300, 311), (610, 1), (0, 611)]:
        want = pipeline._pack_tile_host_inner(tiles[row0:row0 + rows])
        _assert_chunks_equal(
            [pipeline._pack_joined_host(joined, halo, row0, rows)], [want])


@pytest.mark.parametrize("n", [1, C + 1, R * C + 31, 3 * R * C - 7])
def test_numpy_fallback(monkeypatch, rng, n):
    """Without the native library the fused pack tiles the chunk's rows
    alone and packs them with numpy: the same bytes."""
    halo = HALOS["k31"]
    joined = _joined("lower_n", n, halo, rng)
    want = _tiled_chunks(joined, halo)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.pack_joined(joined, C, halo, 8224, 0, 1) is None
    _assert_chunks_equal(_fused_chunks(joined, halo), want)


def test_pack_joined_refuses_bad_geometry():
    joined = np.zeros(100, np.uint8)
    with pytest.raises(ValueError, match="refused"):
        native.pack_joined(joined, C, 30, 8220, 0, 1)      # not % 8
    with pytest.raises(ValueError, match="refused"):
        native.pack_joined(joined, C, 30, C + 24, 0, 1)    # narrower


@pytest.mark.parametrize("width", [8, 16, 24, 40, 8216, 8224])
def test_word_pack2bit_every_byte(width, rng):
    """dtpu_pack2bit, 16 and 8 bases a step, against the numpy packer on
    tiles that hold every byte value, at widths that are and are not a
    multiple of 16."""
    rows = 3 + (512 // width)
    tile = rng.integers(0, 256, (rows, width), dtype=np.uint8)
    tile.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    got = native.pack2bit(tile)
    assert got is not None
    _assert_chunks_equal([got], [pipeline._pack_tile_host_inner(tile)])


def test_sketch_joined_uploads_what_tiles_upload(monkeypatch, rng):
    """sketch_joined_async uploads the arrays, in the order, that
    sketch_chunk_stream uploads for the join's ASCII tiles, into the same
    registers."""
    halo = HALOS["k31"]
    joined = _joined("lower_n", 2 * R * C + 999, halo, rng)
    params = pipeline.SketchParams(k=31)
    uploads = []
    orig = pipeline._upload

    def spy(*arrays, device):
        uploads.append([a.copy() for a in arrays])
        return orig(*arrays, device=device)
    monkeypatch.setattr(pipeline, "_upload", spy)
    f = pipeline.InputFile(0, "joined", params.spacer(), joined)
    assert pipeline.file_route(f, False, True, 64) == "joined"
    before = pipeline.joined_packs
    got = pipeline.registers_to_numpy(
        pipeline.sketch_joined_async(joined, params, 12, CPU))
    assert pipeline.joined_packs - before == 3
    fused, uploads[:] = list(uploads), []
    want = pipeline.registers_to_numpy(pipeline.sketch_chunk_stream(
        f.tiles(), params, 12, CPU, True))
    np.testing.assert_array_equal(got, want)
    assert got.any()
    assert len(fused) == len(uploads) == 3
    for a, b in zip(fused, uploads):
        _assert_chunks_equal([tuple(a)], [tuple(b)])


def test_sketch_joined_on_mesh(monkeypatch, rng):
    """On a mesh the chunks go round-robin over its cards, as
    sketch_chunk_stream sends them."""
    monkeypatch.setattr(pipeline, "MAX_ROWS", 2)
    joined = _joined("lower_n", 9 * C + 5, HALOS["k25"], rng)
    params = pipeline.SketchParams(k=25)
    off = pipeline.registers_to_numpy(
        pipeline.sketch_joined_async(joined, params, 12, CPU))
    seen = []
    orig = pipeline.packed_to_registers

    def spy(pk, vb, regs, **kw):
        seen.append(regs.data_ptr())
        return orig(pk, vb, regs, **kw)
    monkeypatch.setattr(pipeline, "packed_to_registers", spy)
    mesh._set_local_mesh_for_tests((CPU,) * 4)
    try:
        on = pipeline.registers_to_numpy(
            pipeline.sketch_joined_async(joined, params, 12, CPU))
    finally:
        mesh._set_local_mesh_for_tests(None, frozen=False)
    np.testing.assert_array_equal(on, off)
    assert len(seen) == 5 and len(set(seen)) == 4


# --- end to end -------------------------------------------------------------

def _write_genomes(root, rng, length, n=3):
    """FASTAs of one ancestor at small substitution rates, two records a
    file, the second lowercase, with a run of N."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, length, dtype=np.uint8)
    names = []
    for i in range(n):
        g = anc.copy()
        hit = np.flatnonzero(rng.random(length) < 0.004 * i)
        g[hit] = (g[hit] + 1) & 3
        seq = bytearray(lut[g].tobytes())
        seq[length // 3:length // 3 + 150] = b"N" * 150
        cut = length // 2
        (root / f"g{i}.fa").write_bytes(
            b">a\n%s\n>b\n%s\n" % (bytes(seq[:cut]), bytes(seq[cut:]).lower()))
        names.append(f"g{i}.fa")
    return names


def _ascii_tiles_only(monkeypatch):
    """From here on, every file is tiled and then packed, as before the
    route read the joined bytes."""
    route = pipeline.file_route

    def tiled(*a):
        r = route(*a)
        return "stream" if r == "joined" else r
    monkeypatch.setattr(pipeline, "file_route", tiled)


def _dist(argv, out):
    before = pipeline.joined_packs
    assert tmain.main(list(argv)) == 0
    with open(out, "rb") as fp:
        body = fp.read()
    with open(out + ".labels", "rb") as fp:
        labels = fp.read()
    return body, labels, pipeline.joined_packs - before


@pytest.fixture()
def on_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    return tmp_path


def test_dist_multichunk_equals_ascii_tiles(on_cpu, monkeypatch):
    """dist -k 31 -S 16 -M -b on three files of three chunks each, at the
    real geometry: the matrix, labels and sizes bitwise the ASCII-tile
    route's, with every chunk packed from the joined bytes."""
    names = _write_genomes(on_cpu, np.random.default_rng(31),
                           2 * R * C + 4000)
    argv = ["dist", "-k", "31", "-S", "16", "-M", "-b", "-O", "d.bin",
            "-o", "sizes.tsv"] + names
    uploads = pipeline.chunk_uploads
    got, labels, packs = _dist(argv, "d.bin")
    assert pipeline.chunk_uploads - uploads == 9 and packs == 9
    sizes = (on_cpu / "sizes.tsv").read_bytes()
    _ascii_tiles_only(monkeypatch)
    want, want_labels, none = _dist(argv, "d.bin")
    assert none == 0
    assert got == want and labels == want_labels
    assert sizes == (on_cpu / "sizes.tsv").read_bytes()


@pytest.mark.parametrize("case,packs", [
    ("packed", 3 * 4),              # 3 files of 7 rows, 2 rows a chunk
    ("w50", 0),                     # minimizers: the ASCII route
    ("single_chunk", 0),            # MAX_ROWS rows hold every file
    ("filtered", 0),                # count-min: two passes over tiles
])
def test_joined_packs_counts_its_chunks(on_cpu, monkeypatch, case, packs):
    """The route engages on each chunk of a multi-chunk file on the packed
    route, and nowhere else; every case's output is the ASCII-tile
    route's, bitwise."""
    monkeypatch.setattr(pipeline, "CONTENT", 1024)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 64 if case == "single_chunk"
                        else 2)
    names = _write_genomes(on_cpu, np.random.default_rng(7), 7 * 1024 - 300)
    extra = {"w50": ["-w", "50"], "filtered": ["-y", "-c", "2"]}.get(case,
                                                                    [])
    argv = (["dist", "-k", "31", "-S", "12", "-M", "-b", "-O", "d.bin"]
            + extra + names)
    got, _, n = _dist(argv, "d.bin")
    assert n == packs
    _ascii_tiles_only(monkeypatch)
    want, _, _ = _dist(argv, "d.bin")
    assert got == want


@pytest.fixture()
def golden_cut(monkeypatch, tmp_path):
    """The golden genomes (3 kbp) in rows of 256 bases and chunks of 3
    rows: each file is 4 chunks, packed from its joined bytes."""
    for name in ("g0.fa", "g1.fa", "g2.fa"):
        shutil.copy(os.path.join(GOLDEN, name), tmp_path / name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(pipeline, "CONTENT", 256)
    monkeypatch.setattr(pipeline, "MAX_ROWS", 3)
    return tmp_path


def test_golden_registers_multichunk(golden_cut):
    """sketch -k 21 -S 12 g0.fa with the file cut into chunks: the
    fixture's registers, and its bytes once decompressed."""
    before = pipeline.joined_packs
    assert tmain.main(["sketch", "-k", "21", "-S", "12", "g0.fa"]) == 0
    assert pipeline.joined_packs - before == 4
    out = "g0.fa.w.21.spacing.12.hll"
    got, want = HLL.read(out), HLL.read(os.path.join(GOLDEN, "golden.hll"))
    np.testing.assert_array_equal(got.regs, want.regs)
    with gzip.open(out, "rb") as fp, \
            gzip.open(os.path.join(GOLDEN, "golden.hll"), "rb") as fw:
        assert fp.read() == fw.read()


def test_golden_mash_binary_multichunk(golden_cut, monkeypatch):
    """dist -M -b at the golden fixture's parameters, files cut into
    chunks: bitwise the output at the default geometry (one chunk a file,
    the small-file batch), and within the golden test's bar of the
    fixture."""
    argv = ["dist", "-k", "21", "-S", "12", "-M", "-b", "-O", "out.bin",
            "--avoid-sorting", "g0.fa", "g1.fa", "g2.fa"]
    got, labels, packs = _dist(argv, "out.bin")
    assert packs == 12
    monkeypatch.undo()
    monkeypatch.chdir(golden_cut)
    monkeypatch.setenv("DASHING_TPU_TORCH_DEVICE", "cpu")
    want, want_labels, none = _dist(argv, "out.bin")
    assert none == 0 and got == want and labels == want_labels
    n, ours = distmat.read_binary(str(golden_cut / "out.bin"))
    n_w, theirs = distmat.read_binary(os.path.join(GOLDEN, "dist_mash.bin"))
    assert n == n_w == 3
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6)
    with open(os.path.join(GOLDEN, "dist_mash.bin.labels"), "rb") as fp:
        assert labels == fp.read()
