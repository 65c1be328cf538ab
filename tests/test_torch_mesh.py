"""dashing_tpu_torch.parallel.mesh: the local mesh's rules, and every
production hook with the mesh pinned to (cpu,) * 4 bitwise equal to the
mesh off, with the work seen to spread over the four: the chunk stream
(packed and ASCII routes), the count-min filtered passes, the small-file
batches, the condensed / rect / triples / k-NN / full-square compares
(tiles of 2 rows), as tests/test_mesh_production.py holds the JAX
package's; and `union`, which folds on the host and asks the mesh for no
card."""
import contextlib
import gzip

import numpy as np
import pytest
import torch

from dashing_tpu_torch import pipeline
from dashing_tpu_torch.cli import core
from dashing_tpu_torch.cli import main as tmain
from dashing_tpu_torch.ops import pairwise as pw
from dashing_tpu_torch.parallel import mesh as tmesh
from dashing_tpu_torch.sketch import estimators as est
from dashing_tpu_torch.sketch.hll import HLL

CPU = torch.device("cpu")
CPU4 = (CPU,) * 4


@contextlib.contextmanager
def pinned(mesh):
    tmesh._set_local_mesh_for_tests(mesh)
    try:
        yield
    finally:
        tmesh._set_local_mesh_for_tests(None, frozen=False)


def _hlls(rng, n, p, base=3000):
    out = []
    shared = rng.integers(0, 2 ** 62, base, dtype=np.uint64)
    for i in range(n):
        h = HLL(p)
        h.addh_np(np.concatenate([shared, rng.integers(
            0, 2 ** 62, 300 + 37 * i, dtype=np.uint64)]))
        out.append(h)
    return out


def test_local_mesh_rules(monkeypatch):
    assert tmesh.local_mesh(CPU) is None
    assert tmesh.local_mesh("cuda:0") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tmesh.local_mesh("cuda") == tuple(
        torch.device("cuda", i) for i in range(3))
    monkeypatch.setenv("DASHING_TPU_NO_MESH", "1")
    assert tmesh.local_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("DASHING_TPU_NO_MESH")
    assert tmesh.local_mesh("cuda") is None
    with pinned(CPU4):
        assert tmesh.local_mesh() == CPU4 and tmesh.cards(CPU) == CPU4
    assert tmesh.cards(CPU) == (CPU,)


# ---------------------------------------------------------------------------
# the production hooks, mesh pinned to four CPU "cards" against mesh off
# ---------------------------------------------------------------------------

def _genome(tmp_path, rng, name, n):
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n,
                     p=[0.245] * 4 + [0.02])
    path = tmp_path / name
    path.write_bytes(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")
    return str(path)


def _spy_regs(monkeypatch, name, pos):
    """Record the register tensors (argument `pos`) a sketch wrapper folds
    into."""
    seen = []
    orig = getattr(pipeline, name)

    def spy(*a, **kw):
        seen.append(a[pos].data_ptr())
        return orig(*a, **kw)
    monkeypatch.setattr(pipeline, name, spy)
    return seen


@pytest.mark.parametrize("params", [
    pipeline.SketchParams(k=21),                        # packed, K1
    pipeline.SketchParams(k=21, w=30),                  # ASCII
])
def test_chunk_stream_on_mesh(tmp_path, rng, monkeypatch, params):
    monkeypatch.setattr(pipeline, "MAX_ROWS", 4)       # ~32 kbp chunks
    path = _genome(tmp_path, rng, "g.fa", 150_000)
    name, pos = (("packed_to_registers", 2) if params.w == 0
                 else ("tile_to_registers", 1))
    off = pipeline.sketch_file_hll(path, params, 12, CPU)
    seen = _spy_regs(monkeypatch, name, pos)
    with pinned(CPU4):
        on = pipeline.sketch_file_hll(path, params, 12, CPU)
    np.testing.assert_array_equal(on, off)
    assert len(seen) >= 5 and len(set(seen)) == 4


def test_count_filtered_on_mesh(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(pipeline, "MAX_ROWS", 4)
    anc = _genome(tmp_path, rng, "a.fa", 100_000)
    body = open(anc, "rb").read().split(b"\n")[1]
    path = tmp_path / "twice.fa"     # five chunks, a third of them twice
    path.write_bytes(b">x\n" + body + b"\n>y\n" + body[:50_000] + b"\n")
    params = pipeline.SketchParams(k=15, min_count=2,
                                   use_counting_filter=True, cm_size_log2=16)
    off = pipeline.sketch_file_hll(str(path), params, 11, CPU)
    seen = []
    orig = pipeline.update_registers

    def spy(regs, *a, **kw):
        seen.append(regs.data_ptr())
        return orig(regs, *a, **kw)
    monkeypatch.setattr(pipeline, "update_registers", spy)
    with pinned(CPU4):
        on = pipeline.sketch_file_hll(str(path), params, 11, CPU)
    np.testing.assert_array_equal(on, off)
    assert off.any() and len(set(seen)) == 4
    # the threshold admitted only what the file holds twice
    assert (off <= pipeline.sketch_file_hll(
        str(path), pipeline.SketchParams(k=15), 11, CPU)).all()


def test_small_batches_on_mesh(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(pipeline, "small_batch_size", lambda p: 8)
    paths = [_genome(tmp_path, rng, f"s{i}.fa", 2000 + 97 * i)
             for i in range(30)]
    opts = core.CommonOpts(k=17, sketch_size=10)
    off = [h.regs for h in core.sketch_paths(paths, opts, CPU)]
    devs = []
    orig = pipeline.sketch_small_batch_async

    def spy(chunks, params, p, device, packed):
        devs.append(device)
        return orig(chunks, params, p, device, packed)
    monkeypatch.setattr(pipeline, "sketch_small_batch_async", spy)
    with pinned(CPU4):
        on = [h.regs for h in core.sketch_paths(paths, opts, CPU)]
    np.testing.assert_array_equal(np.stack(on), np.stack(off))
    assert len(devs) == 4            # 30 files in batches of 8


@pytest.fixture()
def bank(rng):
    return _hlls(rng, 9, 10)


def _spread(monkeypatch):
    counts = []
    orig = pw._replicas

    def spy(device, *banks):
        out = orig(device, *banks)
        counts.append(len(out))
        return out
    monkeypatch.setattr(pw, "_replicas", spy)
    return counts


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_compares_on_mesh(bank, monkeypatch, jestim):
    if jestim == est.ERTL_JOINT_MLE:
        bank = bank[:6]           # K5's plain version is slow on the CPU
    refs, queries = bank, bank[2:5]
    runs = {
        "condensed": lambda: pw.all_pairs_condensed(
            bank, pw.MASH_DIST, 21, est.ERTL_MLE, jestim, CPU, tile=2),
        "condensed_rows": lambda: pw.all_pairs_condensed(
            bank, pw.JI, 21, est.ERTL_MLE, jestim, CPU, tile=2,
            row_blocks=[2, 6]),
        "rect": lambda: pw.rect_pairs(refs, queries, pw.JI, 21,
                                      est.ERTL_MLE, jestim, CPU, tile=2),
        "triples": lambda: pw.rect_triples(refs, queries, est.ERTL_MLE,
                                           jestim, CPU, tile=2,
                                           ref_blocks=[0, 4]),
        "nn": lambda: pw.nn_topk(refs, refs, pw.JI, 21, est.ERTL_MLE,
                                 jestim, 3, True, CPU, tile=2),
        "nn_rect": lambda: pw.nn_topk(refs, queries, pw.MASH_DIST, 21,
                                      est.ERTL_MLE, jestim, 3, False, CPU,
                                      tile=2),
        "square": lambda: pw.full_square(bank, pw.CONTAINMENT_INDEX, 21,
                                         est.ERTL_MLE, jestim, CPU, tile=2),
    }
    counts = _spread(monkeypatch)
    for name, run in runs.items():
        off = run()
        with pinned(CPU4):
            on = run()
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (on, off))):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert counts == [1, 4] * len(runs)


def test_union_on_mesh(tmp_path, rng, monkeypatch, capsys):
    paths = []
    for i, h in enumerate(_hlls(rng, 5, 10)):
        paths.append(str(tmp_path / f"u{i}.hll"))
        h.write(paths[-1])
    calls = []
    orig = tmesh.cards

    def spy(device):
        calls.append(device)
        return orig(device)
    monkeypatch.setattr(tmesh, "cards", spy)
    assert tmain.main(["union", "-o", str(tmp_path / "off.hll")]
                      + paths) == 0
    with pinned(CPU4):
        assert tmain.main(["union", "-o", str(tmp_path / "on.hll")]
                          + paths) == 0
    capsys.readouterr()
    assert calls == []
    assert (gzip.open(tmp_path / "on.hll").read()
            == gzip.open(tmp_path / "off.hll").read())
