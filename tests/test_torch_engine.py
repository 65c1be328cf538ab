"""The HLL sketch engine's one entry, `pipeline.sketch_hll_files`, on the
CPU over a mixed list of files, in rows of 1,024 bases and chunks of 2
rows: a multi-chunk file on the packed route, single-chunk files that
batch, a streamed file (STREAM_THRESHOLD below its size), a count-min
filtered file, an empty file and a multi-chunk file under -w 50 (the
ASCII route).  Each file's registers, as the engine lands them among the
others, equal `pipeline.sketch_file_hll` and the JAX package's
`sketch_file_hll` bit for bit; each file's route (`file_route`) is pinned
by what it does alone: chunks packed from joined bytes (`joined_packs`),
uploads (`chunk_uploads`), banked folds and count-min tiles (`cm_tiles`).
The landing order keeps an empty file ahead of the batch it interrupts."""
import numpy as np
import pytest
import torch

from dashing_tpu import pipeline as jpipe
from dashing_tpu_torch import pipeline

torch.set_num_threads(1)
CPU = torch.device("cpu")
P = 12
LUT = np.frombuffer(b"ACGT", np.uint8)
PLAIN = dict(k=21)
W50 = dict(k=21, w=50)
FILTER = dict(min_count=2, cm_size_log2=16)
# the mixed list: name -> bases (an empty file between two batched ones)
FILES = {"batch_a": 1500, "empty": 0, "batch_b": 1700, "packed": 5000,
         "stream": 7000, "filtered": 3000, "multi": 4500}
FILTERED = list(FILES).index("filtered")
# case -> (the file or files, its parameters, route, what it does alone)
CASES = {
    "packed": (["packed"], PLAIN, "joined",
               dict(joined_packs=3, chunk_uploads=3)),
    "batch": (["batch_a", "batch_b"], PLAIN, "batch",
              dict(chunk_uploads=1, banked=1)),
    "stream": (["stream"], PLAIN, "stream", dict(chunk_uploads=4)),
    "filtered": (["filtered"], PLAIN, "filtered", dict(cm_tiles=3)),
    "empty": (["empty"], PLAIN, "empty", {}),
    "w50": (["multi"], W50, "stream", dict(chunk_uploads=3)),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The files, the engine's geometry cut small, and the engine's
    landings over the whole list under each parameter set."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "CONTENT", 1024)
    mp.setattr(pipeline, "MAX_ROWS", 2)
    mp.setattr(pipeline, "STREAM_THRESHOLD", 6000)
    root = tmp_path_factory.mktemp("engine")
    rng = np.random.default_rng(23)
    paths = {}
    for name, n in FILES.items():
        seq = LUT[rng.integers(0, 4, n)].tobytes()
        if name == "filtered":       # its first half twice, so some pass
            seq += b"N" + seq[:n // 2]
        path = root / f"{name}.fa"
        path.write_bytes(b">" + name.encode() + b"\n" + seq + b"\n")
        paths[name] = str(path)
    landed = {}
    for key, kw in (("plain", PLAIN), ("w50", W50)):
        got = []
        pipeline.sketch_hll_files(
            list(enumerate(paths.values())), _params(kw), P, CPU,
            filtered={FILTERED}, land=lambda i, r: got.append((i, r)))
        landed[key] = got
    yield paths, landed
    mp.undo()


def _params(kw, filtered=False, cls=pipeline.SketchParams):
    return cls(**kw, **FILTER, use_counting_filter=filtered)


def _counts():
    return dict(joined_packs=pipeline.joined_packs,
                chunk_uploads=pipeline.chunk_uploads,
                cm_tiles=pipeline.cm_tiles)


@pytest.mark.parametrize("case", list(CASES))
def test_registers_match_file_route_and_jax(world, case):
    """Every file of the case, landed once among the others, holds the
    registers of sketch_file_hll and of the JAX package's."""
    paths, landed = world
    names, kw, _, _ = CASES[case]
    got = dict(landed["w50" if kw is W50 else "plain"])
    assert sorted(got) == list(range(len(FILES)))
    for name in names:
        filt = name == "filtered"
        regs = got[list(FILES).index(name)]
        assert regs.dtype == np.uint8 and regs.shape == (1 << P,)
        want = pipeline.sketch_file_hll(paths[name], _params(kw, filt), P,
                                        CPU)
        jwant = jpipe.sketch_file_hll(paths[name], _params(
            kw, filt, jpipe.SketchParams), P)
        np.testing.assert_array_equal(regs, want, err_msg=name)
        np.testing.assert_array_equal(regs, jwant, err_msg=name)
        assert regs.any() == (name != "empty")


@pytest.mark.parametrize("case", list(CASES))
def test_route_pinned_by_counters(world, case, monkeypatch):
    """The case's files alone: file_route names the route, and the
    counters move by what that route does and by nothing else."""
    paths, _ = world
    names, kw, route, moved = CASES[case]
    params = _params(kw)
    sp = pipeline.check_supported(params)
    packed = pipeline.packed_ok(params, sp, P)
    todo = [(i, paths[name]) for i, name in enumerate(names)]
    files = list(pipeline.prefetch(todo, sp))
    assert {pipeline.file_route(f, case == "filtered", packed,
                                pipeline.small_batch_size(P))
            for f in files} == {route}
    banked = []
    real = pipeline.packed_to_banks
    monkeypatch.setattr(pipeline, "packed_to_banks",
                        lambda *a, **k: banked.append(1) or real(*a, **k))
    before = _counts()
    got = {}
    pipeline.sketch_hll_files(todo, params, P, CPU,
                              filtered={0} if case == "filtered" else (),
                              land=got.__setitem__)
    delta = {name: n - before[name] for name, n in _counts().items()}
    delta["banked"] = len(banked)
    want = dict(joined_packs=0, chunk_uploads=0, cm_tiles=0, banked=0)
    want.update(moved)
    assert delta == want
    assert sorted(got) == list(range(len(names)))


@pytest.mark.parametrize("kw", [PLAIN, W50], ids=["plain", "w50"])
def test_land_order(world, kw):
    """Jobs land in the order they were made: the empty file's zero
    registers before the batch it sits in, which closes at the next file
    that folds alone; then file by file."""
    _, landed = world
    got = [i for i, _ in landed["w50" if kw is W50 else "plain"]]
    assert got == [1, 0, 2, 3, 4, 5, 6]
