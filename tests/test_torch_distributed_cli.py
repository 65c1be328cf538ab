"""The port's CLI as two gloo processes on the CPU against the port in one
process, byte for byte (stdout, and files once gzip ones are
decompressed), one case for each case of
tests/test_distributed.py at P = 2: hll, sketch (per-file outputs, each
process its stride), union, card; dist's TSV, its binary matrix filled by
rank-local mmap stripes, -Q, --nearest-neighbors, PHYLIP -J; the batched
host family (-8) plain, binary and NN; sketch_by_seq and dist_by_seq;
panel; and the single-writer tools mkdist (its per-k passes striped),
readfilt, view, fold and printmat.  The compare tiles are 2 rows (DASHING_TPU_COMPARE_TILE and
DASHING_TPU_HOST_COMPARE_TILE), so both processes own stripes.  At P = 2
`sketch`, `dist -M`, `dist -J -b -O` and `hll` also stand against the JAX
CLI in one process: sketch files byte for byte once decompressed,
matrices at rtol 1e-4, the cardinality at rtol 1e-5 (the bars of
test_torch_slice.py and test_torch_subcommands.py).  The rank-count
regimes P = 3 and 4 are in test_torch_distributed_cli_p3.py."""
import glob
import gzip
import os

import numpy as np
import pytest

from dashing_tpu.cli import main as jmain
from dashing_tpu.io import distmat

from torch_ranks import assert_ok, run_batch

TILE_ENV = {"DASHING_TPU_COMPARE_TILE": "2",
            "DASHING_TPU_HOST_COMPARE_TILE": "2"}
K = ["-k", "17"]
RATES = (0.0, 0.01, 0.02, 0.03, 0.05, 0.08)


def write_genomes(root, rng, rates, length=6000):
    """FASTAs from one ancestor at planted substitution rates (no pair
    near-disjoint), two records each; returns their names."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    anc = rng.integers(0, 4, length, dtype=np.uint8)
    names = []
    for i, rate in enumerate(rates):
        g = anc[:length - 300 * i].copy()
        hit = np.flatnonzero(rng.random(g.size) < rate)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) & 3
        seq = lut[g].tobytes()
        half = len(seq) // 2
        (root / f"s{i}.fa").write_bytes(
            b">s%d_a\n%s\n>s%d_b\n%s\n" % (i, seq[:half], i, seq[half:]))
        names.append(f"s{i}.fa")
    return names


def _cases(names):
    four = names[:4]
    dist = ["dist"] + K + ["-S", "12", "--avoid-sorting"]
    return {
        "hll": ["hll"] + K + ["-S", "14"] + four,
        "dist4": dist + four,
        "sketch": ["sketch"] + K + ["-S", "12", "--avoid-sorting", "-P",
                                    "sk{P}"] + four,
        "union": ["union", "-o", "u{P}.hll"] + [
            f"sk1/{n}.w.17.spacing.12.hll" for n in four],
        "card": ["card"] + K + ["-S", "12", "--avoid-sorting"] + four,
        "tsv": dist + names,
        "binary": dist + ["-b", "-O", "d{P}.bin"] + names,
        "mash_bin": dist + ["-M", "-b", "-O", "m{P}.bin"] + names,
        "jmle_bin": dist + ["-J", "-b", "-O", "j{P}.bin"] + names,
        "rect": dist + ["-Q", "queries.txt"] + names,
        "nn": dist + ["--nearest-neighbors", "2"] + names,
        "phylip": dist + ["-U", "-J"] + names,
        "host": dist + ["-8"] + names,
        "host_bin": dist + ["-8", "-b", "-O", "h{P}.bin"] + names,
        "host_nn": dist + ["-8", "--nearest-neighbors", "2"] + names,
        "sbs": ["sketch_by_seq"] + K + ["-S", "12", "-o", "bysq{P}.gz",
                                        "multi.fa"],
        "dbs": ["dist_by_seq", "-n", "bysq1.gz.names", "bysq1.gz"],
        "panel": ["panel", "-k", "17", "-o", "panel{P}.tsv", "panel.db",
                  "pq.fa"],
        # the single-writer tools: rank 0 runs them, the others return 0
        "mkdist": ["mkdist", "--multik", "mk{P},17,22,4", "-S", "12",
                   "--avoid-sorting"] + four,
        "readfilt": ["readfilt", "-k", "17", "-s", SK0, "-f", "0.2", "-o",
                     "rf{P}.fa", "multi.fa"],
        "view": ["view", SK0],
        "fold": ["fold", "-p", "10", "-o", "fold{P}.hll", SK0],
        "printmat": ["printmat", "d1.bin"],
    }


SK0 = "sk1/s0.fa.w.17.spacing.12.hll"

# the files each case writes ("{P}" is the process count); the rest print
FILES = {"mkdist": ["mk{P}.bin", "_mk{P}_17", "_mk{P}_21"],
         "readfilt": ["rf{P}.fa"], "fold": ["fold{P}.hll"],
"sketch": [f"sk{{P}}/s{i}.fa.w.17.spacing.12.hll" for i in range(4)],
         "union": ["u{P}.hll"], "binary": ["d{P}.bin", "d{P}.bin.labels"],
         "mash_bin": ["m{P}.bin"], "jmle_bin": ["j{P}.bin"],
         "host_bin": ["h{P}.bin", "h{P}.bin.labels"],
         "sbs": ["bysq{P}.gz", "bysq{P}.gz.names"], "panel": ["panel{P}.tsv"]}


def unzipped(path):
    """A file's bytes, decompressed where it is gzip (whose header holds
    the time it was written)."""
    data = path.read_bytes()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases in one process, then as two processes (the P = 2 run
    reads the sketch, sketch_by_seq and panel files of the first)."""
    root = tmp_path_factory.mktemp("dist_cli")
    names = write_genomes(root, np.random.default_rng(17), RATES)
    (root / "queries.txt").write_text("\n".join(names[:2]) + "\n")
    (root / "multi.fa").write_bytes(b"".join(
        (root / n).read_bytes() for n in names))
    seq = (root / names[1]).read_text().splitlines()[1]
    (root / "pq.fa").write_text(f">pq\n{seq[:2000]}\n")
    for d in ("sk1", "sk2", "skj"):
        (root / d).mkdir()
    cases = _cases(names)
    keys = list(cases)
    # panel's database: the first process's sketches as one -o stream
    pre = [(["sketch"] + K + ["-S", "12", "-o", "panel.db",
                              "--avoid-sorting"] + names, {})]
    one, status = run_batch(pre + [(cases[k], {}) for k in keys], str(root),
                            1, extra_env=TILE_ENV)
    assert_ok(status)
    two, status = run_batch([(cases[k], {}) for k in keys], str(root), 2,
                            extra_env=TILE_ENV)
    assert_ok(status)
    return root, names, dict(zip(keys, one[1:])), dict(zip(keys, two))


@pytest.mark.parametrize("case", list(_cases([f"s{i}.fa" for i in
                                              range(6)])))
def test_two_processes_match_one(runs, case):
    """Rank 0 prints what one process prints and writes the same files;
    rank 1 prints nothing."""
    root, _, one, two = runs
    assert two[case][0] == one[case][0], case
    assert two[case][1] == b"", case
    for f in FILES.get(case, []):
        a, b = (unzipped(root / f.replace("{P}", n)) for n in "12")
        assert a and a == b, f
    if case in ("tsv", "dbs", "nn", "host_nn"):
        assert one[case][0].count(b"\n") >= 6


def _jax(argv, cwd, capsys):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        capsys.readouterr()
        assert jmain.main(argv) == 0
        return capsys.readouterr().out
    finally:
        os.chdir(old)


def test_sketch_files_match_jax(runs, capsys):
    root, names, _, _ = runs
    _jax(["sketch"] + K + ["-S", "12", "--avoid-sorting", "-P", "skj"]
         + names[:4], root, capsys)
    port = sorted(glob.glob(str(root / "sk2" / "*.hll")))
    assert len(port) == 4
    for path in port:
        jpath = root / "skj" / os.path.basename(path)
        assert gzip.open(path).read() == gzip.open(jpath).read(), path


@pytest.mark.parametrize("case,extra", [("mash_bin", ["-M"]),
                                        ("jmle_bin", ["-J"])])
def test_matrices_match_jax(runs, capsys, case, extra):
    root, names, _, _ = runs
    out = f"jax_{case}.bin"
    _jax(["dist"] + K + ["-S", "12", "--avoid-sorting", "-b", "-O", out]
         + extra + names, root, capsys)
    nj, mj = distmat.read_binary(str(root / out))
    nt, mt = distmat.read_binary(str(root / f"{case[0]}2.bin"))
    assert nj == nt == len(names)
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)


def test_hll_matches_jax(runs, capsys):
    root, names, _, two = runs
    got = _jax(["hll"] + K + ["-S", "14"] + names[:4], root, capsys)
    line = [l for l in got.splitlines() if "Estimated" in l][0]
    port = two["hll"][0].decode().strip()
    assert port.startswith("Estimated number of unique exact matches: ")
    np.testing.assert_allclose(float(port.split()[-1]),
                               float(line.split()[-1]), rtol=1e-5)
