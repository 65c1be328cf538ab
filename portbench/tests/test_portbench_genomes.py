"""The generator: the same seed gives the same genomes, every seed the
same sizes."""
import numpy as np

from portbench import genomes
from helpers import tiny_config


def test_same_seed_same_genomes():
    cfg = tiny_config("bact100_k31_s16")
    a = genomes.make_genomes(cfg, 2**31 + 12345)
    b = genomes.make_genomes(cfg, 2**31 + 12345)
    assert [g.name for g in a] == [g.name for g in b]
    for x, y in zip(a, b):
        assert all(np.array_equal(r, s) for r, s in zip(x.records, y.records))


def test_other_seed_other_genomes_same_sizes():
    cfg = tiny_config("bact100_k31_s16")
    a = genomes.make_genomes(cfg, 7)
    b = genomes.make_genomes(cfg, 8)
    assert [g.bases for g in a] == [g.bases for g in b]
    assert not np.array_equal(a[0].records[0], b[0].records[0])


def test_layout():
    cfg = tiny_config("bact100_k31_s16", length=40000, ancestors=3)
    gs = genomes.make_genomes(cfg, -5)
    assert len(gs) == 3 * len(cfg["genomes"]["rates"])
    for g in gs:
        assert len(g.records) == 4 and g.bases == 40000
        lower = g.records[1]
        assert ((lower >= ord("a")) | (lower == ord("n"))).all()
        upper = np.concatenate([g.records[0], g.records[2], g.records[3]])
        assert set(np.unique(upper).tolist()) <= set(b"ACGTN")
    # the copies of one ancestor differ at about their rate
    a0 = np.concatenate(gs[0].records) & 0xDF
    a2 = np.concatenate(gs[2].records) & 0xDF
    assert 0 < (a0 != a2).mean() < 0.12


def test_write_fasta(tmp_path):
    cfg = tiny_config("bact100_k31_s16", length=1000, ancestors=1)
    gs = genomes.make_genomes(cfg, 1)
    paths = genomes.write_fasta(gs, str(tmp_path))
    text = open(paths[0], "rb").read().split(b"\n")
    assert text[0] == b">anc0000_c0_r0"
    assert b"".join(text[1::2]) == b"".join(r.tobytes() for r in gs[0].records)
