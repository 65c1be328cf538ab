"""The plain reference against hand-made FASTAs whose k-mer sets are
known, and its estimators against sets of known size and overlap."""
import numpy as np
import pytest
import torch

from portbench.reference import compare, estimators as est, sketch

M64 = (1 << 64) - 1
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def wang(x: int) -> int:
    x = (~x + (x << 21)) & M64
    x ^= x >> 24
    x = (x + (x << 3) + (x << 8)) & M64
    x ^= x >> 14
    x = (x + (x << 2) + (x << 4)) & M64
    x ^= x >> 28
    return (x + (x << 31)) & M64


def kmer_codes(records, k):
    """Canonical codes of the valid k-mers, record by record, in order."""
    out = []
    for rec in records:
        rec = rec.upper()
        for i in range(len(rec) - k + 1):
            w = rec[i:i + k]
            if any(c not in CODE for c in w):
                out.append(None)
                continue
            fwd = rc = 0
            for t, c in enumerate(w):
                fwd |= CODE[c] << (2 * (k - 1 - t))
                rc |= (3 - CODE[c]) << (2 * t)
            out.append(min(fwd, rc))
        out.append("end")
    return out


def registers(codes, p):
    regs = [0] * (1 << p)
    for c in codes:
        h = wang(c)
        rest = ((h << p) & M64) | (1 << (p - 1))
        rank = 64 - rest.bit_length() + 1
        regs[h >> (64 - p)] = max(regs[h >> (64 - p)], rank)
    return regs


def brute(records, k, p, window=0):
    codes = kmer_codes(records, k)
    if window > k:
        win, out, run = window - k + 1, [], []
        for c in codes:
            if c is None or c == "end":
                run = []
                continue
            run.append(c)
            if len(run) >= win:
                out.append(min(run[-win:]))
        return registers(out, p)
    return registers([c for c in codes if c not in (None, "end")], p)


def as_arrays(records):
    return [np.frombuffer(r.encode(), np.uint8) for r in records]


@pytest.mark.parametrize("records", [
    ["ACGTACGTAC"],
    ["ACGTNACGTTGCA", "ttgcaACGtt"],
    ["GATTACAGATTACA", "NNNN", "CCCCGGGG"],
    ["ACGTRYACGGT" * 3, "a" * 12],
])
@pytest.mark.parametrize("k,p", [(3, 4), (5, 6), (7, 10)])
def test_registers_of_known_kmers(records, k, p):
    got = sketch.genome_registers(as_arrays(records), k, p)
    assert got.tolist() == brute(records, k, p)


def test_registers_in_blocks_and_windows():
    rng = np.random.default_rng(3)
    recs = ["".join(rng.choice(list("ACGTN"), 300, p=[.24] * 4 + [.04]))
            for _ in range(3)]
    want = brute(recs, 5, 8)
    assert sketch.genome_registers(as_arrays(recs), 5, 8,
                                   block=17).tolist() == want
    want_w = brute(recs, 5, 8, window=11)
    assert sketch.genome_registers(as_arrays(recs), 5, 8, window=11,
                                   block=13).tolist() == want_w


def test_no_kmer_across_records():
    # "ACG" + "TTT" would hold the k-mers GTT and CGT across the join
    a = sketch.genome_registers(as_arrays(["ACG", "TTT"]), 3, 6)
    b = sketch.genome_registers(as_arrays(["ACG"]), 3, 6)
    c = sketch.genome_registers(as_arrays(["TTT"]), 3, 6)
    assert torch.equal(a, torch.maximum(b, c))


def test_read_fasta(tmp_path):
    path = tmp_path / "x.fa"
    path.write_bytes(b">r1 one\nACGT\nAC\n>r2\n\nGG\n")
    recs = sketch.read_fasta(str(path))
    assert [r.tobytes() for r in recs] == [b"ACGTAC", b"GG"]


def random_regs(n, p, seed):
    """Registers of n distinct random 64-bit hashes."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64))
    return h


def regs_of(h, p):
    idx, rank = sketch.bucket_rank(h, p)
    return torch.zeros(1 << p, dtype=torch.int32).scatter_reduce_(
        0, idx, rank.to(torch.int32), "amax")


@pytest.mark.parametrize("n", [500, 20000, 2_000_000])
def test_mle_near_the_true_cardinality(n):
    p = 12
    regs = regs_of(random_regs(n, p, n), p)
    got = float(est.mle(est.histogram(regs[None], p), p)[0])
    assert abs(got / n - 1) < 0.05          # 3 standard errors at p = 12


def test_mle_of_empty_sketch():
    h = est.histogram(torch.zeros(1, 1 << 8, dtype=torch.int32), 8)
    assert float(est.mle(h, 8)[0]) == 0.0


def test_joint_mle_of_known_overlap():
    p = 12
    x, u, v = (random_regs(n, p, s) for n, s in
               ((30000, 1), (10000, 2), (20000, 3)))
    a = regs_of(torch.cat([x, u]), p)[None]
    b = regs_of(torch.cat([x, v]), p)[None]
    st = {key: t.reshape(1, -1)
          for key, t in est.pair_statistics(a, b, p).items()}
    hist = est.histogram(torch.cat([a, b]), p)
    c = est.mle(hist, p)
    c_u = est.mle(st["eq"] + st["gt_a"] + st["gt_b"], p)
    tri = est.joint_mle(st, c[:1], c[1:], c_u, p)[0]
    want = torch.tensor([10000.0, 20000.0, 30000.0], dtype=torch.float64)
    assert ((tri - want).abs() / want).max() < 0.1
    assert abs(float(est.jaccard(tri)) - 0.5) < 0.03


def test_pair_statistics_and_union_histograms_exact():
    p = 4
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 7, (3, 16))).to(torch.int32)
    b = torch.from_numpy(rng.integers(0, 7, (4, 16))).to(torch.int32)
    st = est.pair_statistics(a, b, p)
    hu = compare.union_histograms(a, b, p)
    for i in range(3):
        for j in range(4):
            x, y = a[i].tolist(), b[j].tolist()
            want = {key: [0] * (64 - p + 2) for key in st}
            want_u = [0] * (64 - p + 2)
            for s, t in zip(x, y):
                want_u[max(s, t)] += 1
                if s > t:
                    want["gt_a"][s] += 1
                    want["lt_b"][t] += 1
                elif s < t:
                    want["lt_a"][s] += 1
                    want["gt_b"][t] += 1
                else:
                    want["eq"][s] += 1
            for key in st:
                assert st[key][i, j].tolist() == want[key]
            assert hu[i, j].tolist() == want_u


def test_mash_and_its_inverse():
    ji = torch.tensor([1.0, 0.5, 0.01, 0.0], dtype=torch.float64)
    d = est.mash(ji, 21)
    assert float(d[0]) == 0.0 and float(d[3]) == 1.0
    assert torch.allclose(est.jaccard_of_mash(d, 21), ji, atol=1e-12)


def test_reorder_condensed():
    n = 4
    i, j = np.triu_indices(n, 1)
    order = [2, 0, 3, 1]                    # item at each written position
    full = np.arange(n * n, dtype=np.float32).reshape(n, n)
    full = full + full.T
    written = np.array([full[order[a], order[b]] for a, b in zip(i, j)],
                       np.float32)
    assert compare.reorder(n, written, order).tolist() == full[i, j].tolist()
