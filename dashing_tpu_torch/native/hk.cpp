// HeavyKeeper frequency filter (Gong et al., USENIX ATC 2018).
//
// The reference selects sketch::hk::HeavyKeeper<6, 10, SeededHash<WangHash>>
// as its CountingSketch when compiled with -DDASHING_USE_HK
// (reference src/dashing.h:131-136); default builds use the count-min
// sketch, so HK is never reachable in a shipped reference binary.  The
// implementation itself lives in the absent sketch submodule — this is an
// independent implementation of the published algorithm, used by
// dashing_tpu's --countmin prefilter when DASHING_TPU_USE_HK=1 (the
// runtime analog of the reference's compile-time switch).
//
// Structure: nrows independent rows of 2^size_log2 slots, each slot a
// (16-bit fingerprint, 32-bit count) pair.  Insert walks every row: a
// matching fingerprint increments (saturating); an empty slot claims the
// key at count 1; a foreign fingerprint decays with probability
// base^-count and is replaced once its count reaches zero ("count-with-
// exponential-decay" — the paper's key idea: heavy keys are nearly
// impossible to evict, mice die fast).  Query returns the max matching
// count over rows.  Insertion is inherently stream-sequential (each
// decay decision depends on the running slot state), so this stays a
// native host structure — the same placement the reference gives it —
// while the default count-min filter runs batched on the device
// (dashing_tpu/pipeline.py _count_filtered_tiles).
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Slot {
    uint16_t fp;
    uint32_t count;
};

constexpr uint32_t HK_POW_TAB = 1024;

struct HK {
    int nrows;
    int size_log2;
    uint64_t seed;
    double base;
    uint64_t rng;
    std::vector<Slot> slots;  // nrows * (1 << size_log2)
    double pow_tab[HK_POW_TAB];  // base^-count, count < HK_POW_TAB
};

// WangHash (public-domain mixing constants; same function the hash stack
// uses, dashing_tpu/hashes.py)
static inline uint64_t wang(uint64_t k) {
    k = (~k) + (k << 21);
    k ^= k >> 24;
    k = (k + (k << 3)) + (k << 8);
    k ^= k >> 14;
    k = (k + (k << 2)) + (k << 4);
    k ^= k >> 28;
    k += k << 31;
    return k;
}

static inline uint64_t xorshift64(uint64_t &s) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
}

static inline double uniform01(uint64_t &s) {
    return (double)(xorshift64(s) >> 11) * 0x1.0p-53;
}

static inline uint16_t fingerprint(uint64_t key, uint64_t seed) {
    // fingerprint hash independent of the row/bucket hashes
    return (uint16_t)(wang(key ^ (seed * 0xA24BAED4963EE407ULL + 1)) >> 48);
}

}  // namespace

extern "C" {

void *dtpu_hk_create(int nrows, int size_log2, uint64_t seed,
                     double decay_base) {
    if (nrows < 1 || nrows > 64 || size_log2 < 1 || size_log2 > 30 ||
        decay_base <= 1.0)
        return nullptr;
    // never let bad_alloc cross the C ABI into ctypes (std::terminate
    // would kill the interpreter); a failed allocation is just "no native
    // structure" and the caller falls back
    try {
        HK *hk = new HK();
        hk->nrows = nrows;
        hk->size_log2 = size_log2;
        hk->seed = seed;
        hk->base = decay_base;
        for (uint32_t c = 0; c < HK_POW_TAB; ++c)
            hk->pow_tab[c] = std::pow(decay_base, -(double)c);
        hk->rng = wang(seed | 1);
        hk->slots.assign((size_t)nrows << size_log2, Slot{0, 0});
        return hk;
    } catch (...) {
        return nullptr;
    }
}

void dtpu_hk_destroy(void *p) { delete (HK *)p; }

void dtpu_hk_add(void *p, const uint64_t *keys, int64_t n) {
    HK *hk = (HK *)p;
    const uint64_t mask = ((uint64_t)1 << hk->size_log2) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t key = keys[i];
        const uint16_t fp = fingerprint(key, hk->seed);
        for (int r = 0; r < hk->nrows; ++r) {
            const uint64_t h =
                wang(key ^ (hk->seed + (uint64_t)r * 0x9E3779B97F4A7C15ULL));
            Slot &s = hk->slots[((size_t)r << hk->size_log2) + (h & mask)];
            if (s.count == 0) {
                s.fp = fp;
                s.count = 1;
            } else if (s.fp == fp) {
                if (s.count != UINT32_MAX) ++s.count;
            } else if (s.count < HK_POW_TAB &&
                       uniform01(hk->rng) < hk->pow_tab[s.count]) {
                // table replaces a libm pow per mismatch in the per-kmer
                // hot loop; counts >= HK_POW_TAB skip the draw entirely
                // (decay prob < 4e-35 there).  The Python fallback
                // implements the SAME cutoff so the two RNG streams stay
                // in lockstep (parity tests).
                if (--s.count == 0) {
                    s.fp = fp;
                    s.count = 1;
                }
            }
        }
    }
}

void dtpu_hk_query(void *p, const uint64_t *keys, int64_t n, uint32_t *out) {
    HK *hk = (HK *)p;
    const uint64_t mask = ((uint64_t)1 << hk->size_log2) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t key = keys[i];
        const uint16_t fp = fingerprint(key, hk->seed);
        uint32_t best = 0;
        for (int r = 0; r < hk->nrows; ++r) {
            const uint64_t h =
                wang(key ^ (hk->seed + (uint64_t)r * 0x9E3779B97F4A7C15ULL));
            const Slot &s =
                hk->slots[((size_t)r << hk->size_log2) + (h & mask)];
            if (s.fp == fp && s.count > best) best = s.count;
        }
        out[i] = best;
    }
}

}  // extern "C"
