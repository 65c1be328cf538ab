// Native distance-matrix text formatter.
//
// The TSV/PHYLIP emitters (dashing_tpu/io/distmat.py) are byte-format
// compatibility surfaces mirroring the reference's emitters
// (reference src/sketch_and_cmp.h:16-35 "%lf"/"%le" row loops); formatting
// one float at a time through Python's "%" operator tops out ~1.4M
// values/s, which at the device compare rate (23.5M pairs/s) would make
// host formatting the end-to-end bottleneck for text output.  This
// formatter packs rows in parallel with snprintf (locale-independent "C"
// numerics are guaranteed: we never setlocale), matching CPython's
// float__format output byte-for-byte for %.6g / %e / %f (both sides are
// correctly rounded; non-finite values are normalized below because glibc
// prints "-nan" where Python prints "nan").
//
// API (ctypes, see dashing_tpu/io/native.py):
//   vals      : all row values, rows concatenated
//   row_off   : exclusive prefix offsets into vals, length nrows+1
//   fmt       : 0 = "%.6g"   1 = "%e"   2 = "%f"
//   slot      : bytes reserved per value in `out` (caller sizes out as
//               row_off[nrows]*slot); per-row output is packed, the slot
//               is only the sizing unit
//   out       : byte sink; row r's segment starts at out + row_off[r]*slot
//   seg_len   : per-row segment byte length (out)
// Each value is emitted as '\t' + formatted text.  Returns 0, or -1 on
// invalid arguments.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// std::to_chars with explicit precision matches printf byte-for-byte
// (verified: 0 mismatches over 2M log-uniform floats per format vs glibc
// snprintf) at 4-7x the speed — snprintf was the measured wall on the
// single-core host this runs on.
inline int fmt_one(char* dst, double v, int fmt) {
    if (std::isnan(v)) { std::memcpy(dst, "nan", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { std::memcpy(dst, "-inf", 4); return 4; }
        std::memcpy(dst, "inf", 3);
        return 3;
    }
    std::chars_format cf = fmt == 1 ? std::chars_format::scientific
                         : fmt == 2 ? std::chars_format::fixed
                                    : std::chars_format::general;
    return static_cast<int>(
        std::to_chars(dst, dst + 55, v, cf, 6).ptr - dst);
}

void fmt_rows_range(const float* vals, const int64_t* row_off, int fmt,
                    int64_t slot, char* out, int64_t* seg_len,
                    int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
        char* base = out + row_off[r] * slot;
        char* p = base;
        for (int64_t i = row_off[r]; i < row_off[r + 1]; ++i) {
            *p++ = '\t';
            p += fmt_one(p, static_cast<double>(vals[i]), fmt);
        }
        seg_len[r] = static_cast<int64_t>(p - base);
    }
}

void fmt_nn_range(const float* vals, const int64_t* ids, int64_t nn,
                  int fmt, int64_t slot, char* out, int64_t* seg_len,
                  int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
        char* base = out + r * nn * slot;
        char* p = base;
        for (int64_t j = r * nn; j < (r + 1) * nn; ++j) {
            *p++ = '\t';
            p = std::to_chars(p, p + 21, ids[j]).ptr;
            *p++ = ':';
            p += fmt_one(p, static_cast<double>(vals[j]), fmt);
        }
        seg_len[r] = static_cast<int64_t>(p - base);
    }
}

}  // namespace

extern "C" int dtpu_fmt_rows(const float* vals, const int64_t* row_off,
                             int64_t nrows, int fmt, int64_t slot,
                             int nthreads, char* out, int64_t* seg_len) {
    // max bytes per value incl. the '\t': "%.6g" 14, "%e" 16 ("-1.234568e-308"),
    // "%f" 48 (FLT_MAX has 39 integral digits + ".%06d")
    if (!vals || !row_off || !out || !seg_len || nrows < 0 ||
        slot < (fmt == 2 ? 56 : 18))
        return -1;
    int64_t total = row_off[nrows];
    if (total < 0) return -1;
    unsigned hw = std::thread::hardware_concurrency();
    int nt = nthreads > 0 ? nthreads : (hw ? static_cast<int>(hw) : 1);
    if (nt > nrows) nt = nrows ? static_cast<int>(nrows) : 1;
    if (nt <= 1 || total < (1 << 16)) {
        fmt_rows_range(vals, row_off, fmt, slot, out, seg_len, 0, nrows);
        return 0;
    }
    // contiguous row ranges balanced by value count
    std::vector<std::thread> ts;
    ts.reserve(nt);
    int64_t r0 = 0;
    for (int t = 0; t < nt && r0 < nrows; ++t) {
        int64_t target = total * (t + 1) / nt;
        int64_t r1 = r0;
        while (r1 < nrows && (row_off[r1] < target || r1 == r0)) ++r1;
        if (t == nt - 1) r1 = nrows;
        ts.emplace_back(fmt_rows_range, vals, row_off, fmt, slot, out,
                        seg_len, r0, r1);
        r0 = r1;
    }
    for (auto& th : ts) th.join();
    return 0;
}

// k-NN TSV rows: each value emits as '\t' + <id>(%d) + ':' + <val>(fmt)
// (reference nndist_loop's "\t%u:%f"-family rows, src/sketch_and_cmp.h:
// 747-760; the rebuild prints ids as signed so the -1 pad sentinel stays
// visible).  Uniform nn values per row; slot must cover 1 + 20 (int64)
// + 1 + the value width.
extern "C" int dtpu_fmt_nn_rows(const float* vals, const int64_t* ids,
                                int64_t nrows, int64_t nn, int fmt,
                                int64_t slot, char* out, int64_t* seg_len) {
    if (!vals || !ids || !out || !seg_len || nrows < 0 || nn <= 0 ||
        slot < (fmt == 2 ? 78 : 40))
        return -1;
    int64_t total = nrows * nn;
    unsigned hw = std::thread::hardware_concurrency();
    int nt = hw ? static_cast<int>(hw) : 1;
    if (nt > nrows) nt = nrows ? static_cast<int>(nrows) : 1;
    if (nt <= 1 || total < (1 << 16)) {
        fmt_nn_range(vals, ids, nn, fmt, slot, out, seg_len, 0, nrows);
        return 0;
    }
    std::vector<std::thread> ts;
    ts.reserve(nt);
    int64_t r0 = 0;
    for (int t = 0; t < nt && r0 < nrows; ++t) {
        int64_t r1 = t == nt - 1 ? nrows : nrows * (t + 1) / nt;
        if (r1 <= r0) r1 = r0 + 1;
        ts.emplace_back(fmt_nn_range, vals, ids, nn, fmt, slot, out,
                        seg_len, r0, r1);
        r0 = r1;
    }
    for (auto& th : ts) th.join();
    return 0;
}
