// 2-bit base packing for the device upload path.
//
// The packed route uploads each chunk of rows as (2-bit codes packed
// 4/byte, validity bits packed 8/byte): ~0.37 B a base on the host ->
// device link.  Semantics match pipeline._pack_tile_host_inner exactly:
// up = byte & 0xDF; code A->0 C->1 G->2 T->3 else 0; valid iff
// up in {A, C, G, T}; codes little-packed 4/byte, valid bits
// little-packed 8/byte (numpy packbits bitorder="little").
//
// The code of a byte b is ((b >> 1) ^ (b >> 2)) & 3 on b & 0xDF (A 0,
// C 1, G 2, T 3), masked by the ACGT test.  Both entries work 16 bases at
// a time with SSE2 (pack16: four byte compares, a movemask gathers the 16
// tests into 2 bytes, shifts and two packs the 16 codes into 4), and the
// rest 8 at a time in one 64-bit word (pack8: four exact zero-byte tests,
// shifts and one multiplication gather the codes into 2 bytes and the
// tests into 1); without SSE2 all of it takes pack8.
//   dtpu_pack2bit   an ASCII tile, rows x C (C % 8 == 0);
//   dtt_pack_joined rows of the tiling of a joined sequence, read straight
//                   from the joined bytes, so no ASCII tile is made.

#include <cstdint>
#include <cstring>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "pack.cpp loads 8 bases as one little-endian word"
#endif

namespace {

constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;
constexpr uint64_t kEveryByte = 0x0101010101010101ULL;
constexpr uint64_t kAllN = kEveryByte * 'N';

// 0x80 in each byte of v that is zero, 0 elsewhere (exact: no carry
// crosses a byte)
inline uint64_t zero_bytes(uint64_t v) {
    return ~(((v & kLow7) + kLow7) | v | kLow7);
}

// bases x[0..7] (byte i of the little-endian word is base i) -> codes of
// bases 0-3 in pk[0] and 4-7 in pk[1], 2 bits each from bit 0; validity
// of base i in bit i of *vb
inline void pack8(uint64_t x, uint8_t *pk, uint8_t *vb) {
    const uint64_t up = x & (kEveryByte * 0xDF);
    const uint64_t hit = zero_bytes(up ^ (kEveryByte * 'A'))
        | zero_bytes(up ^ (kEveryByte * 'C'))
        | zero_bytes(up ^ (kEveryByte * 'G'))
        | zero_bytes(up ^ (kEveryByte * 'T'));
    const uint64_t ones = hit >> 7;                 // 0x01 in a valid byte
    uint64_t c = ((up >> 1) ^ (up >> 2)) & (ones * 3);
    c = (c | (c >> 6)) & 0x000F000F000F000FULL;     // 4 bits a 16-bit lane
    c = (c | (c >> 12)) & 0x000000FF000000FFULL;    // 8 bits a 32-bit lane
    c = (c | (c >> 24)) & 0xFFFFULL;
    pk[0] = static_cast<uint8_t>(c);
    pk[1] = static_cast<uint8_t>(c >> 8);
    // bit 8i of `ones` lands on bit 56 + i: each product bit has one term
    *vb = static_cast<uint8_t>((ones * 0x0102040810204080ULL) >> 56);
}

#if defined(__SSE2__)
// bases src[0..15] -> codes in pk[0..3], validity bits in vb[0..1]
inline void pack16(const uint8_t *src, uint8_t *pk, uint8_t *vb) {
    const __m128i up = _mm_and_si128(
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(src)),
        _mm_set1_epi8(static_cast<char>(0xDF)));
    const __m128i valid = _mm_or_si128(
        _mm_or_si128(_mm_cmpeq_epi8(up, _mm_set1_epi8('A')),
                     _mm_cmpeq_epi8(up, _mm_set1_epi8('C'))),
        _mm_or_si128(_mm_cmpeq_epi8(up, _mm_set1_epi8('G')),
                     _mm_cmpeq_epi8(up, _mm_set1_epi8('T'))));
    const uint16_t bits = static_cast<uint16_t>(_mm_movemask_epi8(valid));
    // 16-bit shifts: a byte's low 2 bits come from its own bits 1-3
    __m128i c = _mm_and_si128(
        _mm_xor_si128(_mm_srli_epi16(up, 1), _mm_srli_epi16(up, 2)),
        _mm_and_si128(valid, _mm_set1_epi8(3)));
    c = _mm_and_si128(_mm_or_si128(c, _mm_srli_epi16(c, 6)),
                      _mm_set1_epi16(0x000F));   // 4 bits a 16-bit lane
    c = _mm_and_si128(_mm_or_si128(c, _mm_srli_epi32(c, 12)),
                      _mm_set1_epi32(0x000000FF));   // 8 bits a 32-bit lane
    c = _mm_packs_epi32(c, c);
    c = _mm_packus_epi16(c, c);
    const uint32_t codes = static_cast<uint32_t>(_mm_cvtsi128_si32(c));
    std::memcpy(pk, &codes, 4);
    std::memcpy(vb, &bits, 2);
}
#endif

// bases src[0..lim) of a row into its codes and validity bits; returns
// the first column not written (lim rounded down to a multiple of 8, 0
// for lim <= 0)
inline int64_t pack_span(const uint8_t *src, int64_t lim, uint8_t *pk,
                         uint8_t *vb) {
    int64_t j = 0;
#if defined(__SSE2__)
    for (; j + 16 <= lim; j += 16) pack16(src + j, pk + j / 4, vb + j / 8);
#endif
    for (; j + 8 <= lim; j += 8) {
        uint64_t x;
        std::memcpy(&x, src + j, 8);
        pack8(x, pk + j / 4, vb + j / 8);
    }
    return j;
}

}  // namespace

extern "C" {

// tile: rows x C (C % 8 == 0). packed: rows x C/4. vbits: rows x C/8.
int dtpu_pack2bit(const uint8_t *tile, int64_t rows, int64_t C,
                  uint8_t *packed, uint8_t *vbits) {
    if (C % 8 != 0 || rows < 0 || C < 0) return -1;
    const int64_t pw = C / 4, vw = C / 8;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t *row = tile + r * C;
        uint8_t *pk = packed + r * pw;
        uint8_t *vb = vbits + r * vw;
        pack_span(row, C, pk, vb);
    }
    return 0;
}

// Rows [row0, row0 + rows) of the tiling of joined[0, n) into rows of
// `content` bases plus a `halo`, padded to `width` columns (a multiple of
// 8, at least content + halo), packed as dtpu_pack2bit packs that tile:
// row r covers joined[r*content : r*content + content + halo], and bytes
// past n, like the columns past content + halo, read as N (pipeline's
// tile_sequence and _pad8).  packed: rows x width/4, vbits: rows x width/8.
int dtt_pack_joined(const uint8_t *joined, int64_t n, int64_t content,
                    int64_t halo, int64_t width, int64_t row0, int64_t rows,
                    uint8_t *packed, uint8_t *vbits) {
    if (n < 0 || content <= 0 || halo < 0 || width % 8 != 0
        || width < content + halo || row0 < 0 || rows < 0) return -1;
    const int64_t pw = width / 4, vw = width / 8;
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t start = (row0 + r) * content;
        int64_t lim = n - start;                    // columns that hold data
        if (lim > content + halo) lim = content + halo;
        const uint8_t *src = lim > 0 ? joined + start : joined;
        uint8_t *pk = packed + r * pw;
        uint8_t *vb = vbits + r * vw;
        int64_t j = pack_span(src, lim, pk, vb);
        if (j < lim) {                              // a word across lim
            uint64_t x = kAllN;
            std::memcpy(&x, src + j, static_cast<size_t>(lim - j));
            pack8(x, pk + j / 4, vb + j / 8);
            j += 8;
        }
        if (j < width) {                            // N: code 0, invalid
            std::memset(pk + j / 4, 0, static_cast<size_t>((width - j) / 4));
            std::memset(vb + j / 8, 0, static_cast<size_t>((width - j) / 8));
        }
    }
    return 0;
}

}  // extern "C"
