// 2-bit base packing for the device upload path.
//
// pipeline._pack_tile_host converts an ASCII tile into (2-bit codes
// packed 4/byte, validity bits packed 8/byte) — ~0.37 B/base on the
// bandwidth-bound host->device link.  The numpy version costs five
// full passes plus np.packbits (~31 MB/s on this single-core host,
// measured round 5), which starves the sketch phase; this single-pass
// C++ version produces byte-identical output from one table lookup per
// base.  Semantics match pipeline._pack_tile_host_inner exactly:
// up = byte & 0xDF; code A->0 C->1 G->2 T->3 else 0; valid iff
// up in {A, C, G, T}; codes little-packed 4/byte, valid bits
// little-packed 8/byte (numpy packbits bitorder="little").

#include <cstdint>

extern "C" {

// tile: rows x C (C % 8 == 0). packed: rows x C/4. vbits: rows x C/8.
int dtpu_pack2bit(const uint8_t *tile, int64_t rows, int64_t C,
                  uint8_t *packed, uint8_t *vbits) {
    if (C % 8 != 0 || rows < 0 || C < 0) return -1;
    uint8_t code[256];
    uint8_t valid[256];
    for (int i = 0; i < 256; ++i) {
        const uint8_t up = static_cast<uint8_t>(i) & 0xDF;
        uint8_t c = 0, v = 0;
        switch (up) {
            case 'A': c = 0; v = 1; break;
            case 'C': c = 1; v = 1; break;
            case 'G': c = 2; v = 1; break;
            case 'T': c = 3; v = 1; break;
            default: break;
        }
        code[i] = c;
        valid[i] = v;
    }
    const int64_t pw = C / 4, vw = C / 8;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t *row = tile + r * C;
        uint8_t *pk = packed + r * pw;
        uint8_t *vb = vbits + r * vw;
        for (int64_t j = 0; j < C; j += 8) {
            const uint8_t *b = row + j;
            pk[j / 4] = static_cast<uint8_t>(
                code[b[0]] | (code[b[1]] << 2) | (code[b[2]] << 4)
                | (code[b[3]] << 6));
            pk[j / 4 + 1] = static_cast<uint8_t>(
                code[b[4]] | (code[b[5]] << 2) | (code[b[6]] << 4)
                | (code[b[7]] << 6));
            vb[j / 8] = static_cast<uint8_t>(
                valid[b[0]] | (valid[b[1]] << 1) | (valid[b[2]] << 2)
                | (valid[b[3]] << 3) | (valid[b[4]] << 4)
                | (valid[b[5]] << 5) | (valid[b[6]] << 6)
                | (valid[b[7]] << 7));
        }
    }
    return 0;
}

}  // extern "C"
