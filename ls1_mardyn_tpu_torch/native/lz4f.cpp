// Minimal native LZ4 frame codec (compress + decompress).
//
// The reference wraps liblz4 for writer output compression
// (src/plugins/compression.{h,cpp}); so that the package needs neither
// liblz4 nor python-lz4, it ships its own implementation:
// a greedy hash-table LZ4 block compressor and a full block
// decompressor, wrapped in the LZ4 frame format (magic 0x184D2204,
// spec v1.6.x) with block-independent 4 MiB blocks and no content
// checksum.  Interoperable with standard `lz4` tools.
//
// Exposed via ctypes (see native/__init__.py):
//   long lz4f_compress(const uint8_t* src, long n, uint8_t* dst, long cap)
//   long lz4f_decompress(const uint8_t* src, long n, uint8_t* dst, long cap)
// Both return the output size, or -1 on error/overflow.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x184D2204u;
constexpr int kBlockLog = 22;  // 4 MiB max blocks (BD byte 7)
constexpr long kBlockSize = 1L << kBlockLog;

// -- xxHash32 (needed for the frame header checksum byte) --------------
inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

uint32_t xxh32(const uint8_t* p, size_t len, uint32_t seed) {
    const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                   P4 = 668265263u, P5 = 374761393u;
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* limit = end - 16;
        do {
            uint32_t x;
            memcpy(&x, p, 4); v1 = rotl32(v1 + x * P2, 13) * P1; p += 4;
            memcpy(&x, p, 4); v2 = rotl32(v2 + x * P2, 13) * P1; p += 4;
            memcpy(&x, p, 4); v3 = rotl32(v3 + x * P2, 13) * P1; p += 4;
            memcpy(&x, p, 4); v4 = rotl32(v4 + x * P2, 13) * P1; p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        uint32_t x;
        memcpy(&x, p, 4);
        h = rotl32(h + x * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p++) * P5, 11) * P1;
    }
    h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
    return h;
}

// -- LZ4 block compression (greedy, 64k hash table) ---------------------
inline uint32_t hash4(uint32_t x) { return (x * 2654435761u) >> 19; }  // 13 bits

// Compress one block; returns compressed size or -1 if it would not
// fit in `cap` (caller then stores the block uncompressed).
long lz4_block_compress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    if (n <= 0) return 0;
    constexpr int HLOG = 13;
    static thread_local int32_t table[1 << HLOG];
    memset(table, -1, sizeof(table));

    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    // matches must end >= 12 bytes before the block end; last literals
    // are always emitted raw (LZ4 spec end-of-block conditions)
    const uint8_t* mflimit = iend - 12;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    const uint8_t* anchor = src;

    if (n >= 13) {
        while (ip < mflimit) {
            uint32_t seq;
            memcpy(&seq, ip, 4);
            uint32_t h = hash4(seq) & ((1u << HLOG) - 1);
            int32_t ref = table[h];
            table[h] = (int32_t)(ip - src);
            uint32_t refseq;
            if (ref >= 0 && (ip - src) - ref <= 65535 &&
                (memcpy(&refseq, src + ref, 4), refseq == seq)) {
                // extend the match
                const uint8_t* match = src + ref;
                const uint8_t* mip = ip + 4;
                const uint8_t* mmatch = match + 4;
                const uint8_t* matchlimit = iend - 5;
                while (mip < matchlimit && *mip == *mmatch) { ++mip; ++mmatch; }
                long mlen = mip - ip;          // total match length (>= 4)
                long litlen = ip - anchor;
                // token + literals + offset + extra lengths
                long worst = 1 + litlen + litlen / 255 + 1 + 2 + mlen / 255 + 1;
                if (op + worst > oend) return -1;
                uint8_t* token = op++;
                long ll = litlen;
                if (ll >= 15) {
                    *token = (uint8_t)(15 << 4);
                    ll -= 15;
                    while (ll >= 255) { *op++ = 255; ll -= 255; }
                    *op++ = (uint8_t)ll;
                } else {
                    *token = (uint8_t)(ll << 4);
                }
                memcpy(op, anchor, litlen);
                op += litlen;
                uint16_t off = (uint16_t)(ip - match);
                memcpy(op, &off, 2);
                op += 2;
                long ml = mlen - 4;
                if (ml >= 15) {
                    *token |= 15;
                    ml -= 15;
                    while (ml >= 255) { *op++ = 255; ml -= 255; }
                    *op++ = (uint8_t)ml;
                } else {
                    *token |= (uint8_t)ml;
                }
                ip = mip;
                anchor = ip;
            } else {
                ++ip;
            }
        }
    }
    // last literals
    long litlen = iend - anchor;
    long worst = 1 + litlen + litlen / 255 + 1;
    if (op + worst > oend) return -1;
    uint8_t* token = op++;
    long ll = litlen;
    if (ll >= 15) {
        *token = (uint8_t)(15 << 4);
        ll -= 15;
        while (ll >= 255) { *op++ = 255; ll -= 255; }
        *op++ = (uint8_t)ll;
    } else {
        *token = (uint8_t)(ll << 4);
    }
    memcpy(op, anchor, litlen);
    op += litlen;
    return op - dst;
}

long lz4_block_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        long litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                litlen += b;
            } while (b == 255);
        }
        if (ip + litlen > iend || op + litlen > oend) return -1;
        memcpy(op, ip, litlen);
        ip += litlen;
        op += litlen;
        if (ip >= iend) break;  // end of block after last literals
        if (ip + 2 > iend) return -1;
        uint16_t off;
        memcpy(&off, ip, 2);
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        long mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - off;
        for (long i = 0; i < mlen; ++i) op[i] = match[i];  // may overlap
        op += mlen;
    }
    return op - dst;
}

inline void put32(uint8_t*& p, uint32_t v) { memcpy(p, &v, 4); p += 4; }

}  // namespace

extern "C" {

long lz4f_compress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    if (op + 7 > oend) return -1;
    put32(op, kMagic);
    // FLG: version 01, block independence 1, no checksums, no size
    uint8_t flg = (1 << 6) | (1 << 5);
    uint8_t bd = (uint8_t)(7 << 4);  // 4 MiB max block size
    uint8_t desc[2] = {flg, bd};
    *op++ = flg;
    *op++ = bd;
    *op++ = (uint8_t)(xxh32(desc, 2, 0) >> 8);  // header checksum
    for (long pos = 0; pos < n; pos += kBlockSize) {
        long blk = n - pos < kBlockSize ? n - pos : kBlockSize;
        if (op + 4 > oend) return -1;
        uint8_t* sizep = op;
        op += 4;
        long c = lz4_block_compress(src + pos, blk, op, oend - op);
        if (c < 0 || c >= blk) {
            // incompressible: store raw with the high bit set
            if (op + blk > oend) return -1;
            memcpy(op, src + pos, blk);
            uint32_t s = (uint32_t)blk | 0x80000000u;
            memcpy(sizep, &s, 4);
            op += blk;
        } else {
            uint32_t s = (uint32_t)c;
            memcpy(sizep, &s, 4);
            op += c;
        }
    }
    if (op + 4 > oend) return -1;
    put32(op, 0);  // EndMark
    return op - dst;
}

long lz4f_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    if (n < 7) return -1;
    uint32_t magic;
    memcpy(&magic, ip, 4);
    ip += 4;
    if (magic != kMagic) return -1;
    uint8_t flg = *ip++;
    uint8_t bd = *ip++;
    (void)bd;
    bool content_size = flg & (1 << 3);
    bool content_checksum = flg & (1 << 2);
    bool block_checksum = flg & (1 << 4);
    if (content_size) ip += 8;
    ip += 1;  // header checksum byte
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip + 4 <= iend) {
        uint32_t bsz;
        memcpy(&bsz, ip, 4);
        ip += 4;
        if (bsz == 0) break;  // EndMark
        bool raw = bsz & 0x80000000u;
        long blen = bsz & 0x7FFFFFFFu;
        if (ip + blen > iend) return -1;
        if (raw) {
            if (op + blen > oend) return -1;
            memcpy(op, ip, blen);
            op += blen;
        } else {
            long d = lz4_block_decompress(ip, blen, op, oend - op);
            if (d < 0) return -1;
            op += d;
        }
        ip += blen;
        if (block_checksum) ip += 4;
    }
    (void)content_checksum;
    return op - dst;
}

}  // extern "C"
