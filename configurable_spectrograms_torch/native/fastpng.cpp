// Minimal fast PNG encoder for RGB8 images.
//
// The port's own copy of the repository's native/fastpng.cpp, built by
// configurable_spectrograms_torch/render/fastpng.py.  Three changes: the
// run/LZ encoder of mostly-white canvases (namespace rlez) runs in every
// build, not only with libdeflate -- it needs a library only for adler32,
// which zlib has too, so a zlib build writes the same bytes for such a
// canvas as a libdeflate build; FASTPNG_ZLIB_ABI builds on a host that has
// neither libdeflate's nor zlib's header; and one canvas's run/LZ deflate is
// split into row stripes that a process-wide pool of native threads encodes
// in parallel (namespace stripes, below).
//
// The figure pipeline's largest host cost is PNG encoding: PIL runs
// adaptive per-scanline filtering plus zlib level-N on a single core.
// This encoder writes PNGs with a fixed filter strategy (Up, which
// compresses spectrogram tiles nearly as well as adaptive at a fraction
// of the filtering cost) and a caller-chosen zlib level.  Exposed via
// ctypes; the Python wrapper releases the GIL for the whole call so
// batch-driver worker threads overlap encode with device readback.
//
// PNG container: 8-byte signature, IHDR, one IDAT (zlib stream), IEND.
//
// Row stripes.  The canvas is cut at 16-row feed-block boundaries into K
// stripes, K a function of the canvas's shape alone (one per 128 KiB of
// filtered scanlines, at least 1, at most MAX_STRIPES), so a canvas gives
// the same bytes on every host and under any load.  Each stripe is
// Up-filtered (its first row against the canvas row above it), adler-summed
// and fed to its own fixed-Huffman encoder in the same fused 16-row loop as
// one stripe.  Its encoder first parses the 32 KB of rows above it without
// emitting, so its match table holds about what one encoder's would there.
// The canvas stays one fixed-Huffman block: the first stripe writes the
// zlib and block headers, the last the end-of-block code, and the caller
// joins the stripes' bits in order as they finish and combines their
// adler-32 and CRC-32 values (each stripe's thread sums its own); so the
// IDAT is one zlib stream within a few hundred bytes of one stripe's
// (smaller on some canvases).  K = 1 (under 256 KiB filtered) is the serial
// encoder's stream byte for byte.
//
// The pool starts at the first striped encode with min(cores / 2 - 1,
// MAX_STRIPES - 1) native helpers, which never touch the interpreter and
// leave the other half of the cores to the threads that do.  The caller
// queues stripes 1..K-1, encodes stripe 0, takes any stripe no helper has
// started, and joins the finished ones in between; so when other callers'
// stripes keep the helpers busy, an encode runs at about the serial cost
// instead of queueing behind them.  The pool records its pid: a forked
// child builds a pool of its own instead of waiting on threads it does not
// have.  Each thread keeps one grow-only buffer the size of a stripe and the
// 32 KB above it (the filtered rows it encodes), not of a canvas.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>

#include <sched.h>
#include <time.h>
#include <unistd.h>

#ifdef __SSSE3__
#include <tmmintrin.h>
#endif

// libdeflate compresses a whole buffer ~2-3x faster than zlib at the same
// ratio; the build tries it first (-DFASTPNG_USE_LIBDEFLATE -ldeflate) and
// falls back to plain zlib when the library is absent.
#ifdef FASTPNG_USE_LIBDEFLATE
#include <libdeflate.h>
#elif defined(FASTPNG_ZLIB_ABI)
// No zlib header on the build host: declare the four entry points this
// file calls, as zlib's stable ABI (libz.so.1) defines them, and link the
// libz.so.1 that Python's own zlib module loads.
extern "C" {
typedef unsigned long uLong;
typedef unsigned long uLongf;
typedef unsigned int uInt;
typedef unsigned char Bytef;
int compress2(Bytef* dest, uLongf* destLen, const Bytef* source, uLong sourceLen, int level);
uLong compressBound(uLong sourceLen);
uLong adler32(uLong adler, const Bytef* buf, uInt len);
uLong crc32(uLong crc, const Bytef* buf, uInt len);
}
#define Z_OK 0
#else
#include <zlib.h>
#endif

namespace {

// Adler-32 of the zlib stream, from whichever library the build links.
uint32_t adler32_of(uint32_t adler, const uint8_t* p, size_t n) {
#ifdef FASTPNG_USE_LIBDEFLATE
    return libdeflate_adler32(adler, p, n);
#else
    constexpr size_t STEP = size_t(1) << 30;  // zlib's length is a uInt
    uLong a = adler;
    for (size_t i = 0; i < n; i += STEP) a = adler32(a, p + i, uInt(n - i < STEP ? n - i : STEP));
    return uint32_t(a);
#endif
}

// Adler-32 of A then B from adler(A), adler(B) and B's length: zlib's
// adler32_combine, written here because libdeflate has no combine (and the
// zlib-abi variant declares only the four symbols above).
uint32_t adler32_combine_of(uint32_t adler1, uint32_t adler2, size_t len2) {
    constexpr uint32_t BASE = 65521u;
    const uint32_t rem = uint32_t(len2 % BASE);
    uint32_t sum1 = adler1 & 0xFFFFu;
    uint32_t sum2 = uint32_t((uint64_t(rem) * sum1) % BASE);
    sum1 += (adler2 & 0xFFFFu) + BASE - 1;
    sum2 += ((adler1 >> 16) & 0xFFFFu) + ((adler2 >> 16) & 0xFFFFu) + BASE - rem;
    if (sum1 >= BASE) sum1 -= BASE;
    if (sum1 >= BASE) sum1 -= BASE;
    if (sum2 >= (BASE << 1)) sum2 -= (BASE << 1);
    if (sum2 >= BASE) sum2 -= BASE;
    return sum1 | (sum2 << 16);
}

void put_be32(uint8_t* p, uint32_t x) {
    p[0] = uint8_t(x >> 24);
    p[1] = uint8_t(x >> 16);
    p[2] = uint8_t(x >> 8);
    p[3] = uint8_t(x);
}

// Repack one RGBA row to RGB.  SSSE3 shuffles 16 input bytes (4 px) to 12
// output bytes per step; the scalar 4->3 gather defeats auto-vectorization.
inline void repack_rgba_row(const uint8_t* in, uint8_t* out, int32_t w) {
    int32_t x = 0;
#ifdef __SSSE3__
    const __m128i shuf = _mm_setr_epi8(0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1);
    // Each step writes 16 bytes (12 valid + 4 scratch), so stop while the
    // scratch bytes still land inside the row's output span.
    for (; x + 5 < w; x += 4) {
        __m128i px4 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + size_t(x) * 4));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + size_t(x) * 3), _mm_shuffle_epi8(px4, shuf));
    }
#endif
    for (; x < w; ++x) {
        out[size_t(x) * 3 + 0] = in[size_t(x) * 4 + 0];
        out[size_t(x) * 3 + 1] = in[size_t(x) * 4 + 1];
        out[size_t(x) * 3 + 2] = in[size_t(x) * 4 + 2];
    }
}

// Subtract rgb(prev) from rgb(cur) where both rows are RGBA, writing the
// 3-byte-per-pixel Up-filtered scanline directly (alpha never touches the
// output).  SSSE3 does subtract + 4->3 shuffle in one pass; each step
// writes 16 bytes (12 valid + 4 scratch), and the x+5 < w guard keeps the
// scratch inside the row span exactly as repack_rgba_row's does.
inline void filter_row_rgba(const uint8_t* cur, const uint8_t* prev, uint8_t* out, int32_t w) {
    int32_t x = 0;
    // (An AVX-512VBMI 16-px permutexvar variant measured NO faster than
    // this SSSE3 loop on the target host: the pass runs at ~20 GB/s of
    // combined read+write traffic, i.e. it is memory-bound already.)
#ifdef __SSSE3__
    const __m128i shuf = _mm_setr_epi8(0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, -1, -1, -1, -1);
    for (; x + 5 < w; x += 4) {
        __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(cur + size_t(x) * 4));
        __m128i p = _mm_loadu_si128(reinterpret_cast<const __m128i*>(prev + size_t(x) * 4));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + size_t(x) * 3),
                         _mm_shuffle_epi8(_mm_sub_epi8(c, p), shuf));
    }
#endif
    for (; x < w; ++x) {
        out[size_t(x) * 3 + 0] = uint8_t(cur[size_t(x) * 4 + 0] - prev[size_t(x) * 4 + 0]);
        out[size_t(x) * 3 + 1] = uint8_t(cur[size_t(x) * 4 + 1] - prev[size_t(x) * 4 + 1]);
        out[size_t(x) * 3 + 2] = uint8_t(cur[size_t(x) * 4 + 2] - prev[size_t(x) * 4 + 2]);
    }
}

// Up-filter canvas rows [y0, y1) into `raw`, which holds rows from y_base
// on (filter byte + stride bytes per row).  Reads straight from the
// caller's RGB/RGBA pixels -- no intermediate repacked row buffers; a row
// is filtered against the canvas row above it wherever `raw` starts.
void filter_rows(const uint8_t* px, int32_t w, int32_t channels,
                 int32_t y0, int32_t y1, int32_t y_base, uint8_t* raw) {
    const size_t stride = size_t(w) * 3;
    const size_t in_stride = size_t(w) * size_t(channels);
    for (int32_t y = y0; y < y1; ++y) {
        uint8_t* dst = raw + size_t(y - y_base) * (stride + 1);
        const uint8_t* cur = px + size_t(y) * in_stride;
        if (y == 0) {
            *dst++ = 0;  // None
            if (channels == 3) std::memcpy(dst, cur, stride);
            else repack_rgba_row(cur, dst, w);
        } else {
            *dst++ = 2;  // Up
            const uint8_t* prev = cur - in_stride;
            if (channels == 3) {
                for (size_t x = 0; x < stride; ++x) dst[x] = uint8_t(cur[x] - prev[x]);
            } else {
                filter_row_rgba(cur, prev, dst, w);
            }
        }
    }
}

// CRC-32 of the bytes after `crc`'s (start from 0), from whichever library
// the build links: a PNG's IDAT is as long as its zlib stream, and a
// byte-at-a-time table took longer than the striped deflate itself.
uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
#ifdef FASTPNG_USE_LIBDEFLATE
    return libdeflate_crc32(crc, p, n);
#else
    constexpr size_t STEP = size_t(1) << 30;  // zlib's length is a uInt
    uLong c = crc;
    for (size_t i = 0; i < n; i += STEP) c = crc32(c, p + i, uInt(n - i < STEP ? n - i : STEP));
    return uint32_t(c);
#endif
}

// CRC-32 over bit strings, read LSB first as deflate packs them and as the
// PNG CRC reads bytes: crc(A then B) = x^|B| crc(A) + crc(B) mod P for any
// bit lengths (the initial and final inversions cancel), so each stripe's
// thread sums its own bits and the caller only combines (zlib's
// crc32_combine, in bits; libdeflate has none).
constexpr uint32_t CRC_POLY = 0xEDB88320u;  // reflected

uint32_t crc_multmodp(uint32_t a, uint32_t b) {  // a * b mod P; a != 0
    uint32_t m = 1u << 31, p = 0;
    for (;;) {
        if (a & m) {
            p ^= b;
            if ((a & (m - 1)) == 0) break;
        }
        m >>= 1;
        b = b & 1 ? (b >> 1) ^ CRC_POLY : b >> 1;
    }
    return p;
}

// CRC-32 of the first `bits` bits of p.
uint32_t crc32_bits(const uint8_t* p, size_t bits) {
    uint32_t c = crc32_update(0, p, bits / 8);
    if (bits & 7) {
        uint32_t raw = ~c;
        const uint8_t last = p[bits / 8];
        for (unsigned i = 0; i < (bits & 7); ++i) {
            raw ^= (last >> i) & 1u;
            raw = raw & 1 ? (raw >> 1) ^ CRC_POLY : raw >> 1;
        }
        c = ~raw;
    }
    return c;
}

// CRC-32 of A then B from crc(A), crc(B) and B's length in bits.
uint32_t crc32_cat(uint32_t crc_a, uint32_t crc_b, uint64_t bits_b) {
    uint32_t xn = 1u << 31, x2k = 1u << 30;  // x^0, and x^(2^k) from x^1
    for (; bits_b; bits_b >>= 1) {
        if (bits_b & 1) xn = crc_multmodp(x2k, xn);
        x2k = crc_multmodp(x2k, x2k);
    }
    return crc_multmodp(xn, crc_a) ^ crc_b;
}

const uint8_t IHDR[4] = {'I', 'H', 'D', 'R'};
const uint8_t IDAT[4] = {'I', 'D', 'A', 'T'};
const uint8_t IEND[4] = {'I', 'E', 'N', 'D'};

// A PNG file: the signature and IHDR go out when it opens, the IDAT and
// IEND when the stream is done.  The striped encoder opens it while its
// helpers encode, and writes the IDAT in one piece: on the 8-core host of
// an H100 machine an open took ~0.5 ms, and a write a stripe ~1 ms more
// than one write.
class PngFile {
public:
    void open(const char* path, int32_t w, int32_t h) {
        f_ = std::fopen(path, "wb");
        if (f_ == nullptr) return;
        static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
        uint8_t ihdr[13];
        put_be32(ihdr, uint32_t(w));
        put_be32(ihdr + 4, uint32_t(h));
        ihdr[8] = 8;   // bit depth
        ihdr[9] = 2;   // color type: truecolor RGB
        ihdr[10] = 0;  // compression
        ihdr[11] = 0;  // filter method
        ihdr[12] = 0;  // no interlace
        ok_ = std::fwrite(sig, 1, 8, f_) == 8;
        chunk(IHDR, ihdr, 13, crc32_update(crc32_update(0, IHDR, 4), ihdr, 13));
    }
    bool opened() const { return f_ != nullptr; }
    // Writes the IDAT (`crc`: the CRC-32 of its type and data), IEND, and
    // closes; true when every write succeeded.
    bool close(const std::vector<uint8_t>& idat, uint32_t crc) {
        chunk(IDAT, idat.data(), idat.size(), crc);
        chunk(IEND, nullptr, 0, crc32_update(0, IEND, 4));
        ok_ = (std::fclose(f_) == 0) && ok_;
        f_ = nullptr;
        return ok_;
    }
    ~PngFile() {
        if (f_ != nullptr) std::fclose(f_);
    }

private:
    void chunk(const uint8_t type[4], const uint8_t* p, size_t n, uint32_t crc) {
        uint8_t head[8], tail[4];
        put_be32(head, uint32_t(n));
        std::memcpy(head + 4, type, 4);
        put_be32(tail, crc);
        ok_ = ok_ && std::fwrite(head, 1, 8, f_) == 8 && (n == 0 || std::fwrite(p, 1, n, f_) == n) &&
              std::fwrite(tail, 1, 4, f_) == 4;
    }
    FILE* f_ = nullptr;
    bool ok_ = false;
};

// ---------------------------------------------------------------------------
// Specialized deflate encoder for filtered figure canvases.
//
// A 200-DPI figure canvas is mostly white, so after the Up filter the
// scanline stream is dominated by long zero runs; libdeflate still walks
// every byte through its hash-chain matcher (~110 ms for a 34 MB canvas on
// this host, independent of level, while the filter pass is 7 ms).  This
// encoder emits a single fixed-Huffman deflate block directly: runs become
// distance-1 matches found with 8-byte word compares, and the remaining
// (tile) bytes go through a single-probe hash-4 greedy LZ.  Measured ~4x
// faster than libdeflate on real canvases at a modest ratio cost; the
// caller falls back to libdeflate when a sampled zero-fraction says the
// canvas is noise-like (where static Huffman would *expand* the data).
// ---------------------------------------------------------------------------
namespace rlez {

inline uint32_t bit_reverse(uint32_t v, int n) {
    uint32_t r = 0;
    for (int i = 0; i < n; ++i) { r = (r << 1) | (v & 1); v >>= 1; }
    return r;
}

struct Tables {
    uint16_t lit_code[288];   // pre-reversed fixed-Huffman literal/length codes
    uint8_t  lit_bits[288];
    uint16_t len_sym[259];    // match length 3..258 -> symbol 257..285
    uint8_t  len_ebits[259];
    uint16_t len_ebase[259];
    uint8_t  dist_sym[32769]; // distance 1..32768 -> code 0..29
    uint8_t  dist_ebits[30];
    uint16_t dist_base[30];
    uint16_t dist_code5[30];  // pre-reversed 5-bit fixed distance codes
    Tables() {
        for (int s = 0; s < 288; ++s) {
            int bits, code;
            if (s < 144)      { bits = 8; code = 0x30 + s; }
            else if (s < 256) { bits = 9; code = 0x190 + (s - 144); }
            else if (s < 280) { bits = 7; code = s - 256; }
            else              { bits = 8; code = 0xC0 + (s - 280); }
            lit_code[s] = uint16_t(bit_reverse(uint32_t(code), bits));
            lit_bits[s] = uint8_t(bits);
        }
        static const int lext[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,0};
        static const int lbase[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,51,59,67,83,99,115,131,163,195,227,258};
        for (int c = 0; c < 29; ++c) {
            int lo = lbase[c];
            int hi = (c == 28) ? 258 : lbase[c + 1] - 1;
            if (hi > 258) hi = 258;
            for (int L = lo; L <= hi; ++L) {
                len_sym[L] = uint16_t(257 + c);
                len_ebits[L] = uint8_t(lext[c]);
                len_ebase[L] = uint16_t(lo);
            }
        }
        static const int dext[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,10,10,11,11,12,12,13,13};
        static const int dbase[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
        for (int c = 0; c < 30; ++c) {
            dist_ebits[c] = uint8_t(dext[c]);
            dist_base[c] = uint16_t(dbase[c]);
            dist_code5[c] = uint16_t(bit_reverse(uint32_t(c), 5));
            int lo = dbase[c];
            int hi = (c == 29) ? 32768 : dbase[c + 1] - 1;
            for (int d = lo; d <= hi; ++d) dist_sym[d] = uint8_t(c);
        }
    }
};

inline const Tables& tables() {
    static const Tables t;
    return t;
}

// Pointer-based LSB-first bit writer.  `put` dumps the accumulator with one
// unaligned 8-byte store and keeps 0-7 residual bits -- no per-byte
// push_back branches.  Callers must `reserve` headroom before a run of
// puts; `finish` trims the vector to the exact byte length and returns the
// number of valid bits in it (the last byte's unused high bits are zero).
struct BitWriter {
    std::vector<uint8_t>& out;
    size_t pos;
    uint64_t acc = 0;
    int nbits = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o), pos(o.size()) {}
    inline void reserve(size_t upcoming_bytes) {
        size_t need = pos + upcoming_bytes + 16;
        if (out.size() < need) out.resize(need + (out.size() >> 1));
    }
    inline void put(uint32_t code, int bits) {  // requires reserved headroom
        acc |= uint64_t(code) << nbits;
        nbits += bits;
        std::memcpy(out.data() + pos, &acc, 8);
        pos += size_t(nbits >> 3);
        acc >>= (nbits & ~7);
        nbits &= 7;
    }
    size_t finish() {
        const size_t bits = pos * 8 + size_t(nbits);
        if (nbits > 0) {
            out[pos++] = uint8_t(acc);
            acc = 0;
            nbits = 0;
        }
        out.resize(pos);
        return bits;
    }
};

// Incremental fixed-Huffman deflate over a growing prefix of a stable
// buffer.  ``feed(upto)`` consumes bytes [consumed, upto); earlier bytes
// must stay valid (back-references reach up to 32 KB behind the cursor).
// The encode driver interleaves Up-filtering, adler, and feed() in row
// blocks so the filtered stream is compressed while still cache-resident
// instead of three whole-canvas DRAM passes.  A run or match never spans
// a feed boundary (it re-forms as distance-1 matches in the next call),
// costing a handful of literals per ~230 KB block -- unmeasurable ratio
// impact.
//
// A canvas is one fixed-Huffman block however many row stripes encode it:
// the `first` stripe's encoder writes the zlib header and the block header,
// the `last` one the end-of-block code, and the caller joins the stripes'
// bits.  So a stripe boundary costs no framing bits, only what its fresh
// parse state loses, which `prime` takes back.
class FixedEnc {
public:
    FixedEnc(std::vector<uint8_t>& out, const uint8_t* base, bool first, bool last)
        : bw_(first ? push_hdr(out) : out), in_(base), last_(last) {
        head_store().assign(size_t(1) << HBITS, -1);
        bw_.reserve(1024);
        if (first) {
            bw_.put(1, 1);  // BFINAL
            bw_.put(1, 2);  // BTYPE=01 fixed Huffman
        }
    }
    // Take bytes [0, upto) as already encoded (the rows above a stripe):
    // parse their last 32 KB without emitting, so the match table holds
    // about what one encoder's would at `upto`.  Filling the table with
    // every position instead measured up to 0.4% larger files: collisions
    // in the 11-bit table evict the entries a parse keeps.
    void prime(size_t upto) {
        i_ = upto > WINDOW ? upto - WINDOW : 0;
        scan<false>(upto);
    }
    void feed(size_t upto) { scan<true>(upto); }
    // Ends the block if `last`; returns the number of valid bits written.
    size_t finish() {
        if (last_) {
            bw_.reserve(16);
            bw_.put(tables().lit_code[256], tables().lit_bits[256]);  // end of block
        }
        return bw_.finish();
    }

private:
    static std::vector<uint8_t>& push_hdr(std::vector<uint8_t>& o) {
        o.push_back(0x78);  // CMF: deflate, 32K window
        o.push_back(0x01);  // FLG: fastest, (0x7801 % 31 == 0)
        return o;
    }
    static std::vector<int64_t>& head_store() {
        static thread_local std::vector<int64_t> hs;
        return hs;
    }
    // 11 bits = a 16 KB head table that stays L1-resident.  Real figure
    // canvases are ~92% zero bytes after the Up filter; the non-zero
    // remainder emits almost entirely literals, so the per-byte head
    // probe/store is overhead with little match payoff and its cache
    // footprint dominates.  Measured on a real 8.6 MB filtered canvas
    // stream: HBITS 15 -> 5.7 ms / 493 kB, 13 -> 5.3 / 497, 12 -> 5.0 /
    // 501, 11 -> 4.7 / 508, 10 -> 4.8 / 518 -- 11 takes ~18% off the
    // compress phase for +3% file size.  (A paired two-literal bit-write
    // variant re-measured 0% here, confirming the earlier rejection.)
    static constexpr int HBITS = 11;
    static constexpr size_t WINDOW = 32768;  // deflate's farthest back-reference
    static uint32_t hash4(const uint8_t* p) {
        uint32_t v;
        std::memcpy(&v, p, 4);
        return (v * 2654435761u) >> (32 - HBITS);
    }
    template <bool EMIT>
    void scan(size_t upto);

    BitWriter bw_;
    const uint8_t* in_;
    const bool last_;
    size_t i_ = 0;
};

// Parse [i_, upto): with EMIT the symbols are written; without, only the
// match table advances (prime).
template <bool EMIT>
void FixedEnc::scan(size_t upto) {
    const Tables& T = tables();
    BitWriter& bw = bw_;
    std::vector<uint8_t>& out = bw_.out;
    const uint8_t* in = in_;
    const size_t n = upto;

    auto emit_lit = [&](uint8_t b) {
        if (EMIT) bw.put(T.lit_code[b], T.lit_bits[b]);
    };
    auto emit_match = [&](size_t L, size_t D) {
        if (!EMIT) return;
        unsigned s = T.len_sym[L];
        bw.put(T.lit_code[s], T.lit_bits[s]);
        if (T.len_ebits[L]) bw.put(uint32_t(L - T.len_ebase[L]), T.len_ebits[L]);
        unsigned dc = T.dist_sym[D];
        bw.put(T.dist_code5[dc], 5);
        if (T.dist_ebits[dc]) bw.put(uint32_t(D - T.dist_base[dc]), T.dist_ebits[dc]);
    };

    constexpr size_t MIN_RUN = 16;
    int64_t* head = head_store().data();

    // (A probe-skipping literal-burst variant -- lengthening literal runs
    // after consecutive failed probes, paired two-literal bit-writes --
    // measured <=1% end-to-end even on pure-noise input and 0% on real
    // canvases: literals never dominate here, the run/RLE path and bit IO
    // do.  Rejected to keep this loop simple.)
    size_t i = i_;
    while (i < n) {
        // Headroom for the worst burst this iteration can emit (a literal
        // is <=2 bytes; a full run segment stays far under this).
        if (EMIT && bw.pos + 2048 > out.size()) bw.reserve(1 << 16);
        // Run fast path: byte repeated >= MIN_RUN times becomes dist-1 matches.
        if (i + MIN_RUN <= n && in[i] == in[i + 1]) {
            uint8_t b = in[i];
            uint64_t pat = 0x0101010101010101ull * b;
            size_t j = i + 1;
            // 32-byte blocks first (auto-vectorizes under -march=native);
            // the 8-byte loop then resolves the tail.
            while (j + 32 <= n) {
                uint64_t v0, v1, v2, v3;
                std::memcpy(&v0, in + j, 8);
                std::memcpy(&v1, in + j + 8, 8);
                std::memcpy(&v2, in + j + 16, 8);
                std::memcpy(&v3, in + j + 24, 8);
                if ((v0 ^ pat) | (v1 ^ pat) | (v2 ^ pat) | (v3 ^ pat)) break;
                j += 32;
            }
            while (j + 8 <= n) {
                uint64_t v;
                std::memcpy(&v, in + j, 8);
                if (v != pat) break;
                j += 8;
            }
            while (j < n && in[j] == b) ++j;
            size_t r = j - i;
            if (r >= MIN_RUN) {
                if (EMIT) bw.reserve((r / 258 + 2) * 4 + 64);  // one giant run can emit many matches
                if (i + 4 <= n) head[hash4(in + i)] = int64_t(i);
                emit_lit(b);
                ++i;
                --r;
                while (r >= 3) {
                    size_t L = r > 258 ? 258 : r;
                    emit_match(L, 1);
                    i += L;
                    r -= L;
                }
                while (r > 0) { emit_lit(in[i]); ++i; --r; }
                continue;
            }
        }
        if (i + 4 <= n) {
            uint32_t hs = hash4(in + i);
            int64_t cand = head[hs];
            head[hs] = int64_t(i);
            if (cand >= 0 && i - size_t(cand) <= WINDOW) {
                uint32_t a, c;
                std::memcpy(&a, in + i, 4);
                std::memcpy(&c, in + size_t(cand), 4);
                if (a == c) {
                    size_t maxL = n - i;
                    if (maxL > 258) maxL = 258;
                    size_t L = 4;
                    // Word-accelerated extension (overlap-safe: bytes before
                    // i are fully defined when the decoder copies them).
                    // 32-byte blocks first; the 8-byte loop resolves tails.
                    while (L + 32 <= maxL) {
                        uint64_t x0, x1, x2, x3, y0, y1, y2, y3;
                        std::memcpy(&x0, in + i + L, 8);
                        std::memcpy(&x1, in + i + L + 8, 8);
                        std::memcpy(&x2, in + i + L + 16, 8);
                        std::memcpy(&x3, in + i + L + 24, 8);
                        std::memcpy(&y0, in + size_t(cand) + L, 8);
                        std::memcpy(&y1, in + size_t(cand) + L + 8, 8);
                        std::memcpy(&y2, in + size_t(cand) + L + 16, 8);
                        std::memcpy(&y3, in + size_t(cand) + L + 24, 8);
                        if ((x0 ^ y0) | (x1 ^ y1) | (x2 ^ y2) | (x3 ^ y3)) break;
                        L += 32;
                    }
                    while (L + 8 <= maxL) {
                        uint64_t x, y;
                        std::memcpy(&x, in + i + L, 8);
                        std::memcpy(&y, in + size_t(cand) + L, 8);
                        uint64_t diff = x ^ y;
                        if (diff) { L += size_t(__builtin_ctzll(diff)) >> 3; goto extended; }
                        L += 8;
                    }
                    while (L < maxL && in[size_t(cand) + L] == in[i + L]) ++L;
                extended:
                    emit_match(L, i - size_t(cand));
                    if (i + L + 4 <= n) head[hash4(in + i + L - 1)] = int64_t(i + L - 1);
                    i += L;
                    continue;
                }
            }
        }
        emit_lit(in[i]);
        ++i;
    }
    i_ = i;
}

// Sampled fraction of zero 8-byte words in the would-be Up-filtered
// stream -- cheap proxy for "mostly white canvas", where the run encoder
// wins.  Noise-like data (static Huffman would expand it) routes to
// libdeflate instead.  Works from the raw canvas (filters ~64 sampled
// rows into a scratch line) so the driver can choose the encoder BEFORE
// any full filter pass exists.
double sampled_zero_frac_rows(const uint8_t* px, int32_t w, int32_t h, int32_t channels) {
    const size_t stride = size_t(w) * 3;
    if (h < 2 || stride < 64) return 0.0;
    static thread_local std::vector<uint8_t> tmp;
    tmp.resize(stride + 1);
    int32_t step = h > 64 ? h / 64 : 1;
    size_t hits = 0, total = 0;
    const size_t in_stride = size_t(w) * size_t(channels);
    for (int32_t y = 1; y < h; y += step) {
        const uint8_t* cur = px + size_t(y) * in_stride;
        const uint8_t* prev = cur - in_stride;
        uint8_t* dst = tmp.data() + 1;
        if (channels == 3) {
            for (size_t x = 0; x < stride; ++x) dst[x] = uint8_t(cur[x] - prev[x]);
        } else {
            filter_row_rgba(cur, prev, dst, w);
        }
        for (size_t i = 1; i + 8 <= stride + 1; i += 32, ++total) {
            uint64_t v;
            std::memcpy(&v, tmp.data() + i, 8);
            if (v == 0) ++hits;
        }
    }
    return total ? double(hits) / double(total) : 0.0;
}

}  // namespace rlez

// ---------------------------------------------------------------------------
// Row stripes of one canvas and the pool of native threads that encodes
// them (see the header comment).
// ---------------------------------------------------------------------------
namespace stripes {

constexpr int32_t BLOCK_ROWS = 16;                 // rows per fused filter/adler/encode step
constexpr int32_t MAX_STRIPES = 16;
constexpr size_t STRIPE_BYTES = size_t(128) << 10;  // filtered bytes per stripe

// The stripe count of a w x h canvas: its shape alone decides it.
int32_t count_for(int32_t w, int32_t h) {
    const size_t filtered = size_t(h) * (size_t(w) * 3 + 1);
    const size_t blocks = (size_t(h) + BLOCK_ROWS - 1) / BLOCK_ROWS;
    size_t k = filtered / STRIPE_BYTES;
    if (k > size_t(MAX_STRIPES)) k = MAX_STRIPES;
    if (k > blocks) k = blocks;
    return k < 1 ? 1 : int32_t(k);
}

struct Stripe {
    int32_t y0 = 0, y1 = 0;             // canvas rows [y0, y1)
    std::vector<uint8_t>* out = nullptr;  // its deflate bits (the caller's buffer)
    size_t bits = 0;                    // how many of them are valid
    uint32_t crc = 0;                   // their CRC-32 (crc32_bits)
    uint32_t adler = 1;
    size_t filtered = 0;                // its filtered bytes (adler-combine length)
    double t0 = 0.0, t1 = 0.0;          // when it started and ended (monotonic())
    bool done = false;                  // under the pool's lock
};

struct Job {
    const uint8_t* px;
    int32_t w, channels, n;
    Stripe s[MAX_STRIPES];
    int32_t next = 1;  // the next stripe to claim, under the pool's lock
};

// Rows of history a stripe after the first primes its encoder with: the
// canvas rows just above it that hold deflate's 32 KB window (filtered
// again by this stripe, which is cheaper than waiting for its neighbour).
int32_t history_rows(size_t row_bytes, int32_t y0) {
    const size_t rows = (size_t(32768) + row_bytes - 1) / row_bytes;
    return rows < size_t(y0) ? int32_t(rows) : y0;
}

// Append the first `src_bits` bits of `src` to `dst`, which holds
// `dst_bits` (LSB-first, as deflate packs them; unused high bits zero).
// Eight bytes a step: a byte loop took ~1 ms for an audio figure's stream.
void append_bits(std::vector<uint8_t>& dst, size_t dst_bits, const std::vector<uint8_t>& src, size_t src_bits) {
    const size_t src_bytes = (src_bits + 7) / 8;
    const unsigned r = unsigned(dst_bits & 7);
    if (r == 0) {
        dst.insert(dst.end(), src.begin(), src.begin() + ptrdiff_t(src_bytes));
        return;
    }
    // dst's last byte is partial: shift src up by r bits into it, carrying
    // each word's top r bits into the next.
    const size_t at = dst.size() - 1;
    dst.resize(at + src_bytes + 1 + 8);  // 8 bytes of slack for the word stores
    uint8_t* d = dst.data() + at;
    uint64_t carry = d[0];
    size_t j = 0;
    for (; j + 8 <= src_bytes; j += 8) {
        uint64_t w;
        std::memcpy(&w, src.data() + j, 8);
        const uint64_t v = (w << r) | carry;
        std::memcpy(d + j, &v, 8);
        carry = w >> (64 - r);
    }
    for (; j < src_bytes; ++j) {
        d[j] = uint8_t((unsigned(src[j]) << r) | unsigned(carry));
        carry = unsigned(src[j]) >> (8 - r);
    }
    d[src_bytes] = uint8_t(carry);
    dst.resize((dst_bits + src_bits + 7) / 8);
}

// CLOCK_MONOTONIC in seconds: the clock of Python's time.perf_counter on
// Linux, so a stripe's interval lines up with the stage timer's.
double monotonic() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return double(ts.tv_sec) + 1e-9 * double(ts.tv_nsec);
}

void encode(Job& job, int32_t k) {
    Stripe& s = job.s[k];
    s.t0 = monotonic();
    const size_t row_bytes = size_t(job.w) * 3 + 1;
    const int32_t base = s.y0 - history_rows(row_bytes, s.y0);  // first row in `raw`
    // Grow-only and per thread: a fresh allocation per call page-faults its
    // way through the filter loop (measured 3x the steady-state encode time
    // on first touch).
    static thread_local std::vector<uint8_t> raw;
    const size_t need = size_t(s.y1 - base) * row_bytes;
    if (raw.size() < need) raw.resize(need);
    s.out->clear();
    filter_rows(job.px, job.w, job.channels, base, s.y0, base, raw.data());
    size_t done = size_t(s.y0 - base) * row_bytes;
    rlez::FixedEnc enc(*s.out, raw.data(), k == 0, k == job.n - 1);
    enc.prime(done);
    // Fused single pass: Up-filter, adler32, and the fixed-Huffman encoder
    // advance together in 16-row blocks, so the filtered bytes are
    // consumed while still cache-resident (the split pipeline walked the
    // canvas through DRAM three times; fusing measured ~30% off).
    uint32_t adler = 1;
    for (int32_t y = s.y0; y < s.y1; y += BLOCK_ROWS) {
        const int32_t ye = y + BLOCK_ROWS < s.y1 ? y + BLOCK_ROWS : s.y1;
        filter_rows(job.px, job.w, job.channels, y, ye, base, raw.data());
        const size_t upto = size_t(ye - base) * row_bytes;
        adler = adler32_of(adler, raw.data() + done, upto - done);
        enc.feed(upto);
        done = upto;
    }
    s.bits = enc.finish();
    s.crc = crc32_bits(s.out->data(), s.bits);
    s.adler = adler;
    s.filtered = size_t(s.y1 - s.y0) * row_bytes;
    s.t1 = monotonic();
}

int32_t cores() {
#ifdef __linux__
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof(set), &set) == 0) return int32_t(CPU_COUNT(&set));
#endif
    return int32_t(std::thread::hardware_concurrency());
}

class Pool {
public:
    explicit Pool(pid_t pid) : pid(pid) {}
    const pid_t pid;

    // An encode takes at most half the cores: its caller and cores/2 - 1
    // helpers.  With cores - 1 helpers a 4-worker FAST pass composited 65%
    // slower and its render dispatcher took 2.4x as long, as the helpers
    // preempted the threads that hold the interpreter's lock; with half,
    // compositing kept its time.
    void start() {
        int32_t helpers = cores() / 2 - 1;
        if (helpers > MAX_STRIPES - 1) helpers = MAX_STRIPES - 1;
        for (int32_t i = 0; i < helpers; ++i) {
            try {
                std::thread([this] { help(); }).detach();
            } catch (const std::system_error&) {
                break;  // fewer helpers: callers encode what no helper takes
            }
        }
    }

    // Queue stripes 1..n-1 of `job` for the helpers.
    void submit(Job& job) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            queue_.push_back(&job);
        }
        work_.notify_all();
    }

    // Encode stripe 0 and any stripe of `job` no helper has started, and
    // hand every stripe to `emit` on this thread in order, as soon as it and
    // those before it are done; returns after the last.
    template <class Emit>
    void work(Job& job, Emit&& emit) {
        encode(job, 0);
        emit(0);
        int32_t emitted = 1;
        std::unique_lock<std::mutex> lk(mu_);
        job.s[0].done = true;
        while (emitted < job.n) {
            const int32_t k = claim(job);
            if (k >= 0) {
                lk.unlock();
                encode(job, k);
                lk.lock();
                job.s[k].done = true;
            } else if (!job.s[emitted].done) {
                finished_.wait(lk, [&] { return job.s[emitted].done; });
            }
            while (emitted < job.n && job.s[emitted].done) {
                lk.unlock();
                emit(emitted++);
                lk.lock();
            }
        }
    }

private:
    // The next unstarted stripe of `job`, or -1; under mu_.  Whoever takes
    // the last one takes the job off the queue, so a queued job always has
    // a stripe left; a helper touches a job only until it marks its stripe
    // done, which the caller waits for.
    int32_t claim(Job& job) {
        if (job.next >= job.n) return -1;
        const int32_t k = job.next++;
        if (job.next == job.n) {
            for (auto it = queue_.begin(); it != queue_.end(); ++it) {
                if (*it == &job) { queue_.erase(it); break; }
            }
        }
        return k;
    }

    void help() {
        std::unique_lock<std::mutex> lk(mu_);
        for (;;) {
            work_.wait(lk, [&] { return !queue_.empty(); });
            Job& job = *queue_.front();
            const int32_t k = claim(job);
            lk.unlock();
            encode(job, k);
            lk.lock();
            job.s[k].done = true;
            finished_.notify_all();
        }
    }

    std::mutex mu_;
    std::condition_variable work_, finished_;
    std::deque<Job*> queue_;
};

// The process's pool, started at the first striped encode.  A forked child
// inherits the pointer but not the threads (and maybe a lock held by one of
// them): it leaves the parent's pool alone and starts its own.
std::atomic<Pool*> the_pool{nullptr};

Pool& pool() {
    const pid_t me = getpid();
    Pool* p = the_pool.load(std::memory_order_acquire);
    while (p == nullptr || p->pid != me) {
        Pool* fresh = new Pool(me);
        if (the_pool.compare_exchange_strong(p, fresh, std::memory_order_acq_rel)) {
            fresh->start();
            return *fresh;
        }
        delete fresh;  // another thread installed one: p now holds it
    }
    return *p;
}

}  // namespace stripes

}  // namespace

// The number of row stripes the run/LZ encoder cuts a w x h canvas into.
extern "C" int32_t fastpng_stripe_count(int32_t w, int32_t h) {
    if (w <= 0 || h <= 0) return 0;
    return stripes::count_for(w, h);
}

// Write a PNG.  `stripes` 0 cuts the canvas by its shape (every caller but
// the tests, which pass 1 for the one-stripe stream); `stripe_times`, when
// not null, receives each stripe's start and end on CLOCK_MONOTONIC, in
// seconds (room for two for each of fastpng_stripe_count's, or `stripes`'s,
// stripes).  Returns the number of stripes the run/LZ encoder used, 0 where
// the library's deflate encoded the canvas, or a negative error.
extern "C" int32_t fastpng_write_v3(
    const uint8_t* px,    // h*w*channels bytes, row-major
    int32_t w,
    int32_t h,
    int32_t channels,     // 3 (RGB) or 4 (RGBA; alpha dropped -- output is RGB)
    int32_t zlevel,
    const char* path,
    int32_t stripes,
    double* stripe_times
) {
    if (w <= 0 || h <= 0 || px == nullptr || path == nullptr) return -1;
    if (channels != 3 && channels != 4) return -1;
    if (stripes < 0) return -1;

    // Filtered scanlines: filter byte 2 ("Up") per row; row 0 uses "None".
    // RGBA input filters straight from the caller's pixels (subtract +
    // 4->3 shuffle fused), so a shared RGBA canvas encodes with zero
    // repack buffers.
    //
    // Mostly-white canvases (the product's figures) take the specialized
    // run/LZ fixed-Huffman encoder (~4x faster); noise-like data routes to
    // the library's deflate (libdeflate, else zlib) where dynamic Huffman is
    // both smaller and faster.
    // FASTPNG_ENCODER=libdeflate|rle forces a path (tests / comparison).
    const char* force = std::getenv("FASTPNG_ENCODER");
    bool use_rle;
    if (force && std::strcmp(force, "rle") == 0) use_rle = true;
    else if (force && std::strcmp(force, "libdeflate") == 0) use_rle = false;
    else use_rle = rlez::sampled_zero_frac_rows(px, w, h, channels) >= 0.35;
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ == __ORDER_BIG_ENDIAN__)
    // The rlez BitWriter flushes its 64-bit accumulator with a raw memcpy
    // and the run finder's word compares assume little-endian byte order;
    // on big-endian hosts that would emit corrupt zlib streams.  Route such
    // builds to libdeflate unconditionally (overrides FASTPNG_ENCODER=rle).
    use_rle = false;
#endif
    // The IDAT's data (the zlib stream) and its CRC-32 from the chunk type on.
    static thread_local std::vector<uint8_t> zdata;
    zdata.clear();
    uint32_t crc = crc32_update(0, IDAT, 4);
    PngFile file;
    int32_t used = 0;
    if (use_rle) {
        // Stripe k covers feed blocks [k*B/K, (k+1)*B/K): the same 16-row
        // blocks as one stripe, cut between them.
        stripes::Job job;
        job.px = px;
        job.w = w;
        job.channels = channels;
        const int32_t blocks = (h + stripes::BLOCK_ROWS - 1) / stripes::BLOCK_ROWS;
        int32_t n = stripes == 0 ? stripes::count_for(w, h) : stripes;
        if (n > stripes::MAX_STRIPES) n = stripes::MAX_STRIPES;
        if (n > blocks) n = blocks;
        job.n = n;
        // The caller's stripe outputs: grow-only like the filter buffers.
        static thread_local std::vector<uint8_t> outs[stripes::MAX_STRIPES];
        for (int32_t k = 0; k < n; ++k) {
            const int32_t b0 = int32_t(int64_t(blocks) * k / n), b1 = int32_t(int64_t(blocks) * (k + 1) / n);
            job.s[k].y0 = b0 * stripes::BLOCK_ROWS;
            job.s[k].y1 = b1 * stripes::BLOCK_ROWS < h ? b1 * stripes::BLOCK_ROWS : h;
            job.s[k].out = &outs[k];
        }
        // Join stripe k's bits to the stream's and fold in its CRC and adler.
        size_t bits = 0;
        uint32_t adler = 1;
        auto emit = [&](int32_t k) {
            const stripes::Stripe& s = job.s[k];
            stripes::append_bits(zdata, bits, *s.out, s.bits);
            bits += s.bits;
            crc = crc32_cat(crc, s.crc, s.bits);
            adler = k == 0 ? s.adler : adler32_combine_of(adler, s.adler, s.filtered);
        };
        stripes::Pool* pool = n > 1 ? &stripes::pool() : nullptr;
        if (pool != nullptr) pool->submit(job);
        file.open(path, w, h);
        if (pool != nullptr) {
            pool->work(job, emit);
        } else {
            stripes::encode(job, 0);
            emit(0);
        }
        if (bits & 7) {  // the last byte's zero padding
            static const uint8_t zero = 0;
            crc = crc32_cat(crc, crc32_bits(&zero, 8 - (bits & 7)), 8 - (bits & 7));
        }
        uint8_t adler_be[4];
        put_be32(adler_be, adler);
        zdata.insert(zdata.end(), adler_be, adler_be + 4);
        crc = crc32_update(crc, adler_be, 4);
        if (stripe_times != nullptr) {
            for (int32_t k = 0; k < n; ++k) {
                stripe_times[2 * k] = job.s[k].t0;
                stripe_times[2 * k + 1] = job.s[k].t1;
            }
        }
        used = n;
    } else {
        // The library's deflate takes the whole filtered canvas at once.
        file.open(path, w, h);
        static thread_local std::vector<uint8_t> raw;
        raw.resize(size_t(h) * (size_t(w) * 3 + 1));
        filter_rows(px, w, channels, 0, h, 0, raw.data());
#ifdef FASTPNG_USE_LIBDEFLATE
        int lvl = zlevel < 1 ? 1 : (zlevel > 12 ? 12 : zlevel);
        libdeflate_compressor* comp = libdeflate_alloc_compressor(lvl);
        if (comp == nullptr) return -2;
        size_t cap = libdeflate_zlib_compress_bound(comp, raw.size());
        zdata.resize(cap);
        size_t zn = libdeflate_zlib_compress(comp, raw.data(), raw.size(), zdata.data(), cap);
        libdeflate_free_compressor(comp);
        if (zn == 0) return -2;
        zdata.resize(zn);
#else
        uLongf bound = compressBound(uLong(raw.size()));
        zdata.resize(bound);
        if (compress2(zdata.data(), &bound, raw.data(), uLong(raw.size()),
                      zlevel < 1 ? 1 : (zlevel > 9 ? 9 : zlevel)) != Z_OK) {
            return -2;
        }
        zdata.resize(bound);
#endif
        crc = crc32_update(crc, zdata.data(), zdata.size());
    }
    if (!file.opened()) return -3;
    return file.close(zdata, crc) ? used : -4;
}

// ---------------------------------------------------------------------------
// Run-blit tile rasterization (render/tile.resample_indices's hot loop).
//
// The Python side resolves the per-pixel geometry (pixel column -> matrix
// row map, output-row runs and their energy columns -- a few hundred
// float32 ops, kept in numpy so host and device mappings stay bit-equal);
// this kernel does the memory-bound remainder in one pass: gather the
// quantized uint8 index for each pixel column of each distinct run, color
// it through the 257-entry RGBA LUT (entry 256 = background for
// out-of-extent columns), and replicate the colored row over the run's
// output rows, writing straight into the (possibly strided) figure-canvas
// rect.  Replaces three numpy passes (fancy-index gather, LUT gather,
// broadcast stores) and their temporaries.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Cached-text-tile alpha blend (render/text's hot loop).
//
// The compositor pastes ~120 small cached RGBA text tiles per figure with
// Pillow's Image.paste(tile, xy, tile); each call costs ~40 us of PIL
// dispatch for ~3 k blended pixels.  This kernel is the arithmetic twin of
// Pillow's paste_mask_RGBA (src/libImaging/Paste.c): every channel --
// alpha included -- blends as (in1*(255-m) + in2*m + 127) / 255, the
// precise-division BLEND of the installed Pillow (12.x), verified EXACT
// against Image.paste over all 256^3 (mask, canvas, tile) byte triples
// (tests/test_native_blit.py; the legacy approximate MULDIV255 pair
// differs from it on 24.5%% of triples).  m == 0 and m == 255
// short-circuits are exact no-op/copy under that rounding.
// ---------------------------------------------------------------------------

namespace {
inline uint32_t pil_blend(uint32_t in1, uint32_t in2, uint32_t m) {
    return (in1 * (255u - m) + in2 * m + 127u) / 255u;
}
}  // namespace

extern "C" int fastpng_blend_tile(
    uint8_t* canvas,           // RGBA rows, row y at y*canvas_stride
    int64_t canvas_stride,     // bytes between canvas rows
    int32_t H,
    int32_t W,
    const uint8_t* tile,       // th*tw*4 contiguous RGBA
    int32_t tw,
    int32_t th,
    int32_t x0,                // paste origin in canvas coords (may be <0)
    int32_t y0
) {
    if (!canvas || !tile || tw < 0 || th < 0) return -1;
    // Clip exactly as ImagingPaste does: shift the tile window for
    // negative origins, bound the extent by the canvas.
    int32_t sx = 0, sy = 0;
    if (x0 < 0) { sx = -x0; x0 = 0; }
    if (y0 < 0) { sy = -y0; y0 = 0; }
    int32_t bw = tw - sx, bh = th - sy;
    if (bw > W - x0) bw = W - x0;
    if (bh > H - y0) bh = H - y0;
    if (bw <= 0 || bh <= 0) return 0;
    for (int32_t y = 0; y < bh; ++y) {
        uint8_t* out = canvas + size_t(y0 + y) * size_t(canvas_stride) + size_t(x0) * 4;
        const uint8_t* in = tile + (size_t(sy + y) * size_t(tw) + size_t(sx)) * 4;
        for (int32_t x = 0; x < bw; ++x, out += 4, in += 4) {
            uint32_t m = in[3];
            if (m == 0) continue;
            if (m == 255) { std::memcpy(out, in, 4); continue; }
            out[0] = uint8_t(pil_blend(out[0], in[0], m));
            out[1] = uint8_t(pil_blend(out[1], in[1], m));
            out[2] = uint8_t(pil_blend(out[2], in[2], m));
            out[3] = uint8_t(pil_blend(out[3], in[3], m));
        }
    }
    return 0;
}

extern "C" int fastpng_blit_runs(
    const uint8_t* idx,        // quantized indices, element [t, e] at t*idx_row_stride + e
    int64_t idx_row_stride,    // bytes between consecutive t rows
    const int32_t* t_idx,      // (>= ow,) matrix row per output pixel column
    const uint8_t* x_ok,       // (>= ow,) in-extent mask per column (0 -> background)
    const int32_t* sel,        // (n_runs,) energy column per run
    const int32_t* starts,     // (n_runs,) first output row of each run (ascending)
    const int32_t* counts,     // (n_runs,) rows in each run
    int32_t n_runs,
    const uint8_t* lut,        // (257, 4) RGBA
    uint8_t* out,              // output rect, row y at y*out_row_stride
    int64_t out_row_stride,    // bytes between output rows
    int32_t oh,
    int32_t ow
) {
    if (!idx || !t_idx || !x_ok || !sel || !starts || !counts || !lut || !out) return -1;
    if (oh <= 0 || ow <= 0) return 0;
    static thread_local std::vector<uint8_t> rowbuf;
    rowbuf.resize(size_t(ow) * 4);
    uint8_t* rb = rowbuf.data();
    for (int32_t k = 0; k < n_runs; ++k) {
        int32_t s = starts[k];
        if (s >= oh) break;
        int32_t e = s + counts[k];
        if (e > oh) e = oh;
        if (e <= s) continue;
        const int32_t col = sel[k];
        for (int32_t c = 0; c < ow; ++c) {
            const uint32_t gi = x_ok[c] ? idx[size_t(t_idx[c]) * size_t(idx_row_stride) + size_t(col)] : 256u;
            std::memcpy(rb + size_t(c) * 4, lut + size_t(gi) * 4, 4);
        }
        for (int32_t y = s; y < e; ++y)
            std::memcpy(out + size_t(y) * size_t(out_row_stride), rb, size_t(ow) * 4);
    }
    return 0;
}

// Which deflate this build links: 1 libdeflate, 0 zlib, 2 zlib's ABI
// declared above (the Python binding records it in BUILD_INFO).
extern "C" int fastpng_variant() {
#ifdef FASTPNG_USE_LIBDEFLATE
    return 1;
#elif defined(FASTPNG_ZLIB_ABI)
    return 2;
#else
    return 0;
#endif
}
