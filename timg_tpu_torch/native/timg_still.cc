// Native one-shot still pipeline of the port (timg_tpu_torch), a copy of
// timg_tpu/native/timg_still.cc whose one change is deflate: neither
// libdeflate.h nor zlib.h is needed to build it.  Compression resolves at
// run time (dlopen, in png_core.load_libdeflate's order: libdeflate.so.0,
// else libz.so.1), and the chunk CRC-32 is a table here.
//
// Purpose: the interactive case `timg-tpu one-image.png` must not pay
// numpy/PIL/jax imports (SURVEY §7: "batch wins must not regress the
// interactive case"; reference one-shot is 9.5 ms, BASELINE.md #1).
// This file provides numpy-free C implementations of every op on that
// path; each is a bit-exact mirror of the Python/numpy implementation
// it shadows (tests/test_fastpath.py asserts equality), which in turn
// is bit-exact vs the reference:
//
//   timg_png_decode       <-> PIL decode + pil_source._to_rgba
//                             (8-bit, non-interlaced subset; else bail)
//   timg_calc_scale       <-> geometry.calc_scale_to_fit
//                             (ref src/image-source.cc:47-153)
//   timg_build_taps       <-> ops/_resize_weights.build_weights +
//                             ops/resize_np.packed_taps (stb-exact)
//   timg_plan_passes      <-> ops/resize_np.plan_passes
//   timg_alpha_over_bg    <-> ops/cpu_mirror.alpha_compose_background_np
//                             (ref src/framebuffer.cc AlphaComposeBackground)
//   timg_quarter_blocks   <-> ops/cpu_mirror.quarter_blocks_np
//   timg_half_blocks      <-> ops/cpu_mirror.half_blocks_np
//                             (ref src/unicode-block-canvas.cc glyph math)
//   timg_resize_nearest   <-> ops/resize_np.resize_nearest_np
//
// Float discipline: all float32 operation orders copy the numpy
// mirrors exactly; runtime.py builds with -ffp-contract=off so no FMA
// contraction reassociates a mul+add (same reason as the resize
// executor in timg_native.cc).

#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#if defined(__SSE2__)
#include <immintrin.h>
#endif
#if defined(__linux__)
#include <sys/mman.h>
#endif

// First-touch page faults on the multi-MB decode arenas cost ~20 ms on
// a 4K still (measured: ~15k minor faults at ~1.3 us each).
// MADV_POPULATE_WRITE pre-faults the whole range in one syscall --
// same page zeroing, none of the per-fault entry/exit.  (MADV_HUGEPAGE
// was measured WORSE here: defrag=madvise makes the first touch do
// direct compaction, 559 ms on a fragmented host.)  Advisory only;
// ranges are page-truncated inward so any malloc pointer is safe.
static void advise_huge(void *p, size_t len) {
#if defined(__linux__) && defined(MADV_POPULATE_WRITE)
    const uintptr_t kPage = 4096;
    if (len < (8u << 20)) return;  // small arenas: faults are cheap
    uintptr_t a = ((uintptr_t)p + kPage - 1) & ~(kPage - 1);
    uintptr_t end = ((uintptr_t)p + len) & ~(kPage - 1);
    if (end > a) madvise((void *)a, end - a, MADV_POPULATE_WRITE);
#else
    (void)p;
    (void)len;
#endif
}

// =====================================================================
// Deflate, resolved at run time.  The prototypes below are the
// libraries' stable C ABIs (libdeflate's, and zlib 1.x's with its
// z_stream layout), so the build needs neither header.  The PNG decoder
// inflates and the launcher's PNG writer compresses through whichever
// loaded; each process takes one, so a stream never mixes compressors.
// =====================================================================

namespace {

struct ZStream {  // zlib's z_stream (zlib.h), 1.x ABI
    const uint8_t *next_in;
    unsigned avail_in;
    unsigned long total_in;
    uint8_t *next_out;
    unsigned avail_out;
    unsigned long total_out;
    const char *msg;
    void *state;
    void *zalloc;
    void *zfree;
    void *opaque;
    int data_type;
    unsigned long adler;
    unsigned long reserved;
};

struct DeflateLib {
    void *handle = nullptr;
    // libdeflate
    void *(*alloc_decompressor)(void) = nullptr;
    int (*zlib_decompress)(void *, const void *, size_t, void *, size_t,
                           size_t *) = nullptr;
    void (*free_decompressor)(void *) = nullptr;
    void *(*alloc_compressor)(int) = nullptr;
    size_t (*zlib_compress_bound)(void *, size_t) = nullptr;
    size_t (*zlib_compress)(void *, const void *, size_t, void *,
                            size_t) = nullptr;
    void (*free_compressor)(void *) = nullptr;
    // zlib
    const char *(*version)(void) = nullptr;
    int (*inflate_init)(ZStream *, const char *, int) = nullptr;
    int (*inflate)(ZStream *, int) = nullptr;
    int (*inflate_end)(ZStream *) = nullptr;
    unsigned long (*compress_bound)(unsigned long) = nullptr;
    int (*compress2)(uint8_t *, unsigned long *, const uint8_t *,
                     unsigned long, int) = nullptr;
};

template <typename F>
static bool bind_sym(void *h, const char *name, F *fn) {
    *fn = reinterpret_cast<F>(dlsym(h, name));
    return *fn != nullptr;
}

static DeflateLib open_libdeflate() {
    DeflateLib L;
    void *h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!h) return L;
    if (bind_sym(h, "libdeflate_alloc_decompressor", &L.alloc_decompressor) &&
        bind_sym(h, "libdeflate_zlib_decompress", &L.zlib_decompress) &&
        bind_sym(h, "libdeflate_free_decompressor", &L.free_decompressor) &&
        bind_sym(h, "libdeflate_alloc_compressor", &L.alloc_compressor) &&
        bind_sym(h, "libdeflate_zlib_compress_bound",
                 &L.zlib_compress_bound) &&
        bind_sym(h, "libdeflate_zlib_compress", &L.zlib_compress) &&
        bind_sym(h, "libdeflate_free_compressor", &L.free_compressor)) {
        L.handle = h;
    } else {
        dlclose(h);
    }
    return L;
}

static DeflateLib open_zlib() {
    DeflateLib L;
    void *h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) return L;
    if (bind_sym(h, "zlibVersion", &L.version) &&
        bind_sym(h, "inflateInit_", &L.inflate_init) &&
        bind_sym(h, "inflate", &L.inflate) &&
        bind_sym(h, "inflateEnd", &L.inflate_end) &&
        bind_sym(h, "compressBound", &L.compress_bound) &&
        bind_sym(h, "compress2", &L.compress2)) {
        L.handle = h;
    } else {
        dlclose(h);
    }
    return L;
}

enum { DEFLATE_NONE = 0, DEFLATE_LIBDEFLATE = 1, DEFLATE_ZLIB = 2 };

static const DeflateLib &libdeflate_lib() {
    static const DeflateLib lib = open_libdeflate();  // once, thread-safe
    return lib;
}

static const DeflateLib &zlib_lib() {
    static const DeflateLib lib = open_zlib();
    return lib;
}

// The library in use: -1 until the first call resolves it.
static int g_deflate = -1;

static int deflate_kind() {
    if (g_deflate < 0) {
        g_deflate = libdeflate_lib().handle ? DEFLATE_LIBDEFLATE
                    : zlib_lib().handle     ? DEFLATE_ZLIB
                                            : DEFLATE_NONE;
    }
    return g_deflate;
}

static uint32_t crc_table[256];

static void crc_init() {
    for (uint32_t n = 0; n < 256; ++n) {
        uint32_t c = n;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
}

}  // namespace

extern "C" {

void timg_buf_free(void *p) { free(p); }

// Select the deflate library: 0 as resolved (libdeflate.so.0, else
// libz.so.1), 1 libdeflate, 2 zlib.  Returns the library then in use
// (1 or 2), or 0 when the one asked for does not load.
int timg_deflate_use(int which) {
    if (which == DEFLATE_LIBDEFLATE)
        g_deflate = libdeflate_lib().handle ? DEFLATE_LIBDEFLATE
                                            : DEFLATE_NONE;
    else if (which == DEFLATE_ZLIB)
        g_deflate = zlib_lib().handle ? DEFLATE_ZLIB : DEFLATE_NONE;
    else
        g_deflate = -1;
    return deflate_kind();
}

// The soname of the library in use, or "" when neither loads.
const char *timg_deflate_name(void) {
    switch (deflate_kind()) {
        case DEFLATE_LIBDEFLATE: return "libdeflate.so.0";
        case DEFLATE_ZLIB: return "libz.so.1";
        default: return "";
    }
}

// CRC-32 (ISO-HDLC, the PNG chunk CRC) continued from ``crc``.
uint32_t timg_crc32(uint32_t crc, const uint8_t *p, long n) {
    static const bool ready = (crc_init(), true);
    (void)ready;
    crc = ~crc;
    for (long i = 0; i < n; ++i)
        crc = crc_table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// Inflate one zlib stream into exactly ``cap`` bytes: 0 on success, 1
// when the stream is bad or its length is not ``cap``, 2 when no
// deflate library loads.
int timg_zlib_inflate(const uint8_t *src, long n, uint8_t *dst, long cap) {
    const int kind = deflate_kind();
    if (kind == DEFLATE_LIBDEFLATE) {
        const DeflateLib &L = libdeflate_lib();
        void *d = L.alloc_decompressor();
        if (!d) return 1;
        size_t actual = 0;
        const int r = L.zlib_decompress(d, src, (size_t)n, dst, (size_t)cap,
                                        &actual);
        L.free_decompressor(d);
        return (r == 0 && actual == (size_t)cap) ? 0 : 1;  // 0: SUCCESS
    }
    if (kind == DEFLATE_ZLIB) {
        const DeflateLib &L = zlib_lib();
        ZStream z;
        memset(&z, 0, sizeof(z));
        if (L.inflate_init(&z, L.version(), (int)sizeof(ZStream)) != 0)
            return 1;
        // one call; avail_* are 32-bit, so hand the stream over in parts
        int r = 0;  // Z_OK
        long in_left = n, out_left = cap;
        z.next_in = src;
        z.next_out = dst;
        while (r == 0) {
            if (z.avail_in == 0 && in_left > 0) {
                z.avail_in = (unsigned)(in_left < (1L << 30) ? in_left
                                                             : (1L << 30));
                in_left -= z.avail_in;
            }
            if (z.avail_out == 0 && out_left > 0) {
                z.avail_out = (unsigned)(out_left < (1L << 30) ? out_left
                                                               : (1L << 30));
                out_left -= z.avail_out;
            }
            const unsigned before_in = z.avail_in, before_out = z.avail_out;
            r = L.inflate(&z, 0);  // Z_NO_FLUSH
            if (r == 0 && z.avail_in == before_in &&
                z.avail_out == before_out)
                break;  // no progress: input ended early or output full
        }
        const bool ok = (r == 1 /* Z_STREAM_END */) &&
                        z.total_out == (unsigned long)cap;
        L.inflate_end(&z);
        return ok ? 0 : 1;
    }
    return 2;
}

// Compress ``n`` bytes into a zlib stream at ``level``, as
// png_core.zlib_compress does: libdeflate when it is the library in use
// (falling through where it refuses the level), else zlib's compress2
// at the level clamped to 0..9 -- the bytes of Python's
// zlib.compress(data, level), which calls deflateInit with the same
// window bits, memory level and strategy.  *out is malloc'd (free it
// with timg_buf_free); returns its length, or -1.
long timg_zlib_compress(const uint8_t *src, long n, int level,
                        uint8_t **out) {
    *out = nullptr;
    const int kind = deflate_kind();
    if (kind == DEFLATE_LIBDEFLATE) {
        const DeflateLib &L = libdeflate_lib();
        void *c = L.alloc_compressor(level);
        if (c) {
            const size_t bound = L.zlib_compress_bound(c, (size_t)n);
            uint8_t *buf = (uint8_t *)malloc(bound ? bound : 1);
            size_t got = buf ? L.zlib_compress(c, src, (size_t)n, buf, bound)
                             : 0;
            L.free_compressor(c);
            if (got) {
                *out = buf;
                return (long)got;
            }
            free(buf);
        }
    }
    const DeflateLib &Z = zlib_lib();
    if (!Z.handle) return -1;
    unsigned long cap = Z.compress_bound((unsigned long)n);
    uint8_t *buf = (uint8_t *)malloc(cap ? cap : 1);
    if (!buf) return -1;
    const int lvl = level < 0 ? 0 : level > 9 ? 9 : level;
    if (Z.compress2(buf, &cap, src, (unsigned long)n, lvl) != 0) {
        free(buf);
        return -1;
    }
    *out = buf;
    return (long)cap;
}

// =====================================================================
// PNG decode (mirrors PIL convert("RGBA") semantics for the gated
// subset: bit depth 8, color types 0/2/3/4/6, interlace 0).
//
// Deliberate PIL-matching quirks:
//  * tRNS on color type 0/2 is IGNORED (PIL convert("RGBA") from
//    L/RGB mode does not apply the transparency info);
//  * tRNS on color type 3 (palette) IS applied;
//  * chunk CRCs are verified (Pillow verifies them and errors out; a
//    CRC mismatch here returns nonzero so the caller falls back to
//    the PIL path for identical user-visible behavior).
// Flags out: bit0 = acTL seen (APNG; caller must bail to the video
// path), bit1 = eXIf seen (caller bails when EXIF rotation is on).
// =====================================================================

static uint32_t be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// Parse + inflate + unfilter: produces the raw scanline arena (rows at
// (w*bpp+1)-byte pitch, pixel bytes at +1 past the filter byte) and
// the header/palette state.  Shared by the RGBA-expanding decode below
// and the fused decode->resize path (timg_png_decode_raw), which feeds
// these scanlines straight into the resize executor.
static long png_decode_core(const uint8_t *buf, long len, uint8_t **out_raw,
                            int *out_w, int *out_h, int *out_color,
                            int *out_flags, uint8_t palette[256][3],
                            uint8_t pal_alpha[256]) {
    static const uint8_t SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                   '\n'};
    *out_raw = NULL;
    *out_flags = 0;
    if (len < 8 + 25 || memcmp(buf, SIG, 8) != 0) return 1;

    long pos = 8;
    int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
    int have_ihdr = 0, have_plte = 0, have_trns = 0;
    memset(palette, 0, 256 * 3);  // PIL zero-fills short palettes
    memset(pal_alpha, 255, 256);
    uint8_t *idat = NULL;
    size_t idat_len = 0, idat_cap = 0;

    while (pos + 12 <= len) {
        uint32_t clen = be32(buf + pos);
        const uint8_t *ctype = buf + pos + 4;
        if (pos + 12 + (long)clen > len) {
            free(idat);
            return 2;  // truncated chunk
        }
        const uint8_t *data = buf + pos + 8;
        // Verify CRC on every chunk (strictly safer than Pillow, which
        // verifies the chunks it reads): mismatch -> caller falls back.
        uint32_t crc = timg_crc32(0, ctype, 4 + clen);
        if (crc != be32(data + clen)) {
            free(idat);
            return 3;
        }
        if (memcmp(ctype, "IHDR", 4) == 0) {
            if (clen != 13) { free(idat); return 4; }
            w = (int)be32(data);
            h = (int)be32(data + 4);
            depth = data[8];
            color = data[9];
            interlace = data[12];
            have_ihdr = 1;
            if (w <= 0 || h <= 0 || depth != 8 || interlace != 0 ||
                (color != 0 && color != 2 && color != 3 && color != 4 &&
                 color != 6)) {
                free(idat);
                return 5;  // outside the gated subset
            }
            if ((long)w * h > (1L << 30)) { free(idat); return 5; }
        } else if (memcmp(ctype, "PLTE", 4) == 0) {
            if (clen % 3 != 0 || clen > 256 * 3) { free(idat); return 6; }
            for (uint32_t i = 0; i < clen / 3; ++i) {
                palette[i][0] = data[i * 3];
                palette[i][1] = data[i * 3 + 1];
                palette[i][2] = data[i * 3 + 2];
            }
            have_plte = 1;
        } else if (memcmp(ctype, "tRNS", 4) == 0) {
            if (color == 3) {
                if (clen > 256) { free(idat); return 6; }
                for (uint32_t i = 0; i < clen; ++i) pal_alpha[i] = data[i];
                have_trns = 1;
            }
            // color 0/2: PIL convert("RGBA") ignores it; so do we.
        } else if (memcmp(ctype, "IDAT", 4) == 0) {
            if (idat_len + clen > idat_cap) {
                size_t ncap = (idat_cap ? idat_cap * 2 : 65536);
                while (ncap < idat_len + clen) ncap *= 2;
                uint8_t *n = (uint8_t *)realloc(idat, ncap);
                if (!n) { free(idat); return 7; }
                idat = n;
                idat_cap = ncap;
            }
            memcpy(idat + idat_len, data, clen);
            idat_len += clen;
        } else if (memcmp(ctype, "acTL", 4) == 0) {
            *out_flags |= 1;  // APNG
        } else if (memcmp(ctype, "eXIf", 4) == 0) {
            *out_flags |= 2;
        } else if (memcmp(ctype, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + clen;
    }
    if (!have_ihdr || !idat) { free(idat); return 8; }
    (void)have_trns;

    static const int CH_IN[7] = {1, 0, 3, 1, 2, 0, 4};
    const int ch_in = CH_IN[color];
    const size_t stride = (size_t)w * ch_in;
    const size_t raw_len = (stride + 1) * h;
    uint8_t *raw = (uint8_t *)malloc(raw_len);
    if (!raw) { free(idat); return 7; }
    advise_huge(raw, raw_len);

    const int r = timg_zlib_inflate(idat, (long)idat_len, raw, (long)raw_len);
    free(idat);
    if (r != 0) {
        free(raw);
        return r == 2 ? 11 : 9;  // 11: no deflate library loads
    }

    // Unfilter in place (scanline = filter byte + stride bytes).
    const int bpp = ch_in;
    for (int y = 0; y < h; ++y) {
        uint8_t *row = raw + (size_t)y * (stride + 1);
        const uint8_t ft = row[0];
        uint8_t *cur = row + 1;
        const uint8_t *up = (y > 0) ? cur - (stride + 1) : NULL;
        switch (ft) {
            case 0:
                break;
            case 1:  // Sub
                for (size_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
                break;
            case 2:  // Up
                if (up) {
                    // Byte adds wrap exactly in SIMD lanes; Up is the
                    // dominant filter on photographic rows and the
                    // scalar loop can't auto-vectorize (cur/up alias
                    // the same arena for the compiler).
                    size_t i = 0;
#if defined(__SSE2__)
                    for (; i + 16 <= stride; i += 16) {
                        __m128i a = _mm_loadu_si128((const __m128i *)(cur + i));
                        __m128i b = _mm_loadu_si128((const __m128i *)(up + i));
                        _mm_storeu_si128((__m128i *)(cur + i),
                                         _mm_add_epi8(a, b));
                    }
#endif
                    for (; i < stride; ++i) cur[i] += up[i];
                }
                break;
            case 3:  // Average
                for (size_t i = 0; i < stride; ++i) {
                    int a = (i >= (size_t)bpp) ? cur[i - bpp] : 0;
                    int b = up ? up[i] : 0;
                    cur[i] += (uint8_t)((a + b) >> 1);
                }
                break;
            case 4:  // Paeth
                for (size_t i = 0; i < stride; ++i) {
                    int a = (i >= (size_t)bpp) ? cur[i - bpp] : 0;
                    int b = up ? up[i] : 0;
                    int c = (up && i >= (size_t)bpp) ? up[i - bpp] : 0;
                    cur[i] += paeth(a, b, c);
                }
                break;
            default:
                free(raw);
                return 10;
        }
    }

    (void)have_plte;
    *out_raw = raw;
    *out_w = w;
    *out_h = h;
    *out_color = color;
    return 0;
}

long timg_png_decode(const uint8_t *buf, long len, uint8_t **out_rgba,
                     int *out_w, int *out_h, int *out_flags) {
    uint8_t palette[256][3];
    uint8_t pal_alpha[256];
    uint8_t *raw = NULL;
    int w = 0, h = 0, color = 0;
    *out_rgba = NULL;
    long rc = png_decode_core(buf, len, &raw, &w, &h, &color, out_flags,
                              palette, pal_alpha);
    if (rc != 0) return rc;
    static const int CH_IN[7] = {1, 0, 3, 1, 2, 0, 4};
    const int ch_in = CH_IN[color];
    const size_t stride = (size_t)w * ch_in;

    uint8_t *out = (uint8_t *)malloc((size_t)w * h * 4);
    if (!out) { free(raw); return 7; }
    advise_huge(out, (size_t)w * h * 4);
    for (int y = 0; y < h; ++y) {
        const uint8_t *src = raw + (size_t)y * (stride + 1) + 1;
        uint8_t *dst = out + (size_t)y * w * 4;
        switch (color) {
            case 0:  // gray
                for (int x = 0; x < w; ++x) {
                    const uint8_t g = src[x];
                    dst[x * 4] = g; dst[x * 4 + 1] = g;
                    dst[x * 4 + 2] = g; dst[x * 4 + 3] = 255;
                }
                break;
            case 2: {  // rgb
                int x = 0;
#if defined(__SSSE3__)
                // 4 px / 16 bytes per shuffle; the load reads 16 bytes
                // from a 12-byte group, safe while a full extra pixel
                // remains in the scanline (plus its filter byte).
                const __m128i shuf = _mm_setr_epi8(
                    0, 1, 2, (char)0x80, 3, 4, 5, (char)0x80,
                    6, 7, 8, (char)0x80, 9, 10, 11, (char)0x80);
                const __m128i alpha = _mm_set1_epi32((int)0xff000000u);
                for (; x + 6 <= w; x += 4) {
                    __m128i v = _mm_loadu_si128(
                        (const __m128i *)(src + (size_t)x * 3));
                    v = _mm_or_si128(_mm_shuffle_epi8(v, shuf), alpha);
                    _mm_storeu_si128((__m128i *)(dst + (size_t)x * 4), v);
                }
#endif
                for (; x < w; ++x) {
                    dst[x * 4] = src[x * 3];
                    dst[x * 4 + 1] = src[x * 3 + 1];
                    dst[x * 4 + 2] = src[x * 3 + 2];
                    dst[x * 4 + 3] = 255;
                }
                break;
            }
            case 3:  // palette (requires PLTE per spec; zeros otherwise)
                for (int x = 0; x < w; ++x) {
                    const uint8_t i = src[x];
                    dst[x * 4] = palette[i][0];
                    dst[x * 4 + 1] = palette[i][1];
                    dst[x * 4 + 2] = palette[i][2];
                    dst[x * 4 + 3] = pal_alpha[i];
                }
                break;
            case 4:  // gray + alpha
                for (int x = 0; x < w; ++x) {
                    const uint8_t g = src[x * 2];
                    dst[x * 4] = g; dst[x * 4 + 1] = g;
                    dst[x * 4 + 2] = g; dst[x * 4 + 3] = src[x * 2 + 1];
                }
                break;
            case 6:  // rgba
                memcpy(dst, src, (size_t)w * 4);
                break;
        }
    }
    free(raw);
    *out_rgba = out;
    *out_w = w;
    *out_h = h;
    return 0;
}

// Fusion entry: decode to the raw unfiltered scanline arena WITHOUT
// materializing the RGBA plane (33 MB of page-zeroing + write + reread
// on a 4K still, ~15 ms of the one-shot).  Rows live at
// (w*bpp+1)-byte pitch with pixel bytes at +1; *out_color is the PNG
// color type.  Gated to color types 2 (RGB) and 6 (RGBA) -- the types
// whose scanlines the resize executor can consume directly
// (timg_resize_polyphase_src); anything else returns >0 and the
// caller uses timg_png_decode.  Free the arena with timg_buf_free.
long timg_png_decode_raw(const uint8_t *buf, long len, uint8_t **out_raw,
                         int *out_w, int *out_h, int *out_color,
                         int *out_flags) {
    uint8_t palette[256][3];
    uint8_t pal_alpha[256];
    *out_raw = NULL;
    long rc = png_decode_core(buf, len, out_raw, out_w, out_h, out_color,
                              out_flags, palette, pal_alpha);
    if (rc != 0) return rc;
    if (*out_color != 2 && *out_color != 6) {
        free(*out_raw);
        *out_raw = NULL;
        return 11;  // raw consumers only handle direct RGB/RGBA rows
    }
    return 0;
}

// =====================================================================
// Scale-to-fit geometry: mirror of geometry.calc_scale_to_fit, which
// mirrors ref src/image-source.cc:47-153 (C float semantics).
// =====================================================================

static const double kMaxStretch = 5.0;  // kMaxAcceptFactor

static double roundf_mirror(float x) {
    // geometry._roundf: C roundf semantics, round half away from zero.
    double d = (double)x;
    return (x >= 0) ? floor(d + 0.5) : ceil(d - 0.5);
}

int timg_calc_scale(int img_width, int img_height, int width, int height,
                    int fill_width, int fill_height, double width_stretch_d,
                    int upscale, int upscale_integer, int cell_x_px,
                    int cell_y_px, int fit_in_rotated, int *out_w,
                    int *out_h) {
    float width_stretch = (float)width_stretch_d;
    if (fit_in_rotated) {
        int t = width; width = height; height = t;
        t = fill_width; fill_width = fill_height; fill_height = t;
        width_stretch = 1.0f / (float)width_stretch_d;
    }
    if (width_stretch > kMaxStretch) width_stretch = (float)kMaxStretch;
    if (width_stretch < 1.0 / kMaxStretch)
        width_stretch = (float)(1.0 / kMaxStretch);

    if (width_stretch > 1.0) {
        width = (int)((float)width / width_stretch);
    } else {
        height = (int)((float)height * width_stretch);
    }

    const float width_fraction = (float)width / (float)img_width;
    const float height_fraction = (float)height / (float)img_height;

    if (!upscale && (fill_height || width_fraction > 1.0) &&
        (fill_width || height_fraction > 1.0)) {
        if (cell_x_px == 2) {
            *out_w = img_width * 2;
            *out_h = img_height;
            return 1;
        }
        *out_w = img_width;
        *out_h = img_height;
        return 0;
    }

    int target_width = width;
    int target_height = height;
    if (fill_width && fill_height) {
        const float larger =
            width_fraction > height_fraction ? width_fraction : height_fraction;
        target_width = (int)roundf_mirror(larger * (float)img_width);
        target_height = (int)roundf_mirror(larger * (float)img_height);
    } else if (fill_height) {
        target_width = (int)roundf_mirror(height_fraction * (float)img_width);
    } else if (fill_width) {
        target_height = (int)roundf_mirror(width_fraction * (float)img_height);
    } else {
        const float smaller =
            width_fraction < height_fraction ? width_fraction : height_fraction;
        target_width = (int)roundf_mirror(smaller * (float)img_width);
        target_height = (int)roundf_mirror(smaller * (float)img_height);
    }

    if (width_stretch > 1.0) {
        target_width = (int)((float)target_width * width_stretch);
    } else {
        target_height = (int)((float)target_height / width_stretch);
    }

    if (0 < cell_x_px && cell_x_px <= 2 && 0 < cell_y_px && cell_y_px <= 2) {
        target_width = target_width / cell_x_px * cell_x_px;
        target_height = target_height / cell_y_px * cell_y_px;
    }
    if (target_width <= 0) target_width = 1;
    if (target_height <= 0) target_height = 1;

    if (upscale_integer && target_width > img_width &&
        target_height > img_height) {
        const float aspect_correct = (cell_x_px == 2) ? 2.0f : 1.0f;
        const float wf =
            1.0f * (float)target_width / aspect_correct / (float)img_width;
        const float hf = 1.0f * (float)target_height / (float)img_height;
        const float smaller_factor = wf < hf ? wf : hf;
        if (smaller_factor > 1.0) {
            const float fl = (float)floor((double)smaller_factor);
            target_width = (int)(aspect_correct * fl * (float)img_width);
            target_height = (int)(fl * (float)img_height);
        }
    }
    *out_w = target_width;
    *out_h = target_height;
    return target_width != img_width || target_height != img_height;
}

// =====================================================================
// Tap-weight construction: mirror of _resize_weights.build_weights +
// resize_np.packed_taps / plan_passes (stb_image_resize2-exact; see
// those modules for the stb:line citations).
// =====================================================================

static const double kSmall = (double)0x1p-120f;  // stbir__small_float
static const float kSmallF = 0x1p-120f;

// Filter kernels: f32 op order copied from resize_np._filter_*.
static float filter_box(float x, float scale) {
    x = fabsf(x);
    const float halfscale = scale / 2;
    const float t = 0.5f + halfscale;
    const float r = 0.5f - halfscale;
    if (x <= r) return 1.0f;
    if (x >= t) return 0.0f;
    return (t - x) / scale;
}

static float filter_mitchell(float x, float scale) {
    (void)scale;
    x = fabsf(x);
    if (x < 1.0) {
        return (16.0f + x * x * (21.0f * x - 36.0f)) / 18.0f;
    }
    if (x < 2.0) {
        return (32.0f + x * (-60.0f + x * (36.0f - 7.0f * x))) / 18.0f;
    }
    return 0.0f;
}

// support(scale): box = 0.5 + s/2 (double), mitchell = 2.0.
static double support_box(double s) { return 0.5 + s / 2.0; }
static double support_mitchell(double s) { (void)s; return 2.0; }

// stbir__double_to_rational mirror (_resize_weights.double_to_rational).
static int double_to_rational(double f, long limit, int limit_denom,
                              long *numer, long *denom) {
    long top = (long)(f * (double)(1 << 25));
    long bot = 1L << 25;
    long numer_last = 0, denom_last = 1;
    long numer_est = 1, denom_est = 0;
    for (;;) {
        if ((limit_denom ? denom_est : numer_est) >= limit) break;
        if (denom_est) {
            double err = fabs((double)numer_est / (double)denom_est - f);
            if (err < 1.0 / (double)(1 << 24)) {
                *numer = numer_est;
                *denom = denom_est;
                return 1;
            }
        }
        if (bot == 0) break;
        long est = top / bot;
        long temp = top % bot;
        top = bot;
        bot = temp;
        long nd = est * denom_est + denom_last;
        denom_last = denom_est;
        denom_est = nd;
        long nn = est * numer_est + numer_last;
        numer_last = numer_est;
        numer_est = nn;
    }
    if (limit_denom) {
        numer_est = (long)(f * (double)limit + 0.5);
        denom_est = limit;
    } else {
        numer_est = limit;
        denom_est = (long)((double)limit / f + 0.5);
    }
    double err = denom_est ? fabs((double)numer_est / (double)denom_est - f)
                           : 1.0;
    *numer = numer_est;
    *denom = denom_est;
    return err < 1.0 / (double)(1 << 24);
}

typedef struct {
    int idx;
    float c;
} Tap;

typedef struct {
    Tap *taps;
    int count;
    int cap;
} TapRow;

static void row_push(TapRow *r, int idx, float c) {
    if (r->count == r->cap) {
        r->cap = r->cap ? r->cap * 2 : 8;
        r->taps = (Tap *)realloc(r->taps, r->cap * sizeof(Tap));
    }
    r->taps[r->count].idx = idx;
    r->taps[r->count].c = c;
    r->count++;
}

// Dense [out_size, in_size] f32 tap matrix (build_weights mirror).
// filter_sel: 0 = stb default pair (box upsample / mitchell downsample).
static float *build_weights_c(int in_size, int out_size) {
    const double scale_double = (double)out_size / (double)in_size;
    const float scale = (float)scale_double;
    const float inv_scale = (float)(1.0 / scale_double);
    const int upsample = ((double)scale >= (1.0 - kSmall));

    float (*kernel)(float, float) = upsample ? filter_box : filter_mitchell;
    double (*support_fn)(double) = upsample ? support_box : support_mitchell;

    long numerator = 0, denominator = 0;
    const int is_rational = double_to_rational(
        scale_double, scale_double <= 1.0 ? out_size : in_size,
        scale_double >= 1.0, &numerator, &denominator);
    const int polyphase = is_rational && numerator < out_size;
    const int phase_count = polyphase ? (int)numerator : out_size;

    TapRow *rows = (TapRow *)calloc(out_size, sizeof(TapRow));

    if (upsample) {
        const float support = (float)support_fn((double)inv_scale);
        const float out_radius = support * scale;
        for (int o = 0; o < phase_count; ++o) {
            const float oc = (float)o + 0.5f;
            const float in_center_of_out = oc * inv_scale;
            int lo = (int)floor((double)((oc - out_radius) * inv_scale) + 0.5);
            int hi = (int)floor((double)((oc + out_radius) * inv_scale) - 0.5);
            if (hi < lo) hi = lo;
            int leading = 1;
            for (int i = lo; i <= hi; ++i) {
                const float x = in_center_of_out - ((float)i + 0.5f);
                float c = kernel(x, inv_scale);
                if (fabs((double)c) < kSmall) {
                    if (leading) continue;  // eat leading zeros
                    c = 0.0f;
                } else {
                    leading = 0;
                }
                row_push(&rows[o], i, c);
            }
            while (rows[o].count && rows[o].taps[rows[o].count - 1].c == 0.0f)
                rows[o].count--;
        }
    } else {
        const float support = (float)support_fn((double)scale);
        const float in_radius = support * inv_scale;
        const int margin =
            (int)ceil((double)support * 2.0 / (double)scale);
        for (int i = -margin; i < in_size + margin; ++i) {
            const float ic = (float)i + 0.5f;
            const float out_center_of_in = ic * scale;
            int out_first =
                (int)floor((double)((ic - in_radius) * scale) + 0.5);
            int out_last =
                (int)floor((double)((ic + in_radius) * scale) - 0.5);
            if (out_first < 0) out_first = 0;
            if (out_last > out_size - 1) out_last = out_size - 1;
            if (polyphase) {
                if (out_first >= numerator) break;
                if (out_last > numerator - 1) out_last = (int)numerator - 1;
            }
            for (int o = out_first; o <= out_last; ++o) {
                const float x = ((float)o + 0.5f) - out_center_of_in;
                float c = kernel(x, scale) * scale;
                if (fabs((double)c) < kSmall) c = 0.0f;
                row_push(&rows[o], i, c);
            }
        }
    }

    // Renormalize (double accumulation over f32 coeffs, in order).
    for (int o = 0; o < phase_count; ++o) {
        double total = 0.0;
        for (int t = 0; t < rows[o].count; ++t)
            total = total + (double)rows[o].taps[t].c;
        if (fabs(total) < kSmall) {
            rows[o].count = 0;
        } else if (total < (1.0 - kSmall) || total > (1.0 + kSmall)) {
            const double inv_total = 1.0 / total;
            for (int t = 0; t < rows[o].count; ++t)
                rows[o].taps[t].c =
                    (float)((double)rows[o].taps[t].c * inv_total);
        }
    }

    if (polyphase) {  // replicate phases with shifted indices
        for (int o = (int)numerator; o < out_size; ++o) {
            const TapRow *srcr = &rows[o - numerator];
            for (int t = 0; t < srcr->count; ++t)
                row_push(&rows[o], srcr->taps[t].idx + (int)denominator,
                         srcr->taps[t].c);
        }
    }

    // EDGE_CLAMP fold into the dense matrix: in-range stores first,
    // then out-of-range-right ascending f32-added at in_size-1, then
    // out-of-range-left with i descending (-1, -2, ...) f32-added at 0.
    float *w = (float *)calloc((size_t)out_size * in_size, sizeof(float));
    for (int o = 0; o < out_size; ++o) {
        float *wo = w + (size_t)o * in_size;
        for (int t = 0; t < rows[o].count; ++t) {
            const int i = rows[o].taps[t].idx;
            if (0 <= i && i < in_size) wo[i] = rows[o].taps[t].c;
        }
        for (int t = 0; t < rows[o].count; ++t) {  // right, ascending i
            const int i = rows[o].taps[t].idx;
            if (i >= in_size) wo[in_size - 1] = wo[in_size - 1] +
                                                rows[o].taps[t].c;
        }
        // left, descending i: taps were appended in ascending i order,
        // so iterate the stored list backwards.
        for (int t = rows[o].count - 1; t >= 0; --t) {
            const int i = rows[o].taps[t].idx;
            if (i < 0) wo[0] = wo[0] + rows[o].taps[t].c;
        }
        free(rows[o].taps);
    }
    free(rows);
    return w;
}

// packed_taps mirror: banded (starts[out] i32, coeffs[out*widest] f32).
// Returns widest (>=1), or -1 on alloc failure. Caller frees both
// arrays with timg_buf_free.
int timg_build_taps(int in_size, int out_size, int horizontal,
                    int32_t **starts_out, float **coeffs_out) {
    float *w = build_weights_c(in_size, out_size);
    if (!w) return -1;
    long *n0s = (long *)calloc(out_size, sizeof(long));
    long *n1s = (long *)calloc(out_size, sizeof(long));
    int widest = 1;
    for (int o = 0; o < out_size; ++o) {
        const float *wo = w + (size_t)o * in_size;
        long first = -1, last = -1;
        for (int i = 0; i < in_size; ++i) {
            if (wo[i] != 0.0f) {
                if (first < 0) first = i;
                last = i;
            }
        }
        n0s[o] = first < 0 ? 0 : first;
        n1s[o] = last < 0 ? 0 : last;
        if ((int)(n1s[o] - n0s[o] + 1) > widest)
            widest = (int)(n1s[o] - n0s[o] + 1);
    }

    if (horizontal) {  // stbir__pack_coefficients right-edge repack
        const int mod = widest & 3;
        for (int o = 0; o < out_size; ++o) {
            const int count = (int)(n1s[o] - n0s[o] + 1);
            int stop_range;
            if (widest > 12) {
                stop_range = ((count - mod + 3) & ~3) + mod;
                if (stop_range < 8 + mod) stop_range = 8 + mod;
            } else {
                stop_range = widest;
            }
            if (n0s[o] + stop_range > in_size) {
                n0s[o] = in_size - stop_range;
                if (n0s[o] < 0) n0s[o] = 0;
            }
        }
    }

    const long start_cap = in_size - widest > 0 ? in_size - widest : 0;
    int32_t *starts = (int32_t *)malloc(out_size * sizeof(int32_t));
    float *coeffs =
        (float *)calloc((size_t)out_size * widest, sizeof(float));
    for (int o = 0; o < out_size; ++o) {
        const long s = n0s[o] < start_cap ? n0s[o] : start_cap;
        starts[o] = (int32_t)s;
        const float *wo = w + (size_t)o * in_size;
        const int span = (int)(in_size - s < widest ? in_size - s : widest);
        for (int t = 0; t < span; ++t) coeffs[(size_t)o * widest + t] =
            wo[s + t];
    }
    free(w);
    free(n0s);
    free(n1s);
    *starts_out = starts;
    *coeffs_out = coeffs;
    return widest;
}

// plan_passes mirror: 1 = vertical-first.
static int filter_pixel_width_c(int in_size, int out_size) {
    const double scale = (double)((float)out_size / (float)in_size);
    if (scale >= 1.0 - kSmall)
        return (int)ceil(support_box(1.0 / scale) * 2.0);
    return (int)ceil(support_mitchell(scale) * 2.0 / scale);
}

static const float COSTS4[8][4] = {
    {0.00000f, 0.50000f, 0.00000f, 0.71875f},
    {0.06250f, 0.84375f, 0.00000f, 0.87500f},
    {1.00000f, 0.50000f, 0.50000f, 0.96875f},
    {1.00000f, 0.09375f, 0.31250f, 0.50000f},
    {1.00000f, 1.00000f, 1.00000f, 1.00000f},
    {1.00000f, 0.03125f, 0.03125f, 0.53125f},
    {0.18750f, 0.12500f, 0.00000f, 1.00000f},
    {0.00000f, 1.00000f, 0.03125f, 0.18750f},
};
static const float COSTS7[8][4] = {
    {0.00000f, 0.59375f, 0.00000f, 0.96875f},
    {0.06250f, 0.81250f, 0.06250f, 0.59375f},
    {0.75000f, 0.43750f, 0.12500f, 0.96875f},
    {0.87500f, 0.06250f, 0.18750f, 0.43750f},
    {1.00000f, 1.00000f, 1.00000f, 1.00000f},
    {0.15625f, 0.12500f, 1.00000f, 1.00000f},
    {0.06250f, 0.12500f, 0.00000f, 1.00000f},
    {0.00000f, 1.00000f, 0.03125f, 0.34375f},
};

int timg_plan_passes(int in_h, int in_w, int out_h, int out_w,
                     int alpha_weighted) {
    const double h_scale = (double)((float)out_w / (float)in_w);
    const double v_scale = (double)((float)out_h / (float)in_h);
    const int h_fpw = filter_pixel_width_c(in_w, out_w);
    const int v_fpw = filter_pixel_width_c(in_h, out_h);
    const int v_is_gather = (v_scale >= 1.0 - kSmall || v_fpw <= 32);
    const int v_out = out_h, h_out = out_w;

    int classification;
    if (v_out <= 4 || h_out <= 4)
        classification = (v_out < h_out) ? 6 : 7;
    else if (v_scale <= 1.0)
        classification = v_is_gather ? 1 : 0;
    else if (v_scale <= 2.0)
        classification = 2;
    else if (v_scale <= 3.0)
        classification = 3;
    else if (v_scale <= 4.0)
        classification = 5;
    else
        classification = 6;

    const float *w = alpha_weighted ? COSTS7[classification]
                                    : COSTS4[classification];
    const float h_cost =
        (float)h_fpw * w[0] + (float)h_scale * (float)v_fpw * w[1];
    const float v_cost =
        (float)v_fpw * w[2] + (float)v_scale * (float)h_fpw * w[3];
    return v_cost <= h_cost;
}

// =====================================================================
// Alpha composition over background (+ optional checkerboard pattern):
// in-place mirror of cpu_mirror.alpha_compose_background_np.
// =====================================================================

long timg_has_translucency(const uint8_t *rgba, long npixels) {
    for (long i = 0; i < npixels; ++i)
        if (rgba[i * 4 + 3] != 255) return 1;
    return 0;
}

void timg_alpha_over_bg(uint8_t *frame, int h, int w, const uint8_t *bg4,
                        const uint8_t *pat4, int pattern_w, int pattern_h,
                        int start_row) {
    const int use_pattern =
        (pat4[3] != 0 &&
         (pat4[0] != bg4[0] || pat4[1] != bg4[1] || pat4[2] != bg4[2] ||
          pat4[3] != bg4[3]) &&
         pattern_w > 0 && pattern_h > 0);
    const int pw = pattern_w > 0 ? pattern_w : 1;
    const int ph = pattern_h > 0 ? pattern_h : 1;
    const int bg_active = bg4[3] != 0;

    float bg_lin[3], pat_lin[3];
    for (int c = 0; c < 3; ++c) {
        const float fb = (float)bg4[c];
        bg_lin[c] = fb * fb;
        const float fp = (float)pat4[c];
        pat_lin[c] = fp * fp;
    }

    for (int y = 0; y < h; ++y) {
        uint8_t *row = frame + (size_t)y * w * 4;
        const int row_active = y >= start_row;
        for (int x = 0; x < w; ++x) {
            uint8_t *px = row + x * 4;
            const int opaque = px[3] == 255;
            if (opaque || !row_active || !bg_active) continue;
            const int checker = ((x / pw) + (y / ph)) % 2;
            const float *chosen =
                (use_pattern && checker == 1) ? pat_lin : bg_lin;
            const float a = (float)px[3];
            const float inv = 255.0f - a;
            for (int c = 0; c < 3; ++c) {
                const float s = (float)px[c];
                const float src_lin = s * s;
                const float blended = (src_lin * a + chosen[c] * inv) / 255.0f;
                float v = sqrtf(blended);
                if (v > 255.0f) v = 255.0f;
                px[c] = (uint8_t)v;
            }
            px[3] = 255;
        }
    }
}

// =====================================================================
// Unicode block glyph selection: scalar mirrors of
// cpu_mirror.quarter_blocks_np / half_blocks_np (same candidate order,
// f32 accumulation order, break-based argmin, transparency overrides).
// =====================================================================

#define T_THRESH 0x60

typedef struct {
    float v[4];
} Px;

static inline Px px_lin(const uint8_t *p) {
    Px o;
    const float r = (float)p[0], g = (float)p[1], b = (float)p[2];
    o.v[0] = r * r;
    o.v[1] = g * g;
    o.v[2] = b * b;
    o.v[3] = (float)p[3];
    return o;
}

static inline float px_dist(const Px *a, const Px *b) {
    const float d0 = b->v[0] - a->v[0];
    const float d1 = b->v[1] - a->v[1];
    const float d2 = b->v[2] - a->v[2];
    return (d0 * d0 + d1 * d1) + d2 * d2;
}

// _avd mirror: sequential f32 accumulation, avg = acc/n, total =
// ((dist(avg,v0)+dist(avg,v1))+...) in argument order.
static inline float px_avd(const Px *vals, int n, Px *avg) {
    Px acc = vals[0];
    for (int i = 1; i < n; ++i)
        for (int c = 0; c < 4; ++c) acc.v[c] = acc.v[c] + vals[i].v[c];
    for (int c = 0; c < 4; ++c) avg->v[c] = acc.v[c] / (float)n;
    float total = px_dist(avg, &vals[0]);
    for (int i = 1; i < n; ++i) total = total + px_dist(avg, &vals[i]);
    return total;
}

static inline void px_repack(const Px *lin, uint8_t *out) {
    for (int c = 0; c < 3; ++c) {
        float v = sqrtf(lin->v[c]);
        if (v > 255.0f) v = 255.0f;
        out[c] = (uint8_t)v;
    }
    out[3] = (uint8_t)lin->v[3];
}

void timg_quarter_blocks(const uint8_t *frame, int h, int w,
                         int use_upper_half_block, int32_t *glyph,
                         uint8_t *fg, uint8_t *bg) {
    const int hc = h / 2, wc = w / 2;
    for (int r = 0; r < hc; ++r) {
        const uint8_t *row0 = frame + (size_t)(2 * r) * w * 4;
        const uint8_t *row1 = frame + (size_t)(2 * r + 1) * w * 4;
        for (int cx = 0; cx < wc; ++cx) {
            const uint8_t *tl_u8 = row0 + (size_t)(2 * cx) * 4;
            const uint8_t *tr_u8 = row0 + (size_t)(2 * cx + 1) * 4;
            const uint8_t *bl_u8 = row1 + (size_t)(2 * cx) * 4;
            const uint8_t *br_u8 = row1 + (size_t)(2 * cx + 1) * 4;
            const Px tl = px_lin(tl_u8), tr = px_lin(tr_u8);
            const Px bl = px_lin(bl_u8), br = px_lin(br_u8);

            Px cand_fg[8], cand_bg[8];
            float costs[8];

            {  // 0: all average
                const Px all[4] = {tl, tr, bl, br};
                Px avg4;
                const float d4 = px_avd(all, 4, &avg4);
                cand_bg[0] = avg4;
                cand_fg[0] = avg4;
                costs[0] = d4;
            }
            {  // 1-4: one-pixel foreground vs rest-average
                const Px rests[4][3] = {{tr, bl, br},
                                        {tl, bl, br},
                                        {tl, tr, br},
                                        {tl, tr, bl}};
                const Px fgs[4] = {tl, tr, bl, br};
                for (int k = 0; k < 4; ++k) {
                    Px avg3;
                    const float d3 = px_avd(rests[k], 3, &avg3);
                    cand_bg[1 + k] = avg3;
                    cand_fg[1 + k] = fgs[k];
                    costs[1 + k] = d3;
                }
            }
            {  // 5: left column fg (tl,bl) vs right column bg (tr,br)
                const Px bgp[2] = {tr, br}, fgp[2] = {tl, bl};
                Px bavg, favg;
                const float db = px_avd(bgp, 2, &bavg);
                const float df = px_avd(fgp, 2, &favg);
                cand_bg[5] = bavg;
                cand_fg[5] = favg;
                costs[5] = db + df;
            }
            {  // 6: diagonal fg (tl,br) vs (tr,bl)
                const Px bgp[2] = {tr, bl}, fgp[2] = {tl, br};
                Px bavg, favg;
                const float db = px_avd(bgp, 2, &bavg);
                const float df = px_avd(fgp, 2, &favg);
                cand_bg[6] = bavg;
                cand_fg[6] = favg;
                costs[6] = db + df;
            }
            int half_glyph;
            {  // 7: half block split
                Px bavg, favg;
                float db, df;
                if (use_upper_half_block) {
                    const Px bgp[2] = {bl, br}, fgp[2] = {tl, tr};
                    db = px_avd(bgp, 2, &bavg);
                    df = px_avd(fgp, 2, &favg);
                    half_glyph = 8;
                } else {
                    const Px bgp[2] = {tl, tr}, fgp[2] = {bl, br};
                    db = px_avd(bgp, 2, &bavg);
                    df = px_avd(fgp, 2, &favg);
                    half_glyph = 7;
                }
                cand_bg[7] = bavg;
                cand_fg[7] = favg;
                costs[7] = db + df;
            }

            // Break-based early-exit argmin (mirrors the exclusive
            // prefix-cummin formulation; ref tie+early-exit semantics).
            int chosen = -1;
            float run_min = 1e12f;
            for (int i = 0; i < 8; ++i) {
                if (costs[i] < run_min && costs[i] < 1.0f) {
                    chosen = i;
                    break;
                }
                if (costs[i] < run_min) run_min = costs[i];
            }
            if (chosen < 0) {  // global argmin, first occurrence
                chosen = 0;
                for (int i = 1; i < 8; ++i)
                    if (costs[i] < costs[chosen]) chosen = i;
            }

            const size_t ci = (size_t)r * wc + cx;
            int g = (chosen == 7) ? half_glyph : chosen;
            uint8_t fg_u8[4], bg_u8[4];
            px_repack(&cand_fg[chosen], fg_u8);
            px_repack(&cand_bg[chosen], bg_u8);

            // Transparency overrides (order: bottom, top, all).
            const int t_tl = tl_u8[3] < T_THRESH, t_tr = tr_u8[3] < T_THRESH;
            const int t_bl = bl_u8[3] < T_THRESH, t_br = br_u8[3] < T_THRESH;
            const int top_t = t_tl && t_tr;
            const int bot_t = t_bl && t_br;
            if (bot_t) {
                const Px pair[2] = {tl, tr};
                Px avg;
                px_avd(pair, 2, &avg);
                g = 8;
                px_repack(&avg, fg_u8);
                memcpy(bg_u8, bl_u8, 4);
            }
            if (top_t) {
                const Px pair[2] = {bl, br};
                Px avg;
                px_avd(pair, 2, &avg);
                g = 7;
                px_repack(&avg, fg_u8);
                memcpy(bg_u8, tl_u8, 4);
            }
            if (top_t && bot_t) {
                g = 0;
                memcpy(fg_u8, bl_u8, 4);
                memcpy(bg_u8, tl_u8, 4);
            }
            glyph[ci] = g;
            memcpy(fg + ci * 4, fg_u8, 4);
            memcpy(bg + ci * 4, bg_u8, 4);
        }
    }
}

void timg_half_blocks(const uint8_t *frame, int h, int w,
                      int use_upper_half_block, int32_t *glyph, uint8_t *fg,
                      uint8_t *bg) {
    const int hc = h / 2;
    for (int r = 0; r < hc; ++r) {
        const uint8_t *top = frame + (size_t)(2 * r) * w * 4;
        const uint8_t *bot = frame + (size_t)(2 * r + 1) * w * 4;
        for (int x = 0; x < w; ++x) {
            const uint8_t *t = top + (size_t)x * 4;
            const uint8_t *b = bot + (size_t)x * 4;
            const int equal = (t[0] == b[0] && t[1] == b[1] && t[2] == b[2] &&
                               t[3] == b[3]);
            const int both_t = (t[3] < T_THRESH) && (b[3] < T_THRESH);
            const int is_bg = equal || both_t;
            const size_t ci = (size_t)r * w + x;
            if (is_bg) {
                glyph[ci] = 0;
                memcpy(fg + ci * 4, t, 4);
                memcpy(bg + ci * 4, b, 4);
            } else if (use_upper_half_block) {
                glyph[ci] = 8;
                memcpy(fg + ci * 4, t, 4);
                memcpy(bg + ci * 4, b, 4);
            } else {
                glyph[ci] = 7;
                memcpy(fg + ci * 4, b, 4);
                memcpy(bg + ci * 4, t, 4);
            }
        }
    }
}

// =====================================================================
// Nearest-neighbor resize (resize_nearest_np mirror; the -a path).
// =====================================================================

void timg_resize_nearest(const uint8_t *in, int in_h, int in_w, uint8_t *out,
                         int out_h, int out_w) {
    for (int y = 0; y < out_h; ++y) {
        long sy = (long)(((double)y + 0.5) * in_h / out_h);
        if (sy < 0) sy = 0;
        if (sy > in_h - 1) sy = in_h - 1;
        const uint8_t *srow = in + (size_t)sy * in_w * 4;
        uint8_t *drow = out + (size_t)y * out_w * 4;
        for (int x = 0; x < out_w; ++x) {
            long sx = (long)(((double)x + 0.5) * in_w / out_w);
            if (sx < 0) sx = 0;
            if (sx > in_w - 1) sx = in_w - 1;
            memcpy(drow + (size_t)x * 4, srow + (size_t)sx * 4, 4);
        }
    }
}

}  // extern "C"
