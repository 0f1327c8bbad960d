// Native runtime pieces for timg-tpu, exposed as a C ABI for ctypes.
// This file is libav-free (video decode lives in timg_video.cc) so it
// can be linked into both libtimg_native.so (full runtime) and
// libtimg_still.so (one-shot still fastpath, minimal dlopen cost).
//
// Contents:
//  * ANSI block-stream assembly (role of ref
//    src/unicode-block-canvas.cc:229-321 AppendDoubleRow): turns the
//    device-computed (glyph, fg, bg) planes into the escape byte stream
//    with run-length color elision and inter-frame diff skips. Kept
//    byte-compatible with the Python emitter (render/ansi.py), which is
//    the reference-parity-tested implementation.
//  * Sixel stream assembly, PNG Sub-filter, libsixel-faithful
//    quantization, and the polyphase resize executor (see each
//    section's citation comments).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <mutex>
#include <thread>
#include <cstdlib>
#include <vector>
#if defined(__SSE2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// ANSI block-stream assembly (glyph/fg/bg planes -> escape bytes)
// ---------------------------------------------------------------------------

namespace {

const char *const kGlyphs[9] = {" ", "▘", "▝", "▖",
                                "▗", "▌", "▚", "▄",
                                "▀"};

inline char *append_str(char *pos, const char *s) {
    size_t n = strlen(s);
    memcpy(pos, s, n);
    return pos + n;
}

inline char *append_dec(char *pos, int v) {
    return pos + sprintf(pos, "%d", v);
}

// "ddd;" 4-byte-chunk lookup for uint8 components: one memcpy instead
// of a sprintf per component (role of the 64-byte-aligned LUT in ref
// unicode-block-canvas.cc:449-491; sprintf was ~30 ms/frame).
struct DecEntry {
    char s[4];
    uint8_t len;
};
struct DecTable {
    DecEntry e[256];
    DecTable() {
        for (int v = 0; v < 256; ++v) {
            int n = snprintf(e[v].s, 4, "%d", v);
            e[v].s[n] = ';';
            e[v].len = (uint8_t)(n + 1);
        }
    }
};
inline char *append_u8_semi(char *pos, uint8_t v) {
    static const DecTable t;  // magic static: thread-safe init
    memcpy(pos, t.e[v].s, 4);
    return pos + t.e[v].len;
}

inline int as_256_term_color(int r, int g, int b) {
    // xterm 6x6x6 cube / gray ramp (parity with timg_tpu.colors).
    if (r == g && g == b) return 232 + (r * 23 / 255);
    auto v2cube = [](int v) {
        return v < 0x5f / 2            ? 0
               : v < (0x5f + 0x87) / 2 ? 1
               : v < (0x87 + 0xaf) / 2 ? 2
               : v < (0xaf + 0xd7) / 2 ? 3
               : v < (0xd7 + 0xff) / 2 ? 4
                                       : 5;
    };
    return 16 + 36 * v2cube(r) + 6 * v2cube(g) + v2cube(b);
}

inline char *append_color(char *pos, const uint8_t *c, bool use_256) {
    if (use_256) {
        pos = append_u8_semi(pos, (uint8_t)as_256_term_color(
            c[0], c[1], c[2]));
    } else {
        pos = append_u8_semi(pos, c[0]);
        pos = append_u8_semi(pos, c[1]);
        pos = append_u8_semi(pos, c[2]);
    }
    return pos;
}

}  // namespace

// ---------------------------------------------------------------------------
// Sixel stream assembly (index plane + palette -> DCS payload)
// (role of the byte-assembly half of ref src/sixel-canvas.cc /
//  libsixel's encoder; quantization+dithering run on the TPU)
// ---------------------------------------------------------------------------

namespace {

inline char *append_dec_fast(char *pos, int v) {
    // manual itoa: the RLE loop calls this ~100k times per random
    // frame; sprintf here cost ~60 ms/frame
    if (v < 10) { *pos++ = (char)('0' + v); return pos; }
    char tmp[12];
    int n = 0;
    while (v) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    while (n) *pos++ = tmp[--n];
    return pos;
}

inline char *append_sixel_runs(char *pos, const uint8_t *bits, int w) {
    // RLE one color's band row: '?'+bitmask chars, '!<n>' for runs > 3.
    // Runs are detected with 8-byte word compares: per-color masks are
    // mostly long equal stretches (zeros for sparse colors), and the
    // byte loop was the assembler's hot spot.
    int i = 0;
    while (i < w) {
        const uint8_t c = bits[i];
        const uint64_t pat = 0x0101010101010101ull * c;
        int run = 1;
        while (i + run + 8 <= w) {
            uint64_t v;
            memcpy(&v, bits + i + run, 8);
            if (v != pat) break;
            run += 8;
        }
        while (i + run < w && bits[i + run] == c) ++run;
        if (c == 0 && i + run == w) break;  // trailing blanks omitted
        const char ch = (char)(0x3F + c);
        if (run > 3) {
            *pos++ = '!';
            pos = append_dec_fast(pos, run);
            *pos++ = ch;
        } else {
            // branchless splat: write 3, advance by run (the output
            // buffer always has slack; see the caller's capacity)
            pos[0] = ch;
            pos[1] = ch;
            pos[2] = ch;
            pos += run;
        }
        i += run;
    }
    return pos;
}

}  // namespace

// indices: uint8[h x w] rows at ``pitch`` bytes apart (pitch >= w:
// device kernels emit 128-aligned padded planes; passing the pitch
// avoids a host repack). palette: uint8[n*3]. out must hold
// n_bands*n*(w+12) + n*20 + 256 bytes, the bound every caller uses
// (per color-band: '$#ddd' + leading blank run + <=1 char/column + 2
// bytes of run-splat slack; h*w*4 is NOT sufficient -- sparse colors'
// gap runs can exceed it on noise frames at small w).  Returns bytes
// written, -1 on allocation failure.
long timg_sixel_encode(const uint8_t *indices, int h, int w, int pitch,
                       const uint8_t *palette, int n_colors, char *out) {
    char *pos = out;
    pos += sprintf(pos, "\033Pq\"1;1;%d;%d", w, h);
    for (int i = 0; i < n_colors; ++i) {
        const int r = (palette[i * 3] * 100 + 127) / 255;
        const int g = (palette[i * 3 + 1] * 100 + 127) / 255;
        const int b = (palette[i * 3 + 2] * 100 + 127) / 255;
        *pos++ = '#';
        pos = append_dec_fast(pos, i);
        pos = append_str(pos, ";2;");
        pos = append_dec_fast(pos, r); *pos++ = ';';
        pos = append_dec_fast(pos, g); *pos++ = ';';
        pos = append_dec_fast(pos, b);
    }
    const int n_bands = (h + 5) / 6;
    // Per-band scatter: one pass over the band fills the per-color
    // column bitmasks, then runs are emitted per present color.  The
    // arena lives per thread (compression-pool workers encode frames
    // concurrently) and stays zeroed between calls: every used color
    // slice is re-zeroed after its runs are emitted, so only a growth
    // reallocation pays the zeroing cost -- not every video frame.
    static thread_local uint8_t *masks = nullptr;
    static thread_local size_t masks_cap = 0;
    const size_t masks_need = 256 * (size_t)w;
    if (masks_cap < masks_need) {
        free(masks);
        masks = (uint8_t *)calloc(1, masks_need);
        masks_cap = masks ? masks_need : 0;
        if (!masks) return -1;
    }
    // Per-color active column range: a sparse color's row is a long
    // leading zero-run, its set columns, and omitted trailing blanks.
    // The scatter tracks [minx, maxx]; emission writes the leading
    // zero-run directly (the exact bytes append_sixel_runs produces
    // for it) and scans only the active range -- byte-identical
    // output, and the per-band cost drops from ncolors*w to
    // ncolors*range (the assembler is per-frame host work in the
    // sixel video path, so this is throughput, not just one-shots).
    int cminx[256], cmaxx[256];
    for (int band = 0; band < n_bands; ++band) {
        const int y0 = band * 6;
        const int rows = (h - y0) < 6 ? (h - y0) : 6;
        for (int c = 0; c < 256; ++c) {
            cminx[c] = w;
            cmaxx[c] = -1;
        }
        for (int r = 0; r < rows; ++r) {
            const uint8_t *line = indices + (long)(y0 + r) * pitch;
            const uint8_t bit = (uint8_t)(1 << r);
            for (int x = 0; x < w; ++x) {
                const int c = line[x];
                masks[(long)c * w + x] |= bit;
                if (x < cminx[c]) cminx[c] = x;
                if (x > cmaxx[c]) cmaxx[c] = x;
            }
        }
        bool first = true;
        for (int color = 0; color < n_colors; ++color) {
            if (cmaxx[color] < 0) continue;
            if (!first) *pos++ = '$';
            first = false;
            *pos++ = '#';
            pos = append_dec_fast(pos, color);
            const int minx = cminx[color], maxx = cmaxx[color];
            if (minx > 0) {
                // Leading blank run, as append_sixel_runs emits it.
                if (minx > 3) {
                    *pos++ = '!';
                    pos = append_dec_fast(pos, minx);
                    *pos++ = '?';
                } else {
                    pos[0] = '?';
                    pos[1] = '?';
                    pos[2] = '?';
                    pos += minx;
                }
            }
            // bits[minx] and bits[maxx] are set, so the slice has no
            // leading/trailing blanks and trailing-blank omission past
            // maxx matches the full-width scan exactly.
            pos = append_sixel_runs(pos, masks + (long)color * w + minx,
                                    maxx - minx + 1);
            memset(masks + (long)color * w + minx, 0, maxx - minx + 1);
        }
        // Indices outside the palette are dropped from the output, but
        // their mask bits were still scattered; re-zero them or they
        // corrupt the next frame encoded on this thread.
        for (int color = n_colors; color < 256; ++color) {
            if (cmaxx[color] < 0) continue;
            memset(masks + (long)color * w + cminx[color], 0,
                   cmaxx[color] - cminx[color] + 1);
        }
        if (band != n_bands - 1) *pos++ = '-';
    }
    *pos++ = '\033';
    *pos++ = '\\';
    return pos - out;
}

namespace {
inline char *emit_sixel_run(char *pos, char ch, int run) {
    // One maximal constant-bits run, exactly as append_sixel_runs
    // emits it (trailing-blank omission is the caller's job).
    if (run > 3) {
        *pos++ = '!';
        pos = append_dec_fast(pos, run);
        *pos++ = ch;
    } else {
        pos[0] = ch;
        pos[1] = ch;
        pos[2] = ch;
        pos += run;
    }
    return pos;
}
}  // namespace

// Assembles the byte-identical DCS payload as timg_sixel_encode, but
// from device-compacted column-run records (ops/sixel_runs.py layout)
// instead of the raw index plane.  records: int32[2] per run,
// band-major then by start column; word0 = band rows 0-3 palette
// indices (little-endian bytes), word1 = rows 4-5 | x<<16.
// band_counts: int32[(h+5)/6] runs per band.  Returns bytes written,
// -1 on allocation failure or malformed records (non-monotonic x).
long timg_sixel_encode_runs(const int32_t *records,
                            const int32_t *band_counts, int h, int w,
                            const uint8_t *palette, int n_colors,
                            char *out) {
    char *pos = out;
    pos += sprintf(pos, "\033Pq\"1;1;%d;%d", w, h);
    for (int i = 0; i < n_colors; ++i) {
        const int r = (palette[i * 3] * 100 + 127) / 255;
        const int g = (palette[i * 3 + 1] * 100 + 127) / 255;
        const int b = (palette[i * 3 + 2] * 100 + 127) / 255;
        *pos++ = '#';
        pos = append_dec_fast(pos, i);
        pos = append_str(pos, ";2;");
        pos = append_dec_fast(pos, r); *pos++ = ';';
        pos = append_dec_fast(pos, g); *pos++ = ';';
        pos = append_dec_fast(pos, b);
    }
    const int n_bands = (h + 5) / 6;
    // Per-color segment lists built in one pass over the band's runs;
    // segments with equal bits that touch merge at insert time, so the
    // emission loop walks maximal constant-bits runs -- the same runs
    // the plane scan in timg_sixel_encode produces.
    struct Seg {
        int x, len, next;
        uint8_t bits;
    };
    static thread_local Seg *segs = nullptr;
    static thread_local size_t segs_cap = 0;
    const size_t segs_need = 6 * (size_t)(w > 0 ? w : 1);
    if (segs_cap < segs_need) {
        free(segs);
        segs = (Seg *)malloc(segs_need * sizeof(Seg));
        segs_cap = segs ? segs_need : 0;
        if (!segs) return -1;
    }
    int heads[256], tails[256];
    long base = 0;
    for (int band = 0; band < n_bands; ++band) {
        const int y0 = band * 6;
        const int rows = (h - y0) < 6 ? (h - y0) : 6;
        const int k = band_counts[band];
        if (k < 0 || k > w) return -1;
        for (int c = 0; c < 256; ++c) heads[c] = tails[c] = -1;
        int nseg = 0;
        for (int i = 0; i < k; ++i) {
            const uint32_t r0 = (uint32_t)records[2 * (base + i)];
            const uint32_t r1 = (uint32_t)records[2 * (base + i) + 1];
            const int x = (int)(r1 >> 16);
            const int xend = (i + 1 < k)
                ? (int)((uint32_t)records[2 * (base + i + 1) + 1] >> 16)
                : w;
            if (x < 0 || xend > w || xend <= x) return -1;
            const int len = xend - x;
            const uint8_t col[6] = {
                (uint8_t)r0,        (uint8_t)(r0 >> 8),
                (uint8_t)(r0 >> 16), (uint8_t)(r0 >> 24),
                (uint8_t)r1,        (uint8_t)(r1 >> 8)};
            uint8_t ucol[6], ubits[6];
            int ncol = 0;
            for (int r = 0; r < rows; ++r) {
                const uint8_t cc = col[r];
                int j = 0;
                while (j < ncol && ucol[j] != cc) ++j;
                if (j == ncol) {
                    ucol[ncol] = cc;
                    ubits[ncol++] = (uint8_t)(1 << r);
                } else {
                    ubits[j] |= (uint8_t)(1 << r);
                }
            }
            for (int j = 0; j < ncol; ++j) {
                const int c = ucol[j];
                const int t = tails[c];
                if (t >= 0 && segs[t].x + segs[t].len == x &&
                    segs[t].bits == ubits[j]) {
                    segs[t].len += len;  // contiguous same-bits: merge
                    continue;
                }
                segs[nseg] = Seg{x, len, -1, ubits[j]};
                if (t >= 0)
                    segs[t].next = nseg;
                else
                    heads[c] = nseg;
                tails[c] = nseg++;
            }
        }
        base += k;
        bool first = true;
        for (int color = 0; color < n_colors; ++color) {
            int s = heads[color];
            if (s < 0) continue;
            if (!first) *pos++ = '$';
            first = false;
            *pos++ = '#';
            pos = append_dec_fast(pos, color);
            int cursor = 0;
            for (; s >= 0; s = segs[s].next) {
                const int gap = segs[s].x - cursor;
                if (gap > 0) pos = emit_sixel_run(pos, '?', gap);
                pos = emit_sixel_run(pos, (char)(0x3F + segs[s].bits),
                                     segs[s].len);
                cursor = segs[s].x + segs[s].len;
            }
            // trailing blanks past the last segment are omitted
        }
        if (band != n_bands - 1) *pos++ = '-';
    }
    *pos++ = '\033';
    *pos++ = '\\';
    return pos - out;
}

// Emits the full frame body. glyph: int32[h*w]; fg/bg: uint8[h*w*4];
// eq: uint8[h*w] diff-skip mask or NULL. Returns bytes written.
long timg_ansi_emit(const int32_t *glyph, const uint8_t *fg,
                    const uint8_t *bg, const uint8_t *eq, int hcells,
                    int wcells, int indent, int use_256, char *out) {
    char *pos = out;
    int y_skip = 0;
    for (int r = 0; r < hcells; ++r) {
        const int32_t *grow = glyph + (long)r * wcells;
        const uint8_t *frow = fg + (long)r * wcells * 4;
        const uint8_t *brow = bg + (long)r * wcells * 4;
        const uint8_t *erow = eq ? eq + (long)r * wcells : nullptr;
        int x_skip = indent;
        char *row_start = pos;
        uint32_t last_fg = 0;
        uint32_t last_bg = 0;
        bool fg_unknown = true, bg_unknown = true;
        for (int c = 0; c < wcells; ++c) {
            if (erow && erow[c]) {
                ++x_skip;
                continue;
            }
            if (y_skip) {
                if (y_skip <= 4) {
                    memset(pos, '\n', y_skip);
                    pos += y_skip;
                } else {
                    pos = append_str(pos, "\033[");
                    pos = append_dec(pos, y_skip);
                    *pos++ = 'B';
                }
                y_skip = 0;
            }
            if (x_skip > 0) {
                pos = append_str(pos, "\033[");
                pos = append_dec(pos, x_skip);
                *pos++ = 'C';
                x_skip = 0;
            }
            const int g = grow[c];
            uint32_t f, b;
            memcpy(&f, frow + c * 4, 4);
            memcpy(&b, brow + c * 4, 4);
            bool color_emitted = false;
            if (g != 0 && (fg_unknown || f != last_fg)) {
                pos = append_str(pos, use_256 ? "\033[38;5;" : "\033[38;2;");
                pos = append_color(pos, frow + c * 4, use_256);
                color_emitted = true;
                last_fg = f;
                fg_unknown = false;
            }
            if (bg_unknown || b != last_bg) {
                if (!color_emitted) pos = append_str(pos, "\033[");
                if (brow[c * 4 + 3] < 0x60) {
                    pos = append_str(pos, "49;");
                } else {
                    pos = append_str(pos, use_256 ? "48;5;" : "48;2;");
                    pos = append_color(pos, brow + c * 4, use_256);
                }
                color_emitted = true;
                bg_unknown = false;
            }
            if (color_emitted) pos[-1] = 'm';
            pos = append_str(pos, kGlyphs[g]);
            last_bg = b;
        }
        if (pos == row_start) {
            ++y_skip;
        } else {
            pos = append_str(pos, "\033[0m\n");
        }
    }
    if (pos != out && y_skip) {
        pos = append_str(pos, "\033[");
        pos = append_dec(pos, y_skip);
        *pos++ = 'B';
    }
    return pos - out;
}

// PNG Sub-filter (type 1) row prep for the kitty/iterm2 encoders:
// out[row] = 0x01, px0 raw, then per-channel cur-prev deltas
// (role of ref src/timg-png.cc:124-134; one pass, no temporaries).
void timg_png_sub_filter(const uint8_t *rgba, int h, int w, int ch,
                         uint8_t *out) {
    const long stride = 1 + (long)w * ch;
    for (int y = 0; y < h; ++y) {
        const uint8_t *row = rgba + (long)y * w * 4;
        uint8_t *o = out + (long)y * stride;
        *o++ = 1;
        for (int c = 0; c < ch; ++c) o[c] = row[c];
        int x = 1;
        // Sub filtering is x[i] - x[i-bpp] with no loop dependency:
        // 4 px per vector op (byte subtraction wraps exactly).
#if defined(__SSE2__)
        if (ch == 4) {
            for (; x + 4 <= w; x += 4) {
                const __m128i cur = _mm_loadu_si128(
                    (const __m128i *)(row + (long)x * 4));
                const __m128i prv = _mm_loadu_si128(
                    (const __m128i *)(row + (long)x * 4 - 4));
                _mm_storeu_si128((__m128i *)(o + (long)x * 4),
                                 _mm_sub_epi8(cur, prv));
            }
        }
#endif
#if defined(__SSSE3__)
        if (ch == 3) {
            // subtract in RGBA lanes, then pack 4 diffs to 12 bytes;
            // the 16-byte store's 4 tail bytes stay inside this row
            // (x+6<=w) and are rewritten by the next iteration.
            const __m128i pack = _mm_setr_epi8(
                0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14,
                (char)0x80, (char)0x80, (char)0x80, (char)0x80);
            for (; x + 6 <= w; x += 4) {
                const __m128i cur = _mm_loadu_si128(
                    (const __m128i *)(row + (long)x * 4));
                const __m128i prv = _mm_loadu_si128(
                    (const __m128i *)(row + (long)x * 4 - 4));
                _mm_storeu_si128(
                    (__m128i *)(o + (long)x * 3),
                    _mm_shuffle_epi8(_mm_sub_epi8(cur, prv), pack));
            }
        }
#endif
        for (; x < w; ++x) {
            const uint8_t *cur = row + (long)x * 4;
            const uint8_t *prev = cur - 4;
            uint8_t *dst = o + (long)x * ch;
            for (int c = 0; c < ch; ++c)
                dst[c] = (uint8_t)(cur[c] - prev[c]);
        }
    }
}

// ---------------------------------------------------------------------------
// libsixel-faithful quantizer (production `--dither=libsixel` path).
//
// Reimplements the algorithm of libsixel's quant.c (netpbm pnmcolormap
// median cut) on the code path the reference selects per frame:
// sixel_dither_new(256) + sixel_dither_initialize(..., SIXEL_LARGE_LUM,
// SIXEL_REP_AVERAGE_COLORS, SIXEL_QUALITY_AUTO) + sixel_encode (ref
// src/sixel-canvas.cc:134-148).  Byte-tested against the scalar oracle
// in timg_tpu/ops/libsixel_quant.py (see that module's docstring for
// every pinned semantic).  Like the reference, this runs on the host in
// the compression thread pool -- libsixel itself is host CPU code.
// ---------------------------------------------------------------------------

namespace {

struct QuantBox {
    int ind;
    int colors;
    long sum;
};

// largestByLuminosity: strict >, first axis wins, init spread 0 / axis 0.
int largest_by_lum(const int *minv, const int *maxv) {
    static const double kLum[3] = {0.2989, 0.5866, 0.1145};
    double best = 0.0;
    int dim = 0;
    for (int plane = 0; plane < 3; ++plane) {
        const double spread = kLum[plane] * (maxv[plane] - minv[plane]);
        if (spread > best) {
            best = spread;
            dim = plane;
        }
    }
    return dim;
}

// error_diffuse: add offset*num/16 (C truncation division) and clamp to
// [0,255] immediately (the uint8 store in libsixel).
inline void error_diffuse(uint8_t *cell, int offset, int num) {
    int v = *cell + offset * num / 16;
    *cell = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

// RGB888 working copy of an RGBA frame (alpha dropped, as sixel_encode
// normalizes RGBA8888 -> RGB888).
static uint8_t *rgba_to_rgb(const uint8_t *rgba, int h, int w, long pitch) {
    uint8_t *data = (uint8_t *)malloc((long)h * w * 3);
    if (!data) return NULL;
    for (int y = 0; y < h; ++y) {
        const uint8_t *src = rgba + y * pitch;
        uint8_t *dst = data + (long)y * w * 3;
        for (int x = 0; x < w; ++x) {
            dst[0] = src[0];
            dst[1] = src[1];
            dst[2] = src[2];
            src += 4;
            dst += 3;
        }
    }
    return data;
}

// Palette construction (computeHistogram + mediancut) over an RGB888
// buffer. Returns (diffuse << 16) | ncolors; negative on error.
static int build_libsixel_palette(const uint8_t *data, long npix,
                                  int reqcolors, uint8_t *out_pal) {
    // --- computeHistogram: sampled 5-bit-bucket histogram -----------------
    const long length = npix * 3;
    const long max_sample = 18383;  // QUALITY_AUTO -> LOW for 256 colors
    long step = length / 3 / max_sample * 3;
    if (length < max_sample * 3) step = 6 * 3;
    if (step <= 0) step = 3;

    uint16_t *histogram = (uint16_t *)calloc(1 << 15, sizeof(uint16_t));
    int *seen_order = (int *)malloc((1 << 15) * sizeof(int));
    if (!histogram || !seen_order) {
        free(histogram); free(seen_order);
        return -1;
    }
    int n_seen = 0;
    for (long i = 0; i < length; i += step) {
        const int bucket = (data[i] >> 3) << 10 | (data[i + 1] >> 3) << 5 |
                           (data[i + 2] >> 3);
        if (histogram[bucket] == 0) seen_order[n_seen++] = bucket;
        if (histogram[bucket] < 65535) histogram[bucket]++;
    }

    // Color table in first-seen order; channel values = bucket bits << 3.
    int *tbl_c = (int *)malloc((size_t)n_seen * 3 * sizeof(int));
    long *tbl_n = (long *)malloc((size_t)n_seen * sizeof(long));
    if (!tbl_c || !tbl_n) {
        free(histogram); free(seen_order);
        free(tbl_c); free(tbl_n);
        return -1;
    }
    for (int i = 0; i < n_seen; ++i) {
        const int b = seen_order[i];
        tbl_c[i * 3 + 0] = (b >> 10 & 0x1F) << 3;
        tbl_c[i * 3 + 1] = (b >> 5 & 0x1F) << 3;
        tbl_c[i * 3 + 2] = (b & 0x1F) << 3;
        tbl_n[i] = histogram[b];
    }
    free(histogram);
    free(seen_order);

    int ncolors;
    int diffuse;
    if (n_seen <= reqcolors) {
        // Palette = the bucket colors themselves; diffusion disabled
        // (sixel_dither_initialize: origcolors <= reqcolors).
        ncolors = n_seen > 0 ? n_seen : 1;
        diffuse = 0;
        memset(out_pal, 0, (size_t)ncolors * 3);
        for (int i = 0; i < n_seen; ++i)
            for (int c = 0; c < 3; ++c)
                out_pal[i * 3 + c] = (uint8_t)tbl_c[i * 3 + c];
    } else {
        // --- mediancut ----------------------------------------------------
        ncolors = reqcolors;
        diffuse = 1;
        QuantBox *bv = (QuantBox *)malloc(sizeof(QuantBox) * reqcolors);
        int *order = (int *)malloc(sizeof(int) * n_seen);
        int *tmp_c = (int *)malloc((size_t)n_seen * 3 * sizeof(int));
        long *tmp_n = (long *)malloc((size_t)n_seen * sizeof(long));
        if (!bv || !order || !tmp_c || !tmp_n) {
            free(tbl_c); free(tbl_n);
            free(bv); free(order); free(tmp_c); free(tmp_n);
            return -1;
        }
        long total = 0;
        for (int i = 0; i < n_seen; ++i) total += tbl_n[i];
        bv[0] = {0, n_seen, total};
        int boxes = 1;
        while (boxes < reqcolors) {
            int bi = 0;
            while (bi < boxes && bv[bi].colors < 2) ++bi;
            if (bi >= boxes) break;
            const int ind = bv[bi].ind, n = bv[bi].colors;
            const long sm = bv[bi].sum;

            int minv[3], maxv[3];
            for (int c = 0; c < 3; ++c) {
                minv[c] = 255;
                maxv[c] = 0;
            }
            for (int i = 0; i < n; ++i)
                for (int c = 0; c < 3; ++c) {
                    const int v = tbl_c[(ind + i) * 3 + c];
                    if (v < minv[c]) minv[c] = v;
                    if (v > maxv[c]) maxv[c] = v;
                }
            const int dim = largest_by_lum(minv, maxv);

            // Stable sort of the segment by component `dim` (glibc qsort
            // is a stable mergesort; counting sort over 0..255 is the
            // same order and O(n)).
            {
                int cnt[257] = {0};
                for (int i = 0; i < n; ++i)
                    cnt[tbl_c[(ind + i) * 3 + dim] + 1]++;
                for (int v = 0; v < 256; ++v) cnt[v + 1] += cnt[v];
                for (int i = 0; i < n; ++i) {
                    const int v = tbl_c[(ind + i) * 3 + dim];
                    order[cnt[v]++] = i;
                }
                for (int i = 0; i < n; ++i) {
                    const int s = order[i];
                    for (int c = 0; c < 3; ++c)
                        tmp_c[i * 3 + c] = tbl_c[(ind + s) * 3 + c];
                    tmp_n[i] = tbl_n[ind + s];
                }
                memcpy(tbl_c + (size_t)ind * 3, tmp_c,
                       (size_t)n * 3 * sizeof(int));
                memcpy(tbl_n + ind, tmp_n, (size_t)n * sizeof(long));
            }

            // Frequency median: lowersum < sm/2, index in [1, n-1].
            long lowersum = tbl_n[ind];
            int i = 1;
            while (i < n - 1 && lowersum < sm / 2) {
                lowersum += tbl_n[ind + i];
                ++i;
            }
            bv[bi].colors = i;
            bv[bi].sum = lowersum;
            bv[boxes].ind = ind + i;
            bv[boxes].colors = n - i;
            bv[boxes].sum = sm - lowersum;
            ++boxes;
            // sumcompare: stable sort by sum descending (insertion sort
            // preserves relative order of equal sums).
            for (int j = 1; j < boxes; ++j) {
                const QuantBox key = bv[j];
                int m = j - 1;
                while (m >= 0 && bv[m].sum < key.sum) {
                    bv[m + 1] = bv[m];
                    --m;
                }
                bv[m + 1] = key;
            }
        }
        // colormapFromBv + averageColors (floor division); zero-fill tail.
        memset(out_pal, 0, (size_t)reqcolors * 3);
        for (int b = 0; b < boxes; ++b) {
            for (int c = 0; c < 3; ++c) {
                long sum = 0;
                for (int i = 0; i < bv[b].colors; ++i)
                    sum += tbl_c[(bv[b].ind + i) * 3 + c];
                out_pal[b * 3 + c] = (uint8_t)(sum / bv[b].colors);
            }
        }
        free(bv);
        free(order);
        free(tmp_c);
        free(tmp_n);
    }
    free(tbl_c);
    free(tbl_n);
    return (diffuse << 16) | ncolors;
}

// Full per-frame pipeline: palette construction + cached-FS apply.
// rgba: h*w RGBA pixels with row pitch `pitch` bytes.  Writes the
// palette to out_pal (capacity reqcolors*3) and indices to out_idx
// (h*w).  Returns (diffuse << 16) | ncolors; negative on error.
int timg_libsixel_quant(const uint8_t *rgba, int h, int w, long pitch,
                        int reqcolors, uint8_t *out_pal, uint8_t *out_idx) {
    if (reqcolors < 1 || reqcolors > 256) return -1;
    const long npix = (long)h * w;
    uint8_t *data = rgba_to_rgb(rgba, h, w, pitch);
    if (!data) return -1;
    const int pr = build_libsixel_palette(data, npix, reqcolors, out_pal);
    if (pr < 0) {
        free(data);
        return pr;
    }
    const int ncolors = pr & 0xFFFF;
    const int diffuse = pr >> 16;

    // --- apply palette: lookup_fast cache + integer FS diffusion ----------
    uint16_t *cache = (uint16_t *)calloc(1 << 15, sizeof(uint16_t));
    if (!cache) {
        free(data);
        return -1;
    }
    // SoA palette + distance staging for the cache-miss argmin: the
    // distance fill vectorizes (the AoS strict-< scan was the one-shot
    // sixel hot spot on low-coherence images -- every novel 15-bit
    // bucket pays a 256-wide scan).  First-minimum selection below is
    // exactly quant.c's strict-< "lowest index wins".
    int pal_r[256], pal_g[256], pal_b[256], dist[256];
    for (int i = 0; i < ncolors; ++i) {
        pal_r[i] = out_pal[i * 3 + 0];
        pal_g[i] = out_pal[i * 3 + 1];
        pal_b[i] = out_pal[i * 3 + 2];
    }
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint8_t *p = data + ((long)y * w + x) * 3;
            const int hashv =
                (p[0] >> 3) << 10 | (p[1] >> 3) << 5 | (p[2] >> 3);
            int idx;
            if (cache[hashv]) {
                idx = cache[hashv] - 1;
            } else {
                const int pr_ = p[0], pg_ = p[1], pb_ = p[2];
                for (int i = 0; i < ncolors; ++i) {
                    const int dr = pr_ - pal_r[i];
                    const int dg = pg_ - pal_g[i];
                    const int db = pb_ - pal_b[i];
                    dist[i] = dr * dr + dg * dg + db * db;
                }
                int bestd = dist[0];
                for (int i = 1; i < ncolors; ++i)
                    if (dist[i] < bestd) bestd = dist[i];
                idx = 0;
                while (dist[idx] != bestd) ++idx;
                cache[hashv] = (uint16_t)(idx + 1);
            }
            out_idx[(long)y * w + x] = (uint8_t)idx;
            if (!diffuse) continue;
            for (int n = 0; n < 3; ++n) {
                const int off = p[n] - out_pal[idx * 3 + n];
                if (off == 0) continue;
                uint8_t *base = data + n;
                const long pos = (long)y * w + x;
                if (x < w - 1)
                    error_diffuse(base + (pos + 1) * 3, off, 7);
                if (x > 0 && y < h - 1)
                    error_diffuse(base + (pos + w - 1) * 3, off, 3);
                if (y < h - 1)
                    error_diffuse(base + (pos + w) * 3, off, 5);
                if (x < w - 1 && y < h - 1)
                    error_diffuse(base + (pos + w + 1) * 3, off, 1);
            }
        }
    }
    free(cache);
    free(data);
    return (diffuse << 16) | ncolors;
}

// Palette construction only (computeHistogram + mediancut over the
// frame), without the apply pass: the device dither path builds its
// bucket table and runs the FS kernel itself; only the ~18383-sample
// palette is host work (VERDICT r2 #3 design).  Returns
// (diffuse << 16) | ncolors; negative on error.
int timg_libsixel_palette(const uint8_t *rgba, int h, int w, long pitch,
                          int reqcolors, uint8_t *out_pal) {
    if (reqcolors < 1 || reqcolors > 256) return -1;
    uint8_t *data = rgba_to_rgb(rgba, h, w, pitch);
    if (!data) return -1;
    const int pr = build_libsixel_palette(data, (long)h * w, reqcolors,
                                          out_pal);
    free(data);
    return pr;
}

// Prefilled lookup table: for every 15-bit bucket, the index of the
// palette color nearest to the bucket's *base* color (bits << 3 — the
// same reconstruction libsixel's histogram/color-table uses).  This is
// the order-independent variant of quant.c's lookup_fast cache: the
// cached answer no longer depends on which pixel touched the bucket
// first (that raster-order dependence is what makes the original cache
// inherently sequential and unshardable — see ops/libsixel_quant.py
// module docs for the full analysis).  out_table: 32768 bytes.
void timg_libsixel_build_table(const uint8_t *pal, int ncolors,
                               uint8_t *out_table) {
    // Per-channel squared-distance LUTs over the 32 bucket levels.
    static thread_local long lut[3][32][256];
    for (int c = 0; c < 3; ++c)
        for (int v = 0; v < 32; ++v) {
            const int base = v << 3;
            for (int i = 0; i < ncolors; ++i) {
                const long d = base - pal[i * 3 + c];
                lut[c][v][i] = d * d;
            }
        }
    for (int b = 0; b < (1 << 15); ++b) {
        const long *lr = lut[0][(b >> 10) & 0x1F];
        const long *lg = lut[1][(b >> 5) & 0x1F];
        const long *lb = lut[2][b & 0x1F];
        long bestd = 0x7FFFFFFFL;
        int idx = 0;
        for (int i = 0; i < ncolors; ++i) {
            const long d = lr[i] + lg[i] + lb[i];
            if (d < bestd) {  // strict <: lowest index wins
                bestd = d;
                idx = i;
            }
        }
        out_table[b] = (uint8_t)idx;
    }
}

// FS apply with the prefilled bucket table: identical integer
// Floyd-Steinberg semantics to timg_libsixel_quant's apply pass
// (offset*num/16 C truncation, clamp-on-store per write, interior
// guards), with the per-pixel index from the order-independent table
// instead of the first-touch cache.  The strict CPU mirror of the
// device wavefront kernel (sixel_pallas3.fs_dither_table_fused) —
// byte-identity TPU==CPU is what the stream tests assert.
int timg_libsixel_apply_table(const uint8_t *rgba, int h, int w,
                              long pitch, const uint8_t *table,
                              const uint8_t *pal, int diffuse,
                              uint8_t *out_idx) {
    uint8_t *data = rgba_to_rgb(rgba, h, w, pitch);
    if (!data) return -1;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint8_t *p = data + ((long)y * w + x) * 3;
            const int hashv =
                (p[0] >> 3) << 10 | (p[1] >> 3) << 5 | (p[2] >> 3);
            const int idx = table[hashv];
            out_idx[(long)y * w + x] = (uint8_t)idx;
            if (!diffuse) continue;
            for (int n = 0; n < 3; ++n) {
                const int off = p[n] - pal[idx * 3 + n];
                if (off == 0) continue;
                uint8_t *base = data + n;
                const long pos = (long)y * w + x;
                if (x < w - 1)
                    error_diffuse(base + (pos + 1) * 3, off, 7);
                if (x > 0 && y < h - 1)
                    error_diffuse(base + (pos + w - 1) * 3, off, 3);
                if (y < h - 1)
                    error_diffuse(base + (pos + w) * 3, off, 5);
                if (x < w - 1 && y < h - 1)
                    error_diffuse(base + (pos + w + 1) * 3, off, 1);
            }
        }
    }
    free(data);
    return 0;
}

// ---------------------------------------------------------------------
// Polyphase resize: bit-exact mirror of ops/resize_np.py::resize_batch_np
// (itself bit-exact vs stb_image_resize2 as the reference configures it,
// reference src/image-scaler.cc:29-33 STBIR path). The banded taps are
// computed in Python (resize_np.packed_taps) and passed in; this routine
// reproduces the numpy executor's exact float32 operation order:
//  - input scaled by (float)(1.0/255.0), alpha-premultiplied channels
//    appended when alpha_weighted (7-channel pipeline);
//  - vertical axis: sequential tap accumulation;
//  - horizontal axis: even/odd split accumulation when widest >= 4
//    (resize_np.apply_axis_np), sequential otherwise;
//  - unweight by 1/max(alpha, 2^-120), pack clip(x*255+0.5, 0, 255).
// Any deviation in op order would flip last-ulp roundings and break the
// golden byte parity the suite asserts, so keep mul/add shapes as-is.
// (Built with -ffp-contract=off so no FMA contraction reassociates.)

static const float kInv255 = (float)(1.0 / 255.0);
static const float kSmallFloat = 0x1p-120f;  // stbir__small_float

static inline int clip_int(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}


// One output pixel with per-tap index clipping (edge pixels, and the
// no-SIMD fallback).  This is the original scalar tap walk; the exact
// mul/add sequence below is the byte-parity contract.
static inline void hresample_px_scalar(const float *in_row, float *px,
                                       int s0, int in_size, int ch,
                                       const float *cf, int widest) {
    if (widest >= 4) {
        // numpy: even=tap0, odd=tap1, even+=tap2, ... acc=even+odd
        float even[8], odd[8];
        const float *p0 = in_row + (long)clip_int(s0, 0, in_size - 1) * ch;
        const float *p1 =
            in_row + (long)clip_int(s0 + 1, 0, in_size - 1) * ch;
        for (int c = 0; c < ch; ++c) even[c] = p0[c] * cf[0];
        for (int c = 0; c < ch; ++c) odd[c] = p1[c] * cf[1];
        for (int t = 2; t < widest; ++t) {
            const float *p =
                in_row + (long)clip_int(s0 + t, 0, in_size - 1) * ch;
            float *acc = (t & 1) ? odd : even;
            const float c = cf[t];
            for (int k = 0; k < ch; ++k) acc[k] += p[k] * c;
        }
        for (int c = 0; c < ch; ++c) px[c] = even[c] + odd[c];
    } else {
        const float *p0 = in_row + (long)clip_int(s0, 0, in_size - 1) * ch;
        for (int c = 0; c < ch; ++c) px[c] = p0[c] * cf[0];
        for (int t = 1; t < widest; ++t) {
            const float *p =
                in_row + (long)clip_int(s0 + t, 0, in_size - 1) * ch;
            const float c = cf[t];
            for (int k = 0; k < ch; ++k) px[k] += p[k] * c;
        }
    }
}

// Horizontal resample [rows][in_size][ch] -> [rows][out_size][ch].
// Interior pixels (tap span fully inside the row -- all but a few at
// each edge) take a SIMD path: one vector per channel group, lane-wise
// mul/add, which computes each channel with the identical f32 op
// sequence as the scalar walk (same taps, same alternating even/odd
// accumulation), so bytes are unchanged.  Edge pixels keep the scalar
// clipped walk.
static void resample_horizontal(const float *src, float *dst, int rows,
                                int in_size, int out_size, int ch,
                                const int32_t *starts, const float *coeffs,
                                int widest) {
    for (int r = 0; r < rows; ++r) {
        const float *in_row = src + (long)r * in_size * ch;
        float *out_row = dst + (long)r * out_size * ch;
        for (int o = 0; o < out_size; ++o) {
            float *px = out_row + (long)o * ch;
            const float *cf = coeffs + (long)o * widest;
            const int s0 = starts[o];
            const int interior = (s0 >= 0 && s0 + widest <= in_size);
#if defined(__SSE2__)
            if (interior && ch == 4) {
                const float *p = in_row + (long)s0 * 4;
                if (widest >= 4) {
                    __m128 even = _mm_mul_ps(_mm_loadu_ps(p),
                                             _mm_set1_ps(cf[0]));
                    __m128 odd = _mm_mul_ps(_mm_loadu_ps(p + 4),
                                            _mm_set1_ps(cf[1]));
                    int t = 2;
                    for (; t + 1 < widest; t += 2) {
                        even = _mm_add_ps(
                            even, _mm_mul_ps(_mm_loadu_ps(p + 4 * (long)t),
                                             _mm_set1_ps(cf[t])));
                        odd = _mm_add_ps(
                            odd,
                            _mm_mul_ps(_mm_loadu_ps(p + 4 * (long)(t + 1)),
                                       _mm_set1_ps(cf[t + 1])));
                    }
                    if (t < widest)  // widest odd: final tap is even
                        even = _mm_add_ps(
                            even, _mm_mul_ps(_mm_loadu_ps(p + 4 * (long)t),
                                             _mm_set1_ps(cf[t])));
                    _mm_storeu_ps(px, _mm_add_ps(even, odd));
                } else {
                    __m128 acc = _mm_mul_ps(_mm_loadu_ps(p),
                                            _mm_set1_ps(cf[0]));
                    for (int t = 1; t < widest; ++t)
                        acc = _mm_add_ps(
                            acc, _mm_mul_ps(_mm_loadu_ps(p + 4 * (long)t),
                                            _mm_set1_ps(cf[t])));
                    _mm_storeu_ps(px, acc);
                }
                continue;
            }
#endif
#if defined(__AVX512F__) && defined(__AVX512DQ__)
// GCC 12's AVX512 intrinsic headers trip -Wmaybe-uninitialized false
// positives (builtin masked/cast forms with "undefined" operands).
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
            if (interior && ch == 8 && widest >= 4) {
                // One zmm = [even acc (8) | odd acc (8)]: a 64-byte
                // load spans taps t,t+1 and the coeff vector carries
                // [cf[t] x8 | cf[t+1] x8], so each fused iteration
                // advances both parity accumulators with the same
                // per-lane mul/add the 256-bit walk does -- identical
                // f32 sequence, half the loop trips.
                const float *p = in_row + (long)s0 * 8;
                __m512 acc = _mm512_mul_ps(
                    _mm512_loadu_ps(p),
                    _mm512_mask_broadcastss_ps(
                        _mm512_broadcastss_ps(_mm_load_ss(cf)),
                        (__mmask16)0xFF00, _mm_load_ss(cf + 1)));
                int t = 2;
                for (; t + 1 < widest; t += 2)
                    acc = _mm512_add_ps(
                        acc, _mm512_mul_ps(
                                 _mm512_loadu_ps(p + 8 * (long)t),
                                 _mm512_mask_broadcastss_ps(
                                     _mm512_broadcastss_ps(
                                         _mm_load_ss(cf + t)),
                                     (__mmask16)0xFF00,
                                     _mm_load_ss(cf + t + 1))));
                __m256 even = _mm512_castps512_ps256(acc);
                const __m256 odd = _mm512_extractf32x8_ps(acc, 1);
                if (t < widest)  // widest odd: final tap is even
                    even = _mm256_add_ps(
                        even, _mm256_mul_ps(_mm256_loadu_ps(p + 8 * (long)t),
                                            _mm256_set1_ps(cf[t])));
                _mm256_storeu_ps(px, _mm256_add_ps(even, odd));
                continue;
            }
#pragma GCC diagnostic pop
#endif
#if defined(__AVX__)
            if (interior && ch == 8) {
                const float *p = in_row + (long)s0 * 8;
                if (widest >= 4) {
                    __m256 even = _mm256_mul_ps(_mm256_loadu_ps(p),
                                                _mm256_set1_ps(cf[0]));
                    __m256 odd = _mm256_mul_ps(_mm256_loadu_ps(p + 8),
                                               _mm256_set1_ps(cf[1]));
                    int t = 2;
                    for (; t + 1 < widest; t += 2) {
                        even = _mm256_add_ps(
                            even,
                            _mm256_mul_ps(_mm256_loadu_ps(p + 8 * (long)t),
                                          _mm256_set1_ps(cf[t])));
                        odd = _mm256_add_ps(
                            odd, _mm256_mul_ps(
                                     _mm256_loadu_ps(p + 8 * (long)(t + 1)),
                                     _mm256_set1_ps(cf[t + 1])));
                    }
                    if (t < widest)
                        even = _mm256_add_ps(
                            even,
                            _mm256_mul_ps(_mm256_loadu_ps(p + 8 * (long)t),
                                          _mm256_set1_ps(cf[t])));
                    _mm256_storeu_ps(px, _mm256_add_ps(even, odd));
                } else {
                    __m256 acc = _mm256_mul_ps(_mm256_loadu_ps(p),
                                               _mm256_set1_ps(cf[0]));
                    for (int t = 1; t < widest; ++t)
                        acc = _mm256_add_ps(
                            acc,
                            _mm256_mul_ps(_mm256_loadu_ps(p + 8 * (long)t),
                                          _mm256_set1_ps(cf[t])));
                    _mm256_storeu_ps(px, acc);
                }
                continue;
            }
#endif
            hresample_px_scalar(in_row, px, s0, in_size, ch, cf, widest);
        }
    }
}

// u8 row -> float row (the former whole-image staging, one row at a
// time).  7 meaningful floats when alpha-weighted, padded to stride 8
// so inner loops run power-of-two widths (pad lane carries zeros;
// per-channel arithmetic is unchanged).
static void row_to_float(const uint8_t *src, float *dst, int n, int ch,
                         int alpha_weighted) {
    int p = 0;
#if defined(__AVX2__)
    // 2 px / 8 source bytes per iteration.  Lane-exact with the scalar
    // walk: cvtepi32_ps is exact on 0..255, the *kInv255 and premult
    // muls are the same single-rounded f32 ops, and the masked lane is
    // +0.0f like the scalar store.
    if (alpha_weighted) {
        const __m256 k = _mm256_set1_ps(kInv255);
        const __m256i aidx = _mm256_setr_epi32(3, 3, 3, 3, 7, 7, 7, 7);
        const __m256 pmmask = _mm256_castsi256_ps(
            _mm256_setr_epi32(-1, -1, -1, 0, -1, -1, -1, 0));
        for (; p + 2 <= n; p += 2) {
            __m128i b8 =
                _mm_loadl_epi64((const __m128i *)(src + (long)p * 4));
            __m256 v = _mm256_mul_ps(
                _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(b8)), k);
            __m256 av = _mm256_permutevar8x32_ps(v, aidx);
            __m256 pm = _mm256_and_ps(_mm256_mul_ps(v, av), pmmask);
            float *o = dst + (long)p * 8;
            _mm256_storeu_ps(o, _mm256_permute2f128_ps(v, pm, 0x20));
            _mm256_storeu_ps(o + 8, _mm256_permute2f128_ps(v, pm, 0x31));
        }
    } else {
        const __m256 k = _mm256_set1_ps(kInv255);
        const long total = (long)n * 4;
        long i = 0;
        for (; i + 8 <= total; i += 8) {
            __m128i b8 = _mm_loadl_epi64((const __m128i *)(src + i));
            _mm256_storeu_ps(
                dst + i,
                _mm256_mul_ps(
                    _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(b8)), k));
        }
        p = (int)(i / 4);  // i is a multiple of 8, so this is exact
    }
#endif
    for (; p < n; ++p) {
        float *v = dst + (long)p * ch;
        v[0] = (float)src[p * 4 + 0] * kInv255;
        v[1] = (float)src[p * 4 + 1] * kInv255;
        v[2] = (float)src[p * 4 + 2] * kInv255;
        v[3] = (float)src[p * 4 + 3] * kInv255;
        if (alpha_weighted) {
            v[4] = v[0] * v[3];
            v[5] = v[1] * v[3];
            v[6] = v[2] * v[3];
            v[7] = 0.0f;
        }
    }
}

// RGB source rows (the fused PNG color-type-2 path): expand a chunk to
// [r,g,b,255] in a hot stack buffer, then run the IDENTICAL conversion
// -- so every float equals the RGBA path's for an opaque image, and
// the executors stay byte-identical whichever decode entry fed them.
static void row_to_float_rgb(const uint8_t *src, float *dst, int n,
                             int ch, int alpha_weighted) {
    uint8_t chunk[256 * 4];
    int done = 0;
    while (done < n) {
        const int c = (n - done < 256) ? (n - done) : 256;
        const uint8_t *s = src + (long)done * 3;
        int x = 0;
#if defined(__SSSE3__)
        const __m128i shuf = _mm_setr_epi8(
            0, 1, 2, (char)0x80, 3, 4, 5, (char)0x80,
            6, 7, 8, (char)0x80, 9, 10, 11, (char)0x80);
        const __m128i alpha = _mm_set1_epi32((int)0xff000000u);
        // the 16-byte load reads 4 bytes past the 12-byte group; safe
        // while a whole pixel remains beyond the group in this row
        for (; x + 6 <= c; x += 4)
            _mm_storeu_si128(
                (__m128i *)(chunk + (long)x * 4),
                _mm_or_si128(
                    _mm_shuffle_epi8(
                        _mm_loadu_si128((const __m128i *)(s + (long)x * 3)),
                        shuf),
                    alpha));
#endif
        for (; x < c; ++x) {
            chunk[x * 4 + 0] = s[x * 3 + 0];
            chunk[x * 4 + 1] = s[x * 3 + 1];
            chunk[x * 4 + 2] = s[x * 3 + 2];
            chunk[x * 4 + 3] = 255;
        }
        row_to_float(chunk, dst + (long)done * ch, c, ch, alpha_weighted);
        done += c;
    }
}

static inline void row_to_float_src(const uint8_t *src, int src_rgb,
                                    float *dst, int n, int ch,
                                    int alpha_weighted) {
    if (src_rgb)
        row_to_float_rgb(src, dst, n, ch, alpha_weighted);
    else
        row_to_float(src, dst, n, ch, alpha_weighted);
}

// One vertical tap: acc[i] (=|+=) r[i] * c.  The restrict-qualified
// single-tap form is what GCC needs to auto-vectorize (the former
// nested rows[t][i] loop loaded the row pointer through a
// pointer-to-pointer each iteration -- "evolution of base is not
// affine" -- and ran scalar, which made the 4K vertical combine the
// dominant still-pipeline cost at ~60 ms).  Per element the mul/add
// sequence is unchanged, so output bytes are unchanged.
static void axpy_row(float *__restrict__ acc, const float *__restrict__ r,
                     float c, long n, int first_tap) {
    if (first_tap) {
        for (long i = 0; i < n; ++i) acc[i] = r[i] * c;
    } else {
        for (long i = 0; i < n; ++i) acc[i] += r[i] * c;
    }
}

// Vertical tap combine for ONE output row: dst[i] = sum_t rows[t][i] *
// cf[t], accumulated in tap order -- element-for-element the op order
// of the former whole-image resample_vertical pass.
static void combine_rows(float *dst, const float *const *rows,
                         const float *cf, int widest, long row_floats) {
    axpy_row(dst, rows[0], cf[0], row_floats, 1);
    for (int t = 1; t < widest; ++t)
        axpy_row(dst, rows[t], cf[t], row_floats, 0);
}

// Float row -> u8 RGBA row (the former whole-image repack, per row).
static void row_repack(const float *src, uint8_t *dst, int n, int ch,
                       int alpha_weighted) {
    for (int p = 0; p < n; ++p) {
        const float *v = src + (long)p * ch;
        float rgba[4];
        if (alpha_weighted) {
            const float alpha = v[3];
            const float ialpha =
                1.0f / (alpha > kSmallFloat ? alpha : kSmallFloat);
            for (int c = 0; c < 3; ++c)
                rgba[c] = (alpha < kSmallFloat) ? v[c] : v[4 + c] * ialpha;
            rgba[3] = alpha;
        } else {
            for (int c = 0; c < 4; ++c) rgba[c] = v[c];
        }
        for (int c = 0; c < 4; ++c) {
            float f = rgba[c] * 255.0f + 0.5f;
            if (f < 0.0f) f = 0.0f;
            if (f > 255.0f) f = 255.0f;
            dst[p * 4 + c] = (uint8_t)f;
        }
    }
}

// in: [batch][in_h][in_w][4] u8; out: [batch][out_h][out_w][4] u8.
// Returns 0 on success, -1 on allocation failure.
//
// Streaming scanline executor: output rows are produced one at a time
// from a ring of `widest_v` prepared source rows (raw float rows when
// the vertical pass runs first, horizontally-resampled rows when the
// horizontal pass runs first).  The per-pixel float op order is
// IDENTICAL to the former whole-image two-pass code (each output value
// touches the same inputs with the same multiply/accumulate sequence),
// so output bytes are unchanged -- pinned by the stb-oracle bit-parity
// tests.  What changes is the footprint: a 512x512 one-shot previously
// staged ~21 MB of fresh float planes per call (mmap'd and faulted
// every invocation, dominating the interactive latency at ~14 ms); the
// ring peaks under 1 MB and stays cache-resident (~3 ms).
// Vertical-first scatter executor: source rows are converted once, in
// ascending order, and scattered into the active output-row
// accumulators.  The gather form above it replaced re-streamed every
// source row once per consuming output row (~4x Mitchell overlap =
// ~528 MB of float traffic on a 4K still); the scatter form reads the
// u8 source exactly once (~33 MB) and keeps the ~6 active accumulators
// L2-resident.  Per output element the taps still arrive in t order
// (clip(starts[o]+t) is non-decreasing in t, and we walk y upward), so
// the f32 op sequence -- and therefore every output byte -- is
// identical to the gather executor; pinned by the stb-oracle parity
// tests.  Requires non-decreasing starts_v (the stb band builder
// guarantees it; caller checks and falls back otherwise).
// Vertical-first tiled-gather executor: each output row is combined
// directly from its widest_v source rows, one L1-sized column tile at
// a time -- the u8 source tile is converted (SIMD) into a hot scratch
// tile and multiply-accumulated into an accumulator tile that stays
// L1-resident through the tap loop.  Unlike the scatter form below it
// never streams image-width accumulator rows through L2 (the scatter's
// floor: ~max_active x row_floats x 2 of L2 traffic per source row).
// The price is re-converting overlapping window rows (~4x for Mitchell
// downsampling), which the AVX2 row_to_float makes cheap.  Per output
// element the taps are applied in ascending t with the identical
// mul/add sequence, so output bytes are unchanged.
static long resize_polyphase_vfirst_gather(
    const uint8_t *in, long in_pitch, int src_rgb, int batch, int in_h,
    int in_w, uint8_t *out, int out_h, int out_w, const int32_t *starts_v,
    const float *coeffs_v, int widest_v, const int32_t *starts_h,
    const float *coeffs_h, int widest_h, int alpha_weighted) {
    const int ch = alpha_weighted ? 8 : 4;
    const int bpp = src_rgb ? 3 : 4;
    const long row_floats = (long)in_w * ch;
    const int kTilePx = 512;

    float *acc_row = (float *)malloc((size_t)row_floats * sizeof(float));
    float *tmp = (float *)malloc((size_t)kTilePx * ch * sizeof(float));
    float *final_row = (float *)malloc((size_t)out_w * ch * sizeof(float));
    if (!acc_row || !tmp || !final_row) {
        free(acc_row);
        free(tmp);
        free(final_row);
        return -1;
    }

    for (int b = 0; b < batch; ++b) {
        const uint8_t *src = in + (long)b * in_h * in_pitch;
        uint8_t *dst = out + (long)b * (long)out_h * out_w * 4;
        for (int o = 0; o < out_h; ++o) {
            const float *cfo = coeffs_v + (long)o * widest_v;
            const int s0 = starts_v[o];
            for (int px0 = 0; px0 < in_w; px0 += kTilePx) {
                const int tw =
                    (in_w - px0 < kTilePx) ? (in_w - px0) : kTilePx;
                const long tf = (long)tw * ch;
                float *at = acc_row + (long)px0 * ch;
                for (int t = 0; t < widest_v; ++t) {
                    const int y = clip_int(s0 + t, 0, in_h - 1);
                    row_to_float_src(
                        src + (long)y * in_pitch + (long)px0 * bpp,
                        src_rgb, tmp, tw, ch, alpha_weighted);
                    axpy_row(at, tmp, cfo[t], tf, t == 0);
                }
            }
            resample_horizontal(acc_row, final_row, 1, in_w, out_w, ch,
                                starts_h, coeffs_h, widest_h);
            row_repack(final_row, dst + (long)o * out_w * 4, out_w, ch,
                       alpha_weighted);
        }
    }
    free(acc_row);
    free(tmp);
    free(final_row);
    return 0;
}

static long resize_polyphase_vfirst_scatter(
    const uint8_t *in, long in_pitch, int src_rgb, int batch, int in_h,
    int in_w, uint8_t *out, int out_h, int out_w, const int32_t *starts_v,
    const float *coeffs_v, int widest_v, const int32_t *starts_h,
    const float *coeffs_h, int widest_h, int alpha_weighted) {
    const int ch = alpha_weighted ? 8 : 4;
    const int bpp = src_rgb ? 3 : 4;
    const long row_floats = (long)in_w * ch;

    // Max simultaneously-active output rows AT BLOCK GRANULARITY: o is
    // active from the y-block containing clip(starts_v[o]) through
    // y=clip(starts_v[o]+widest_v-1); both bounds are non-decreasing
    // in o, so a two-pointer sweep finds the widest overlap.  The
    // activation bound is rounded down to the processing block (4
    // rows, kYBlock below): the executor activates an output at the
    // start of the block its first tap lands in, so two outputs that
    // never share a single source row can still share a block.
    int max_active = 1;
    {
        int lo = 0;
        for (int o = 0; o < out_h; ++o) {
            const int act = (clip_int(starts_v[o], 0, in_h - 1) / 4) * 4;
            while (lo < o &&
                   clip_int(starts_v[lo] + widest_v - 1, 0, in_h - 1) < act)
                ++lo;
            const int active = o - lo + 1;
            if (active > max_active) max_active = active;
        }
    }

    // Source rows are processed in blocks of kYBlock, column-tiled at
    // kTilePx: the block's converted source tiles (kYBlock x 8 KB at
    // ch=8) and the current accumulator tile stay L1-resident, so each
    // accumulator tile is loaded/stored once per BLOCK instead of once
    // per tap -- the acc streaming was the executor's measured floor
    // (~max_active x row_floats x 2 of L2 traffic per source row on a
    // 4K still).  Within a block each output's taps are still applied
    // in ascending t (j below is forced by clip order), so per output
    // element the f32 op sequence is exactly the untiled walk's.
    const int kTilePx = 256;
    const int kYBlock = 4;
    float *acc = (float *)malloc((size_t)max_active * row_floats *
                                 sizeof(float));
    float *tmp =
        (float *)malloc((size_t)kYBlock * kTilePx * ch * sizeof(float));
    float *final_row = (float *)malloc((size_t)out_w * ch * sizeof(float));
    int *next_tap = (int *)malloc((size_t)out_h * sizeof(int));
    int *tap_end = (int *)malloc((size_t)out_h * sizeof(int));
    if (!acc || !tmp || !final_row || !next_tap || !tap_end) {
        free(acc);
        free(tmp);
        free(final_row);
        free(next_tap);
        free(tap_end);
        return -1;
    }

    long rc = 0;
    for (int b = 0; b < batch; ++b) {
        const uint8_t *src = in + (long)b * in_h * in_pitch;
        uint8_t *dst = out + (long)b * (long)out_h * out_w * 4;
        for (int o = 0; o < out_h; ++o) next_tap[o] = 0;
        int o_lo = 0, o_hi = 0;
        for (int yb = 0; yb < in_h && o_lo < out_h; yb += kYBlock) {
            const int ylim = (yb + kYBlock < in_h) ? yb + kYBlock : in_h;
            while (o_hi < out_h &&
                   clip_int(starts_v[o_hi], 0, in_h - 1) < ylim)
                ++o_hi;
            if (o_lo == o_hi) continue;
            // Tap span per active output for this block (index math
            // only): taps whose clipped source row lands in [yb, ylim).
            for (int o = o_lo; o < o_hi; ++o) {
                int t = next_tap[o];
                while (t < widest_v &&
                       clip_int(starts_v[o] + t, 0, in_h - 1) < ylim)
                    ++t;
                tap_end[o] = t;
            }
            for (int px0 = 0; px0 < in_w; px0 += kTilePx) {
                const int tw =
                    (in_w - px0 < kTilePx) ? (in_w - px0) : kTilePx;
                const long tf = (long)tw * ch;
                for (int y = yb; y < ylim; ++y)
                    row_to_float_src(
                        src + (long)y * in_pitch + (long)px0 * bpp,
                        src_rgb, tmp + (long)(y - yb) * kTilePx * ch, tw,
                        ch, alpha_weighted);
                for (int o = o_lo; o < o_hi; ++o) {
                    const float *cfo = coeffs_v + (long)o * widest_v;
                    float *at = acc + (long)(o % max_active) * row_floats +
                                (long)px0 * ch;
                    for (int t = next_tap[o]; t < tap_end[o]; ++t) {
                        const int j =
                            clip_int(starts_v[o] + t, 0, in_h - 1) - yb;
                        axpy_row(at, tmp + (long)j * kTilePx * ch, cfo[t],
                                 tf, t == 0);
                    }
                }
            }
            for (int o = o_lo; o < o_hi; ++o) {
                next_tap[o] = tap_end[o];
                if (tap_end[o] == widest_v) {
                    float *ao = acc + (long)(o % max_active) * row_floats;
                    resample_horizontal(ao, final_row, 1, in_w, out_w, ch,
                                        starts_h, coeffs_h, widest_h);
                    row_repack(final_row, dst + (long)o * out_w * 4, out_w,
                               ch, alpha_weighted);
                }
            }
            while (o_lo < out_h && next_tap[o_lo] == widest_v) ++o_lo;
        }
        if (o_lo < out_h) {  // starts_v not as assumed; bail for caller
            rc = -2;
            break;
        }
    }
    free(acc);
    free(tmp);
    free(final_row);
    free(next_tap);
    free(tap_end);
    return rc;
}

// Pitched/typed-source entry for the fused decode->resize path: `in`
// rows live at `in_pitch` bytes apart and hold RGB (src_rgb=1) or
// RGBA (src_rgb=0) pixels -- PNG raw scanlines feed this directly
// (timg_png_decode_raw) without an RGBA plane in between.  Output
// bytes are identical to decoding first: the RGB rows pass through an
// in-register [r,g,b,255] expansion and then the same conversion.
long timg_resize_polyphase_src(const uint8_t *in, long in_pitch,
                               int src_rgb, int batch, int in_h, int in_w,
                               uint8_t *out, int out_h, int out_w,
                               const int32_t *starts_v,
                               const float *coeffs_v, int widest_v,
                               const int32_t *starts_h,
                               const float *coeffs_h, int widest_h,
                               int vertical_first, int alpha_weighted) {
    if (vertical_first && in_h > 0 && out_h > 0 && widest_v > 0) {
        // Measured on the 4K kitty-size leg (one-core Xeon): blocked
        // scatter 64 ms, tiled gather 87 ms (the gather's ~4x window
        // re-conversion outweighs its acc-tile L1 residency even with
        // the AVX2 converter).  The knob keeps the A/B reproducible.
        const char *ex = getenv("TIMG_TPU_RESIZE_EXEC");
        if (ex && strcmp(ex, "gather") == 0)
            return resize_polyphase_vfirst_gather(
                in, in_pitch, src_rgb, batch, in_h, in_w, out, out_h,
                out_w, starts_v, coeffs_v, widest_v, starts_h, coeffs_h,
                widest_h, alpha_weighted);
        int monotonic = 1;
        for (int o = 1; o < out_h; ++o)
            if (starts_v[o] < starts_v[o - 1]) {
                monotonic = 0;
                break;
            }
        if (monotonic) {
            const long rc = resize_polyphase_vfirst_scatter(
                in, in_pitch, src_rgb, batch, in_h, in_w, out, out_h,
                out_w, starts_v, coeffs_v, widest_v, starts_h, coeffs_h,
                widest_h, alpha_weighted);
            if (rc != -2) return rc;  // -2: fall through to the ring
        }
    }
    const int ch = alpha_weighted ? 8 : 4;
    // Ring rows: raw input width when vertical-first, resampled output
    // width when horizontal-first.
    const long ring_floats =
        (vertical_first ? (long)in_w : (long)out_w) * ch;
    const int ring_n = widest_v > 0 ? widest_v : 1;
    float *ring = (float *)malloc((size_t)ring_n * ring_floats *
                                  sizeof(float));
    int *ring_idx = (int *)malloc((size_t)ring_n * sizeof(int));
    // Scratch: one staged input float row (horizontal-first needs it as
    // the resample source), one combined row, one final float row.
    float *stage_row =
        (float *)malloc((size_t)in_w * ch * sizeof(float));
    const long comb_floats = ring_floats;
    float *comb_row = (float *)malloc((size_t)comb_floats * sizeof(float));
    float *final_row =
        (float *)malloc((size_t)out_w * ch * sizeof(float));
    if (!ring || !ring_idx || !stage_row || !comb_row || !final_row) {
        free(ring);
        free(ring_idx);
        free(stage_row);
        free(comb_row);
        free(final_row);
        return -1;
    }
    const float *rows[512];
    std::vector<const float *> rows_heap;
    const float **rowsp = rows;
    if (ring_n > 512) {
        rows_heap.resize((size_t)ring_n);
        rowsp = rows_heap.data();
    }
    for (int b = 0; b < batch; ++b) {
        const uint8_t *src = in + (long)b * in_h * in_pitch;
        uint8_t *dst = out + (long)b * (long)out_h * out_w * 4;
        for (int s = 0; s < ring_n; ++s) ring_idx[s] = -1;
        for (int o = 0; o < out_h; ++o) {
            const float *cfv = coeffs_v + (long)o * widest_v;
            // Prepare the widest_v source rows this output row needs.
            for (int t = 0; t < widest_v; ++t) {
                const int idx = clip_int(starts_v[o] + t, 0, in_h - 1);
                const int slot = idx % ring_n;
                float *rslot = ring + (long)slot * ring_floats;
                if (ring_idx[slot] != idx) {
                    const uint8_t *in_row = src + (long)idx * in_pitch;
                    if (vertical_first) {
                        row_to_float_src(in_row, src_rgb, rslot, in_w, ch,
                                         alpha_weighted);
                    } else {
                        row_to_float_src(in_row, src_rgb, stage_row, in_w,
                                         ch, alpha_weighted);
                        resample_horizontal(stage_row, rslot, 1, in_w,
                                            out_w, ch, starts_h, coeffs_h,
                                            widest_h);
                    }
                    ring_idx[slot] = idx;
                }
                rowsp[t] = rslot;
            }
            if (vertical_first) {
                combine_rows(comb_row, rowsp, cfv, widest_v, ring_floats);
                resample_horizontal(comb_row, final_row, 1, in_w, out_w,
                                    ch, starts_h, coeffs_h, widest_h);
                row_repack(final_row, dst + (long)o * out_w * 4, out_w, ch,
                           alpha_weighted);
            } else {
                combine_rows(comb_row, rowsp, cfv, widest_v, ring_floats);
                row_repack(comb_row, dst + (long)o * out_w * 4, out_w, ch,
                           alpha_weighted);
            }
        }
    }
    free(ring);
    free(ring_idx);
    free(stage_row);
    free(comb_row);
    free(final_row);
    return 0;
}

long timg_resize_polyphase(const uint8_t *in, int batch, int in_h, int in_w,
                           uint8_t *out, int out_h, int out_w,
                           const int32_t *starts_v, const float *coeffs_v,
                           int widest_v, const int32_t *starts_h,
                           const float *coeffs_h, int widest_h,
                           int vertical_first, int alpha_weighted) {
    return timg_resize_polyphase_src(
        in, (long)in_w * 4, /*src_rgb=*/0, batch, in_h, in_w, out, out_h,
        out_w, starts_v, coeffs_v, widest_v, starts_h, coeffs_h, widest_h,
        vertical_first, alpha_weighted);
}

}  // extern "C"
