// Unicode block cells: glyph argmin, colors and window diff.
//
// Replaces timg_tpu/ops/blocks.py quarter_blocks (:82) and half_blocks
// (:185) with timg_tpu/ops/diff.py window_cell_diff (:20), which the JAX
// package left to XLA (one fused pass; no Pallas kernel), as its block
// video window runs them: on the resized window of [B, th, tw] int32
// RGBA words (R | G << 8 | B << 16 | A << 24), with an odd height padded
// by a blank (all-zero, so transparent) row on top, or at the bottom
// with use_upper, and frame 0 diffed against the previous window's last
// frame.  Neither the pad row nor the tail is materialized: a thread
// reads its cell's words by index and takes 0 for a row outside the
// frame, and frame i's diff reads frame i - 1 (frame 0 reads the tail,
// or blank words without one).
//
// One thread owns one cell: 2x2 pixels (quarter) or 1x2 (half).
// Outputs a cell: glyph (uint8), fg and bg (int32 words) and, when
// asked, eq (uint8: every pixel equal to the frame before).  Quarter
// cells take the reference's arithmetic (ref unicode-block-canvas.cc:
// 154-227, framebuffer.h:138-200) in float32 in its order: every
// product and sum is __fmul_rn / __fadd_rn, so nvcc contracts nothing
// into an FMA; /3 is __fdiv_rn and /2, /4 the exact multiplies by 0.5
// and 0.25; the repack is (uint8)min(__fsqrt_rn(v), 255) for rgb and
// the truncation of the f32 alpha average.  The 8 candidates are scanned
// in the reference's order from best = 1e12, a candidate replacing the
// best only when strictly better, and the scan stops at the first new
// best below 1.  Half cells take the raw pixels, no color math.
//
// Bound on the H100, by count: device-memory bytes (16 B read and 10 B
// written a quarter cell; the diff's second read of the frame before
// hits L2) over about 400 float operations.  In practice quarter cells
// are issue-bound: each correctly rounded division and root is a
// sequence of instructions with a slow path, 16 and 6 of them a cell.
// The design is the simple exact one: coalesced 8-byte loads of a
// cell's row pairs, the argmin in registers, each candidate's colors
// recomputed only for the chosen one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kTransparent = 0x60;   // is_transparent(): a < 0x60
constexpr int kBackground = 0, kLowerBlock = 7, kUpperBlock = 8;

struct Lin {
  float r, g, b, a;
};

__device__ __forceinline__ Lin lin(uint32_t w) {
  const float r = (float)(w & 0xFF), g = (float)((w >> 8) & 0xFF),
              b = (float)((w >> 16) & 0xFF), a = (float)(w >> 24);
  return {__fmul_rn(r, r), __fmul_rn(g, g), __fmul_rn(b, b), a};
}

__device__ __forceinline__ Lin add(const Lin& x, const Lin& y) {
  return {__fadd_rn(x.r, y.r), __fadd_rn(x.g, y.g), __fadd_rn(x.b, y.b),
          __fadd_rn(x.a, y.a)};
}

__device__ __forceinline__ Lin scale(const Lin& x, float s) {
  return {__fmul_rn(x.r, s), __fmul_rn(x.g, s), __fmul_rn(x.b, s),
          __fmul_rn(x.a, s)};
}

__device__ __forceinline__ Lin div3(const Lin& x) {
  return {__fdiv_rn(x.r, 3.0f), __fdiv_rn(x.g, 3.0f), __fdiv_rn(x.b, 3.0f),
          __fdiv_rn(x.a, 3.0f)};
}

// (d0*d0 + d1*d1) + d2*d2 with d = v - avg (ref framebuffer.h:145-148)
__device__ __forceinline__ float dist(const Lin& avg, const Lin& v) {
  const float d0 = __fsub_rn(v.r, avg.r), d1 = __fsub_rn(v.g, avg.g),
              d2 = __fsub_rn(v.b, avg.b);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// avd over 2, 3 or 4 linear colors: the average and the distances to
// it, both summed left to right (ref framebuffer.h:177-194)
__device__ __forceinline__ Lin avg2(const Lin& x, const Lin& y) {
  return scale(add(x, y), 0.5f);
}
__device__ __forceinline__ float avd2(const Lin& x, const Lin& y) {
  const Lin m = avg2(x, y);
  return __fadd_rn(dist(m, x), dist(m, y));
}
__device__ __forceinline__ Lin avg3(const Lin& x, const Lin& y,
                                    const Lin& z) {
  return div3(add(add(x, y), z));
}
__device__ __forceinline__ float avd3(const Lin& x, const Lin& y,
                                      const Lin& z) {
  const Lin m = avg3(x, y, z);
  return __fadd_rn(__fadd_rn(dist(m, x), dist(m, y)), dist(m, z));
}
__device__ __forceinline__ Lin avg4(const Lin& w, const Lin& x, const Lin& y,
                                    const Lin& z) {
  return scale(add(add(add(w, x), y), z), 0.25f);
}
__device__ __forceinline__ float avd4(const Lin& w, const Lin& x,
                                      const Lin& y, const Lin& z) {
  const Lin m = avg4(w, x, y, z);
  return __fadd_rn(__fadd_rn(__fadd_rn(dist(m, w), dist(m, x)), dist(m, y)),
                   dist(m, z));
}

// LinearColor::repack: (uint8)min(sqrtf(v), 255) a color channel, the
// alpha average truncated
__device__ __forceinline__ uint32_t repack(const Lin& c) {
  const uint32_t r = (uint32_t)fminf(__fsqrt_rn(c.r), 255.0f);
  const uint32_t g = (uint32_t)fminf(__fsqrt_rn(c.g), 255.0f);
  const uint32_t b = (uint32_t)fminf(__fsqrt_rn(c.b), 255.0f);
  const uint32_t a = (uint32_t)c.a;
  return r | (g << 8) | (b << 16) | (a << 24);
}

// Row `row` of the padded frame as the words' row: the blank pad row,
// and any row outside the frame, reads as -1 (blank).
__device__ __forceinline__ int word_row(int row, int top, int th) {
  const int r = row - top;
  return (r >= 0 && r < th) ? r : -1;
}

struct Cell {
  int r0, r1;   // words rows of the cell's two pixel rows, -1 if blank
};

__device__ __forceinline__ Cell cell_rows(int cr, int top, int th) {
  return {word_row(2 * cr, top, th), word_row(2 * cr + 1, top, th)};
}

// two adjacent words of one row (8-byte aligned: tw and x are even)
__device__ __forceinline__ uint2 load2(const int32_t* frame, int r, int tw,
                                       int x) {
  if (r < 0 || frame == nullptr) return make_uint2(0, 0);
  return *reinterpret_cast<const uint2*>(frame + (int64_t)r * tw + x);
}

__device__ __forceinline__ uint32_t load1(const int32_t* frame, int r,
                                          int tw, int x) {
  if (r < 0 || frame == nullptr) return 0;
  return (uint32_t)frame[(int64_t)r * tw + x];
}

__device__ __forceinline__ bool transparent(uint32_t w) {
  return (w >> 24) < kTransparent;
}

// The frame before frame i of the window: frame i - 1, or the tail.
__device__ __forceinline__ const int32_t* before(const int32_t* words,
                                                 const int32_t* prev, int i,
                                                 int64_t frame_words) {
  return i > 0 ? words + (i - 1) * frame_words : prev;
}

__global__ void __launch_bounds__(kThreads)
quarter_cells(const int32_t* __restrict__ words,
              const int32_t* __restrict__ prev, int th, int tw, int h2,
              int top, int use_upper, uint8_t* __restrict__ glyph_out,
              int32_t* __restrict__ fg_out, int32_t* __restrict__ bg_out,
              uint8_t* __restrict__ eq_out) {
  const int wc = tw / 2;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= h2 * wc) return;
  const int i = blockIdx.y;
  const int cr = idx / wc, cc = idx - cr * wc;
  const int64_t frame_words = (int64_t)th * tw;
  const int32_t* frame = words + i * frame_words;
  const Cell rows = cell_rows(cr, top, th);
  const uint2 t = load2(frame, rows.r0, tw, 2 * cc);
  const uint2 u = load2(frame, rows.r1, tw, 2 * cc);
  const uint32_t tl_w = t.x, tr_w = t.y, bl_w = u.x, br_w = u.y;
  const Lin tl = lin(tl_w), tr = lin(tr_w), bl = lin(bl_w), br = lin(br_w);

  // the candidates' costs in the reference's switch order (ref :207-218)
  float cost[8];
  cost[0] = avd4(tl, tr, bl, br);
  cost[1] = avd3(tr, bl, br);
  cost[2] = avd3(tl, bl, br);
  cost[3] = avd3(tl, tr, br);
  cost[4] = avd3(tl, tr, bl);
  cost[5] = __fadd_rn(avd2(tr, br), avd2(tl, bl));
  cost[6] = __fadd_rn(avd2(tr, bl), avd2(tl, br));
  cost[7] = use_upper ? __fadd_rn(avd2(bl, br), avd2(tl, tr))
                      : __fadd_rn(avd2(tl, tr), avd2(bl, br));
  float best = 1e12f;
  int chosen = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (cost[k] < best) {
      best = cost[k];
      chosen = k;
      if (cost[k] < 1.0f) break;
    }
  }

  Lin fg, bg;
  switch (chosen) {
    case 0: fg = bg = avg4(tl, tr, bl, br); break;
    case 1: fg = tl; bg = avg3(tr, bl, br); break;
    case 2: fg = tr; bg = avg3(tl, bl, br); break;
    case 3: fg = bl; bg = avg3(tl, tr, br); break;
    case 4: fg = br; bg = avg3(tl, tr, bl); break;
    case 5: fg = avg2(tl, bl); bg = avg2(tr, br); break;
    case 6: fg = avg2(tl, br); bg = avg2(tr, bl); break;
    default:
      fg = use_upper ? avg2(tl, tr) : avg2(bl, br);
      bg = use_upper ? avg2(bl, br) : avg2(tl, tr);
  }
  int glyph = chosen == 7 ? (use_upper ? kUpperBlock : kLowerBlock) : chosen;
  uint32_t fg_w = repack(fg), bg_w = repack(bg);

  // transparency overrides, in the order bottom, top, all (ref :182-191)
  const bool top_t = transparent(tl_w) && transparent(tr_w);
  const bool bot_t = transparent(bl_w) && transparent(br_w);
  if (bot_t) {
    glyph = kUpperBlock;
    fg_w = repack(avg2(tl, tr));
    bg_w = bl_w;
  }
  if (top_t) {
    glyph = kLowerBlock;
    fg_w = repack(avg2(bl, br));
    bg_w = tl_w;
  }
  if (top_t && bot_t) {
    glyph = kBackground;
    fg_w = bl_w;
    bg_w = tl_w;
  }
  const int64_t o = (int64_t)i * h2 * wc + idx;
  glyph_out[o] = (uint8_t)glyph;
  fg_out[o] = (int32_t)fg_w;
  bg_out[o] = (int32_t)bg_w;
  if (eq_out != nullptr) {
    const int32_t* p = before(words, prev, i, frame_words);
    const uint2 pt = load2(p, rows.r0, tw, 2 * cc);
    const uint2 pu = load2(p, rows.r1, tw, 2 * cc);
    eq_out[o] = (uint8_t)(pt.x == t.x && pt.y == t.y && pu.x == u.x
                          && pu.y == u.y);
  }
}

__global__ void __launch_bounds__(kThreads)
half_cells(const int32_t* __restrict__ words,
           const int32_t* __restrict__ prev, int th, int tw, int h2,
           int top, int use_upper, uint8_t* __restrict__ glyph_out,
           int32_t* __restrict__ fg_out, int32_t* __restrict__ bg_out,
           uint8_t* __restrict__ eq_out) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= h2 * tw) return;
  const int i = blockIdx.y;
  const int cr = idx / tw, cc = idx - cr * tw;
  const int64_t frame_words = (int64_t)th * tw;
  const int32_t* frame = words + i * frame_words;
  const Cell rows = cell_rows(cr, top, th);
  const uint32_t t = load1(frame, rows.r0, tw, cc);
  const uint32_t b = load1(frame, rows.r1, tw, cc);
  // ref unicode-block-canvas.cc:165-171: equal pixels, or both
  // transparent, make a background cell of (top, bottom)
  const bool is_bg = t == b || (transparent(t) && transparent(b));
  const int64_t o = (int64_t)i * h2 * tw + idx;
  glyph_out[o] = (uint8_t)(is_bg ? kBackground
                                 : (use_upper ? kUpperBlock : kLowerBlock));
  fg_out[o] = (int32_t)((is_bg || use_upper) ? t : b);
  bg_out[o] = (int32_t)((is_bg || use_upper) ? b : t);
  if (eq_out != nullptr) {
    const int32_t* p = before(words, prev, i, frame_words);
    eq_out[o] = (uint8_t)(load1(p, rows.r0, tw, cc) == t
                          && load1(p, rows.r1, tw, cc) == b);
  }
}

using CellKernel = void (*)(const int32_t*, const int32_t*, int, int, int,
                            int, int, uint8_t*, int32_t*, int32_t*,
                            uint8_t*);

int launch(CellKernel kernel, int cell_w, const void* words,
           const void* prev, int b, int th, int tw, int use_upper,
           void* glyph, void* fg, void* bg, void* eq, void* stream) {
  if (b <= 0 || th <= 0 || tw <= 0) return 0;
  if (b > 65535 || tw % cell_w) return (int)cudaErrorInvalidValue;
  const int h2 = (th + 1) / 2;
  const int top = (th % 2 && !use_upper) ? 1 : 0;
  const int64_t cells = (int64_t)h2 * (tw / cell_w);
  const dim3 grid((unsigned)((cells + kThreads - 1) / kThreads),
                  (unsigned)b);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)prev, th, tw, h2, top,
      use_upper, (uint8_t*)glyph, (int32_t*)fg, (int32_t*)bg,
      (uint8_t*)eq);
  return (int)cudaGetLastError();
}

}  // namespace

// words: [b, th, tw] int32, contiguous (tw even); prev: [th, tw] int32
// or null (blank); glyph, eq: [b, h2, tw / 2] uint8 (eq may be null, no
// diff); fg, bg: [b, h2, tw / 2] int32; h2 = ceil(th / 2).
extern "C" int timg_quarter_cells(const void* words, const void* prev, int b,
                                  int th, int tw, int use_upper, void* glyph,
                                  void* fg, void* bg, void* eq,
                                  void* stream) {
  return launch(quarter_cells, 2, words, prev, b, th, tw, use_upper, glyph,
                fg, bg, eq, stream);
}

// As timg_quarter_cells with [b, h2, tw] outputs: one cell a column.
extern "C" int timg_half_cells(const void* words, const void* prev, int b,
                               int th, int tw, int use_upper, void* glyph,
                               void* fg, void* bg, void* eq, void* stream) {
  return launch(half_cells, 1, words, prev, b, th, tw, use_upper, glyph, fg,
                bg, eq, stream);
}
