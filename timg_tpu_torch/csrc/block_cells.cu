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
// cells give the bytes of the reference's float32 arithmetic (ref
// unicode-block-canvas.cc:154-227, framebuffer.h:138-200): the 8
// candidates are scanned in its order from best = 1e12, a candidate
// replacing the best only when strictly better, and the scan stops at
// the first new best below 1.  Half cells take the raw pixels.
//
// Bound on the H100: instruction issue.  A quarter cell reads 16 B and
// writes 10 B (the diff's second read of the frame before hits L2), but
// does a few hundred float operations, each its own instruction: no
// product and sum of the reference is contracted into an FMA
// (__fmul_rn / __fadd_rn in its order).  What the design does about it
// does not change a bit of the result:
// - the sums of linear colors are integers below 2^24 (squares of
//   bytes), exact in float32 in any order, so a 3-pixel sum is the
//   4-pixel total less the fourth pixel;
// - a pair's avd is exactly half the squared distance of the pair
//   (pair_cost), the pixels sitting symmetrically about their average;
// - /3 is a reciprocal product with one residual correction (div_n),
//   the root an approximate one rounded and corrected (root): no slow
//   path of __fdiv_rn / __fsqrt_rn;
// - each candidate's cost is computed only when the scan reaches it,
//   and the colors only for the chosen candidate, from the sums of the
//   pixels it averages (kFgMasks), so a flat cell stops after one;
// - a thread takes two adjacent cells (a row's last alone where the row
//   holds an odd number), which halves the index and address arithmetic
//   a cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kTransparent = 0x60;   // is_transparent(): a < 0x60
constexpr int kBackground = 0, kLowerBlock = 7, kUpperBlock = 8;
constexpr float kThird = 1.0f / 3.0f;     // rounded to nearest

struct Lin {
  float r, g, b, a;
};

// byte c of w as a float: the bits of 2^23 + byte, less 2^23 (exact)
__device__ __forceinline__ float byte_f(uint32_t w, int c) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + c)),
                   8388608.0f);
}

// LinearColor: rgb -> c*c, alpha as it is
__device__ __forceinline__ Lin lin(uint32_t w) {
  const float r = byte_f(w, 0), g = byte_f(w, 1), b = byte_f(w, 2);
  return {__fmul_rn(r, r), __fmul_rn(g, g), __fmul_rn(b, b), byte_f(w, 3)};
}

// Sums of linear colors: integers below 2^24, so exact in any order.
__device__ __forceinline__ Lin add(const Lin& x, const Lin& y) {
  return {__fadd_rn(x.r, y.r), __fadd_rn(x.g, y.g), __fadd_rn(x.b, y.b),
          __fadd_rn(x.a, y.a)};
}

__device__ __forceinline__ Lin sub(const Lin& x, const Lin& y) {
  return {__fsub_rn(x.r, y.r), __fsub_rn(x.g, y.g), __fsub_rn(x.b, y.b),
          __fsub_rn(x.a, y.a)};
}

__device__ __forceinline__ Lin scale(const Lin& x, float s) {
  return {__fmul_rn(x.r, s), __fmul_rn(x.g, s), __fmul_rn(x.b, s),
          __fmul_rn(x.a, s)};
}

// The correctly rounded s / n of an integer s in [0, 195075] for n = 1,
// 2, 3 or 4, inv = 1/n rounded: the product with the reciprocal, then
// one correction by the exact residual s - q*n.  For n = 1, 2, 4 the
// product is exact and the residual 0.  For n = 3 it equals __fdiv_rn
// on every integer of the domain (sums of three squares of bytes, or of
// alphas), as tests/test_torch_kernels.py checks on all of them
// (test_block_kernel_division_is_exact_on_every_sum).  The
// FMAs here are the division's algorithm, not a contraction of the
// reference's arithmetic.
__device__ __forceinline__ float div_n(float s, float n, float inv) {
  const float q = __fmul_rn(s, inv);
  return __fmaf_rn(__fmaf_rn(-q, n, s), inv, q);
}

__device__ __forceinline__ Lin div3(const Lin& x) {
  return {div_n(x.r, 3.0f, kThird), div_n(x.g, 3.0f, kThird),
          div_n(x.b, 3.0f, kThird), div_n(x.a, 3.0f, kThird)};
}

// (d0*d0 + d1*d1) + d2*d2 (ref framebuffer.h:145-148)
__device__ __forceinline__ float sq3(float d0, float d1, float d2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// the distance of v to avg, d = v - avg
__device__ __forceinline__ float dist(const Lin& avg, const Lin& v) {
  return sq3(__fsub_rn(v.r, avg.r), __fsub_rn(v.g, avg.g),
             __fsub_rn(v.b, avg.b));
}

// avd over 3 or 4 linear colors (ref framebuffer.h:177-194): the
// distances to the average, summed left to right
__device__ __forceinline__ float avd3(const Lin& m, const Lin& x,
                                      const Lin& y, const Lin& z) {
  return __fadd_rn(__fadd_rn(dist(m, x), dist(m, y)), dist(m, z));
}
__device__ __forceinline__ float avd4(const Lin& m, const Lin& w,
                                      const Lin& x, const Lin& y,
                                      const Lin& z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(dist(m, w), dist(m, x)), dist(m, y)),
                   dist(m, z));
}

// The square distance of a pair, e = x - y (exact: integers).  With m =
// (x + y) * 0.5 exact, x - m = e / 2 and y - m = -e / 2 are exact too,
// so the reference's avd2(x, y) = 2 * sq3(e / 2) = sq3(e) * 0.5 bit for
// bit (scaling by powers of 2 commutes with rounding), and a candidate
// of two pairs costs (E1 + E2) * 0.5.
__device__ __forceinline__ float pair_sq(const Lin& x, const Lin& y) {
  return sq3(__fsub_rn(x.r, y.r), __fsub_rn(x.g, y.g), __fsub_rn(x.b, y.b));
}
__device__ __forceinline__ float pair_cost(float e1, float e2) {
  return __fmul_rn(__fadd_rn(e1, e2), 0.5f);
}

// (uint8)min(sqrtf(v), 255) for v >= 0: the nearest integer k to an
// approximate root, less one where k*k > v, is floor(sqrt(floor(v)))
// whenever the approximation is within 0.5 of the root.  That equals the
// truncated correctly rounded root on every value the repack is fed (a
// pixel's square, m*0.5, m*0.25, rn(m/3) of integer sums m): these stay
// at least 1/510 below any n*n (timg_tpu/ops/exact.py:24-36), as
// tests/test_torch_kernels.py checks on all 390,151 of them
// (test_block_kernel_root_is_exact_on_the_repack_lattice).
__device__ __forceinline__ uint32_t root(float v) {
  float s;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(v));
  float k = rintf(s);
  if (__fmul_rn(k, k) > v) k = __fsub_rn(k, 1.0f);
  return (uint32_t)fminf(k, 255.0f);
}

// LinearColor::repack of the average sum / n: the root of each color
// channel, the alpha average truncated
__device__ __forceinline__ uint32_t repack(const Lin& sum, int n) {
  const float nf = (float)n;
  const float inv = n == 3 ? kThird : (n == 4 ? 0.25f : (n == 2 ? 0.5f
                                                                 : 1.0f));
  const uint32_t r = root(div_n(sum.r, nf, inv));
  const uint32_t g = root(div_n(sum.g, nf, inv));
  const uint32_t b = root(div_n(sum.b, nf, inv));
  const uint32_t a = (uint32_t)div_n(sum.a, nf, inv);
  return r | (g << 8) | (b << 16) | (a << 24);
}

// The pixels each candidate's fg averages, 4 bits a candidate (tl 1, tr
// 2, bl 4, br 8; ref :207-218): 0 all four, 1-4 the one pixel, 5 the
// left bar, 6 the diagonal, 7 the lower half (the upper with
// use_upper).  Its bg averages the other pixels, all four for 0.
constexpr uint32_t kFgMasks = 0xC958421Fu, kFgMasksUpper = 0x3958421Fu;
constexpr uint32_t kTop = 0x3, kBottom = 0xC;

__device__ __forceinline__ Lin pick(uint32_t m, const Lin& tl, const Lin& tr,
                                    const Lin& bl, const Lin& br) {
  const Lin z = {0.0f, 0.0f, 0.0f, 0.0f};
  return add(add(add(m & 1 ? tl : z, m & 2 ? tr : z), m & 4 ? bl : z),
             m & 8 ? br : z);
}

// The reference's scan (ref :198-225): a candidate replaces the best
// only when strictly better; take() is true where the scan stops.
struct Scan {
  float best = 1e12f;
  int chosen = 0;
  __device__ __forceinline__ bool take(int k, float cost) {
    if (!(cost < best)) return false;
    best = cost;
    chosen = k;
    return cost < 1.0f;
  }
};

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

struct CellOut {
  uint32_t glyph, fg, bg;
};

// One quarter cell from its four words.
__device__ __forceinline__ CellOut quarter_cell(uint32_t tl_w, uint32_t tr_w,
                                                uint32_t bl_w, uint32_t br_w,
                                                int use_upper) {
  const Lin tl = lin(tl_w), tr = lin(tr_w), bl = lin(bl_w), br = lin(br_w);
  const Lin total = add(add(add(tl, tr), bl), br);

  // transparency overrides, in the order bottom, top, all (ref :182-191):
  // where one applies, it alone decides the outputs
  const bool top_t = transparent(tl_w) && transparent(tr_w);
  const bool bot_t = transparent(bl_w) && transparent(br_w);
  Scan scan;
  if (!top_t && !bot_t) {
    // the candidates in the reference's switch order (ref :207-218),
    // each cost computed only when the scan reaches it
    scan.take(0, avd4(scale(total, 0.25f), tl, tr, bl, br))
        || scan.take(1, avd3(div3(sub(total, tl)), tr, bl, br))
        || scan.take(2, avd3(div3(sub(total, tr)), tl, bl, br))
        || scan.take(3, avd3(div3(sub(total, bl)), tl, tr, br))
        || scan.take(4, avd3(div3(sub(total, br)), tl, tr, bl))
        || scan.take(5, pair_cost(pair_sq(tr, br), pair_sq(tl, bl)))
        || scan.take(6, pair_cost(pair_sq(tr, bl), pair_sq(tl, br)))
        || scan.take(7, pair_cost(pair_sq(tl, tr), pair_sq(bl, br)));
  }
  const int k = scan.chosen;
  int glyph = k == 7 ? (use_upper ? kUpperBlock : kLowerBlock) : k;
  uint32_t fm = ((use_upper ? kFgMasksUpper : kFgMasks) >> (4 * k)) & 0xF;
  if (bot_t) {
    glyph = kUpperBlock;
    fm = kTop;
  }
  if (top_t) {
    glyph = kLowerBlock;
    fm = kBottom;
  }
  const Lin fg_sum = pick(fm, tl, tr, bl, br);
  const int fn = __popc(fm);
  uint32_t fg_w = repack(fg_sum, fn);
  uint32_t bg_w = fn == 4 ? fg_w : repack(sub(total, fg_sum), 4 - fn);
  if (bot_t) bg_w = bl_w;
  if (top_t) bg_w = tl_w;
  if (top_t && bot_t) {
    glyph = kBackground;
    fg_w = bl_w;
  }
  return {(uint32_t)glyph, fg_w, bg_w};
}

// The two words of row r under the cell at word x (x even), in one
// 8-byte load (tw is even, so every row starts 8-byte aligned); zeros
// for a blank row.
__device__ __forceinline__ uint2 load_cell_row(const int32_t* frame, int r,
                                               int tw, int x) {
  if (r < 0 || frame == nullptr) return make_uint2(0, 0);
  return *reinterpret_cast<const uint2*>(frame + (int64_t)r * tw + x);
}

// Two adjacent quarter cells a thread.  Where a row holds an odd number
// of cells, its last thread loads its one cell twice and stores it
// once.  The words of the frame before, for the diff, load beside the
// cells' own.
__global__ void __launch_bounds__(kThreads)
quarter_cells(const int32_t* __restrict__ words,
              const int32_t* __restrict__ prev, int th, int tw, int h2,
              int top, int use_upper, uint8_t* __restrict__ glyph_out,
              int32_t* __restrict__ fg_out, int32_t* __restrict__ bg_out,
              uint8_t* __restrict__ eq_out) {
  const int wc = tw / 2, pairs = (wc + 1) / 2;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= h2 * pairs) return;
  const int i = blockIdx.y;
  const int cr = idx / pairs, c0 = 2 * (idx - cr * pairs);
  const int n = min(2, wc - c0);
  const int64_t frame_words = (int64_t)th * tw;
  const int32_t* frame = words + i * frame_words;
  const int32_t* p = eq_out != nullptr ? before(words, prev, i, frame_words)
                                       : nullptr;
  const Cell rows = cell_rows(cr, top, th);
  uint2 t[2], u[2], pt[2], pu[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int x = 2 * (c0 + min(j, n - 1));
    t[j] = load_cell_row(frame, rows.r0, tw, x);
    u[j] = load_cell_row(frame, rows.r1, tw, x);
    pt[j] = load_cell_row(p, rows.r0, tw, x);
    pu[j] = load_cell_row(p, rows.r1, tw, x);
  }
  const int64_t o = ((int64_t)i * h2 + cr) * wc + c0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const CellOut c = quarter_cell(t[j].x, t[j].y, u[j].x, u[j].y,
                                   use_upper);
    if (j >= n) break;
    glyph_out[o + j] = (uint8_t)c.glyph;
    fg_out[o + j] = (int32_t)c.fg;
    bg_out[o + j] = (int32_t)c.bg;
    if (eq_out != nullptr) {
      eq_out[o + j] = (uint8_t)(pt[j].x == t[j].x && pt[j].y == t[j].y
                                && pu[j].x == u[j].x && pu[j].y == u[j].y);
    }
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

// row_threads: the threads of one row of cells
int launch(CellKernel kernel, int row_threads, const void* words,
           const void* prev, int b, int th, int tw, int use_upper,
           void* glyph, void* fg, void* bg, void* eq, void* stream) {
  if (b <= 0 || th <= 0 || tw <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const int h2 = (th + 1) / 2;
  const int top = (th % 2 && !use_upper) ? 1 : 0;
  const int64_t threads = (int64_t)h2 * row_threads;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads),
                  (unsigned)b);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)prev, th, tw, h2, top,
      use_upper, (uint8_t*)glyph, (int32_t*)fg, (int32_t*)bg,
      (uint8_t*)eq);
  return (int)cudaGetLastError();
}

}  // namespace

// words: [b, th, tw] int32, contiguous and 8-byte aligned (tw even);
// prev: [th, tw] int32, 8-byte aligned, or null (blank); glyph, eq:
// [b, h2, tw / 2] uint8 (eq may be null, no diff); fg, bg: [b, h2,
// tw / 2] int32; h2 = ceil(th / 2).
extern "C" int timg_quarter_cells(const void* words, const void* prev, int b,
                                  int th, int tw, int use_upper, void* glyph,
                                  void* fg, void* bg, void* eq,
                                  void* stream) {
  if (tw % 2) return (int)cudaErrorInvalidValue;
  return launch(quarter_cells, (tw / 2 + 1) / 2, words, prev, b, th, tw,
                use_upper, glyph, fg, bg, eq, stream);
}

// As timg_quarter_cells with [b, h2, tw] outputs: one cell a column.
extern "C" int timg_half_cells(const void* words, const void* prev, int b,
                               int th, int tw, int use_upper, void* glyph,
                               void* fg, void* bg, void* eq, void* stream) {
  return launch(half_cells, tw, words, prev, b, th, tw, use_upper, glyph, fg,
                bg, eq, stream);
}
