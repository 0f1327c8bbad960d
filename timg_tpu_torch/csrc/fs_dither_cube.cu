// Floyd-Steinberg dither, one wavefront driver for all five dithers of
// the port, templated on its quantizer (the 6x7x6 cube, a median-cut
// tree, or libsixel's per-frame bucket table), whose arithmetic policy
// comes with it (f32 error mixes, or libsixel's integer shares), and on
// its pixel source (pitched int32 RGBA words, or [B, H, W, C] bytes).
//
// Replaces the TPU kernels of timg_tpu/ops/sixel_pallas3.py:
//   K6 fs_dither_cube_fused (_make_wavefront_kernel + _make_fs_kernel),
//   K7 fs_dither_tree_fused (the same wavefront + _make_fs_tree_kernel),
//   K8 fs_dither_table_fused (_make_wavefront_kernel_int +
//      _make_fs_table_kernel; numpy specification
//      timg_tpu/ops/libsixel_quant.py apply_palette_bucket_table),
//   K3 _skewT, K4 _transpose_bwd and K5 _unskewT;
// of timg_tpu/ops/sixel_pallas.py:
//   K9 fs_dither_cube_pallas (3-channel bytes, cube quantizer), whose
//   XLA skew, 128-row padding and 16-column blocking are layout only;
// and the XLA scan timg_tpu/ops/sixel.py _fs_dither_tree_impl (the tree
// quantizer on 3-channel bytes, the library API's adaptive mode).
// The layout kernels existed only to give the TPU's 128-lane vector
// unit a skewed, transposed column stream; here the skew is indexing:
// at step t, row y handles x = t - 2y.  The byte source reads each
// pixel's first three channels in place.
//
// What bounds it on the H100.  The recurrence is serial: row y at step t
// needs row y-1's carries from step t-1, so a frame takes w + 2(h-1)
// dependent steps (2,718 at 720x1280) whatever the card; the bytes (4 B
// in, 1 B out a pixel) are a few percent of the time.  So the time is
// steps x one step's latency, and a step's latency is set by
//   * its dependent chain: about 15 f32 operations and one shuffle for
//     the cube; the tree adds its descent (4 dependent shared-memory
//     loads, below); the table its four truncated shares with clamps and
//     two dependent shared-memory loads (bucket, then palette);
//   * anything else that waits on that chain: a device-memory load, a
//     block-wide barrier, a fence, a carry through memory;
//   * the issue rate: a warp issues ~125 instructions a step (cube), and
//     warps that share an SM's four schedulers add up.  Measured (PERF.md
//     §6, PR 6), a lone warp takes 0.10-0.12 us a step and B=32 0.22-0.25:
//     the issue rate, not the chain, is what is left.
//
// Layout (ops/sixel_kernel.py plan_bands says how many of each):
//   * a warp owns 32 consecutive rows, one a lane;
//   * a block ("band") holds `warps` consecutive warps of one frame, and
//     a frame takes `bands` blocks, so a frame's rows spread over SMs
//     (about 132 / B blocks a frame, of at least 4 warps);
//   * each block takes a ticket from a per-launch counter (zeroed on the
//     stream before the launch) and maps it to (frame, band) so that band
//     j of a frame always has a later ticket than band j-1: a block only
//     ever waits on a block that is already running, whatever order the
//     hardware starts blocks in, so no cooperative launch is needed;
//     a quantizer with per-frame tables (the bucket table) loads them
//     once the ticket has named the frame.
// The step loop, per warp:
//   * a warp steps only from t = 2 y_first (its first row's first pixel;
//     a chunk earlier where lane 0 needs the row above's older carries,
//     as libsixel's shares do) to 2 y_last + w (its last row at x = w,
//     whose carry the row below still reads), in chunks of kChunk steps
//     unrolled so that every register ring index is a constant; a lane
//     whose row has no pixel at a step computes with carry 0;
//   * pixels come off the chain: each lane loads its row's pixels for the
//     next chunk while it computes this one;
//   * no block barrier and no fence: lane i takes lane i-1's three
//     carries from the step before by __shfl_up_sync; lane 0 takes row
//     y_first-1's carries from the warp above, which lane 31 there writes
//     a step at a time as self-validating carries (Carry below), and
//     which lanes 0..kChunk-1 here read a chunk at a time and lane 0 takes
//     by __shfl_sync:
//       - inside a block, a ring of kRing steps in shared memory; the
//         reader publishes how far it has read, and the writer waits only
//         when the ring is full;
//       - at a band edge, an array in device memory as long as the steps
//         (the writer never waits);
//       the reader loads the carries two chunks ahead and checks their
//       flags when it reaches them (reloading a chunk that was not there
//       yet), so the hand-off's latency, shared memory's or L2's, adds a
//       fixed lag an edge, not a wait every chunk;
//   * no branch inside a step: stores are predicated, so the shuffles
//     need no reconvergence (ptxas otherwise wraps each in a collective);
//   * carries for steps past the writer's last are never needed: they
//     reach only lanes whose x is already past w (whose carry is 0);
//   * u8 indices of a row gather into aligned 32-bit words (a byte store
//     a step per lane would be 32 transactions a warp a step).
// PERF.md §6 records the steps that led here: release/acquire flags,
// the conversion unit and collective shuffles each cost time; the first
// table kernel, one block a frame with a barrier every step, took 4x the
// f32 driver's time.
//
// Arithmetic.  f32 (K6, K7, K9, byte tree; F32Mix below) is the
// reference's f32 sequence exactly (sixel_pallas3.py:282-297, 315-330;
// numpy mirror sixel_np.py:132-184):
//   mix = (e1*(3/16) + e2*(5/16)) + e3*(1/16)   (the carry handed down)
//   v   = clip(col + (e1*(7/16) + mix_above), 0, 255)
//   cube: q = rint(v * f32((n-1)/255));  chosen = rint(q * f32(255/(n-1)))
//   tree: chosen = the leaf color of rint(v)'s descent (TreeQuant)
//   err = v - chosen (0 outside 0 <= x < w)
// with __fmul_rn/__fadd_rn so nvcc cannot contract any pair into an FMA;
// rint (round half to even, like jnp.round) is the exact x + 2^23 - 2^23
// of the FMA pipe, and the byte <-> float steps are exact bit moves
// (plus23 and chan below), so no conversion instruction runs.
// int32 (K8; IntShares below; sixel_pallas3.py:440-443, 511-519,
// 561-592): the carry handed down is the raw offset; the row below
// keeps the last three it received (its pixels x+1, x, x-1 above) and
// adds, in source-raster order, each add followed by a clamp to
// [0, 255]: + up_left*1/16, + up*5/16, + up_right*3/16, + left*7/16,
// where a*n/16 is C division (truncation toward zero);
//   key = (v0 >> 3) << 10 | (v1 >> 3) << 5 | (v2 >> 3);  idx = table[key]
//   offset = v - palette[idx] per channel (0 off the image, and 0 in a
//   frame whose diffuse flag is 0: it still writes indices).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;   // warps a block: 512 threads, <= 128 registers
constexpr int kMaxRows = 4096;  // rows a frame (128 warps)
constexpr int kChunk = 8;       // steps a chunk (ops/sixel_kernel.py CHUNK)
constexpr int kRing = 64;       // steps a shared warp-edge ring holds
static_assert((kRing & (kRing - 1)) == 0 && kRing > 2 * kChunk &&
              kRing % kChunk == 0, "ring");
static_assert(64 % kChunk == 0, "warps' chunks must align across edges");

constexpr float kTwo23 = 8388608.0f;

// Exact integer <-> float steps without the conversion unit (whose rate
// is a quarter of the FMA pipe's and whose latency sits on the chain):
// byte c of a word, as a float: the byte placed under the exponent of
// 2^23, minus 2^23.
__device__ __forceinline__ float chan(uint32_t word, int c) {
  const uint32_t w23 = __byte_perm(word, 0x4B000000u, 0x7440 | c);
  return __fsub_rn(__uint_as_float(w23), kTwo23);
}

// x + 2^23 for 0 <= x < 2^22: x rounded to an integer, half to even (as
// rintf and jnp.round), held in the low mantissa bits; rint23 takes it
// back to a float (exactly), int23 to an int.
__device__ __forceinline__ float plus23(float x) {
  return __fadd_rn(x, kTwo23);
}
__device__ __forceinline__ float rint23(float t) {
  return __fsub_rn(t, kTwo23);
}
__device__ __forceinline__ int int23(float t) {
  return __float_as_int(t) - 0x4B000000;
}

// Arithmetic policies: per lane, the state a row keeps between its
// steps, how a channel's value v comes from its pixel byte and the
// carry of the row above (from the step before), and what the row hands
// down after the quantizer has chosen a color.  A carry travels as its
// 32-bit pattern (bits / of_bits).

// f32 errors (K6, K7, K9, byte tree): the row hands down its premixed
// error mix = (e1*(3/16) + e2*(5/16)) + e3*(1/16).
struct F32Mix {
  using T = float;
  static constexpr int kLead = 0;  // the carries lane 0 needs start at x = 0
  float e1[3] = {}, e2[3] = {}, e3[3] = {};
  __device__ __forceinline__ static uint32_t bits(float v) {
    return __float_as_uint(v);
  }
  __device__ __forceinline__ static float of_bits(uint32_t u) {
    return __uint_as_float(u);
  }
  __device__ __forceinline__ float value(int c, uint32_t word, float above) {
    const float in = __fadd_rn(__fmul_rn(e1[c], 7.0f / 16.0f), above);
    return fminf(fmaxf(__fadd_rn(chan(word, c), in), 0.0f), 255.0f);
  }
  __device__ __forceinline__ float carry(int c, bool keep, float v,
                                         float color) {
    e3[c] = e2[c];
    e2[c] = e1[c];
    e1[c] = keep ? __fsub_rn(v, color) : 0.0f;
    return __fadd_rn(__fadd_rn(__fmul_rn(e1[c], 3.0f / 16.0f),
                               __fmul_rn(e2[c], 5.0f / 16.0f)),
                     __fmul_rn(e3[c], 1.0f / 16.0f));
  }
};

// libsixel's integer shares (K8): the row hands down its raw offset; the
// row below keeps the last three it received, u1 (its x+1 above), u2
// (x) and u3 (x-1), and adds each share truncated, with a clamp after
// each add.  Lane 0's u2 at its first pixel is the row above's offset of
// the step two before, so a warp starts a chunk early (kLead).
__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

struct IntShares {
  using T = int;
  static constexpr int kLead = kChunk;
  int u1[3] = {}, u2[3] = {}, u3[3] = {}, left[3] = {};
  __device__ __forceinline__ static uint32_t bits(int v) { return (uint32_t)v; }
  __device__ __forceinline__ static int of_bits(uint32_t u) { return (int)u; }
  __device__ __forceinline__ int value(int c, uint32_t word, int above) {
    u3[c] = u2[c];
    u2[c] = u1[c];
    u1[c] = above;
    int a = (int)__byte_perm(word, 0u, 0x4440 | c);
    a = clamp255(a + u3[c] * 1 / 16);
    a = clamp255(a + u2[c] * 5 / 16);
    a = clamp255(a + u1[c] * 3 / 16);
    return clamp255(a + left[c] * 7 / 16);
  }
  __device__ __forceinline__ int carry(int c, bool keep, int v, int color) {
    left[c] = keep ? v - color : 0;
    return left[c];
  }
};

// Quantizers.  Each maps a clipped value 0 <= v[3] <= 255 (its policy's
// type) to a palette index and the palette color the error is taken
// against; `load` stages its tables in shared memory before the steps
// (kPerFrame: the tables of frame f, loaded once the ticket names it);
// `diffuses` says whether frame f hands its errors on.

// K6's 6x7x6 cube: q = rint(v * (n-1)/255), color = rint(q * 255/(n-1)).
struct CubeQuant {
  using Arith = F32Mix;
  static constexpr int kTableInts = 0;
  static constexpr bool kPerFrame = false;
  __device__ __forceinline__ void load(int*, int, int, int) const {}
  __device__ __forceinline__ bool diffuses(int) const { return true; }
  __device__ __forceinline__ int quantize(const int*, const float v[3],
                                          float color[3]) const {
    const float step[3] = {(float)(5 / 255.0), (float)(6 / 255.0),
                           (float)(5 / 255.0)};
    const float inv[3] = {(float)(255.0 / 5), (float)(255.0 / 6),
                          (float)(255.0 / 5)};
    int idx = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float q = plus23(__fmul_rn(v[c], step[c]));
      // q * 51 is an exact integer (red, blue): its rint is itself
      const float qc = __fmul_rn(rint23(q), inv[c]);
      color[c] = c == 1 ? rint23(plus23(qc)) : qc;
      idx = idx * (c == 1 ? 7 : 6) + int23(q);
    }
    return idx;
  }
};

// K7's balanced median-cut tree (timg_tpu/ops/sixel_np.py
// median_cut_tree): levels[d][node] = axis << 8 | thr, descend right
// iff rint(v[axis]) > thr; leaves[node] = idx << 24 | r << 16 | g << 8 | b.
// The TPU folded pairs of levels into 4-way tables (_quad_tables) for its
// lane gather.  Here `load` turns each node into a pair {mask, thr'} =
// {0xFF << 8 axis, thr << 8 axis} in shared memory, so that a node's test
// on the packed rint(v) bytes q is one AND and one compare, (q & mask) >
// thr'; the descent takes two levels a round, loading a node and both its
// children together, so 4 dependent shared-memory loads pick the leaf
// instead of 8.  The partition is the same.
constexpr int kTreeDepth = 8;
constexpr int kTreeLevelNodes = 128;

struct TreeQuant {
  using Arith = F32Mix;
  static constexpr int kTableInts = 2 * kTreeDepth * kTreeLevelNodes
                                    + (1 << kTreeDepth);
  static constexpr bool kPerFrame = false;
  const int32_t* levels;  // [8, 128] in device memory
  const int32_t* leaves;  // [256]
  __device__ __forceinline__ bool diffuses(int) const { return true; }
  __device__ __forceinline__ void load(int* tab, int, int tid,
                                       int nth) const {
    for (int i = tid; i < kTreeDepth * kTreeLevelNodes; i += nth) {
      const int word = levels[i], shift = 8 * min(word >> 8, 2);
      tab[2 * i] = 0xFF << shift;
      tab[2 * i + 1] = (word & 0xFF) << shift;
    }
    for (int i = tid; i < (1 << kTreeDepth); i += nth)
      tab[2 * kTreeDepth * kTreeLevelNodes + i] = leaves[i];
  }
  __device__ __forceinline__ int quantize(const int* tab, const float v[3],
                                          float color[3]) const {
    // rint(v[c]) sits in the low byte of plus23(v[c]) (its next two bytes
    // are 0): pack the three as q = r | g << 8 | b << 16
    const uint32_t r = __float_as_uint(plus23(v[0]));
    const uint32_t g = __float_as_uint(plus23(v[1]));
    const uint32_t b = __float_as_uint(plus23(v[2]));
    const int q = (int)__byte_perm(__byte_perm(r, g, 0x2240), b, 0x2410);
    const int2* nodes = reinterpret_cast<const int2*>(tab);
    int node = 0;
#pragma unroll
    for (int d = 0; d < kTreeDepth; d += 2) {
      const int2 a = nodes[d * kTreeLevelNodes + node];
      const int4 kids = reinterpret_cast<const int4*>(
          nodes + (d + 1) * kTreeLevelNodes)[node];
      const int right = (q & a.x) > a.y;
      const int2 kid = right ? make_int2(kids.z, kids.w)
                             : make_int2(kids.x, kids.y);
      node = 4 * node + 2 * right + ((q & kid.x) > kid.y);
    }
    const uint32_t leaf = tab[2 * kTreeDepth * kTreeLevelNodes + node];
    color[0] = chan(leaf, 2);
    color[1] = chan(leaf, 1);
    color[2] = chan(leaf, 0);
    return leaf >> 24;
  }
};

// K8's libsixel bucket table: a frame's 32,768-byte table of nearest
// palette indices by 15-bit key, and its 256 palette words 0xRRGGBB, in
// shared memory, so the lookup is two dependent shared-memory loads (the
// TPU needed a lane gather over [64, B, 128] packed words and a 6-level
// select for it).
constexpr int kBuckets = 1 << 15;
constexpr int kPalette = 256;

struct TableQuant {
  using Arith = IntShares;
  static constexpr int kTableInts = kBuckets / 4 + kPalette;
  static constexpr bool kPerFrame = true;
  const uint8_t* tables;   // [b, 32768]
  const int32_t* palette;  // [b, 256]
  const int32_t* diffuse;  // [b], 0: palette only
  __device__ __forceinline__ bool diffuses(int f) const {
    return diffuse[f] != 0;
  }
  __device__ __forceinline__ void load(int* tab, int f, int tid,
                                       int nth) const {
    const uint8_t* src = tables + (int64_t)f * kBuckets;
    if (((uintptr_t)src & 15) == 0) {
      for (int i = tid; i < kBuckets / 16; i += nth)
        reinterpret_cast<int4*>(tab)[i] = reinterpret_cast<const int4*>(src)[i];
    } else {
      for (int i = tid; i < kBuckets; i += nth)
        reinterpret_cast<uint8_t*>(tab)[i] = src[i];
    }
    for (int i = tid; i < kPalette; i += nth)
      tab[kBuckets / 4 + i] = palette[(int64_t)f * kPalette + i];
  }
  __device__ __forceinline__ int quantize(const int* tab, const int v[3],
                                          int color[3]) const {
    const int key = (v[0] >> 3) << 10 | (v[1] >> 3) << 5 | (v[2] >> 3);
    const int idx = reinterpret_cast<const uint8_t*>(tab)[key];
    const int pw = tab[kBuckets / 4 + idx];
    color[0] = (pw >> 16) & 0xFF;
    color[1] = (pw >> 8) & 0xFF;
    color[2] = pw & 0xFF;
    return idx;
  }
};

// Pixel sources: how element i of a row of ``stride``-byte elements
// becomes one RGB word (r | g << 8 | b << 16).  They hold no data: the
// kernel takes the base pointer and the pitches as plain parameters (a
// source passed as a struct spilled in PR 3's kernel).

// int32 RGBA words (K6/K7's input); stride 4, known at compile time.
struct WordPixels {
  static constexpr int kStride = 4;
  __device__ __forceinline__ static int32_t load(const uint8_t* row, int x,
                                                 int) {
    return reinterpret_cast<const int32_t*>(row)[x];
  }
};

// uint8 pixels of stride >= 3 channels (K9's input); channels past the
// third are never read.  The stride comes at run time.
struct RgbPixels {
  static constexpr int kStride = 0;
  __device__ __forceinline__ static int32_t load(const uint8_t* row, int x,
                                                 int stride) {
    const uint8_t* p = row + (int64_t)x * stride;
    return (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
  }
};

// Carries between warps, with no fence: each step's three mixes travel as
// two 16-byte words {m0, f, m1, f} and {m2, f, 0, f} whose flag f is the
// step + 1.  An aligned 8-byte half is written whole, so a reader that
// finds the flag beside a value has that step's value (the scheme of
// NCCL's low-latency protocol); the buffers start zeroed (flag 0).
struct Carry {
  uint4 a, b;
};

// Loads into v if `on` (else v keeps its value); predicated, as below.
__device__ __forceinline__ void ld_volatile(const uint4* p, uint4& v,
                                            bool on) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
               "@p ld.volatile.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
               : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
               : "l"(p), "r"((int)on));
}

// Stores v if `on`, predicated inside the asm: no branch around it, so
// the warp stays converged for the shuffles of the step loop.
__device__ __forceinline__ void st_volatile(uint4* p, uint4 v, bool on) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
               "@p st.volatile.v4.u32 [%0], {%1, %2, %3, %4};\n\t}"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
               "r"((int)on));
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  asm volatile("st.volatile.b32 [%0], %1;" ::"l"(p), "r"(v));
}

// Where a warp's top carries come from and its bottom carries go.
enum Edge { kNone = 0, kShared = 1, kGlobal = 2 };

// One launch: frames [b] of h x w, as b * bands blocks of warps * 32
// threads.  sync[0] is the ticket counter; edges [b][bands-1][edge_len]
// the carries of band j's last warp of frame f, by step (zeroed).
template <typename Pixels, typename Quant, typename OutT>
__global__ void __launch_bounds__(kMaxWarps * 32)
fs_dither(const uint8_t* __restrict__ pixels, int b, int h, int w,
          int pitch_h, int pitch_w, int stride, Quant quant,
          OutT* __restrict__ out, int bands, int* sync, Carry* edges,
          int edge_len) {
  using Arith = typename Quant::Arith;
  using T = typename Arith::T;
  // [Quant::kTableInts] tables, then per warp k the ring of its top edge
  // [kRing] Carry, then per warp k the steps it has read from that ring
  extern __shared__ __align__(16) int smem[];
  __shared__ int ticket;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* tab = smem;
  Carry* rings = reinterpret_cast<Carry*>(smem + Quant::kTableInts);
  int* consumed = reinterpret_cast<int*>(rings + warps * kRing);
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  if (!Quant::kPerFrame) quant.load(tab, 0, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < warps * kRing * 8; i += blockDim.x)
    reinterpret_cast<int*>(rings)[i] = 0;
  __syncthreads();
  const int band = ticket / b, f = ticket % b;
  if (Quant::kPerFrame) quant.load(tab, f, threadIdx.x, blockDim.x);
  const int y0 = (band * warps + warp) * 32;  // the warp's first row
  // the first step: lane 0's first pixel, or kLead steps before it where
  // it needs older carries of the row above (none above row 0)
  const int t_begin = y0 == 0 ? 0 : 2 * y0 - Arith::kLead;
  if (lane == 0) consumed[warp] = t_begin - 1;  // the first step it reads
  __syncthreads();
  if (y0 >= h) return;
  if (Pixels::kStride) stride = Pixels::kStride;
  // 4-channel bytes on 4-byte boundaries load as one word a pixel
  const bool as_words = !Pixels::kStride && stride == 4 &&
                        ((uintptr_t)pixels & 3) == 0;
  const bool diffuses = quant.diffuses(f);

  const int y = y0 + lane;
  const bool row_ok = y < h;
  const int row_w = row_ok ? w : 0;       // x < row_w: a pixel of the row
  const int t_stop = 2 * min(y0 + 31, h - 1) + w + 1;
  const int prod_stop = 2 * y0 - 1 + w;   // the warp above's t_stop
  const int64_t row = (int64_t)f * h + (row_ok ? y : 0);
  const uint8_t* src = pixels
      + ((int64_t)f * pitch_h + (row_ok ? y : 0)) * pitch_w * stride;
  OutT* dst = out + row * w;
  const int skew = (int)(row * w & 3);    // u8 out: the row's first byte % 4

  // the top edge: none (row 0), the ring of warp-1, or band-1's array;
  // the bottom edge: none (no row below), ring warp+1, or band+1's array
  const Edge top = y0 == 0 ? kNone : (warp == 0 ? kGlobal : kShared);
  const Edge sink = y0 + 32 >= h ? kNone
                                 : (warp == warps - 1 ? kGlobal : kShared);
  const Carry* top_src = top == kGlobal
      ? edges + (int64_t)(f * (bands - 1) + band - 1) * edge_len
      : rings + warp * kRing;
  const int top_mask = top == kGlobal ? -1 : kRing - 1;  // step -> slot
  Carry* out_dst = sink == kGlobal
      ? edges + (int64_t)(f * (bands - 1) + band) * edge_len
      : rings + (warp + 1) * kRing;
  const int out_mask = sink == kGlobal ? -1 : kRing - 1;
  const int sink_len = sink == kGlobal ? edge_len : INT_MAX;

  Arith arith;
  T up[3], above[3];               // carries: lane i-1's, the top edge's
#pragma unroll
  for (int c = 0; c < 3; ++c) up[c] = above[c] = 0;
  int32_t pa[kChunk], pb[kChunk];  // this lane's pixels, two chunks
  Carry ra = {}, rb = {};          // lane k < kChunk: a top carry, raw
  uint32_t packed = 0;             // u8 out: bytes of the current word
  int seen_out = 0;

  // Lane k < kChunk loads the top carry of step s0 + k (no wait: the
  // flags say later whether it was there yet).
  auto issue = [&](Carry& r, int s0) {
    const int s = s0 + lane;
    const bool on = lane < kChunk && (top == kShared || s < edge_len);
    ld_volatile(&top_src[s & top_mask].a, r.a, on);
    ld_volatile(&top_src[s & top_mask].b, r.b, on);
  };
  // Wait until every lane k < kChunk holds the carry of step s0 + k
  // (steps from the producer's last on are never needed), then unpack it
  // into `above`; a ring's reader then frees the chunk's slots.
  auto settle = [&](Carry& r, int s0) {
    const int s = s0 + lane;
    const unsigned f1 = s + 1;
    auto ok = [&] {
      return lane >= kChunk || s >= prod_stop ||
             (r.a.y == f1 && r.a.w == f1 && r.b.y == f1 && r.b.w == f1);
    };
    while (!__all_sync(0xffffffffu, ok())) issue(r, s0);
    above[0] = Arith::of_bits(r.a.x);
    above[1] = Arith::of_bits(r.a.z);
    above[2] = Arith::of_bits(r.b.x);
    if (top == kShared && lane == 0)
      st_volatile(&consumed[warp], s0 + kChunk);
  };
  auto load_pixels = [&](int32_t (&p)[kChunk], int t0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int x = t0 + k - 2 * y;
      p[k] = (unsigned)x >= (unsigned)row_w ? 0
             : as_words ? WordPixels::load(src, x, 4)
                        : Pixels::load(src, x, stride);
    }
  };

  // the top carries are loaded two chunks ahead, while the chunk before
  // computes, and checked when reached: the hand-off's latency then adds
  // a fixed lag an edge instead of a wait every chunk
  load_pixels(pa, t_begin);
  if (top != kNone) {
    issue(ra, t_begin - 1);
    issue(rb, t_begin + kChunk - 1);
  }
  // two chunks an iteration, so that the register rings swap roles at
  // compile time: a chunk of steps t0 .. t0 + kChunk - 1 runs from pixels
  // p and top carries r, and fetches the next chunk's pixels into np
  for (int t2 = t_begin; t2 < t_stop; t2 += 2 * kChunk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t0 = t2 + half * kChunk;
      auto& r = half ? rb : ra;
      auto& p = half ? pb : pa;
      auto& np = half ? pa : pb;
      if (top != kNone) {
        settle(r, t0 - 1);
        issue(r, t0 + 2 * kChunk - 1);
      }
      load_pixels(np, t0 + kChunk);
      if (sink == kShared) {  // the ring's slots for this chunk must be free
        while (seen_out < t0 + kChunk - kRing)
          seen_out = __shfl_sync(0xffffffffu,
                                 ld_volatile(&consumed[warp + 1]), 31);
      }
      // a chunk's slots are consecutive (kRing is a multiple of kChunk)
      Carry* out_chunk = &out_dst[t0 & out_mask];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int t = t0 + k, x = t - 2 * y;
        const bool valid = (unsigned)x < (unsigned)row_w;
        T v[3], color[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T top_carry = __shfl_sync(0xffffffffu, above[c], k);
          v[c] = arith.value(c, (uint32_t)p[k],
                             lane == 0 ? top_carry : up[c]);
        }
        const int idx = quant.quantize(tab, v, color);
        if constexpr (sizeof(OutT) == 1) {
          // bytes of a row gather into aligned words; a word that is not
          // all inside the row (its ends) is stored a byte at a time
          const int pos = (skew + x) & 3;
          packed = pos == 0 ? (uint32_t)idx
                            : packed | ((uint32_t)idx << (8 * pos));
          const bool inside = x >= pos && x + 3 - pos < w;
          if (valid && inside && pos == 3)
            *reinterpret_cast<uint32_t*>(dst + x - 3) = packed;
          if (valid && !inside) dst[x] = (OutT)idx;
        } else {
          if (valid) dst[x] = (OutT)idx;
        }
        T mix[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          mix[c] = arith.carry(c, valid && diffuses, v[c], color[c]);
          up[c] = __shfl_up_sync(0xffffffffu, mix[c], 1);
        }
        // lane 31 hands its carries to the warp below (a ring's slot or
        // the band edge's array; sink_len bounds the array)
        const unsigned f1 = t + 1;
        const bool hand = lane == 31 && sink != kNone && t < sink_len;
        Carry* c = out_chunk + k;
        st_volatile(&c->a, make_uint4(Arith::bits(mix[0]), f1,
                                      Arith::bits(mix[1]), f1), hand);
        st_volatile(&c->b, make_uint4(Arith::bits(mix[2]), f1, 0u, f1),
                    hand);
      }
    }
}

// The pixel source of a launch: base pointer, pitches, element stride.
struct Source {
  const void* pixels;
  int pitch_h, pitch_w, stride;
};

// The band plan of a launch (ops/sixel_kernel.py plan_bands) and its
// scratch, zeroed on the stream: sync [1] int32, the ticket counter, and
// edges [b * (bands-1) * edge_len] Carry (unused when bands == 1).
struct Bands {
  int bands, warps;
  void* sync;
  void* edges;
  int edge_len;
};

// Dynamic shared memory of a block of `warps` warps (ops/sixel_kernel.py
// block_smem_bytes).
template <typename Quant>
size_t smem_bytes(int warps) {
  return (size_t)Quant::kTableInts * sizeof(int)
         + (size_t)warps * (kRing * sizeof(Carry) + sizeof(int));
}

template <typename Pixels, typename Quant, typename OutT>
int launch(Source src, int b, int h, int w, Quant quant, OutT* out,
           Bands plan, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const int rows = plan.bands * plan.warps * 32;
  if (h > kMaxRows || plan.warps < 1 || plan.warps > kMaxWarps ||
      plan.bands < 1 || rows < h || rows - plan.warps * 32 >= h ||
      plan.sync == nullptr ||
      (plan.bands > 1 &&
       (plan.edges == nullptr || plan.edge_len < w + 2 * h + 4 * kChunk)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<Quant>(plan.warps);
  if (smem > 48 * 1024) {  // the bucket table: opt in above the default
    const cudaError_t err = cudaFuncSetAttribute(
        fs_dither<Pixels, Quant, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fs_dither<Pixels, Quant, OutT>
      <<<b * plan.bands, plan.warps * 32, smem, stream>>>(
          (const uint8_t*)src.pixels, b, h, w, src.pitch_h, src.pitch_w,
          src.stride, quant, out, plan.bands, (int*)plan.sync,
          (Carry*)plan.edges, plan.edge_len);
  return (int)cudaGetLastError();
}

template <typename Pixels, typename Quant>
int launch_out(Source src, int b, int h, int w, Quant quant, void* out,
               int out_u8, Bands plan, void* stream) {
  if (out_u8)
    return launch<Pixels>(src, b, h, w, quant, (uint8_t*)out, plan,
                          (cudaStream_t)stream);
  return launch<Pixels>(src, b, h, w, quant, (int32_t*)out, plan,
                        (cudaStream_t)stream);
}

}  // namespace

// Each entry takes, after its data arguments, the band plan: bands and
// warps (ops/sixel_kernel.py plan_bands), sync and edges (scratch as in
// Bands above) and edge_len (>= w + 2h + 32).
//
// words: [b, pitch_h, pitch_w] int32 RGBA words, valid extent h x w.
// out: [b, h, w] uint8 (out_u8) or int32 palette indices.
extern "C" int timg_fs_dither_cube(const void* words, int b, int h, int w,
                                   int pitch_h, int pitch_w, void* out,
                                   int out_u8, int bands, int warps,
                                   void* sync, void* edges, int edge_len,
                                   void* stream) {
  return launch_out<WordPixels>(Source{words, pitch_h, pitch_w, 4}, b, h, w,
                                CubeQuant{}, out, out_u8,
                                Bands{bands, warps, sync, edges, edge_len},
                                stream);
}

// levels: [8, 128] int32, leaves: [256] int32 (one tree for the batch).
extern "C" int timg_fs_dither_tree(const void* words, int b, int h, int w,
                                   int pitch_h, int pitch_w,
                                   const void* levels, const void* leaves,
                                   void* out, int out_u8, int bands,
                                   int warps, void* sync, void* edges,
                                   int edge_len, void* stream) {
  return launch_out<WordPixels>(
      Source{words, pitch_h, pitch_w, 4}, b, h, w,
      TreeQuant{(const int32_t*)levels, (const int32_t*)leaves}, out, out_u8,
      Bands{bands, warps, sync, edges, edge_len}, stream);
}

// rgb: [b, pitch_h, pitch_w, channels] uint8 (channels >= 3), valid
// extent h x w; out as above.  K9's contract.
extern "C" int timg_fs_dither_cube_rgb(const void* rgb, int b, int h, int w,
                                       int pitch_h, int pitch_w,
                                       int channels, void* out, int out_u8,
                                       int bands, int warps, void* sync,
                                       void* edges, int edge_len,
                                       void* stream) {
  if (channels < 3) return (int)cudaErrorInvalidValue;
  return launch_out<RgbPixels>(Source{rgb, pitch_h, pitch_w, channels}, b, h,
                               w, CubeQuant{}, out, out_u8,
                               Bands{bands, warps, sync, edges, edge_len},
                               stream);
}

extern "C" int timg_fs_dither_tree_rgb(const void* rgb, int b, int h, int w,
                                       int pitch_h, int pitch_w,
                                       int channels, const void* levels,
                                       const void* leaves, void* out,
                                       int out_u8, int bands, int warps,
                                       void* sync, void* edges, int edge_len,
                                       void* stream) {
  if (channels < 3) return (int)cudaErrorInvalidValue;
  return launch_out<RgbPixels>(
      Source{rgb, pitch_h, pitch_w, channels}, b, h, w,
      TreeQuant{(const int32_t*)levels, (const int32_t*)leaves}, out, out_u8,
      Bands{bands, warps, sync, edges, edge_len}, stream);
}

// words as above; tables: [b, 32768] uint8; pal_words: [b, 256] int32
// 0xRRGGBB; diffuse: [b] int32 (0 = palette only).  K8's contract.
extern "C" int timg_fs_dither_table(const void* words, int b, int h, int w,
                                    int pitch_h, int pitch_w,
                                    const void* tables, const void* pal_words,
                                    const void* diffuse, void* out,
                                    int out_u8, int bands, int warps,
                                    void* sync, void* edges, int edge_len,
                                    void* stream) {
  return launch_out<WordPixels>(
      Source{words, pitch_h, pitch_w, 4}, b, h, w,
      TableQuant{(const uint8_t*)tables, (const int32_t*)pal_words,
                 (const int32_t*)diffuse},
      out, out_u8, Bands{bands, warps, sync, edges, edge_len}, stream);
}

extern "C" int timg_fs_dither_cube_max_rows() { return kMaxRows; }

// Warps a block at most, and steps a chunk (checked by the wrapper
// against ops/sixel_kernel.py MAX_WARPS and CHUNK).
extern "C" int timg_fs_dither_max_warps() { return kMaxWarps; }
extern "C" int timg_fs_dither_chunk() { return kChunk; }

// Shared memory of a block of `warps` warps with quantizer 0 (cube),
// 1 (tree) or 2 (table) (checked by the wrapper against
// ops/sixel_kernel.py block_smem_bytes).
extern "C" int timg_fs_dither_smem_bytes(int quant, int warps) {
  return (int)(quant == 0   ? smem_bytes<CubeQuant>(warps)
               : quant == 1 ? smem_bytes<TreeQuant>(warps)
                            : smem_bytes<TableQuant>(warps));
}
