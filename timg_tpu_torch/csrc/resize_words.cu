// Video resize of RGBA-packed int32 words: both separable passes in one
// fused tile kernel, the bf16 intermediate kept in shared memory.
//
// Replaces the TPU kernels timg_tpu/ops/resize_pallas.py
// resize_video_words_pallas (K1) and resize_video_words_pallas_tiled (K2).
// On the TPU the passes were banded bf16 matmuls on the MXU inside one
// strip kernel whose input window had to fit VMEM (hence the row-tiled
// variant for 4K-class inputs).  Here one launch covers every geometry:
// the tile planner (ops/resize.py plan_tiles) shrinks the tile until its
// mid tile fits shared memory.
//
// Arithmetic, held byte-equal to the JAX package's CPU path
// (timg_tpu/ops/resize.py resize_video_words; the plain version is
// ops/resize.py resize_video_words_plain):
//   * channels unpacked from the word (chan23 below; exact);
//   * taps are bf16 (round-to-nearest-even from the f32 band matrix,
//     folded edge duplicates summed first), values are bf16; output o
//     reads inputs starts[o] .. starts[o] + T - 1 (compact tables, no
//     FLOP spent on the band matrix's zeros);
//   * each product of two bf16 values is exact in f32, so only the
//     order of the f32 sums matters: it is XLA:CPU's dot order (dot3n
//     below; ops/resize.py says how it was found); every product and sum
//     is rounded on its own (__fmaf_rn of an exact product, __fadd_rn),
//     so nothing is contracted or reordered;
//   * the first pass rounds its result to bf16 (__float2bfloat16_rn);
//   * the second pass adds 0.5, clips to [0, 255], truncates, and packs
//     r | g << 8 | b << 16 | 0xFF000000.
// The pass order (vertical or horizontal first) is the caller's, taken
// from stb's cost heuristic as the reference CPU path does.
//
// Bound on the H100: device-memory bytes.  Each input word read once and
// each output word written once: a 32-frame 1080p -> 720x1280 window is
// 265 MB in and 118 MB out, 383 MB or 0.114 ms at 3.35 TB/s; the work is
// a few FLOPs a byte, far below the tensor cores' break-even, and the
// f32 sums' fixed order keeps them off the tensor cores anyway.  So the
// design moves nothing else through HBM:
//   * one launch a resize; a block owns a rows x cols tile of one frame's
//     output words (grid: tile column, tile row, frame; 32-bit indices);
//   * vertical-first, the block first copies the input rows and columns
//     its taps read into shared memory with 16-byte cp.async (coalesced;
//     about 20% halo at 1080p -> 720x1280, mostly from L2);
//   * it fills a mid tile in shared memory (f32 values rounded to bf16,
//     so the second pass reads them without unpacking): vertical-first,
//     its rows
//     over the window of input columns its columns' taps read (a warp
//     takes runs of one mid row, whose taps are then the warp's own);
//     horizontal-first, the window of input rows its rows' taps read over
//     its columns (read from global memory; neighbouring taps hit L1);
//   * the second pass reads only shared memory and writes one output word
//     a thread, neighbouring threads on neighbouring words;
//   * a thread sums up to kSpan outputs that share one start and one tap
//     row together (dot3n), and the reference order's block ends are
//     computed once an output, not tested every tap.
// Measured (PERF.md), it is not the bytes that bound it: with the
// taps left out it still takes half its time, and the tap loops, at
// about 12 instructions a tap of an output for 3 channels, the other
// half; the SM issues well below its peak in both.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;     // ops/resize.py TILE_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kOrderBlock = 32;   // inputs a block of the reference order
constexpr int kSpan = 4;          // outputs a thread sums together
constexpr int kMinBlocks = 3;     // blocks an SM: lets ptxas use 80 registers

constexpr float kTwo23 = 8388608.0f;

// Channel c of a word, plus 2^23, as a float: the byte placed under the
// exponent of 2^23 (one instruction, exact).  A tap (w, -w * 2^23) turns
// it into the exact product w * byte with one fused multiply-add (see
// dot3n).
__device__ __forceinline__ float chan23(int32_t word, int c) {
  return __uint_as_float(
      __byte_perm((uint32_t)word, 0x4B000000u, 0x7440 | c));
}

// N outputs of a banded filter for 3 channels that share their start s
// and taps: out[j] = sum over t < T of w_t * value_j(s + t), each product
// fma(w_t, load, c_t) for the tap taps[t * stride] = (w_t, c_t): where the
// load is 2^23 + byte, c_t = -w_t * 2^23 and the fma's one rounding gives
// the exact product w_t * byte (at most 16 significant bits); where the
// load is the value itself, c_t = 0 and it gives the rounded product as
// __fmul_rn does.  (A zero product may come out +0 instead of -0; added
// to a sum that is never -0, it changes nothing.)  The sums run
// in the reference dot's order over the input index k = s + t: within
// each block of 32 inputs, even and odd k go to two ascending sums; at a
// block's end its (even + odd) joins the running total.  So the taps fall
// into runs that end where k crosses a multiple of 32: the first at
// t = 32 - s % 32 (ops/resize.py first_flush), then every 32 taps.  Two
// floats add the same in either order, so within a run the two sums may
// be told apart by the tap's offset from the run's start rather than by
// the parity of k.  Each run is a plain loop over pairs of taps; no tap
// is tested, and the run bounds and each tap's load are shared by the N
// outputs.  load(j, t, v) gives the three values of output j's tap t.
template <int N, class Load>
__device__ __forceinline__ void dot3n(const Load& load, int s,
                                      const float2* taps, int stride, int T,
                                      float out[N][3]) {
  float total[N][3], a[N][3], b[N][3];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) total[j][c] = a[j][c] = b[j][c] = 0.0f;
  auto run = [&](int t, int end) {
    for (; t + 1 < end; t += 2) {
      const float2 w0 = taps[t * stride], w1 = taps[(t + 1) * stride];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v0[3], v1[3];
        load(j, t, v0);
        load(j, t + 1, v1);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a[j][c] = __fadd_rn(a[j][c], __fmaf_rn(w0.x, v0[c], w0.y));
          b[j][c] = __fadd_rn(b[j][c], __fmaf_rn(w1.x, v1[c], w1.y));
        }
      }
    }
    if (t < end) {
      const float2 w0 = taps[t * stride];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v0[3];
        load(j, t, v0);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          a[j][c] = __fadd_rn(a[j][c], __fmaf_rn(w0.x, v0[c], w0.y));
      }
    }
  };
  int t = min(kOrderBlock - s % kOrderBlock, T);
  run(0, t);
  for (; t < T; t += kOrderBlock) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        total[j][c] = __fadd_rn(total[j][c], __fadd_rn(a[j][c], b[j][c]));
        a[j][c] = b[j][c] = 0.0f;
      }
    run(t, min(t + kOrderBlock, T));
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[j][c] = __fadd_rn(total[j][c], __fadd_rn(a[j][c], b[j][c]));
}

// f(std::integral_constant<int, m>) with m = min(n, kSpan) for a
// run-time n >= 1 (the same across a warp), so that each count of
// outputs gets its own unguarded code.
template <class F>
__device__ __forceinline__ void with_count(int n, const F& f) {
  static_assert(kSpan == 4, "with_count covers 1 .. 4");
  switch (min(n, kSpan)) {
    case 4: f(std::integral_constant<int, 4>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    default: f(std::integral_constant<int, 1>()); break;
  }
}

// The first pass's rounding: to bf16, kept as the float it equals.
__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Add 0.5, clip to [0, 255], truncate, pack with alpha 255.
__device__ __forceinline__ int32_t pack_word(const float v[3]) {
  int32_t packed = (int32_t)0xFF000000u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q = fminf(fmaxf(__fadd_rn(v[c], 0.5f), 0.0f), 255.0f);
    packed |= ((int32_t)q) << (8 * c);
  }
  return packed;
}

// Staged row pitch: the window plus up to 3 words in front (its start
// rounded down to 16 bytes), rounded up to 32 words.  A warp's last run
// of 32 columns may read past a row's end, into the next row or the tap
// tables behind the buffer: shared memory of the block, whose values go
// nowhere.
__host__ __device__ inline int pitch(int mid_n) {
  return (mid_n + 3 + 31) / 32 * 32;
}

// Shared memory of a block, in the order the kernel carves it (and
// ops/resize.py tile_smem_regions lists it), each region aligned for its
// use: the staged input words [stage_n][pitch(mid_n)] (vertical-first;
// first, so that its 16-byte copies land at 16-byte offsets: its size is
// a multiple of 128 bytes); the vertical taps [rows][Tv] and the
// horizontal taps [Th][cols] (transposed: a warp's columns read
// neighbouring entries) as float2 (w, c) (dot3n); the int32 starts
// [rows] and [cols]; then the mid tile [3][m1][m2] of f32 values rounded
// to bf16.
__host__ __device__ inline int smem_bytes(bool vfirst, int rows, int cols,
                                          int mid_n, int stage_n, int Tv,
                                          int Th) {
  const int m = vfirst ? rows * mid_n : mid_n * cols;
  return 4 * stage_n * pitch(mid_n) + 8 * (rows * Tv + cols * Th) +
         4 * (rows + cols + 3 * m);
}

// words [B, H, W] -> out [B, out_h, out_w] over rows x kCols tiles.
// windows_v[i] = (lo, hi): the input rows the vertical taps of tile row i
// read; windows_h[j] the input columns of tile column j; mid_n and
// stage_n as ops/resize.py TilePlan.
template <bool kVFirst, int kCols>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
resize_words_tiles(const int32_t* __restrict__ words, int H, int W,
                   const int32_t* __restrict__ starts_v,
                   const __nv_bfloat16* __restrict__ taps_v, int Tv,
                   int out_h, const int32_t* __restrict__ starts_h,
                   const __nv_bfloat16* __restrict__ taps_h, int Th,
                   int out_w, int rows,
                   const int2* __restrict__ windows_v,
                   const int2* __restrict__ windows_h, int mid_n,
                   int stage_n, int wide, int32_t* __restrict__ out) {
  constexpr int kGroups = kThreads / kCols;  // threads that share a column
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * rows, c0 = blockIdx.x * kCols;
  const int nr = min(rows, out_h - r0), nc = min(kCols, out_w - c0);
  const int32_t* frame = words + (size_t)blockIdx.z * H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = threadIdx.x % kCols, group = threadIdx.x / kCols;

  const int sp = pitch(mid_n);                     // staged row pitch
  int32_t* stage = reinterpret_cast<int32_t*>(smem);  // [stage_n][sp]
  float2* tv = reinterpret_cast<float2*>(stage + stage_n * sp);  // [rows][Tv]
  float2* th = tv + rows * Tv;                    // [Th][kCols]
  int* sv = reinterpret_cast<int*>(th + Th * kCols);
  int* sh = sv + rows;
  float* mid = reinterpret_cast<float*>(sh + kCols);
  const int m2 = kVFirst ? mid_n : kCols;          // mid row pitch
  const int plane = (kVFirst ? rows : mid_n) * m2;
  const int2 wv = windows_v[blockIdx.y], wh = windows_h[blockIdx.x];
  // the first pass's window on the other axis: lo .. lo + nw - 1
  const int lo = kVFirst ? wh.x : wv.x;
  const int nw = kVFirst ? wh.y - wh.x : wv.y - wv.x;

  if (kVFirst) {
    // stage the input rows of the vertical taps over the window, [ny][sp]
    // words with window column x at (lo % 4) + x, by asynchronous copies
    // of 16 bytes where the rows allow it (wide), else of 4; a warp takes
    // whole rows
    const int ny = wv.y - wv.x, skew = lo % 4;
    for (int y = warp; y < ny; y += kWarps) {
      const int32_t* src = frame + (wv.x + y) * W + lo - skew;
      int32_t* dst = stage + y * sp;
      if (wide)
        for (int q = 4 * lane; q < skew + nw; q += 4 * 32)
          __pipeline_memcpy_async(dst + q, src + q, 16);
      else
        for (int q = skew + lane; q < skew + nw; q += 32)
          __pipeline_memcpy_async(dst + q, src + q, 4);
    }
    __pipeline_commit();
  }

  // the tile's slices of the tables; the first pass's taps multiply
  // 2^23 + byte, the second's the mid values
  const float cv = kVFirst ? -kTwo23 : 0.0f, ch = kVFirst ? 0.0f : -kTwo23;
  for (int i = threadIdx.x; i < nr * Tv; i += kThreads) {
    const float w = __bfloat162float(taps_v[r0 * Tv + i]);
    tv[i] = make_float2(w, __fmul_rn(w, cv));
  }
  for (int i = threadIdx.x; i < nc * Th; i += kThreads) {
    const float w = __bfloat162float(taps_h[c0 * Th + i]);
    th[i % Th * kCols + i / Th] = make_float2(w, __fmul_rn(w, ch));
  }
  for (int i = threadIdx.x; i < nr; i += kThreads) sv[i] = starts_v[r0 + i];
  for (int i = threadIdx.x; i < nc; i += kThreads) sh[i] = starts_h[c0 + i];
  if (kVFirst) __pipeline_wait_prior(0);
  __syncthreads();

  if (kVFirst) {
    // mid[c][r][x]: a warp takes up to kSpan runs of 32 window columns of
    // one mid row, whose vertical taps are then the warp's own
    const int units = (nw + 32 * kSpan - 1) / (32 * kSpan);
    for (int u = warp; u < nr * units; u += kWarps) {
      const int r = u % nr, x0 = u / nr * 32 * kSpan + lane;
      const int s = sv[r];
      const int32_t* in = stage + (s - wv.x) * sp + lo % 4 + x0;
      with_count((nw - x0 + lane + 31) / 32, [&](auto count) {
        constexpr int N = decltype(count)::value;
        float v[N][3];
        dot3n<N>([&](int j, int t, float* o) {
                   const int32_t w = in[t * sp + 32 * j];
#pragma unroll
                   for (int c = 0; c < 3; ++c) o[c] = chan23(w, c);
                 }, s, tv + r * Tv, 1, Tv, v);
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (x0 + 32 * j < nw)
#pragma unroll
            for (int c = 0; c < 3; ++c)
              mid[c * plane + r * m2 + x0 + 32 * j] = to_bf16(v[j][c]);
      });
    }
  } else if (col < nc) {
    // mid[c][i][col]: a thread keeps its column, whose horizontal taps are
    // its own, and sums kSpan window rows i = i0 + kGroups * j at a time
    const int s = sh[col];
    const int32_t* in = frame + lo * W + s;
    for (int i0 = group; i0 < nw; i0 += kGroups * kSpan) {
      with_count((nw - i0 + kGroups - 1) / kGroups, [&](auto count) {
        constexpr int N = decltype(count)::value;
        float v[N][3];
        dot3n<N>([&](int j, int t, float* o) {
                   const int32_t w = __ldg(in + (i0 + kGroups * j) * W + t);
#pragma unroll
                   for (int c = 0; c < 3; ++c) o[c] = chan23(w, c);
                 }, s, th + col, kCols, Th, v);
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            mid[c * plane + (i0 + kGroups * j) * m2 + col] =
                to_bf16(v[j][c]);
      });
    }
  }
  __syncthreads();

  if (col >= nc) return;
  int32_t* dst = out + ((size_t)blockIdx.z * out_h + r0) * out_w + c0 + col;
  if (kVFirst) {
    // horizontal taps of column col over kSpan output rows at a time
    const int s = sh[col];
    const float* in = mid + (s - lo);
    for (int q0 = group; q0 < nr; q0 += kGroups * kSpan) {
      with_count((nr - q0 + kGroups - 1) / kGroups, [&](auto count) {
        constexpr int N = decltype(count)::value;
        float v[N][3];
        dot3n<N>([&](int j, int t, float* o) {
                   const float* p = in + (q0 + kGroups * j) * m2 + t;
#pragma unroll
                   for (int c = 0; c < 3; ++c) o[c] = p[c * plane];
                 }, s, th + col, kCols, Th, v);
#pragma unroll
        for (int j = 0; j < N; ++j)
          dst[(size_t)(q0 + kGroups * j) * out_w] = pack_word(v[j]);
      });
    }
  } else {
    // vertical taps of output row r over column col
    for (int r = group; r < nr; r += kGroups) {
      const int s = sv[r];
      const float* in = mid + (s - lo) * m2 + col;
      float v[1][3];
      dot3n<1>([&](int, int t, float* o) {
                 const float* p = in + t * m2;
#pragma unroll
                 for (int c = 0; c < 3; ++c) o[c] = p[c * plane];
               }, s, tv + r * Tv, 1, Tv, v);
      dst[(size_t)r * out_w] = pack_word(v[0]);
    }
  }
}

using Kernel = decltype(&resize_words_tiles<true, 32>);

Kernel pick(bool vfirst, int cols) {
  switch (cols) {
    case 32: return vfirst ? resize_words_tiles<true, 32>
                           : resize_words_tiles<false, 32>;
    case 64: return vfirst ? resize_words_tiles<true, 64>
                           : resize_words_tiles<false, 64>;
    case 128: return vfirst ? resize_words_tiles<true, 128>
                            : resize_words_tiles<false, 128>;
    default: return nullptr;
  }
}

}  // namespace

// One launch: words [B, H, W] -> out [B, out_h, out_w], both passes.
// rows x cols is the tile (cols 32, 64 or 128); windows_v, windows_h,
// mid_n and stage_n are the planner's (ops/resize.py TilePlan); wide:
// the words' rows may be copied 16 bytes at a time (W a multiple of 4,
// words 16-byte aligned).  Returns the CUDA error of the launch
// (cudaErrorInvalidValue for a tiling it cannot run).
extern "C" int timg_resize_words(const void* words, int B, int H, int W,
                                 const void* starts_v, const void* taps_v,
                                 int Tv, int out_h, const void* starts_h,
                                 const void* taps_h, int Th, int out_w,
                                 int vertical_first, int rows, int cols,
                                 const void* windows_v,
                                 const void* windows_h, int mid_n,
                                 int stage_n, int wide, void* out,
                                 void* stream) {
  const Kernel kernel = pick(vertical_first != 0, cols);
  if (kernel == nullptr || rows <= 0 || mid_n <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || out_h == 0 || out_w == 0) return 0;
  const int smem = smem_bytes(vertical_first != 0, rows, cols, mid_n,
                              stage_n, Tv, Th);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((out_w + cols - 1) / cols, (out_h + rows - 1) / rows, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)words, H, W, (const int32_t*)starts_v,
      (const __nv_bfloat16*)taps_v, Tv, out_h, (const int32_t*)starts_h,
      (const __nv_bfloat16*)taps_h, Th, out_w, rows,
      (const int2*)windows_v, (const int2*)windows_h, mid_n, stage_n, wide,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
