// Lean video resize of RGBA-packed int32 words in two separable passes:
// the route for geometries that the fused tile kernel (resize_words.cu)
// cannot tile, where even a 1 x 32 tile's taps and mid do not fit shared
// memory (near a 90x downscale of both axes, e.g. 2160x3840 -> 16x28;
// ops/resize.py plan_tiles returns None for them).
//
// Replaces, for those geometries, the TPU kernels
// timg_tpu/ops/resize_pallas.py resize_video_words_pallas (K1) and
// resize_video_words_pallas_tiled (K2), which the JAX package itself
// leaves to its dense einsum fallback there (timg_tpu/ops/resize.py).
// The bf16 intermediate [B, 3, H1, W1] goes through device memory (the
// wrapper allocates it); it is small at these output sizes.
//
// Arithmetic, held byte-equal to the JAX package's CPU path
// (timg_tpu/ops/resize.py resize_video_words; the plain version is
// ops/resize.py resize_video_words_plain):
//   * channels unpacked from the word with shifts and masks (alpha makes
//     the words negative, so every shift is masked);
//   * taps are bf16 (round-to-nearest-even from the f32 band matrix,
//     folded edge duplicates summed first), values are bf16;
//   * each product of two bf16 values is exact in f32, so a product and
//     its sum are one fma, and only the order of the f32 sums matters:
//     XLA:CPU's dot order (ops/resize.py says how it was found).  Inputs
//     are cut into blocks of 32 by absolute index k; inside a block, the
//     even k and the odd k form two ascending sums E_j and O_j (taps
//     outside [s, s+T) skipped); the output is
//     ((0 + (E_0 + O_0)) + (E_1 + O_1)) + ... over the blocks in order.
//     The block sums are independent of each other: only the chain over
//     the blocks is serial, so the kernels below compute E_j and O_j in
//     parallel and chain them after;
//   * the first pass rounds its result to bf16 (__float2bfloat16_rn);
//   * the second pass adds 0.5, clips to [0, 255], truncates, and packs
//     r | g << 8 | b << 16 | 0xFF000000.
// The pass order (vertical or horizontal first) is the caller's, taken
// from stb's cost heuristic as the reference CPU path does; the
// geometries that reach this route are horizontal-first.
//
// What bounds it on the H100: device-memory bytes, each input word read
// once (265 MB at 8 frames of 2160x3840, 0.079 ms at 3.35 TB/s), and
// then the f32 sums (~800 M fma at that size, ~0.03 ms at the issue
// rate).  A first design took one thread an output looping over its
// ~550 taps: neighbouring lanes read words ~137 apart (a cache line
// each), every word was read by ~4 overlapping bands, and the second
// pass waited on one L2 load a tap (PERF.md §6).  Here:
//   * resize_rows_to_mid (the pass along rows, over the words): a block
//     copies a row's words into shared memory by 16-byte cp.async, two
//     rows ahead.  Thread (j, p) takes order block j's 16 words of
//     parity p, unpacks each word's channels once, and computes E_j or
//     O_j for every output whose band covers block j from taps it keeps
//     in registers for all rows, so each word is read once from device
//     memory and once from shared memory; a thread per (output, channel)
//     then chains the row's block sums while the next row computes;
//   * resize_pass (the other passes: along columns, or over the small
//     mid): a block takes 32 neighbouring outputs, its warps split each
//     band's order blocks, and a block of 32 values and taps is loaded
//     together before its two sums, so a block costs one load latency
//     instead of 32.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kTwo23 = 8388608.0f;

// byte c of a word as a float (exactly): the byte under the exponent of
// 2^23, minus 2^23
__device__ __forceinline__ float chan(uint32_t word, int c) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | c)),
                   kTwo23);
}

constexpr int kOrderBlock = 32;  // ops/resize.py ORDER_BLOCK

// ---------------------------------------------------------------------
// The pass along rows over the words (the horizontal first pass).
// ---------------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr int kChunkBlocks = kRowThreads / 2;  // order blocks a chunk
constexpr int kChunkWords = kChunkBlocks * kOrderBlock;
// words a staged order block: its 32 words and 4 of padding (16-byte
// copies need 16-byte aligned blocks), so that the 32 threads of a warp
// (16 blocks, both parities) read at most 2 words a bank
constexpr int kPitch = 36;

constexpr int kSlots = 6;   // outputs a thread's taps hold in registers
constexpr int kStages = 3;  // stage buffers: units copied kStages-1 ahead

// words [B, H, W] -> mid [B, 3, H, out_n] bf16, filtering along rows.
// Block g takes rows g, g + gridDim.x, ..., each as ceil(W / 4096)
// units (chunks of kChunkBlocks order blocks).  Thread (j, p) of a unit
// takes order block j's 16 words of parity p; slot_taps
// [nb][2][slots][16] f32 holds, for each output m of the `slots` whose
// bands may cover block j, its taps of inputs 32 j + p + 2i, +0 outside
// its band; slot_dst [nb][slots] where the slot's block sums go (-1: no
// output; slots <= kSlots); ops/resize.py slot_taps builds both.  Where
// a row is one unit (W <= 4096), a thread keeps its taps in registers for
// every row; else it loads them each unit.
//
// Skipping a product and adding a +0 product give the same bits: each
// sum starts at +0, and x + (+0) == x for every x but -0, which a sum
// that starts at +0 never is (round-to-nearest gives -0 only for
// (-0) + (-0)); the words are bytes, so a +0 tap's product is +0.
//
// A unit's words are copied into shared memory by cp.async kStages-1
// units ahead, and the block sums of a row go to one of two buffers,
// chained in the next row's first unit: one barrier a unit, and two
// blocks an SM, so that one's barrier, copies and chain overlap the
// other's sums.
__global__ void __launch_bounds__(kRowThreads, 2)
resize_rows_to_mid(const int32_t* __restrict__ words, int B, int H, int W,
                   const float4* __restrict__ slot_taps,
                   const int* __restrict__ slot_dst, int slots,
                   const int32_t* __restrict__ starts, int T, int nb_max,
                   int out_n, __nv_bfloat16* __restrict__ mid) {
  // [kStages][kChunkBlocks][kPitch] staged words, then [2] block sums
  // [out_n][3][nb_max] of {E, O}
  extern __shared__ __align__(16) float smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  float* sums = smem + kStages * kChunkBlocks * kPitch;
  const int sums_n = out_n * 3 * nb_max * 2;
  const int tid = threadIdx.x;
  const int nb = (W + kOrderBlock - 1) / kOrderBlock;
  const int chunks = (nb + kChunkBlocks - 1) / kChunkBlocks;
  const int rows = B * H;
  const int my_rows =
      rows > (int)blockIdx.x ? (rows - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_rows * chunks;
  // rows of whole 16-byte groups on 16-byte boundaries copy 16 bytes at a
  // time
  const bool wide = W % 4 == 0 && ((uintptr_t)words & 15) == 0;

  // Thread tid copies words 4 tid + 1024 i .. + 3 (i < 4) of the next
  // unit's chunk into its stage buffer, 16 bytes a copy.  Words past the
  // row are not copied: their taps are +0, and a stale word is bytes, so
  // its product is +0 too.  Units are issued in order, (row, chunk)
  // advancing as a counter.
  int issue_n = 0, issue_row = blockIdx.x, issue_ch = 0;
  const int stage_off = (4 * tid / kOrderBlock) * kPitch + 4 * tid % kOrderBlock;
  auto issue = [&]() {
    if (issue_n < units) {
      const int left = W - issue_ch * kChunkWords - 4 * tid;  // from 4 tid on
      const int32_t* src = words + (int64_t)issue_row * W
                           + issue_ch * kChunkWords + 4 * tid;
      uint32_t* dst = stages + (issue_n % kStages) * kChunkBlocks * kPitch
                      + stage_off;
      if (wide) {
#pragma unroll
        for (int i = 0; i < kChunkWords / (4 * kRowThreads); ++i)
          if (i * 4 * kRowThreads < left)
            __pipeline_memcpy_async(dst + i * (4 * kRowThreads / kOrderBlock) * kPitch,
                                    src + i * 4 * kRowThreads, 16);
      } else {
#pragma unroll
        for (int i = 0; i < kChunkWords / (4 * kRowThreads); ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i * 4 * kRowThreads + e < left)
              __pipeline_memcpy_async(
                  dst + i * (4 * kRowThreads / kOrderBlock) * kPitch + e,
                  src + i * 4 * kRowThreads + e, 4);
      }
      if (++issue_ch == chunks) {
        issue_ch = 0;
        issue_row += gridDim.x;
      }
    }
    ++issue_n;
    __pipeline_commit();
  };

  // The chain of a row: thread (o, c) < 3 out_n adds its blocks' (E + O)
  // in order, 8 blocks' sums loaded together.  Its band's block count
  // and sums offset are the thread's own for every row.
  const int oc = min(tid, 3 * out_n - 1);
  const int oc_start = starts[oc / 3];
  const int oc_blocks = (oc_start + T - 1) / kOrderBlock - oc_start / kOrderBlock + 1;
  auto chain = [&](int row, const float* buf) {
    const int b = row / H, y = row % H;
    for (int q = tid; q < 3 * out_n; q += kRowThreads) {
      int n = oc_blocks;
      if (q != oc) {  // more items than threads
        const int s = starts[q / 3];
        n = (s + T - 1) / kOrderBlock - s / kOrderBlock + 1;
      }
      const float2* eo = reinterpret_cast<const float2*>(buf) + q * nb_max;
      float total = 0.0f;
      for (int jb = 0; jb < n; jb += 8) {
        float2 e[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = eo[min(jb + k, n - 1)];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (jb + k < n) total = __fadd_rn(total, __fadd_rn(e[k].x, e[k].y));
      }
      mid[(((int64_t)b * 3 + q % 3) * H + y) * out_n + q / 3] =
          __float2bfloat16_rn(total);
    }
  };

  const int jl = tid / 2, p = tid & 1;
  const bool keep_taps = chunks == 1;
  // the taps are bf16 values: two a register (i = 2h low, 2h + 1 high)
  uint32_t tap[kSlots][8];
  int dst[kSlots];
  auto load_taps = [&](int j) {
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const bool ok = j < nb && m < slots;
      const float4* src = slot_taps + (((int64_t)j * 2 + p) * slots + (ok ? m : 0)) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 t4 = ok ? __ldg(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        tap[m][2 * q] = __float_as_uint(t4.x) >> 16 | (__float_as_uint(t4.y) & 0xFFFF0000u);
        tap[m][2 * q + 1] = __float_as_uint(t4.z) >> 16 | (__float_as_uint(t4.w) & 0xFFFF0000u);
      }
      dst[m] = ok ? slot_dst[(int64_t)j * slots + m] : -1;
    }
  };
  if (keep_taps) load_taps(jl);

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) issue();
  int row = blockIdx.x, ch = 0, row_n = 0;  // unit n's row, chunk, row count
  for (int n = 0; n <= units; ++n) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of unit n
    __syncthreads();                     // everyone's; iteration n-1 done
    issue();                             // into the stage n-1 read
    if (n > 0 && ch == 0)                // the row before is complete
      chain(row - gridDim.x, sums + ((row_n - 1) & 1) * sums_n);
    if (n == units) break;
    const int j = ch * kChunkBlocks + jl;
    float* buf = sums + (row_n & 1) * sums_n + p;
    const uint32_t* stage = stages + (n % kStages) * kChunkBlocks * kPitch;
    if (++ch == chunks) {
      ch = 0;
      row += gridDim.x;
      ++row_n;
    }
    if (j >= nb) continue;
    const uint32_t* w = stage + jl * kPitch + p;  // word i: w[2 i]
    if (!keep_taps) load_taps(j);
    // E_j or O_j of every slot and channel: 3 kSlots independent sums,
    // each over i in ascending order
    float acc[kSlots][3];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) acc[m][0] = acc[m][1] = acc[m][2] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t word = w[2 * i];
      const float v[3] = {chan(word, 0), chan(word, 1), chan(word, 2)};
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float t = __uint_as_float(
            i & 1 ? tap[m][i / 2] & 0xFFFF0000u : tap[m][i / 2] << 16);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[m][c] = __fmaf_rn(t, v[c], acc[m][c]);
      }
    }
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      if (dst[m] >= 0)
#pragma unroll
        for (int c = 0; c < 3; ++c) buf[dst[m] + c * 2 * nb_max] = acc[m][c];
  }
}

// ---------------------------------------------------------------------
// The other passes: 32 outputs of one channel a block.
// ---------------------------------------------------------------------

// Value sources: line(b, c, y, x) points at element (y, x) of channel
// c's [H, W] plane of frame b; value(q, c) reads it as a float.
struct WordSrc {  // RGBA words [B, H, W]
  using Elem = int32_t;
  const int32_t* p;
  int H, W;
  __device__ __forceinline__ const int32_t* line(int b, int, int y, int x) const {
    return p + ((int64_t)b * H + y) * W + x;
  }
  __device__ __forceinline__ static float value(const int32_t* q, int c) {
    return chan(__ldg(q), c);
  }
};

struct MidSrc {  // bf16 planes [B, 3, H, W]
  using Elem = __nv_bfloat16;
  const __nv_bfloat16* p;
  int H, W;
  __device__ __forceinline__ const __nv_bfloat16* line(int b, int c, int y,
                                                       int x) const {
    return p + (((int64_t)b * 3 + c) * H + y) * W + x;
  }
  __device__ __forceinline__ static float value(const __nv_bfloat16* q, int) {
    return __bfloat162float(*q);
  }
};

// Destinations of an output channel's sum.
struct MidDst {  // bf16 planes [B, 3, H, W], rounded to nearest even
  __nv_bfloat16* p;
  int H, W;
  __device__ __forceinline__ void operator()(int b, int c, int y, int x,
                                             float v) const {
    p[(((int64_t)b * 3 + c) * H + y) * W + x] = __float2bfloat16_rn(v);
  }
};

struct WordDst {  // the bytes of RGBA words [B, H, W]; alpha 255
  uint8_t* p;
  int H, W;
  __device__ __forceinline__ void operator()(int b, int c, int y, int x,
                                             float v) const {
    uint8_t* q = p + (((int64_t)b * H + y) * W + x) * 4;
    q[c] = (uint8_t)(int)fminf(fmaxf(__fadd_rn(v, 0.5f), 0.0f), 255.0f);
    if (c == 0) q[3] = 0xFF;
  }
};

// src [B, 3 channels, H0, W0] -> dst [B, 3, OH, OW], filtering along one
// axis: vertical (OH outputs, OW = W0) or horizontal (OW outputs, OH =
// H0).  A block takes 32 neighbouring x of one (b, c, y) of dst, a lane
// each; its warps split each output's order blocks (warp w takes blocks
// w, w + kPassWarps, ...), each computing its block's (E + O) from 32
// loads issued together, and warp 0 chains them in order.  sums
// [nb_max][32] in shared memory; nb_max bounds the order blocks of a band.
constexpr int kPassWarps = 16;

template <typename Src, typename Dst>
__global__ void __launch_bounds__(kPassWarps * 32)
resize_pass(Src src, Dst dst, int OH, int OW,
            const int32_t* __restrict__ starts,
            const __nv_bfloat16* __restrict__ taps, int T, int vertical) {
  extern __shared__ float sums[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int x_blocks = (OW + 31) / 32;
  const int x = (int)(blockIdx.x % x_blocks) * 32 + lane;
  const int y = (int)(blockIdx.x / x_blocks % OH);
  const int c = (int)(blockIdx.x / x_blocks / OH % 3);
  const int b = (int)(blockIdx.x / x_blocks / OH / 3);
  const bool on = x < OW;
  const int o = vertical ? y : min(x, OW - 1);
  const int s = starts[o];
  const int j0 = s / kOrderBlock;
  const int n = (s + T - 1) / kOrderBlock - j0 + 1;  // the band's blocks
  const __nv_bfloat16* tp = taps + (int64_t)o * T;
  // the band's first input, and the step between inputs
  const typename Src::Elem* q0 =
      vertical ? src.line(b, c, s, min(x, OW - 1)) : src.line(b, c, y, s);
  const int step = vertical ? src.W : 1;
  for (int jr = warp; jr < n; jr += kPassWarps) {
    const int kb = (j0 + jr) * kOrderBlock;
    // the block's loads all issue before its sums (clamped into the
    // band, so no branch); the products outside the band are skipped
    float t[kOrderBlock], v[kOrderBlock];
#pragma unroll
    for (int r = 0; r < kOrderBlock; ++r) {
      const int t_r = min(max(kb + r - s, 0), T - 1);
      t[r] = __bfloat162float(tp[t_r]);
      v[r] = Src::value(q0 + (int64_t)t_r * step, c);
    }
    asm volatile("" ::: "memory");
    float even = 0.0f, odd = 0.0f;
#pragma unroll
    for (int r = 0; r < kOrderBlock; r += 2) {
      if (kb + r >= s && kb + r < s + T) even = __fmaf_rn(t[r], v[r], even);
      if (kb + r + 1 >= s && kb + r + 1 < s + T)
        odd = __fmaf_rn(t[r + 1], v[r + 1], odd);
    }
    sums[jr * 32 + lane] = __fadd_rn(even, odd);
  }
  __syncthreads();
  if (warp != 0 || !on) return;
  float total = 0.0f;
  for (int jb = 0; jb < n; jb += 8) {  // 8 blocks loaded together, chained
    float e[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) e[r] = sums[min(jb + r, n - 1) * 32 + lane];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (jb + r < n) total = __fadd_rn(total, e[r]);
  }
  dst(b, c, y, x, total);
}

template <typename Src, typename Dst>
int launch_pass(Src src, Dst dst, int B, int OH, int OW, const void* starts,
                const void* taps, int T, int nb_max, int vertical,
                void* stream) {
  const int64_t blocks = (int64_t)B * 3 * OH * ((OW + 31) / 32);
  if (blocks > 0)
    resize_pass<<<(unsigned)blocks, kPassWarps * 32,
                  sizeof(float) * 32 * nb_max, (cudaStream_t)stream>>>(
        src, dst, OH, OW, (const int32_t*)starts, (const __nv_bfloat16*)taps,
        T, vertical);
  return (int)cudaGetLastError();
}

}  // namespace

// The pass along rows over the words (horizontal first pass): words
// [B, H, W] -> mid [B, 3, H, out_n] bf16.  slot_taps, slot_dst and
// slots as resize_rows_to_mid says (ops/resize.py slot_taps); starts
// and T the axis' tap table; nb_max the most order blocks of a band.
extern "C" int timg_resize_rows_to_mid(const void* words, int B, int H,
                                       int W, const void* slot_taps,
                                       const void* slot_dst, int slots,
                                       const void* starts, int T, int nb_max,
                                       int out_n, void* mid, void* stream) {
  if ((int64_t)B * H * W <= 0 || out_n <= 0) return 0;
  if (slots > kSlots) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kStages * (size_t)kChunkBlocks * kPitch
                                       + 2 * (size_t)out_n * nb_max * 6);
  cudaError_t err = cudaFuncSetAttribute(
      resize_rows_to_mid, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resize_rows_to_mid, kRowThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = std::min<int64_t>((int64_t)B * H,
                                         (int64_t)sms * std::max(per_sm, 1));
  resize_rows_to_mid<<<(unsigned)grid, kRowThreads, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)words, B, H, W, (const float4*)slot_taps,
      (const int*)slot_dst, slots, (const int32_t*)starts, T, nb_max, out_n,
      (__nv_bfloat16*)mid);
  return (int)cudaGetLastError();
}

// The vertical first pass: words [B, H, W] -> mid [B, 3, out_n, W]
// bf16.  nb_max: the most order blocks a band of the axis touches.
extern "C" int timg_resize_words_to_mid(const void* words, int B, int H,
                                        int W, const void* starts,
                                        const void* taps, int T, int nb_max,
                                        int out_n, void* mid, void* stream) {
  return launch_pass(WordSrc{(const int32_t*)words, H, W},
                     MidDst{(__nv_bfloat16*)mid, out_n, W}, B, out_n, W,
                     starts, taps, T, nb_max, 1, stream);
}

// mid [B, 3, H1, W1] bf16 -> out [B, OH, OW] words, filtering the other
// axis.  vertical: OH = out_n, OW = W1;  horizontal: OH = H1, OW = out_n.
extern "C" int timg_resize_mid_to_words(const void* mid, int B, int H1,
                                        int W1, const void* starts,
                                        const void* taps, int T, int nb_max,
                                        int vertical, int out_n, void* out,
                                        void* stream) {
  const int OH = vertical ? out_n : H1, OW = vertical ? W1 : out_n;
  return launch_pass(MidSrc{(const __nv_bfloat16*)mid, H1, W1},
                     WordDst{(uint8_t*)out, OH, OW}, B, OH, OW, starts, taps,
                     T, nb_max, vertical, stream);
}
