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
// Each pass is one launch with one thread per output element, reading
// its taps from a compact [out, T] table (T = band width) instead of a
// dense band matrix, so no window limit exists and no FLOP is spent on
// zeros; the bf16 intermediate [B, 3, H1, W1] goes through device
// memory (the wrapper allocates it).
//
// Arithmetic, held byte-equal to the JAX package's CPU path
// (timg_tpu/ops/resize.py resize_video_words; the plain version is
// ops/resize.py resize_video_words_plain):
//   * channels unpacked from the word with shifts and masks (alpha makes
//     the words negative, so every shift is masked);
//   * taps are bf16 (round-to-nearest-even from the f32 band matrix,
//     folded edge duplicates summed first), values are bf16;
//   * each product of two bf16 values is exact in f32, so only the
//     order of the f32 sums matters: it is XLA:CPU's dot order (DotSum
//     below; ops/resize.py says how it was found);
//   * the first pass rounds its result to bf16 (__float2bfloat16_rn);
//   * the second pass adds 0.5, clips to [0, 255], truncates, and packs
//     r | g << 8 | b << 16 | 0xFF000000.
// The pass order (vertical or horizontal first) is the caller's, taken
// from stb's cost heuristic as the reference CPU path does.
//
// Bound on the H100: device-memory bytes (each input word read once,
// each output word written once); at these downscales the input is
// nearly all of it.  Consecutive threads take consecutive output columns,
// so a horizontal first pass reads rows of taps from L1/L2.  These
// geometries are rare (a terminal a few cells wide showing 4K video), so
// the route stays simple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float chan(int32_t word, int c) {
  return (float)((word >> (8 * c)) & 0xFF);
}

// The reference dot's sum order over the input index k: within each
// block of 32 inputs, even and odd k go to two ascending sums; at a
// block's end its (even + odd) is added to the running total.
constexpr int kOrderBlock = 32;

struct DotSum {
  float total = 0.0f, even = 0.0f, odd = 0.0f;
  // product p of input k, the t-th tap of this output (t = 0 first)
  __device__ __forceinline__ void add(int k, int t, float p) {
    if (t > 0 && k % kOrderBlock == 0) {
      total = __fadd_rn(total, __fadd_rn(even, odd));
      even = odd = 0.0f;
    }
    if (k & 1) odd = __fadd_rn(odd, p);
    else even = __fadd_rn(even, p);
  }
  __device__ __forceinline__ float sum() const {
    return __fadd_rn(total, __fadd_rn(even, odd));
  }
};

// words [B, H, W] -> mid [B, 3, H1, W1] bf16, filtering one axis.
// vertical: H1 = out_n, W1 = W;  horizontal: H1 = H, W1 = out_n.
__global__ void resize_words_to_mid(const int32_t* __restrict__ words,
                                    int B, int H, int W,
                                    const int32_t* __restrict__ starts,
                                    const __nv_bfloat16* __restrict__ taps,
                                    int T, int vertical, int out_n,
                                    __nv_bfloat16* __restrict__ mid) {
  const int H1 = vertical ? out_n : H;
  const int W1 = vertical ? W : out_n;
  const int64_t n = (int64_t)B * H1 * W1;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = (int)(i % W1);
  const int row = (int)((i / W1) % H1);
  const int b = (int)(i / ((int64_t)W1 * H1));
  const int o = vertical ? row : col;
  const int s = starts[o];
  const int32_t* src = words + (int64_t)b * H * W;
  DotSum acc[3];
  for (int t = 0; t < T; ++t) {
    const int k = s + t;
    const float tap = __bfloat162float(taps[(int64_t)o * T + t]);
    const int32_t word = vertical ? src[(int64_t)k * W + col]
                                  : src[(int64_t)row * W + k];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c].add(k, t, __fmul_rn(tap, chan(word, c)));
  }
  const int64_t plane = (int64_t)H1 * W1;
  __nv_bfloat16* dst = mid + (int64_t)b * 3 * plane + (int64_t)row * W1 + col;
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c * plane] = __float2bfloat16_rn(acc[c].sum());
}

// mid [B, 3, H1, W1] bf16 -> out [B, OH, OW] words, filtering the other
// axis.  vertical: OH = out_n, OW = W1;  horizontal: OH = H1, OW = out_n.
__global__ void resize_mid_to_words(const __nv_bfloat16* __restrict__ mid,
                                    int B, int H1, int W1,
                                    const int32_t* __restrict__ starts,
                                    const __nv_bfloat16* __restrict__ taps,
                                    int T, int vertical, int out_n,
                                    int32_t* __restrict__ out) {
  const int OH = vertical ? out_n : H1;
  const int OW = vertical ? W1 : out_n;
  const int64_t n = (int64_t)B * OH * OW;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = (int)(i % OW);
  const int row = (int)((i / OW) % OH);
  const int b = (int)(i / ((int64_t)OW * OH));
  const int o = vertical ? row : col;
  const int s = starts[o];
  const int64_t plane = (int64_t)H1 * W1;
  const __nv_bfloat16* src = mid + (int64_t)b * 3 * plane;
  int32_t packed = (int32_t)0xFF000000u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const __nv_bfloat16* p = src + c * plane;
    DotSum acc;
    for (int t = 0; t < T; ++t) {
      const int k = s + t;
      const float tap = __bfloat162float(taps[(int64_t)o * T + t]);
      const float v = __bfloat162float(vertical ? p[(int64_t)k * W1 + col]
                                                : p[(int64_t)row * W1 + k]);
      acc.add(k, t, __fmul_rn(tap, v));
    }
    const float v = fminf(fmaxf(__fadd_rn(acc.sum(), 0.5f), 0.0f), 255.0f);
    packed |= ((int32_t)v) << (8 * c);
  }
  out[i] = packed;
}

constexpr int kThreads = 256;

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int timg_resize_words_to_mid(const void* words, int B, int H,
                                        int W, const void* starts,
                                        const void* taps, int T,
                                        int vertical, int out_n, void* mid,
                                        void* stream) {
  const int64_t n = (int64_t)B * (vertical ? out_n : H) * (vertical ? W : out_n);
  if (n > 0)
    resize_words_to_mid<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, B, H, W, (const int32_t*)starts,
        (const __nv_bfloat16*)taps, T, vertical, out_n, (__nv_bfloat16*)mid);
  return (int)cudaGetLastError();
}

extern "C" int timg_resize_mid_to_words(const void* mid, int B, int H1,
                                        int W1, const void* starts,
                                        const void* taps, int T,
                                        int vertical, int out_n, void* out,
                                        void* stream) {
  const int64_t n = (int64_t)B * (vertical ? out_n : H1) * (vertical ? W1 : out_n);
  if (n > 0)
    resize_mid_to_words<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)mid, B, H1, W1, (const int32_t*)starts,
        (const __nv_bfloat16*)taps, T, vertical, out_n, (int32_t*)out);
  return (int)cudaGetLastError();
}
