// Floyd-Steinberg dither with f32 error carries, one wavefront kernel
// templated on its quantizer (the 6x7x6 cube or a median-cut tree) and
// on its pixel source (pitched int32 RGBA words, or [B, H, W, C] bytes).
//
// Replaces the TPU kernels of timg_tpu/ops/sixel_pallas3.py:
//   K6 fs_dither_cube_fused (_make_wavefront_kernel + _make_fs_kernel),
//   K7 fs_dither_tree_fused (the same wavefront + _make_fs_tree_kernel),
//   K3 _skewT, K4 _transpose_bwd and K5 _unskewT;
// and of timg_tpu/ops/sixel_pallas.py:
//   K9 fs_dither_cube_pallas (3-channel bytes, cube quantizer), whose
//   XLA skew, 128-row padding and 16-column blocking are layout only.
// The layout kernels existed only to give the TPU's 128-lane vector
// unit a skewed, transposed column stream; here the skew is indexing:
// at step t, row y handles x = t - 2y, so no layout pass runs, and rows
// at y >= h do not exist.  The byte source reads each pixel's first
// three channels in place (no pass packs them into words first); the
// 3-channel tree entry is what timg_tpu/ops/sixel.py runs as an XLA scan
// (_fs_dither_tree_impl) for the library API's adaptive mode.
//
// Layout: one block per frame, one thread per row (a thread owns R = 2
// or 4 rows when h > 1024; __launch_bounds__ keeps a 1024-thread block
// within the SM's 65,536 registers).  Each row keeps its last
// three error vectors e1, e2, e3 (steps t-1, t-2, t-3) in registers.
// Row y at step t needs row y-1's mix (3/16 e1 + 5/16 e2 + 1/16 e3, i.e.
// the errors at x+1, x, x-1 of the row above), which row y-1 computed at
// the end of step t-1: it goes through a double-buffered shared array,
// with one __syncthreads() per step.  Rows keep stepping after their
// last pixel (their error is then 0), so the row below always reads the
// settled carries.
//
// Arithmetic is the reference's f32 sequence exactly
// (sixel_pallas3.py:282-297, 315-330; numpy mirror sixel_np.py:132-184):
//   mix = (e1*(3/16) + e2*(5/16)) + e3*(1/16)
//   v   = clip(col + (e1*(7/16) + mix_above), 0, 255)
//   cube: q = rint(v * f32((n-1)/255));  chosen = rint(q * f32(255/(n-1)))
//   tree: chosen = the leaf color of rint(v)'s descent (TreeQuant)
//   err = v - chosen (0 outside 0 <= x < w)
// with __fmul_rn/__fadd_rn so nvcc cannot contract any pair into an FMA,
// and rintf (round half to even, like jnp.round).
//
// Bound on the H100: latency of the serial wavefront, w + 2(h-1) steps
// (2,718 at 720x1280), each a barrier plus ~60 dependent FLOPs per row;
// the device-memory traffic (4 B in, 1 B out per pixel) is small; the
// tree's 8 dependent shared-memory loads per pixel lengthen a step.  One
// block per frame fills 32 of 132 SMs at a 32-frame window; splitting a
// frame's rows across blocks needs cross-block carries (a later PR).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRowsPerThread = 4;

__device__ __forceinline__ float chan(int32_t word, int c) {
  return (float)((word >> (8 * c)) & 0xFF);
}

// Quantizers of the f32 wavefront.  Each maps a clipped f32 value v[3] to
// a palette index and the palette color (as f32) the error is taken
// against; `load` stages its tables in shared memory before the steps.

// K6's 6x7x6 cube: q = rint(v * (n-1)/255), color = rint(q * 255/(n-1)).
struct CubeQuant {
  static constexpr int kTableInts = 0;
  __device__ __forceinline__ void load(int*, int, int) const {}
  __device__ __forceinline__ int quantize(const int*, const float v[3],
                                          float color[3]) const {
    const float step[3] = {(float)(5 / 255.0), (float)(6 / 255.0),
                           (float)(5 / 255.0)};
    const float inv[3] = {(float)(255.0 / 5), (float)(255.0 / 6),
                          (float)(255.0 / 5)};
    int idx = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float q = rintf(__fmul_rn(v[c], step[c]));
      color[c] = rintf(__fmul_rn(q, inv[c]));
      idx = idx * (c == 1 ? 7 : 6) + (int)q;
    }
    return idx;
  }
};

// K7's balanced median-cut tree (timg_tpu/ops/sixel_np.py
// median_cut_tree): levels[d][node] = axis << 8 | thr, descend right
// iff rint(v[axis]) > thr; leaves[node] = idx << 24 | r << 16 | g << 8 | b.
// The TPU folded pairs of levels into 4-way tables (_quad_tables) for its
// lane gather; the partition is the same, so this descends the binary
// levels from shared memory.
constexpr int kTreeDepth = 8;
constexpr int kTreeLevelNodes = 128;

struct TreeQuant {
  static constexpr int kTableInts = kTreeDepth * kTreeLevelNodes
                                    + (1 << kTreeDepth);
  const int32_t* levels;  // [8, 128] in device memory
  const int32_t* leaves;  // [256]
  __device__ __forceinline__ void load(int* tab, int tid, int nth) const {
    for (int i = tid; i < kTreeDepth * kTreeLevelNodes; i += nth)
      tab[i] = levels[i];
    for (int i = tid; i < (1 << kTreeDepth); i += nth)
      tab[kTreeDepth * kTreeLevelNodes + i] = leaves[i];
  }
  __device__ __forceinline__ int quantize(const int* tab, const float v[3],
                                          float color[3]) const {
    const float vq[3] = {rintf(v[0]), rintf(v[1]), rintf(v[2])};
    int node = 0;
#pragma unroll
    for (int d = 0; d < kTreeDepth; ++d) {
      const int word = tab[d * kTreeLevelNodes + node];
      const int axis = word >> 8;
      const float comp = axis == 0 ? vq[0] : (axis == 1 ? vq[1] : vq[2]);
      node = node * 2 + (comp > (float)(word & 0xFF) ? 1 : 0);
    }
    const int leaf = tab[kTreeDepth * kTreeLevelNodes + node];
    color[0] = (float)((leaf >> 16) & 0xFF);
    color[1] = (float)((leaf >> 8) & 0xFF);
    color[2] = (float)(leaf & 0xFF);
    return (leaf >> 24) & 0xFF;
  }
};

// Pixel sources: how a pixel of [B, pitch_h, pitch_w] elements of
// ``stride`` bytes becomes one RGB word (r | g << 8 | b << 16).  They hold
// no data: the kernel takes the base pointer and the pitches as plain
// parameters, as K6 did before the source became a template parameter.
// A source passed as a struct, or loaded as three floats, spilled 4-28
// bytes at 4 rows a thread (ptxas); this form spills nowhere for words
// and only in the byte tree at 2 rows a thread (16 bytes).

// int32 RGBA words (K6/K7's input); stride 4, known at compile time.
struct WordPixels {
  static constexpr int kStride = 4;
  __device__ __forceinline__ static int32_t load(const uint8_t* frame,
                                                 int64_t i, int) {
    return reinterpret_cast<const int32_t*>(frame)[i];
  }
};

// uint8 pixels of stride >= 3 channels (K9's input); channels past the
// third are never read.  The stride comes at run time.
struct RgbPixels {
  static constexpr int kStride = 0;
  __device__ __forceinline__ static int32_t load(const uint8_t* frame,
                                                 int64_t i, int stride) {
    const uint8_t* p = frame + i * stride;
    return (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
  }
};

template <typename Pixels, typename Quant, typename OutT, int R>
__global__ void __launch_bounds__(kMaxThreads)
fs_dither_f32(const uint8_t* __restrict__ pixels, int h, int w,
              int pitch_h, int pitch_w, int stride, Quant quant,
              OutT* __restrict__ out) {
  extern __shared__ int smem[];  // [Quant::kTableInts] tables, [2][3][h] mix
  int* tab = smem;
  float* mixbuf = reinterpret_cast<float*>(smem + Quant::kTableInts);
  const int b = blockIdx.x;
  const int nth = blockDim.x;
  if (Pixels::kStride) stride = Pixels::kStride;
  const uint8_t* src = pixels + (int64_t)b * pitch_h * pitch_w * stride;
  OutT* dst = out + (int64_t)b * h * w;

  const float c7 = 7.0f / 16.0f, c5 = 5.0f / 16.0f;
  const float c3 = 3.0f / 16.0f, c1 = 1.0f / 16.0f;

  float e1[R][3], e2[R][3], e3[R][3];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) e1[k][c] = e2[k][c] = e3[k][c] = 0.0f;
  for (int i = threadIdx.x; i < 2 * 3 * h; i += nth) mixbuf[i] = 0.0f;
  quant.load(tab, threadIdx.x, nth);
  __syncthreads();

  const int n_steps = w + 2 * (h - 1);
  for (int t = 0; t < n_steps; ++t) {
    const float* mix_in = mixbuf + (t & 1) * 3 * h;
    float* mix_out = mixbuf + ((t + 1) & 1) * 3 * h;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int y = threadIdx.x + k * nth;
      if (y >= h) break;
      const int x = t - 2 * y;
      const bool valid = x >= 0 && x < w;
      const int32_t word =
          valid ? Pixels::load(src, (int64_t)y * pitch_w + x, stride) : 0;
      float v[3], color[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float up = y == 0 ? 0.0f : mix_in[c * h + y - 1];
        const float incoming = __fadd_rn(__fmul_rn(e1[k][c], c7), up);
        v[c] = fminf(fmaxf(__fadd_rn(chan(word, c), incoming), 0.0f), 255.0f);
      }
      const int idx = quant.quantize(tab, v, color);
      if (valid) dst[(int64_t)y * w + x] = (OutT)idx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e3[k][c] = e2[k][c];
        e2[k][c] = e1[k][c];
        e1[k][c] = valid ? __fsub_rn(v[c], color[c]) : 0.0f;
        mix_out[c * h + y] = __fadd_rn(
            __fadd_rn(__fmul_rn(e1[k][c], c3), __fmul_rn(e2[k][c], c5)),
            __fmul_rn(e3[k][c], c1));
      }
    }
    __syncthreads();
  }
}

// The pixel source of a launch: base pointer, pitches, element stride.
struct Source {
  const void* pixels;
  int pitch_h, pitch_w, stride;
};

template <typename Pixels, typename Quant, typename OutT, int R>
int launch_rows(Source src, int b, int h, int w, Quant quant, OutT* out,
                cudaStream_t stream) {
  const int rows = (h + R - 1) / R;
  const int threads = (rows + 31) / 32 * 32;
  const size_t smem = (size_t)Quant::kTableInts * sizeof(int)
                      + (size_t)2 * 3 * h * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fs_dither_f32<Pixels, Quant, OutT, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fs_dither_f32<Pixels, Quant, OutT, R><<<b, threads, smem, stream>>>(
      (const uint8_t*)src.pixels, h, w, src.pitch_h, src.pitch_w, src.stride,
      quant, out);
  return (int)cudaGetLastError();
}

template <typename Pixels, typename Quant, typename OutT>
int launch(Source src, int b, int h, int w, Quant quant, OutT* out,
           cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (h <= kMaxThreads)
    return launch_rows<Pixels, Quant, OutT, 1>(src, b, h, w, quant, out,
                                               stream);
  if (h <= 2 * kMaxThreads)
    return launch_rows<Pixels, Quant, OutT, 2>(src, b, h, w, quant, out,
                                               stream);
  if (h <= kMaxRowsPerThread * kMaxThreads)
    return launch_rows<Pixels, Quant, OutT, kMaxRowsPerThread>(
        src, b, h, w, quant, out, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename Pixels, typename Quant>
int launch_out(Source src, int b, int h, int w, Quant quant, void* out,
               int out_u8, void* stream) {
  if (out_u8)
    return launch<Pixels>(src, b, h, w, quant, (uint8_t*)out,
                          (cudaStream_t)stream);
  return launch<Pixels>(src, b, h, w, quant, (int32_t*)out,
                        (cudaStream_t)stream);
}

}  // namespace

// words: [b, pitch_h, pitch_w] int32 RGBA words, valid extent h x w.
// out: [b, h, w] uint8 (out_u8) or int32 palette indices.
extern "C" int timg_fs_dither_cube(const void* words, int b, int h, int w,
                                   int pitch_h, int pitch_w, void* out,
                                   int out_u8, void* stream) {
  return launch_out<WordPixels>(Source{words, pitch_h, pitch_w, 4}, b, h, w,
                                CubeQuant{}, out, out_u8, stream);
}

// levels: [8, 128] int32, leaves: [256] int32 (one tree for the batch).
extern "C" int timg_fs_dither_tree(const void* words, int b, int h, int w,
                                   int pitch_h, int pitch_w,
                                   const void* levels, const void* leaves,
                                   void* out, int out_u8, void* stream) {
  return launch_out<WordPixels>(
      Source{words, pitch_h, pitch_w, 4}, b, h, w,
      TreeQuant{(const int32_t*)levels, (const int32_t*)leaves}, out, out_u8,
      stream);
}

// rgb: [b, pitch_h, pitch_w, channels] uint8 (channels >= 3), valid
// extent h x w; out as above.  K9's contract.
extern "C" int timg_fs_dither_cube_rgb(const void* rgb, int b, int h, int w,
                                       int pitch_h, int pitch_w,
                                       int channels, void* out, int out_u8,
                                       void* stream) {
  if (channels < 3) return (int)cudaErrorInvalidValue;
  return launch_out<RgbPixels>(Source{rgb, pitch_h, pitch_w, channels}, b, h,
                               w, CubeQuant{}, out, out_u8, stream);
}

extern "C" int timg_fs_dither_tree_rgb(const void* rgb, int b, int h, int w,
                                       int pitch_h, int pitch_w,
                                       int channels, const void* levels,
                                       const void* leaves, void* out,
                                       int out_u8, void* stream) {
  if (channels < 3) return (int)cudaErrorInvalidValue;
  return launch_out<RgbPixels>(
      Source{rgb, pitch_h, pitch_w, channels}, b, h, w,
      TreeQuant{(const int32_t*)levels, (const int32_t*)leaves}, out, out_u8,
      stream);
}

extern "C" int timg_fs_dither_cube_max_rows() {
  return kMaxThreads * kMaxRowsPerThread;
}
