// Sixel DCS body bytes of uint8 index planes, a band at a time (the
// device-emitted DCS device->host transport).
//
// Replaces timg_tpu/ops/sixel_dcs.py plan_device, layout_device and
// emit_device (XLA device ops in the reference, under batch_band_lens and
// batch_encode; no Pallas kernel).  Input: [B, >=h, >=w] uint8 planes,
// rows contiguous, given with their frame and row strides; any w < 32768.
//
// One block of 256 threads a (band, frame); no block barrier inside a
// colour's walk.
// 1. Presence: every pixel of the band's rows (at most 6; the last band's
//    pad rows are left out, as the reference's sentinel 256 matches no
//    colour) stores 1 into a 256-byte set (4-byte loads where the row
//    allows); a ballot a warp makes it a 256-bit set, and a colour's slot
//    in the list is the popc of the set bits below it.  Slots 0..63
//    (COLOR_CAP) are laid out; the count goes out unclamped, so the
//    caller falls back to the plane when it exceeds 64.
// 2. Mask rows, a tile of columns at a time: the listed colours' rows
//    share kMaskBytes of shared memory, so the tile is as wide as that
//    allows (all of a 1280-column row for up to 24 colours) and shared
//    memory does not grow with w.  Each thread takes a column, loads its
//    rows' bytes, and ORs each row's bit into its colour's byte; the
//    buffer reads 0 past w.
// 3. The walk: a warp takes the next listed colour (a shared counter)
//    and walks its mask row 32 columns a step, one a lane.  A run starts
//    where m[x] != m[x-1] (a ballot); the lane at a start ends the run
//    before it, whose start is the highest start below it in the step
//    (clz of the ballot) or the one carried from the steps before, so a
//    run that crosses steps and tiles keeps its start in a register.  A
//    run's bytes: 2 + digits(len) when len > 3 ('!', the length with the
//    reference's 4-digit cap, the char), else len (the char repeated).
//    m starts at 0 before x = 0 and reads 0 past w, so a zero run at the
//    row's end never ends and costs nothing (the reference drops it), and
//    a run ending at x = 0 has length 0.  Where the row is 0 and the step
//    held no start, the warp skims 128 columns a step (4-byte loads, one
//    ballot) to the next step holding a nonzero byte.  A colour's state
//    (m before the tile, the open run's start, its bytes) waits in shared
//    memory between tiles.
// 4. Offsets: a row has content exactly when its runs hold bytes.  One
//    warp gives each listed colour its header ('$' before every content
//    row but the band's first, '#', the colour's digits) and scans the
//    64 row totals: the band's length and each row's offset.
//
// dcs_band_lens walks once and writes each band's byte total and colour
// count.  dcs_emit walks once to size the rows, then (mask rows rebuilt
// where a row took more than one tile) walks each content row again: a
// warp scan of a step's run bytes places each run, and the lane at the
// run's end writes it.  Nothing is written at or past cap, and every
// byte of the band buffer is written: a band of cap <= kStageMax is
// staged in shared memory and goes out in 16-byte stores, zeros past its
// length included; a larger one is written in place and its tail zeroed.
// The host reads the lengths to pick cap between the two launches, as
// the reference does.
//
// Bound on the H100: integer operations (the function needs a pixel's
// presence and mask bits, then a listed colour and column's start
// compare and byte count, and a store a body byte).  The walk spends
// about 30 instructions a 32-column step and a few a skimmed 128
// columns, so the kernels stay well above that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // one thread a colour in the presence set
constexpr int kWarps = kThreads / 32;
constexpr int kColorCap = 64;
constexpr int kMaskBytes = 32768;   // the mask rows of a tile
constexpr int kStageMax = 2048;     // dcs_emit stages a band up to this cap
constexpr unsigned kAll = 0xffffffffu;

struct Planes {
  const uint8_t* p;
  long long frame_stride, row_stride;
  int h, w, nb;
};

// Decimal digits, capped at 4 as the reference counts them.
__device__ __forceinline__ int digits(int v) {
  return v >= 1000 ? 4 : v >= 100 ? 3 : v >= 10 ? 2 : 1;
}

__device__ __forceinline__ int run_bytes(int len) {
  return len > 3 ? 2 + digits(len) : len;
}

__device__ __forceinline__ void put(uint8_t* dst, int q, int cap, int v) {
  if (q < cap) dst[q] = (uint8_t)v;
}

// The nd digits of v at q..q+nd-1, most significant first; with nd = 4
// the first is (v / 1000) % 10, as the reference caps the power.
__device__ __forceinline__ void put_digits(uint8_t* dst, int q, int cap,
                                          int v, int nd) {
  const int e = q + nd - 1;         // the units digit's position
  put(dst, e, cap, '0' + v % 10);
  if (nd > 1) put(dst, e - 1, cap, '0' + v / 10 % 10);
  if (nd > 2) put(dst, e - 2, cap, '0' + v / 100 % 10);
  if (nd > 3) put(dst, e - 3, cap, '0' + v / 1000 % 10);
}

__device__ __forceinline__ void put_run(uint8_t* dst, int q, int cap,
                                        int len, int value) {
  const int ch = 0x3F + value;
  if (len > 3) {
    const int nd = digits(len);
    put(dst, q, cap, '!');
    put_digits(dst, q + 1, cap, len, nd);
    put(dst, q + 1 + nd, cap, ch);
  } else {
    for (int k = 0; k < len; ++k) put(dst, q + k, cap, ch);
  }
}

// Every colour of one row into the presence set (4-byte loads from the
// first aligned column).
__device__ __forceinline__ void mark_row(const uint8_t* __restrict__ row,
                                         int w, uint8_t* present) {
  const int tid = threadIdx.x;
  const int head = min(w, (int)((4 - ((uintptr_t)row & 3)) & 3));
  if (tid < head) present[__ldg(row + tid)] = 1;
  const uint32_t* row4 = (const uint32_t*)(row + head);
  const int nw = (w - head) >> 2;
#pragma unroll 4
  for (int i = tid; i < nw; i += kThreads) {
    const uint32_t v = __ldg(row4 + i);
    present[v & 255] = 1;
    present[(v >> 8) & 255] = 1;
    present[(v >> 16) & 255] = 1;
    present[v >> 24] = 1;
  }
  for (int x = head + 4 * nw + tid; x < w; x += kThreads)
    present[__ldg(row + x)] = 1;
}

// 16 bytes of the staged band, zero from byte n on (n < 16).
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int n) {
  const auto mask = [n](int c) {
    const int k = min(max(n - 4 * c, 0), 4);
    return k == 4 ? 0xffffffffu : (1u << (8 * k)) - 1;
  };
  return make_uint4(v.x & mask(0), v.y & mask(1), v.z & mask(2),
                    v.w & mask(3));
}

// One warp walks one colour's mask row over columns [t0, end) of the
// tile whose buffer row is mrow (zero past w).  prev, start and acc are
// the colour's carried state: m at t0 - 1, the open run's start, and its
// bytes so far (kWrite: the next byte's position in the band).  The
// caller keeps end <= t0 + tile, and tile and t0 multiples of 32.
template <bool kWrite>
__device__ __forceinline__ void walk(const uint8_t* mrow, int t0, int end,
                                     int& prev, int& start, int& acc,
                                     uint8_t* dst, int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned below_me = (1u << lane) - 1;
  bool quiet = prev == 0;   // the row is 0 here and the last step was flat
  int sum = 0;
  for (int c0 = t0; c0 < end; c0 += 32) {
    if (quiet) {            // skim: the first step with a nonzero byte
      const int c = c0 + 4 * lane;
      const uint32_t v = c < end ? *(const uint32_t*)(mrow + (c - t0)) : 1u;
      const unsigned nz = __ballot_sync(kAll, v != 0);
      if (!nz) {
        c0 += 96;           // 128 columns of zeros
        continue;
      }
      c0 += ((__ffs(nz) - 1) >> 3) * 32;   // 8 words a step
      if (c0 >= end) break;
    }
    const int x = c0 + lane;
    const int m = mrow[x - t0];
    int pm = __shfl_up_sync(kAll, m, 1);
    if (lane == 0) pm = prev;
    const bool st = m != pm;
    const unsigned starts = __ballot_sync(kAll, st);
    if (starts) {
      const unsigned b = starts & below_me;
      const int len = x - (b ? c0 + 31 - __clz(b) : start);
      const int n = st ? run_bytes(len) : 0;
      if (kWrite) {
        int inc = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kAll, inc, o);
          if (lane >= o) inc += y;
        }
        if (n) put_run(dst, acc + inc - n, cap, len, pm);
        acc += __shfl_sync(kAll, inc, 31);
      } else {
        sum += n;
      }
      start = c0 + 31 - __clz(starts);
    }
    prev = __shfl_sync(kAll, m, 31);
    quiet = !starts && !prev;
  }
  if (!kWrite) acc += __reduce_add_sync(kAll, sum);
}

template <bool kEmit>
__global__ void __launch_bounds__(kThreads)
dcs_bands(Planes P, int mask_bytes, int cap, int32_t* __restrict__ lens,
          int32_t* __restrict__ counts, uint8_t* __restrict__ out) {
  // [ncol][tile] mask rows, then (dcs_emit, cap <= kStageMax) the band
  extern __shared__ __align__(16) uint8_t masks[];
  __shared__ uint8_t present[256];
  __shared__ uint8_t slot_of[256];
  __shared__ unsigned present_bits[kWarps];
  __shared__ int clist[kColorCap];
  __shared__ int st_prev[kColorCap], st_start[kColorCap], st_acc[kColorCap];
  __shared__ int body[kColorCap];
  __shared__ int next_colour, band_len;

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int band = blockIdx.x, f = blockIdx.y;
  const int w = P.w;
  const int nrows = min(6, P.h - band * 6);
  const uint8_t* src = P.p + f * P.frame_stride
                       + (long long)band * 6 * P.row_stride;
  uint8_t* dst = kEmit ? out + ((long long)f * P.nb + band) * cap : nullptr;
  const bool staged = kEmit && cap <= kStageMax && cap % 16 == 0;
  uint8_t* sink = staged ? masks + mask_bytes : dst;   // the bytes go here

  // 1. presence -> the 256-bit set -> slots
  present[tid] = 0;
  if (tid < kColorCap) st_prev[tid] = st_start[tid] = st_acc[tid] = 0;
  __syncthreads();
  for (int r = 0; r < nrows; ++r) mark_row(src + r * P.row_stride, w, present);
  __syncthreads();
  const bool here = present[tid] != 0;
  const unsigned bits = __ballot_sync(kAll, here);
  if (lane == 0) present_bits[wid] = bits;
  __syncthreads();
  int slot = __popc(bits & ((1u << lane) - 1)), total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int n = __popc(present_bits[k]);
    slot += k < wid ? n : 0;
    total += n;
  }
  const bool listed = here && slot < kColorCap;
  slot_of[tid] = listed ? slot : 0xFF;
  if (listed) clist[slot] = tid;
  const int ncol = min(total, kColorCap);
  // columns 0..w (w reads as 0) in tiles of a multiple of 32 columns, as
  // wide as the listed colours' rows let mask_bytes hold
  const int tile = min((w + 32) / 32 * 32,
                       mask_bytes / max(ncol, 1) / 32 * 32);

  // 2-3. tiles of mask rows and the walks; dcs_emit walks twice
  for (int pass = 0; pass < (kEmit ? 2 : 1); ++pass) {
    for (int t0 = 0; t0 <= w; t0 += tile) {
      if (pass == 0 || tile <= w) {   // else the one tile is still there
        __syncthreads();
        uint4* z = (uint4*)masks;
        for (int i = tid; i < ncol * tile / 16; i += kThreads)
          z[i] = make_uint4(0, 0, 0, 0);
        __syncthreads();
        const int ncols = min(tile, w - t0);
        for (int i = tid; i < ncols; i += kThreads) {
          const uint8_t* col = src + t0 + i;
          int px[6];
#pragma unroll
          for (int r = 0; r < 6; ++r)
            px[r] = r < nrows ? __ldg(col + r * P.row_stride) : 0;
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            const int s = slot_of[px[r]];
            if (r < nrows && s != 0xFF)
              masks[s * tile + i] |= (uint8_t)(1 << r);
          }
        }
      }
      if (tid == 0) next_colour = 0;
      __syncthreads();
      const int end = min(t0 + tile, w + 1);
      for (;;) {
        int s = 0;
        if (lane == 0) s = atomicAdd(&next_colour, 1);
        s = __shfl_sync(kAll, s, 0);
        if (s >= ncol) break;
        if (pass && !body[s]) continue;   // no content: nothing to write
        int prev = st_prev[s], start = st_start[s], acc = st_acc[s];
        if (pass)
          walk<true>(masks + s * tile, t0, end, prev, start, acc, sink, cap);
        else
          walk<false>(masks + s * tile, t0, end, prev, start, acc, nullptr,
                      0);
        if (lane == 0) {
          st_prev[s] = prev;
          st_start[s] = start;
          st_acc[s] = acc;
        }
      }
      __syncthreads();
    }
    if (pass) break;

    // 4. headers and row offsets (warp 0); dcs_emit writes the headers
    if (wid == 0) {
      int base = 0;
      bool seen = false;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = half * 32 + lane;
        const int b = s < ncol ? st_acc[s] : 0;
        const unsigned content = __ballot_sync(kAll, b > 0);
        const bool dollar = b > 0 && (seen || (content & ((1u << lane) - 1)));
        seen = seen || content;
        const int colour = s < ncol ? clist[s] : 0;
        const int nd = digits(colour);
        const int hdr = b > 0 ? dollar + 1 + nd : 0;
        int inc = hdr + b;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kAll, inc, o);
          if (lane >= o) inc += y;
        }
        const int at = base + inc - hdr - b;   // the row's first byte
        if (kEmit) {
          if (b > 0) {
            if (dollar) put(sink, at, cap, '$');
            put(sink, at + dollar, cap, '#');
            put_digits(sink, at + dollar + 1, cap, colour, nd);
          }
          body[s] = b;
          st_prev[s] = st_start[s] = 0;
          st_acc[s] = at + hdr;
        }
        base += __shfl_sync(kAll, inc, 31);
      }
      if (lane == 0) {
        lens[f * P.nb + band] = base;
        band_len = base;
        if (!kEmit) counts[f * P.nb + band] = total;
      }
    }
  }

  // 5. dcs_emit: the rest of the band buffer, zero past the band's length
  // (the staged band in 16-byte stores, else the bytes past the length)
  if (kEmit) {
    __syncthreads();
    const int len = band_len;
    if (staged) {
      const uint4* s4 = (const uint4*)sink;
      uint4* d4 = (uint4*)dst;
      for (int i = tid; i < cap / 16; i += kThreads) {
        const int n = len - 16 * i;
        d4[i] = n >= 16 ? s4[i]
              : n > 0 ? keep_bytes(s4[i], n) : make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int q = len + tid; q < cap; q += kThreads) dst[q] = 0;
    }
  }
}

template <bool kEmit>
int launch(const Planes& P, int b, int cap, void* lens, void* counts,
           void* out, void* stream) {
  // the mask rows of all 64 colours over columns 0..w, up to kMaskBytes,
  // and a staged band (under 48 KB with the static arrays)
  const int mask_bytes = min(kMaskBytes, kColorCap * ((P.w + 32) / 32 * 32));
  const int smem = mask_bytes
                   + (kEmit && cap <= kStageMax && cap % 16 == 0 ? cap : 0);
  dcs_bands<kEmit><<<dim3(P.nb, b), kThreads, smem, (cudaStream_t)stream>>>(
      P, mask_bytes, cap, (int32_t*)lens, (int32_t*)counts, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: [B, >=h, >=w] uint8 with the given strides (elements); lens and
// counts: [B, nb] int32 out (bytes of each band's body; present colours).
extern "C" int timg_dcs_band_lens(const void* planes, int b, int h, int w,
                                  long long frame_stride,
                                  long long row_stride, void* lens,
                                  void* counts, void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  return launch<false>(P, b, 0, lens, counts, nullptr, stream);
}

// bands: [B, nb, cap] uint8 out, 16-byte aligned, every byte written
// (zero past each band's length); lens: [B, nb] int32 out.
extern "C" int timg_dcs_emit(const void* planes, int b, int h, int w,
                             long long frame_stride, long long row_stride,
                             int cap, void* bands, void* lens,
                             void* stream) {
  const Planes P{(const uint8_t*)planes, frame_stride, row_stride, h, w,
                 (h + 5) / 6};
  return launch<true>(P, b, cap, lens, nullptr, bands, stream);
}
