// Multi-scale deformable attention sampling, forward, for Hopper (sm_90a),
// bound to Python through a plain C interface
// (sola_torch/ops/deformable_interp.py loads it with ctypes).
//
// Replaces sola_tpu/ops/deformable_interp.py::_interp_kernel (launched by
// interp_matmul_level through pl.pallas_call, entry
// ms_deform_attn_core_pallas). It computes the same function:
//   out[b, q, h, :] = sum over levels l, points p and the 4 bilinear corners
//                     of attn_w[b, q, h, l, p] * corner_w * V_l[b, corner, h, :]
// with align_corners=False pixel mapping (x = loc_x * W - 0.5), zero outside
// the map, fp32 accumulation over every level and point, and one write of
// the output in the values' type.
//
// The TPU kernel builds a tile-sparse interpolation matrix S and runs S @ V
// on the matrix unit, because the TPU has no gather. The card has one, so
// this is the direct gather form of the upstream CUDA op: one warp per
// (batch, query, head), lanes over the head's channels. With head_dim 32 a
// corner is one coalesced 128-byte fp32 row (64 bytes in bf16); a smaller
// head_dim leaves lanes idle and a larger one loops.
//
// Corner math follows corner_terms (deformable_interp.py:161-193) exactly:
// location math in fp32 even for bf16 values, floor, a per-corner in-range
// test, clipped indices, and the weight attn_w * corner_w. The products and
// differences use the _rn intrinsics so that nvcc does not contract them
// into FMAs, which would round differently from the reference. Lane
// t = l * P + p computes term t's 4 corner indices and weights once; the
// warp then walks the terms, taking each from its lane with __shfl_sync.
// A corner with zero weight (out of range) is skipped: its term is exactly
// zero for finite values.
//
// What bounds it on an H100: bytes. Per (query, head) it reads L * P
// locations and weights and up to 4 * L * P value rows, and does 2 FLOPs
// per value element read, far below the card's balance point. Counting each
// input once (values, locations, weights) and the output once, the
// encoder's call at an 800x1333 canvas moves ~80 MB per expression in fp32.
// The value rows it gathers are read from L2 many times (each row is a
// corner of many queries); this simple design keeps no tile of V in shared
// memory and relies on L2 for that reuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 16;
constexpr int kMaxChunks = 8;  // head_dim <= 8 * 32
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ inline T from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// One bilinear corner (yi, xi) of a level: its flat index into the
// flattened (sum HW) value axis, clipped into the map, and its weight
// attn * corner_w, zero when the corner lies outside the map.
__device__ inline void corner(float yi, float xi, float cw, float a, int h,
                              int w, int start, int* idx, float* wgt) {
  const bool inb = xi >= 0.f && xi < static_cast<float>(w) && yi >= 0.f &&
                   yi < static_cast<float>(h);
  const int xc = static_cast<int>(fminf(fmaxf(xi, 0.f),
                                        static_cast<float>(w - 1)));
  const int yc = static_cast<int>(fminf(fmaxf(yi, 0.f),
                                        static_cast<float>(h - 1)));
  *idx = start + yc * w + xc;
  *wgt = inb ? __fmul_rn(cw, a) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_fwd_kernel(const T* __restrict__ value,
                     const float* __restrict__ loc,
                     const float* __restrict__ attn, T* __restrict__ out,
                     const Levels lv, int S, int Lq, int H, int D, int L,
                     int P, long long n_items) {
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp leaves together
  const int h = static_cast<int>(item % H);
  const long long b = item / H / Lq;
  const int C = H * D;
  const int LP = L * P;
  const T* vbase = value + static_cast<size_t>(b) * S * C +
                   static_cast<size_t>(h) * D;
  const float* locp = loc + static_cast<size_t>(item) * LP * 2;
  const float* attp = attn + static_cast<size_t>(item) * LP;

  float acc[kMaxChunks];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) acc[k] = 0.f;

  for (int base = 0; base < LP; base += 32) {
    const int t = base + lane;
    int i00 = 0, i01 = 0, i10 = 0, i11 = 0;
    float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
    if (t < LP) {
      const int l = t / P;
      const int hl = lv.h[l], wl = lv.w[l], st = lv.start[l];
      const float a = attp[t];
      const float x = __fsub_rn(__fmul_rn(locp[2 * t], static_cast<float>(wl)),
                                0.5f);
      const float y = __fsub_rn(
          __fmul_rn(locp[2 * t + 1], static_cast<float>(hl)), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
      const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
      const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
      corner(y0, x0, __fmul_rn(wy0, wx0), a, hl, wl, st, &i00, &w00);
      corner(y0, x1, __fmul_rn(wy0, wx1), a, hl, wl, st, &i01, &w01);
      corner(y1, x0, __fmul_rn(wy1, wx0), a, hl, wl, st, &i10, &w10);
      corner(y1, x1, __fmul_rn(wy1, wx1), a, hl, wl, st, &i11, &w11);
    }
    const int n = min(32, LP - base);
    for (int j = 0; j < n; ++j) {
      const int idx[4] = {__shfl_sync(kFull, i00, j), __shfl_sync(kFull, i01, j),
                          __shfl_sync(kFull, i10, j),
                          __shfl_sync(kFull, i11, j)};
      const float wgt[4] = {__shfl_sync(kFull, w00, j),
                            __shfl_sync(kFull, w01, j),
                            __shfl_sync(kFull, w10, j),
                            __shfl_sync(kFull, w11, j)};
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        if (wgt[c4] == 0.f) continue;  // warp-uniform: the weight is shared
        const T* row = vbase + static_cast<size_t>(idx[c4]) * C;
#pragma unroll
        for (int k = 0; k < kMaxChunks; ++k) {
          const int c = lane + 32 * k;
          if (c < D) acc[k] += wgt[c4] * to_float(row[c]);
        }
      }
    }
  }

  T* orow = out + static_cast<size_t>(item) * D;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c = lane + 32 * k;
    if (c < D) orow[c] = from_float<T>(acc[k]);
  }
}

template <typename T>
int launch(const void* value, const float* loc, const float* attn, void* out,
           const Levels& lv, int B, int S, int Lq, int H, int D, int L, int P,
           cudaStream_t stream) {
  const long long n_items = static_cast<long long>(B) * Lq * H;
  const long long blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ms_deform_fwd_kernel<T><<<static_cast<unsigned>(blocks),
                            kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), lv, S,
      Lq, H, D, L, P, n_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (values and output).
// value (B, S, H * D) with S = sum of h[l] * w[l], levels stacked in order
// at offsets start[l]; loc (B, Lq, H, L, P, 2) float32 in [0, 1] (x, y);
// attn (B, Lq, H, L, P) float32; out (B, Lq, H * D).
// shapes: host array of 2 * L ints (h0, w0, h1, w1, ...); starts: host
// array of L ints. Returns the cudaError_t of the launch (0 on success).
int sola_ms_deform_attn_fwd(const void* value, const float* loc,
                            const float* attn, const int* shapes,
                            const int* starts, void* out, int B, int S,
                            int Lq, int H, int D, int L, int P, int dtype,
                            void* stream) {
  if (B <= 0 || S <= 0 || Lq <= 0 || H <= 0 || D <= 0 ||
      D > 32 * kMaxChunks || L <= 0 || L > kMaxLevels || P <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = starts[l];
    if (lv.h[l] <= 0 || lv.w[l] <= 0 || lv.start[l] < 0 ||
        lv.start[l] + lv.h[l] * lv.w[l] > S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int l = L; l < kMaxLevels; ++l) lv.h[l] = lv.w[l] = lv.start[l] = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P, s);
  }
  if (dtype == 1) {
    return launch<bf16>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
