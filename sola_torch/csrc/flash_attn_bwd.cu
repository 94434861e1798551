// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound to Python through a plain C interface
// (sola_torch/ops/flash_attention.py loads them with ctypes).
//
// Replaces sola_tpu/ops/flash_attention.py::_attn_bwd_dq_kernel and
// ::_attn_bwd_dkv_kernel (launched by _core_bwd through pl.pallas_call).
// They compute the same functions, from the forward's saved logsumexp
// (lse) and delta = rowsum(dO * O) of the forward's own (dropped) output:
//   P  = exp(S * scale - lse)           S = Q K^T; masked keys score -1e30
//   dP = (dO V^T) * keep * inv_keep     (dropout: the forward's mask)
//   dS = P * (dP - delta) * scale
//   dQ = dS K        dK = dS^T Q        dV = (P * keep * inv_keep)^T dO
// with the conventions of the port's forward (flash_attn_fwd.cu): a key
// past Lk is excluded, and the keep mask is the counter hash of (seed,
// batch*head, global query, global key), so every kernel regenerates it
// from the seed whatever its tiles. A masked key gets P = 0 exactly, so its
// dK and dV rows are exactly zero, as are the dropped entries of P.
//
// What bounds it on an H100: at the selection model's training shapes
// (head dim 128, fp32; obj_attn 512 x 64 x 64, motion_attn 4096 x 8 x 8,
// object2lang_attn 64 x 512 x 128 as (batch*heads) x Lq x Lk) the dQ pass
// does 6 and the dK/dV pass 8 FLOPs per (q, k, d): at object2lang_attn,
// the largest, 3.2 and 4.3 GFLOP against some 60 MB of Q, K, V, dO, lse,
// delta and gradients, about 55-70 FLOP per byte. Against float32's
// 67 TFLOP/s outside the tensor cores that is compute-bound (48 and 64 us);
// motion_attn and obj_attn are smaller still and their bytes bound them.
//
// What this simple design does about that: nothing clever yet, it is right
// first. dQ: one block of 256 threads per (batch*head, 64-query tile) and a
// loop over 32-key tiles (the TPU's sequential k grid axis), which
// recomputes S and dP for the tile with plain fp32 FMAs from tiles staged
// in shared memory (bf16 inputs are widened to fp32 there), builds dS in
// shared memory, and adds dS K to a dQ accumulator held in registers. dK/dV:
// one block per (batch*head, 32-key tile) looping over 64-query tiles, with
// dK and dV in registers, so no atomics and a deterministic result. Key
// tiles that the mask empties are skipped (dQ) or written as zeros (dK/dV)
// when the batch entry has a valid key. No tensor cores, TMA or pipelining:
// the tiles are small and lopsided at these shapes (motion_attn's 8 x 8
// fills 1/32 of a 64 x 32 tile), so the waste of the fixed tiles, not the
// arithmetic, is what a later version has to remove.
//
// Head dims: any D <= 256 that is a multiple of 8; the register
// accumulators are sized for D <= 128 or D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

using sola_dropout::Dropout;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 32;   // key rows per tile
constexpr int kLdS = kBK + 1;  // leading dim of the (kBQ, kBK) score tiles
constexpr float kMaskedScore = -1e30f;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Stage `rows_valid` rows of a (rows, D) row-major tile as fp32 in shared
// memory with leading dim ld = D + 1 (odd, so a column read by 32 lanes on
// 32 rows hits 32 banks); rows past rows_valid are zero.
template <typename T>
__device__ inline void stage_rows(float* dst, const T* src, int rows_valid,
                                  int rows, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * ld + c] = r < rows_valid ? to_float(src[i]) : 0.0f;
  }
}

// Shared-memory floats of the stage buffers: two (kBQ, D) query-side tiles
// (Q, dO), two (kBK, D) key-side tiles (K, V), `n_score` (kBQ, kBK) tiles,
// lse and delta; then kBK mask bytes.
__host__ __device__ inline size_t smem_bytes(int D, int n_score) {
  const size_t floats = static_cast<size_t>(2 * kBQ + 2 * kBK) * (D + 1) +
                        static_cast<size_t>(n_score) * kBQ * kLdS + 2 * kBQ;
  return floats * sizeof(float) + kBK;
}

// Does batch entry `mb` (null: no mask) have a valid key at all? If so, a
// key tile that the mask empties contributes exactly nothing and is
// skipped; otherwise every tile takes part, as in the forward. Uniform
// across the block.
__device__ inline bool skip_masked_tiles(const unsigned char* mb, int Lk) {
  int any_valid = 0;
  for (int i = threadIdx.x; mb && i < Lk; i += kThreads) any_valid |= mb[i];
  return mb != nullptr && __syncthreads_or(any_valid);
}

__device__ inline bool tile_has_valid_key(const unsigned char* mb, int k0,
                                          int kv) {
  int valid = 0;
  for (int i = threadIdx.x; i < kv; i += kThreads) valid |= mb[k0 + i];
  return __syncthreads_or(valid);
}

template <typename T, int DMAX, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Lq, int Lk, int D, float scale, uint32_t seed,
                    uint32_t keep_thresh, float inv_keep) {
  constexpr int kGroups = kThreads / kBQ;  // 4 threads share a query row
  constexpr int kSPer = kBK / kGroups;     // score columns per thread
  constexpr int kDPer = DMAX / kGroups;    // dQ columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sDO = sQ + kBQ * ld;
  float* sK = sDO + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sDS = sV + kBK * ld;
  float* sLse = sDS + kBQ * kLdS;
  float* sDelta = sLse + kBQ;
  unsigned char* sMask = reinterpret_cast<unsigned char*>(sDelta + kBQ);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int qv = min(kBQ, Lq - q0);
  // thread roles: a warp holds 32 consecutive rows and one column group,
  // so row reads hit 32 banks and column reads broadcast
  const int row = threadIdx.x % kBQ;
  const int grp = threadIdx.x / kBQ;
  const size_t row0 = static_cast<size_t>(bh) * Lq + q0;
  const T* kb = k + static_cast<size_t>(bh) * Lk * D;
  const T* vb = v + static_cast<size_t>(bh) * Lk * D;
  const unsigned char* mb =
      mask ? mask + static_cast<size_t>(bh / H) * Lk : nullptr;
  Dropout drop{0u, keep_thresh, inv_keep};
  if constexpr (kDrop) drop.for_head(seed, bh);

  stage_rows(sQ, q + row0 * D, qv, kBQ, D);
  stage_rows(sDO, dout + row0 * D, qv, kBQ, D);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    // a row past Lq gets P = exp(s - inf) = 0
    sLse[i] = i < qv ? lse[row0 + i] : INFINITY;
    sDelta[i] = i < qv ? delta[row0 + i] : 0.0f;
  }
  const bool skip = skip_masked_tiles(mb, Lk);

  float acc[kDPer];
#pragma unroll
  for (int m = 0; m < kDPer; ++m) acc[m] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    const int kv = min(kBK, Lk - k0);
    if (skip && !tile_has_valid_key(mb, k0, kv)) continue;
    __syncthreads();  // the previous tile's sK / sDS are no longer read
    stage_rows(sK, kb + static_cast<size_t>(k0) * D, kv, kBK, D);
    stage_rows(sV, vb + static_cast<size_t>(k0) * D, kv, kBK, D);
    for (int i = threadIdx.x; i < kBK; i += kThreads) {
      sMask[i] = (mb && i < kv) ? (mb[k0 + i] != 0) : 1;
    }
    __syncthreads();

    // S = Q K^T and dO V^T for this thread's row and columns grp + 4j
    float s[kSPer], dp[kSPer];
#pragma unroll
    for (int j = 0; j < kSPer; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * ld + d];
      const float od = sDO[row * ld + d];
#pragma unroll
      for (int j = 0; j < kSPer; ++j) {
        const int c = grp + kGroups * j;
        s[j] = fmaf(qd, sK[c * ld + d], s[j]);
        dp[j] = fmaf(od, sV[c * ld + d], dp[j]);
      }
    }
    const float lse_r = sLse[row];
    const float delta_r = sDelta[row];
#pragma unroll
    for (int j = 0; j < kSPer; ++j) {
      const int c = grp + kGroups * j;
      float p = 0.0f;  // a key past Lk is excluded
      if (c < kv) p = expf((sMask[c] ? s[j] * scale : kMaskedScore) - lse_r);
      float dpj = dp[j];
      if constexpr (kDrop) dpj *= drop.factor(q0 + row, k0 + c);
      sDS[row * kLdS + c] = p * (dpj - delta_r) * scale;
    }
    __syncthreads();

    // dQ[row, grp + 4m] += sum_c dS[row, c] K[c, grp + 4m]
    for (int c = 0; c < kv; ++c) {
      const float ds = sDS[row * kLdS + c];
#pragma unroll
      for (int m = 0; m < kDPer; ++m) {
        const int col = grp + kGroups * m;
        if (col < D) acc[m] = fmaf(ds, sK[c * ld + col], acc[m]);
      }
    }
  }

  if (row < qv) {
    T* dst = dq + (row0 + row) * D;
#pragma unroll
    for (int m = 0; m < kDPer; ++m) {
      const int col = grp + kGroups * m;
      if (col < D) dst[col] = from_float<T>(acc[m]);
    }
  }
}

template <typename T, int DMAX, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int D,
                     float scale, uint32_t seed, uint32_t keep_thresh,
                     float inv_keep) {
  constexpr int kGroups = kThreads / kBK;  // 8 threads share a key row
  constexpr int kSPer = kBQ / kGroups;     // score rows per thread
  constexpr int kDPer = DMAX / kGroups;    // dK / dV columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sDO = sQ + kBQ * ld;
  float* sK = sDO + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * ld;
  float* sDS = sP + kBQ * kLdS;
  float* sLse = sDS + kBQ * kLdS;
  float* sDelta = sLse + kBQ;
  unsigned char* sMask = reinterpret_cast<unsigned char*>(sDelta + kBQ);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int kv = min(kBK, Lk - k0);
  // thread roles: a warp holds the tile's 32 keys and one row/column group
  const int key = threadIdx.x % kBK;
  const int grp = threadIdx.x / kBK;
  const size_t key0 = static_cast<size_t>(bh) * Lk + k0;
  const T* qb = q + static_cast<size_t>(bh) * Lq * D;
  const T* ob = dout + static_cast<size_t>(bh) * Lq * D;
  const unsigned char* mb =
      mask ? mask + static_cast<size_t>(bh / H) * Lk : nullptr;

  if (skip_masked_tiles(mb, Lk) && !tile_has_valid_key(mb, k0, kv)) {
    // every key of the tile is masked: P = 0 there, so dK = dV = 0
    for (int i = threadIdx.x; i < kv * D; i += kThreads) {
      dk[key0 * D + i] = from_float<T>(0.0f);
      dv[key0 * D + i] = from_float<T>(0.0f);
    }
    return;
  }
  Dropout drop{0u, keep_thresh, inv_keep};
  if constexpr (kDrop) drop.for_head(seed, bh);

  stage_rows(sK, k + key0 * D, kv, kBK, D);
  stage_rows(sV, v + key0 * D, kv, kBK, D);
  for (int i = threadIdx.x; i < kBK; i += kThreads) {
    sMask[i] = (mb && i < kv) ? (mb[k0 + i] != 0) : 1;
  }

  float dk_acc[kDPer], dv_acc[kDPer];
#pragma unroll
  for (int m = 0; m < kDPer; ++m) dk_acc[m] = dv_acc[m] = 0.0f;

  for (int q0 = 0; q0 < Lq; q0 += kBQ) {
    const int qv = min(kBQ, Lq - q0);
    const size_t row0 = static_cast<size_t>(bh) * Lq + q0;
    __syncthreads();  // the previous tile's sQ / sDO / sP / sDS are read
    stage_rows(sQ, qb + static_cast<size_t>(q0) * D, qv, kBQ, D);
    stage_rows(sDO, ob + static_cast<size_t>(q0) * D, qv, kBQ, D);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      sLse[i] = i < qv ? lse[row0 + i] : INFINITY;
      sDelta[i] = i < qv ? delta[row0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T and (dO V^T)^T for this thread's key and rows grp + 8i
    float s[kSPer], dp[kSPer];
#pragma unroll
    for (int i = 0; i < kSPer; ++i) s[i] = dp[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[key * ld + d];
      const float vd = sV[key * ld + d];
#pragma unroll
      for (int i = 0; i < kSPer; ++i) {
        const int r = grp + kGroups * i;
        s[i] = fmaf(sQ[r * ld + d], kd, s[i]);
        dp[i] = fmaf(sDO[r * ld + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSPer; ++i) {
      const int r = grp + kGroups * i;
      float p = 0.0f;  // a key past Lk is never written; keep it finite
      if (key < kv) {
        p = expf((sMask[key] ? s[i] * scale : kMaskedScore) - sLse[r]);
      }
      float pv = p;
      float dpi = dp[i];
      if constexpr (kDrop) {
        const float f = drop.factor(q0 + r, k0 + key);
        pv = p * f;
        dpi = dpi * f;
      }
      sP[r * kLdS + key] = pv;
      sDS[r * kLdS + key] = p * (dpi - sDelta[r]) * scale;
    }
    __syncthreads();

    // dV[key, col] += sum_r P[r, key] dO[r, col]; dK likewise with dS, Q
    for (int r = 0; r < qv; ++r) {
      const float pv = sP[r * kLdS + key];
      const float ds = sDS[r * kLdS + key];
#pragma unroll
      for (int m = 0; m < kDPer; ++m) {
        const int col = grp + kGroups * m;
        if (col < D) {
          dv_acc[m] = fmaf(pv, sDO[r * ld + col], dv_acc[m]);
          dk_acc[m] = fmaf(ds, sQ[r * ld + col], dk_acc[m]);
        }
      }
    }
  }

  if (key < kv) {
    T* dk_row = dk + (key0 + key) * D;
    T* dv_row = dv + (key0 + key) * D;
#pragma unroll
    for (int m = 0; m < kDPer; ++m) {
      const int col = grp + kGroups * m;
      if (col < D) {
        dk_row[col] = from_float<T>(dk_acc[m]);
        dv_row[col] = from_float<T>(dv_acc[m]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const unsigned char* mask;
  const void* dout;
  const float *lse, *delta;
  void *g0, *g1;  // dQ; or dK, dV
  int BH, H, Lq, Lk, D;
  float scale;
  uint32_t seed, keep_thresh;
  float inv_keep;
};

template <typename T, int DMAX, bool kDrop>
int launch_dq(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, DMAX, kDrop>;
  const size_t bytes = smem_bytes(a.D, 1);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, a.BH);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.g0), a.H, a.Lq, a.Lk, a.D, a.scale,
      a.seed, a.keep_thresh, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX, bool kDrop>
int launch_dkv(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, DMAX, kDrop>;
  const size_t bytes = smem_bytes(a.D, 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + kBK - 1) / kBK, a.BH);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.H,
      a.Lq, a.Lk, a.D, a.scale, a.seed, a.keep_thresh, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// Picks the instance: the accumulator width for D (128 or 256), for the
// kernel, input type and dropout of the caller.
template <bool kDq, typename T, bool kDrop>
int dispatch_d(const Args& a, cudaStream_t s) {
  if constexpr (kDq) {
    return a.D <= 128 ? launch_dq<T, 128, kDrop>(a, s)
                      : launch_dq<T, 256, kDrop>(a, s);
  } else {
    return a.D <= 128 ? launch_dkv<T, 128, kDrop>(a, s)
                      : launch_dkv<T, 256, kDrop>(a, s);
  }
}

template <bool kDq>
int dispatch(const Args& a, int dtype, void* stream) {
  if (a.D <= 0 || a.D > 256 || a.D % 8 != 0 || a.Lq <= 0 || a.Lk <= 0 ||
      a.BH <= 0 || a.H <= 0 || a.BH % a.H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = a.inv_keep > 0.0f;
  if (dtype == 0) {
    return drop ? dispatch_d<kDq, float, true>(a, s)
                : dispatch_d<kDq, float, false>(a, s);
  }
  if (dtype == 1) {
    return drop ? dispatch_d<kDq, bf16, true>(a, s)
                : dispatch_d<kDq, bf16, false>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dout (BH, Lq, D); k, v (BH, Lk, D);
// mask (BH / H, Lk) bytes or null; lse and delta (BH, Lq) float32; dq like
// q. Dropout as in sola_flash_attn_fwd (inv_keep = 0: none). Returns the
// cudaError_t of the launch (0 on success).
int sola_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                           const unsigned char* mask, const void* dout,
                           const float* lse, const float* delta, void* dq,
                           int BH, int H, int Lq, int Lk, int D, int dtype,
                           float scale, unsigned int seed,
                           unsigned int keep_thresh, float inv_keep,
                           void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dq, nullptr, BH, H, Lq, Lk, D,
               scale, seed, keep_thresh, inv_keep};
  return dispatch<true>(a, dtype, stream);
}

// As sola_flash_attn_bwd_dq, writing dk and dv (like k and v).
int sola_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                            const unsigned char* mask, const void* dout,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int BH, int H, int Lq, int Lk, int D,
                            int dtype, float scale, unsigned int seed,
                            unsigned int keep_thresh, float inv_keep,
                            void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, dk, dv, BH, H, Lq, Lk, D,
               scale, seed, keep_thresh, inv_keep};
  return dispatch<false>(a, dtype, stream);
}

}  // extern "C"
