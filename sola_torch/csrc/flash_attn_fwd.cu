// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (sola_torch/ops/flash_attention.py loads it with ctypes).
//
// Replaces sola_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _fwd_impl through pl.pallas_call). It computes the same function:
//   O   = softmax(Q K^T / sqrt(D)) V     per (batch*head) row block
//   lse = m + log(l)                     fp32 logsumexp per query row
// with fp32 running max, running sum and accumulator, and P cast to V's
// type before the PV product, as the Pallas kernel does.
//
// Dropout (training): with inv_keep > 0 the P that enters the PV product is
// multiplied by keep x inv_keep, where keep is _keep_mask's counter hash of
// (seed, batch*head, global query, global key) below keep_thresh; the row
// sum l stays undropped (softmax first, then dropout on the probabilities,
// torch SDPA's placement). The hash uses global indices, so the mask does
// not depend on this kernel's tiles and the two backward kernels
// (flash_attn_bwd.cu) regenerate it exactly. inv_keep = 0 selects the
// instance without dropout, which is the kernel as it was before dropout.
//
// Masking: the key mask arrives as (B, Lk) bytes shared by the H heads of a
// batch entry. A masked key scores -1e30 (not -inf), so a fully masked row
// returns the mean of V over the real keys, the convention of the dense
// paths (sam2/memory.py). A key past Lk in the ragged last tile is excluded
// (scores -inf and adds nothing), where the Pallas kernel padded keys with
// zeros and scored them -1e30.
//
// What bounds it on an H100: at the shapes of the SAM2 main path it is
// compute-bound. Memory cross-attention does 4*B*Lq*Lk*D = 4*4*4096*28736*256
// ~ 0.48 TFLOP per layer for 4 objects against ~133 MB of Q, K, V and O, so
// it sits far above the card's ~295 FLOP/byte balance point for bf16. Its
// bound is the tensor cores' 989 TFLOP/s.
//
// What this simple design does about that: one thread block per
// (batch*head, 64-query tile); a loop inside the block over key tiles staged
// in shared memory (this replaces the TPU's sequential k grid axis and its
// VMEM scratch). For bf16 both products run on the tensor cores through
// WMMA 16x16x16 fragments with fp32 accumulation; the score tile, the
// softmax statistics and the fp32 output accumulator live in shared memory,
// so the (Lq, Lk) score matrix never reaches device memory. Key tiles that
// the mask empties (memory slots not yet filled early in a pass, unused
// pointer slots) are skipped, so the work follows the valid keys. There is no
// TMA, no wgmma and no producer/consumer pipeline yet: loads and products
// alternate under __syncthreads, so the card runs well below its peak.
// The fp32 path (Hiera's global blocks, whose encoder computes in fp32 as the
// JAX package's does) runs both products on the tensor cores as three TF32
// products (3xTF32): x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
// a*b ~ hi_a*lo_b + lo_a*hi_b + hi_a*hi_b, which keeps about 21 of fp32's 24
// mantissa bits (a single TF32 product keeps 11).
//
// Head dims: any D <= 256 that is a multiple of 8. D is padded with zeros to
// a multiple of 16 inside shared memory; the caller never pads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"

using namespace nvcuda;

namespace {

using sola_dropout::Dropout;

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;              // query rows per block
constexpr int kWarps = 4;            // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kMaskedScore = -1e30f;

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BK = 64;              // keys per shared-memory tile
  static constexpr bool kSeparateP = true;   // P stored as bf16 for WMMA
};
template <> struct Tile<float> {
  static constexpr int BK = 32;              // fp32 tiles are twice as wide
  static constexpr bool kSeparateP = false;  // P overwrites S in place
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Byte offsets of the shared-memory regions of one block. Leading dims are
// padded (+8 / +4 elements) to spread rows over the banks; every region
// starts 128-byte aligned, which WMMA's 32-byte rule needs.
struct Layout {
  int dp, ldt, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, a, mask, total;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int dp) {
  constexpr int bk = Tile<T>::BK;
  Layout L;
  L.dp = dp;
  L.ldt = dp + 8;
  L.lds = bk + 4;
  L.ldp = bk + 8;
  L.ldo = dp + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(T) * kBQ * L.ldt);
  L.k = off; off = align128(off + sizeof(T) * bk * L.ldt);
  L.v = off; off = align128(off + sizeof(T) * bk * L.ldt);
  L.s = off; off = align128(off + sizeof(float) * kBQ * L.lds);
  L.p = off;
  if (Tile<T>::kSeparateP) off = align128(off + sizeof(T) * kBQ * L.ldp);
  L.o = off; off = align128(off + sizeof(float) * kBQ * L.ldo);
  L.m = off; off = align128(off + sizeof(float) * kBQ);
  L.l = off; off = align128(off + sizeof(float) * kBQ);
  L.a = off; off = align128(off + sizeof(float) * kBQ);
  L.mask = off; off = align128(off + bk);
  L.total = off;
  return L;
}

template <typename T> __device__ inline T from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows_valid` rows of a (rows, d) row-major tile into shared memory
// with leading dim `ld`, zero-filling rows past rows_valid and columns
// d..dp. 16-byte vectors: d % 8 == 0 keeps every vector inside or outside
// the real columns, and the wrapper checks 16-byte base alignment.
template <typename T>
__device__ inline void load_tile(T* dst, int ld, const T* src, int rows_valid,
                                 int rows, int d, int dp) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = dp / VE;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * VE;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < d) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * d + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
using FragA32 = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                               wmma::precision::tf32, wmma::row_major>;
template <typename Major>
using FragB32 =
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, Major>;

// Splits a fragment loaded with fp32 values into hi = tf32(x) (in place) and
// lo = tf32(x - hi); x - hi is exact in fp32.
template <typename Frag>
__device__ inline void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float x = hi.x[t];
    const float h = wmma::__float_to_tf32(x);
    hi.x[t] = h;
    lo.x[t] = wmma::__float_to_tf32(x - h);
  }
}

// acc += a * b in 3xTF32, the small cross terms first.
template <typename FB>
__device__ inline void mma_3xtf32(FragC& acc, const FragA32& a_hi,
                                  const FragA32& a_lo, const FB& b_hi,
                                  const FB& b_lo) {
  wmma::mma_sync(acc, a_lo, b_hi, acc);
  wmma::mma_sync(acc, a_hi, b_lo, acc);
  wmma::mma_sync(acc, a_hi, b_hi, acc);
}

// S[16 rows of this warp, BK] = Q K^T (unscaled), fp32.
template <typename T>
__device__ inline void warp_scores(const T* sQ, const T* sK, float* sS,
                                   const Layout& L, int warp, int lane) {
  constexpr int BK = Tile<T>::BK;
  if constexpr (std::is_same<T, bf16>::value) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int kk = 0; kk < L.dp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sQ + warp * 16 * L.ldt + kk, L.ldt);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        // B(k, n) = K[n][k]: K's rows read as a column-major B
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sK + n * 16 * L.ldt + kk, L.ldt);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::store_matrix_sync(sS + warp * 16 * L.lds + n * 16, acc[n], L.lds,
                              wmma::mem_row_major);
    }
  } else {
    FragC acc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int kk = 0; kk < L.dp; kk += 8) {
      FragA32 a_hi, a_lo;
      wmma::load_matrix_sync(a_hi, sQ + warp * 16 * L.ldt + kk, L.ldt);
      split_tf32(a_hi, a_lo);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        FragB32<wmma::col_major> b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, sK + n * 16 * L.ldt + kk, L.ldt);
        split_tf32(b_hi, b_lo);
        mma_3xtf32(acc[n], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::store_matrix_sync(sS + warp * 16 * L.lds + n * 16, acc[n], L.lds,
                              wmma::mem_row_major);
    }
  }
}

// Online-softmax update of this warp's 16 rows over one key tile: writes
// P = exp(s - m_new) (as T, P's home depends on the path), the rescale
// factor alpha, and the new running max and sum. With kDrop the stored P is
// the dropped one (x keep x inv_keep at global row q0 + r, key k0 + c); the
// sum is not.
template <typename T, bool kDrop>
__device__ inline void warp_softmax(float* sS, T* sP, int ldp, float* sM,
                                    float* sL, float* sA,
                                    const unsigned char* sMask, int kv,
                                    float scale, const Dropout& drop, int q0,
                                    int k0, const Layout& L, int warp,
                                    int lane) {
  constexpr int BK = Tile<T>::BK;
  constexpr int PER_LANE = BK / 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    float s[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      float x = sS[r * L.lds + c] * scale;
      if (c >= kv) {
        x = -INFINITY;               // past Lk: excluded
      } else if (!sMask[c]) {
        x = kMaskedScore;            // masked key, as in the Pallas kernel
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      const float p = expf(s[j] - m_new);
      sum += p;
      if constexpr (kDrop) {
        sP[r * ldp + c] = from_float<T>(p * drop.factor(q0 + r, k0 + c));
      } else {
        sP[r * ldp + c] = from_float<T>(p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sA[r] = alpha;
      sL[r] = sL[r] * alpha + sum;
      sM[r] = m_new;
    }
  }
  __syncwarp();
}

// O[16 rows] = alpha * O + P V, fp32 accumulator in shared memory.
template <typename T>
__device__ inline void warp_pv(const T* sP, int ldp, const T* sV, float* sO,
                               const float* sA, const Layout& L, int warp,
                               int lane) {
  constexpr int BK = Tile<T>::BK;
  for (int i = lane; i < 16 * L.dp; i += 32) {
    const int r = warp * 16 + i / L.dp;
    sO[r * L.ldo + i % L.dp] *= sA[r];
  }
  __syncwarp();
  if constexpr (std::is_same<T, bf16>::value) {
    for (int j = 0; j < L.dp; j += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = sO + warp * 16 * L.ldo + j;
      wmma::load_matrix_sync(acc, o_tile, L.ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + warp * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(b, sV + kk * L.ldt + j, L.ldt);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, L.ldo, wmma::mem_row_major);
    }
  } else {
    // The tensor cores' fp32 accumulation truncates, and over the thousands
    // of products a long row adds to one accumulator that bias grows far
    // past fp32 rounding; so each key tile's product starts from zero and
    // is added to O in ordinary (round-to-nearest) fp32.
    for (int j = 0; j < L.dp; j += 16) {
      FragC acc, o;
      float* o_tile = sO + warp * 16 * L.ldo + j;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        FragA32 a_hi, a_lo;
        FragB32<wmma::row_major> b_hi, b_lo;
        wmma::load_matrix_sync(a_hi, sP + warp * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(b_hi, sV + kk * L.ldt + j, L.ldt);
        split_tf32(a_hi, a_lo);
        split_tf32(b_hi, b_lo);
        mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
      }
      wmma::load_matrix_sync(o, o_tile, L.ldo, wmma::mem_row_major);
#pragma unroll
      for (int t = 0; t < o.num_elements; ++t) o.x[t] += acc.x[t];
      wmma::store_matrix_sync(o_tile, o, L.ldo, wmma::mem_row_major);
    }
  }
  __syncwarp();
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const unsigned char* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                 int Lk, int D, int dp, float scale, uint32_t seed,
                 uint32_t keep_thresh, float inv_keep) {
  constexpr int BK = Tile<T>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(dp);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sK = reinterpret_cast<T*>(smem + L.k);
  T* sV = reinterpret_cast<T*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  float* sA = reinterpret_cast<float*>(smem + L.a);
  unsigned char* sMask = smem + L.mask;
  T* sP;
  int ldp;
  if constexpr (Tile<T>::kSeparateP) {
    sP = reinterpret_cast<T*>(smem + L.p);
    ldp = L.ldp;
  } else {
    sP = reinterpret_cast<T*>(sS);  // fp32: P overwrites S in place
    ldp = L.lds;
  }

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + (static_cast<size_t>(bh) * Lq + q0) * D;
  const T* kb = k + static_cast<size_t>(bh) * Lk * D;
  const T* vb = v + static_cast<size_t>(bh) * Lk * D;
  const unsigned char* mb =
      mask ? mask + static_cast<size_t>(bh / H) * Lk : nullptr;
  Dropout drop{0u, keep_thresh, inv_keep};
  if constexpr (kDrop) drop.for_head(seed, bh);

  load_tile(sQ, L.ldt, qb, min(kBQ, Lq - q0), kBQ, D, dp);
  for (int i = threadIdx.x; i < kBQ * L.ldo; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    sM[i] = kMaskedScore;
    sL[i] = 0.0f;
  }
  __syncthreads();

  // Does the batch entry have a valid key at all? If so, a key tile that is
  // masked throughout adds exactly nothing (exp(-1e30 - m) is 0 once a real
  // score sets m, and a masked tile seen earlier is scaled away by
  // alpha = 0), so it is skipped; a row with no valid key keeps every tile,
  // which gives the mean of V.
  int any_valid = mb == nullptr;
  for (int i = threadIdx.x; mb && i < Lk; i += kThreads) any_valid |= mb[i];
  const bool skip_masked_tiles = mb && __syncthreads_or(any_valid);

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int kv = min(BK, Lk - k0);
    if (skip_masked_tiles) {
      int tile_valid = 0;
      for (int i = threadIdx.x; i < kv; i += kThreads) tile_valid |= mb[k0 + i];
      if (!__syncthreads_or(tile_valid)) continue;  // uniform across the block
    }
    load_tile(sK, L.ldt, kb + static_cast<size_t>(k0) * D, kv, BK, D, dp);
    load_tile(sV, L.ldt, vb + static_cast<size_t>(k0) * D, kv, BK, D, dp);
    for (int i = threadIdx.x; i < BK; i += kThreads) {
      sMask[i] = (mb && i < kv) ? (mb[k0 + i] != 0) : 1;
    }
    __syncthreads();
    warp_scores<T>(sQ, sK, sS, L, warp, lane);
    __syncwarp();
    warp_softmax<T, kDrop>(sS, sP, ldp, sM, sL, sA, sMask, kv, scale, drop,
                           q0, k0, L, warp, lane);
    warp_pv<T>(sP, ldp, sV, sO, sA, L, warp, lane);
    __syncthreads();  // every warp is done with sK / sV before the next load
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    const int c = i % D;
    if (q0 + r < Lq) {
      const float l_safe = fmaxf(sL[r], 1e-30f);
      out[(static_cast<size_t>(bh) * Lq + q0 + r) * D + c] =
          from_float<T>(sO[r * L.ldo + c] / l_safe);
    }
  }
  if (lane < 16) {
    const int r = warp * 16 + lane;
    if (q0 + r < Lq) {
      lse[static_cast<size_t>(bh) * Lq + q0 + r] =
          sM[r] + logf(fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, bool kDrop>
int launch_instance(const void* q, const void* k, const void* v,
                    const unsigned char* mask, void* out, float* lse, int BH,
                    int H, int Lq, int Lk, int D, float scale, uint32_t seed,
                    uint32_t keep_thresh, float inv_keep,
                    cudaStream_t stream) {
  const int dp = (D + 15) / 16 * 16;
  const Layout L = make_layout<T>(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, kDrop><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, H, Lq, Lk, D,
      dp, scale, seed, keep_thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* mask, void* out, float* lse, int BH, int H,
           int Lq, int Lk, int D, float scale, uint32_t seed,
           uint32_t keep_thresh, float inv_keep, cudaStream_t stream) {
  if (inv_keep > 0.0f) {
    return launch_instance<T, true>(q, k, v, mask, out, lse, BH, H, Lq, Lk,
                                    D, scale, seed, keep_thresh, inv_keep,
                                    stream);
  }
  return launch_instance<T, false>(q, k, v, mask, out, lse, BH, H, Lq, Lk, D,
                                   scale, seed, keep_thresh, inv_keep, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (BH, Lq, D); k, v (BH, Lk, D);
// mask (BH / H, Lk) bytes or null; out like q; lse (BH, Lq) float32.
// Dropout: inv_keep = 1 / (1 - rate) and keep_thresh = round((1 - rate)
// * 2^32) capped at 2^32 - 1; inv_keep = 0 (rate 0) means no dropout.
// Returns the cudaError_t of the launch (0 on success).
int sola_flash_attn_fwd(const void* q, const void* k, const void* v,
                        const unsigned char* mask, void* out, float* lse,
                        int BH, int H, int Lq, int Lk, int D, int dtype,
                        float scale, unsigned int seed,
                        unsigned int keep_thresh, float inv_keep,
                        void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || Lq <= 0 || Lk <= 0 || BH <= 0 ||
      H <= 0 || BH % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, mask, out, lse, BH, H, Lq, Lk, D, scale,
                         seed, keep_thresh, inv_keep, s);
  }
  if (dtype == 1) {
    return launch<bf16>(q, k, v, mask, out, lse, BH, H, Lq, Lk, D, scale,
                        seed, keep_thresh, inv_keep, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
