// Flash-attention backward for Hopper (sm_90a): one fused kernel that
// writes dQ, dK and dV, bound to Python through a plain C interface
// (sola_torch/ops/flash_attention.py loads it with ctypes).
//
// Replaces sola_tpu/ops/flash_attention.py::_attn_bwd_dq_kernel (:117) and
// ::_attn_bwd_dkv_kernel (:159), launched by _core_bwd through two
// pl.pallas_calls. It computes both their functions in one pass, from the
// forward's saved logsumexp (lse) and delta = rowsum(dO * O) of the
// forward's own (dropped) output:
//   P  = exp(S * scale - lse)           S = Q K^T; masked keys score -1e30
//   dP = (dO V^T) * keep * inv_keep     (dropout: the forward's mask)
//   dS = P * (dP - delta) * scale
//   dQ = dS K        dK = dS^T Q        dV = (P * keep * inv_keep)^T dO
// with the conventions of the port's forward (flash_attn_fwd.cu): a key
// past Lk is excluded, a batch entry with no valid key lets every key take
// part (each scoring -1e30), and the keep mask is the counter hash of
// (seed, batch*head, global query, original key index), so the kernel
// regenerates it from the seed whatever its tiles; the seed is read from
// device memory, as the forward reads it. A masked key gets P = 0
// exactly, so its dK and dV rows are exactly zero; they are written as
// zeros without being computed.
//
// What bounds it on an H100: at the selection model's training sites
// (head dim 128, fp32, as (batch*heads) x Lq x Lk: obj_attn 512 x 64 x 64
// with 40 valid keys, motion_attn 4096 x 8 x 8 with 5-8, object2lang_attn
// 64 x 512 x 128 with 38-52) the fused work is 10 FLOPs per (query, valid
// key, d) against Q, K, V, dO, dQ, dK and dV moved once: 0.035, 0.035 and
// 0.020 ms of bytes at 3.35 TB/s, above the operations at the tensor
// cores' 3xTF32 rate, so bytes bound all three. In fp32 FMAs (67 TFLOP/s),
// the arithmetic this kernel does, object2lang_attn's 1.9 GFLOP take
// 0.028 ms and come close to its bytes.
//
// What the design does about it. The dQ / dK-dV pair it replaces ran two
// passes that each recomputed S and dP, fixed 64 x 32 tiles that
// motion_attn's 8 x 8 heads filled to 1/32, one shared-memory load per FMA,
// and blocks for key tiles that the mask emptied. Here:
// - One pass. A block owns a chunk of a head's keys at a time (64 key slots
//   at D <= 128, 32 at D <= 256, so dK and dV fit the registers) and walks
//   the head's query tiles of 64 rows. Each tile recomputes S and dP once,
//   forms P and dS (transposed) in shared memory, adds P^T dO and dS^T Q to
//   dK and dV in registers, and forms the tile's dQ = dS K. Where the
//   head's keys fit one chunk (every selection site) dQ is complete and is
//   written once in the output type; otherwise the chunks run in order in
//   the same block and carry dQ in an fp32 workspace the wrapper allocates,
//   the last one converting it. No atomics: every sum runs in a fixed order.
// - Only the keys the mask leaves. Warp 0 lists the batch entry's valid
//   keys (ballots over the mask row) a chunk at a time in shared memory, in
//   ascending order; only those keys are staged, and each keeps its
//   original index for the hash and for the dK/dV store.
// - Small heads packed. When Lq and Lk are small (motion_attn's 8 x 8), a
//   block takes G consecutive heads of one batch entry (which share its
//   mask row): the tile's rows are G runs of RH rows and the chunk's key
//   slots G runs of KH slots. Every micro-tile lies inside one head's run,
//   and a thread computes only the micro-tiles of its own head's diagonal
//   block, so no product crosses heads.
// - Register-tiled products from float4 loads, 512 threads (16 warps, four
//   to each scheduler, to hide shared-memory latency; at most 128
//   registers a thread). The block's halves split the work by matrix: S
//   and dP each take 4 rows x 4 key slots a thread, reading 4 head-dim
//   values of each operand at once; P and dS are then formed in place,
//   4 rows at a time, with the lse, delta and the keep mask; dV and dK
//   each keep 8 key slots x 4 columns a thread, reading 4 rows of P^T or
//   dS^T at once (about 11 FMAs a 16-byte load); dQ takes 4 rows x 4
//   columns a thread. Row strides of D + 4 and 68 floats keep each
//   quarter-warp's 16-byte loads on distinct banks.
// - Staging overlapped with the products. fp32 tiles arrive by 16-byte
//   cp.async (rows past Lq zero-filled). With one 64-row buffer for Q and
//   dO (two would not fit beside K, V, P and dS at D 128: 238,336 bytes),
//   the next query tile's copy is issued as soon as dK and dV stop reading
//   Q and dO, and lands while the block computes the current tile's dQ.
//   bf16 inputs are widened to fp32 on staging through registers at the
//   same point.
//   Dynamic shared memory: 170,752 bytes at D 128, 217,728 at D 256; one
//   block an SM.
//
// What is left: one block a head leaves 68 of the 132 SMs idle at
// object2lang_attn (64 heads) and more where Lk spans several chunks, and
// the S / dP products, at 2 bytes of shared memory a thread for each FMA,
// take about half the time; splitting a head's queries over blocks and
// tensor-core products are the next steps.
//
// Head dims: any D <= 256 that is a multiple of 8; any Lq and Lk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

using sola_dropout::Dropout;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kRows = 64;         // query rows of a tile, all packed heads
constexpr int kLdT = kRows + 4;   // leading dim of the transposed P, dS
constexpr float kMaskedScore = -1e30f;

// key slots of a chunk, and each thread's share of the products, by the
// accumulator width DMAX (128 or 256)
template <int DMAX>
struct Tiling {
  static constexpr int kKeys = DMAX <= 128 ? 64 : 32;
  static constexpr int kScoreCols = kKeys / 16;  // S or dP key slots a thread
  static constexpr int kKeyGroups = kKeys / 8;   // dK or dV: 8 slots a thread
  static constexpr int kColGroups = DMAX / 4;    // dK or dV: 4 columns
  static constexpr int kDqPasses = DMAX / 128;   // dQ column passes
};

__host__ __device__ inline size_t smem_bytes(int D, int keys) {
  const size_t ld = D + 4;
  return sizeof(float) * ((2 * kRows + 2 * keys) * ld + 2 * keys * kLdT +
                          2 * kRows) +
         sizeof(int) * keys;
}

__device__ inline float to_float(bf16 x) { return __bfloat162float(x); }

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ inline float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes of a row of T into fp32 shared memory: 4 floats by cp.async, or
// 8 bf16 loaded and widened; zeros when !valid
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ inline void stage16(float* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4) {
    cp_async16(dst, src, valid);
  } else {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (valid) raw = *reinterpret_cast<const uint4*>(src);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
    *reinterpret_cast<float4*>(dst) = make_float4(
        to_float(h[0]), to_float(h[1]), to_float(h[2]), to_float(h[3]));
    *reinterpret_cast<float4*>(dst + 4) = make_float4(
        to_float(h[4]), to_float(h[5]), to_float(h[6]), to_float(h[7]));
  }
}

// 4 values rounded once into T
template <typename T>
__device__ inline void store4(T* dst, float4 v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
}

struct Params {
  const void *q, *k, *v;
  const unsigned char* mask;
  const void* dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* dq_ws;  // (BH, Lq, D) fp32 when Lk > KH, else null
  int BH, H, Lq, Lk, D;
  int G, RH, KH;  // heads a block, rows a head in a tile, key slots a chunk
  float scale;
  const int64_t* seed;  // device; its low 32 bits seed the hash
  uint32_t keep_thresh;
  float inv_keep;
};

// Warp 0: the next `want` keys that take part (mb null: every key), from
// the scan position *next, into sKey in ascending order; *next moves past
// the last one taken.
__device__ inline void collect_keys(const unsigned char* mb, int Lk, int want,
                                    int* sKey, int* next) {
  const int lane = threadIdx.x & 31;
  int pos = *next;
  int n = 0;
  while (n < want && pos < Lk) {
    const int key = pos + lane;
    const bool ok = key < Lk && (mb == nullptr || mb[key] != 0);
    const unsigned bal = __ballot_sync(~0u, ok);
    const int rank = __popc(bal & ((1u << lane) - 1u));
    if (ok && n + rank < want) sKey[n + rank] = key;
    const int got = __popc(bal);
    if (n + got > want) {
      // the chunk ends inside this window: the next starts at the first
      // key not taken
      const unsigned rest = __ballot_sync(~0u, ok && n + rank == want);
      pos += __ffs(rest) - 1;
      n = want;
    } else {
      pos += 32;
      n += got;
    }
  }
  if (lane == 0) *next = pos;
}

// Q, dO, lse and delta rows of query tile q0 for the block's G heads:
// row g * RH + i is query q0 + i of head bh0 + g; rows past Lq are zero
// (lse +inf, so P = 0 there).
template <typename T>
__device__ inline void stage_tile(float* sQ, float* sDO, float* sLse,
                                  float* sDelta, const Params& p, int bh0,
                                  int q0) {
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int D = p.D, ld = D + 4, vpr = D / kVec<T>;
  const int rows = p.G * p.RH;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec<T>;
    const int g = r / p.RH;
    const int qi = q0 + r - g * p.RH;
    const bool ok = qi < p.Lq;
    const size_t off =
        (static_cast<size_t>(bh0 + g) * p.Lq + (ok ? qi : 0)) * D + c;
    stage16<T>(sQ + r * ld + c, q + off, ok);
    stage16<T>(sDO + r * ld + c, dout + off, ok);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int g = r / p.RH;
    const int qi = q0 + r - g * p.RH;
    if (qi < p.Lq) {
      const size_t row = static_cast<size_t>(bh0 + g) * p.Lq + qi;
      cp_async4(sLse + r, p.lse + row);
      cp_async4(sDelta + r, p.delta + row);
    } else {
      sLse[r] = INFINITY;
      sDelta[r] = 0.0f;
    }
  }
}

// K and V rows of the chunk's listed keys: slot g * KH + j is key sKey[j]
// of head bh0 + g
template <typename T>
__device__ inline void stage_keys(float* sK, float* sV, const int* sKey,
                                  const Params& p, int bh0, int nvc) {
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int D = p.D, ld = D + 4, vpr = D / kVec<T>;
  for (int i = threadIdx.x; i < p.G * nvc * vpr; i += kThreads) {
    const int row = i / vpr;
    const int c = (i - row * vpr) * kVec<T>;
    const int g = row / nvc;
    const int j = row - g * nvc;
    const size_t off =
        (static_cast<size_t>(bh0 + g) * p.Lk + sKey[j]) * D + c;
    const int slot = g * p.KH + j;
    stage16<T>(sK + slot * ld + c, k + off, true);
    stage16<T>(sV + slot * ld + c, v + off, true);
  }
}

template <typename T, int DMAX, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const Params p) {
  using Tl = Tiling<DMAX>;
  constexpr int KC = Tl::kKeys;
  constexpr int NJ = Tl::kScoreCols;
  constexpr int KG = Tl::kKeyGroups;
  constexpr int CG = Tl::kColGroups;
  extern __shared__ __align__(16) float smem[];
  __shared__ int sNext;  // scan position of the next chunk's keys

  const int D = p.D, ld = D + 4;
  const int G = p.G, RH = p.RH, KH = p.KH;
  float* sQ = smem;
  float* sDO = sQ + kRows * ld;
  float* sK = sDO + kRows * ld;
  float* sV = sK + KC * ld;
  float* sPt = sV + KC * ld;    // P^T (dropped): [key slot][row]
  float* sDSt = sPt + KC * kLdT;  // dS^T: [key slot][row]
  float* sLse = sDSt + KC * kLdT;
  float* sDelta = sLse + kRows;
  int* sKey = reinterpret_cast<int*>(sDelta + kRows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh0 = blockIdx.x * G;
  const unsigned char* mb =
      p.mask ? p.mask + static_cast<size_t>(bh0 / p.H) * p.Lk : nullptr;

  // the batch entry's valid keys (every warp counts for itself)
  int nvalid = p.Lk;
  if (mb) {
    nvalid = 0;
    for (int base = 0; base < p.Lk; base += 32) {
      const int key = base + lane;
      nvalid += __popc(__ballot_sync(~0u, key < p.Lk && mb[key] != 0));
    }
  }
  const bool all_masked = mb != nullptr && nvalid == 0;
  const unsigned char* listed = all_masked ? nullptr : mb;  // null: all
  const int nkeys = all_masked ? p.Lk : nvalid;

  // masked keys' dK and dV rows: exactly zero, not computed
  if (listed) {
    const int vpr = D / 4;
    for (int i = tid; i < G * p.Lk * vpr; i += kThreads) {
      const int row = i / vpr;  // g * Lk + key
      const int key = row % p.Lk;
      if (listed[key]) continue;
      const size_t off = (static_cast<size_t>(bh0) * p.Lk + row) * D +
                         (i - row * vpr) * 4;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      store4<T>(static_cast<T*>(p.dk) + off, z);
      store4<T>(static_cast<T*>(p.dv) + off, z);
    }
  }

  // per-head hash bases of the block's heads (G <= 16)
  __shared__ uint32_t sBase[16];
  if (kDrop && tid < G) {
    Dropout d{0u, 0u, 0.0f};
    d.for_head(static_cast<uint32_t>(*p.seed), bh0 + tid);
    sBase[tid] = d.base;
  }

  // thread roles. The two halves of the block split S / dP and dV / dK:
  // - S (half 0) or dP (half 1): rows 4*sh .. 4*sh + 3 of the tile (one
  //   head's run) x key slots sl + 16 j;
  // - dV (half 0) or dK (half 1): key slots 8*kg .. 8*kg + 7 (one head's
  //   run) x columns 4*cg .. 4*cg + 3; the accumulator persists over the
  //   chunk's query tiles. Half 1 numbers its key groups from KG / 4, so
  //   that the groups a short key list leaves busy spread over the SM's
  //   four schedulers;
  // - dQ (all): rows 4*qh .. 4*qh + 3 x columns 4*ql + 128*pass.
  const int half = tid >> 8;
  const int t = tid & 255;
  const int sh = t >> 4, sl = t & 15;
  const int sr0 = 4 * sh;
  const bool s_live = sr0 < G * RH;
  const int shead = s_live ? sr0 / RH : 0;
  const int sloc = sr0 - shead * RH;  // first row's query within its tile
  const int kg = (t / CG + half * (KG / 4)) % KG, cg = t % CG;
  const int kc0 = 8 * kg;
  const bool k_live = kc0 < G * KH;
  const int khead = k_live ? kc0 / KH : 0;
  const int kloc = kc0 - khead * KH;  // first slot's index in the key list
  const int qh = tid >> 5, ql = tid & 31;
  const int qr0 = 4 * qh;
  const bool q_live = qr0 < G * RH;
  const int qhead = q_live ? qr0 / RH : 0;
  const int qloc = qr0 - qhead * RH;
  const float* sRowOp = half ? sDO : sQ;   // S: Q K^T; dP: dO V^T
  const float* sKeyOp = half ? sV : sK;
  float* sScore = half ? sDSt : sPt;       // S, then P; dP, then dS
  const float* sGradA = half ? sDSt : sPt;  // dK: dS^T Q; dV: P^T dO
  const float* sGradB = half ? sQ : sDO;
  T* dkv = static_cast<T*>(half ? p.dk : p.dv);

  T* dq = static_cast<T*>(p.dq);
  const int n_chunks = (nkeys + KH - 1) / KH;
  if (tid == 0) sNext = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int nvc = min(KH, nkeys - chunk * KH);
    const bool first = chunk == 0;
    const bool last = chunk == n_chunks - 1;
    __syncthreads();  // the last chunk's readers of sKey, sK and sV are done
    if (tid < 32) collect_keys(listed, p.Lk, nvc, sKey, &sNext);
    __syncthreads();
    stage_keys<T>(sK, sV, sKey, p, bh0, nvc);
    stage_tile<T>(sQ, sDO, sLse, sDelta, p, bh0, 0);
    cp_async_commit();

    float acc[8][4];  // dV (half 0) or dK (half 1): 8 slots x 4 columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    const bool k_on = k_live && kloc < nvc;
    // one key slot past the last that S / dP need, for an unpacked block
    const int jmax = (nvc + 15) / 16;

    for (int q0 = 0; q0 < p.Lq; q0 += RH) {
      const int qv = min(RH, p.Lq - q0);  // rows of each head in the tile
      const int rows4 = (qv + 3) & ~3;    // rows that the micro-tiles cover
      cp_async_wait_all();
      __syncthreads();  // the tile is staged; the last tile's dQ is done

      // S (or dP) for this thread's rows and its head's key slots, into
      // shared memory transposed
      bool on[NJ];
      bool any_on = false;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = sl + 16 * j;
        on[j] = s_live && sloc < qv && c / KH == shead &&
                c - shead * KH < nvc;
        any_on |= on[j];
      }
      if (any_on) {
        float sc[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) sc[i][j] = 0.0f;
        }
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          float4 ra[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ra[i] = ld4(sRowOp + (sr0 + i) * ld + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            // unpacked: a uniform bound (a slot past nvc computes what no
            // one reads); packed: the head's own slots only
            if (G == 1 ? j >= jmax : !on[j]) continue;
            const float4 kb = ld4(sKeyOp + (sl + 16 * j) * ld + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[i][j] = dot4(ra[i], kb, sc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (!on[j]) continue;
          *reinterpret_cast<float4*>(sScore + (sl + 16 * j) * kLdT + sr0) =
              make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        }
      }
      __syncthreads();

      // P = exp(S * scale - lse) and dS = P (dP - delta) * scale, in place,
      // 4 rows at a time; the dropped P (P * keep / (1 - rate)) is what dV
      // takes, and the keep mask also scales dP
      {
        const int quads = rows4 / 4;
        const int per_head = nvc * quads;
        for (int it = tid; it < G * per_head; it += kThreads) {
          const int g = it / per_head;
          const int rem = it - g * per_head;
          const int j = rem / quads;
          const int i0 = (rem - j * quads) * 4;
          const int c = g * KH + j;
          const int r = g * RH + i0;
          const float4 s4 = ld4(sPt + c * kLdT + r);
          const float4 dp4 = ld4(sDSt + c * kLdT + r);
          const float4 l4 = ld4(sLse + r);
          const float4 de4 = ld4(sDelta + r);
          Dropout drop{0u, p.keep_thresh, p.inv_keep};
          if constexpr (kDrop) drop.base = sBase[g];
          const int key = sKey[j];
          float pv[4], ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = expf(
                (all_masked ? kMaskedScore : at(s4, i) * p.scale) -
                at(l4, i));
            float dpi = at(dp4, i);
            pv[i] = pr;
            if constexpr (kDrop) {
              const float f = drop.factor(q0 + i0 + i, key);
              pv[i] = pr * f;
              dpi *= f;
            }
            ds[i] = pr * (dpi - at(de4, i)) * p.scale;
          }
          *reinterpret_cast<float4*>(sPt + c * kLdT + r) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
          *reinterpret_cast<float4*>(sDSt + c * kLdT + r) =
              make_float4(ds[0], ds[1], ds[2], ds[3]);
        }
      }
      __syncthreads();

      // dV += P^T dO (half 0) or dK += dS^T Q (half 1) over the head's rows
      if (k_on && 4 * cg < D) {
        const int rbeg = khead * RH;
        for (int r = rbeg; r < rbeg + rows4; r += 4) {
          float4 a[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = ld4(sGradA + (kc0 + j) * kLdT + r);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float4 b4 = ld4(sGradB + (r + rr) * ld + 4 * cg);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float aj = at(a[j], rr);
              acc[j][0] = fmaf(aj, b4.x, acc[j][0]);
              acc[j][1] = fmaf(aj, b4.y, acc[j][1]);
              acc[j][2] = fmaf(aj, b4.z, acc[j][2]);
              acc[j][3] = fmaf(aj, b4.w, acc[j][3]);
            }
          }
        }
      }
      __syncthreads();  // Q, dO, lse and delta are free

      // the next tile's copy lands while this tile's dQ is formed
      if (q0 + RH < p.Lq) {
        stage_tile<T>(sQ, sDO, sLse, sDelta, p, bh0, q0 + RH);
        cp_async_commit();
      }

      // dQ = dS K over the head's key slots of the chunk
      if (q_live && qloc < qv) {
        const int cbeg = qhead * KH;
        const int cend = cbeg + nvc;
        const size_t row0 = static_cast<size_t>(bh0 + qhead) * p.Lq + q0 +
                            qloc;
#pragma unroll 1
        for (int pass = 0; pass < Tl::kDqPasses; ++pass) {
          const int e = 128 * pass + 4 * ql;
          if (e >= D) break;
          float qacc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int x = 0; x < 4; ++x) qacc[i][x] = 0.0f;
          }
#pragma unroll 4
          for (int c = cbeg; c < cend; ++c) {
            const float4 d4 = ld4(sDSt + c * kLdT + qr0);
            const float4 k4 = ld4(sK + c * ld + e);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float di = at(d4, i);
              qacc[i][0] = fmaf(di, k4.x, qacc[i][0]);
              qacc[i][1] = fmaf(di, k4.y, qacc[i][1]);
              qacc[i][2] = fmaf(di, k4.z, qacc[i][2]);
              qacc[i][3] = fmaf(di, k4.w, qacc[i][3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (qloc + i >= qv) continue;
            {
              const size_t off = (row0 + i) * D + e;
              float4 val = make_float4(qacc[i][0], qacc[i][1], qacc[i][2],
                                       qacc[i][3]);
              if (!first) {  // earlier chunks' sum, added in chunk order
                const float4 w = ld4(p.dq_ws + off);
                val = make_float4(w.x + val.x, w.y + val.y, w.z + val.z,
                                  w.w + val.w);
              }
              if (last) {
                store4<T>(dq + off, val);
              } else {
                *reinterpret_cast<float4*>(p.dq_ws + off) = val;
              }
            }
          }
        }
      }
    }

    // the chunk's dV (half 0) or dK (half 1) rows, at their keys' original
    // indices
    if (k_on && 4 * cg < D) {
      const size_t head_row = static_cast<size_t>(bh0 + khead) * p.Lk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kloc + j >= nvc) continue;
        store4<T>(dkv + (head_row + sKey[kloc + j]) * D + 4 * cg,
                  make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      }
    }
  }
}

template <typename T, int DMAX, bool kDrop>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = flash_bwd_kernel<T, DMAX, kDrop>;
  const size_t bytes = smem_bytes(p.D, Tiling<DMAX>::kKeys);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.BH / p.G, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Picks the instance: the accumulator width for D (128 or 256), for the
// input type and dropout of the caller.
template <typename T, bool kDrop>
int dispatch_d(const Params& p, cudaStream_t s) {
  return p.D <= 128 ? launch<T, 128, kDrop>(p, s)
                    : launch<T, 256, kDrop>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq (BH, Lq, D); k, v, dk, dv
// (BH, Lk, D); mask (BH / H, Lk) bytes or null; lse and delta (BH, Lq)
// float32. The work split (flash_attention.bwd_plan): G consecutive heads
// of one batch entry a block (G divides H), RH rows of each head in a
// query tile and KH key slots of each head in a chunk, both multiples of
// 4, with G * RH <= 64 and G * KH <= 64 (32 at D > 128). dq_ws is an fp32
// (BH, Lq, D) workspace, needed when Lk > KH (the keys may span chunks),
// else null. Dropout as in sola_flash_attn_fwd (inv_keep = 0: none, and
// seed may be null).
// Returns the cudaError_t of the launch (0 on success).
int sola_flash_attn_bwd(const void* q, const void* k, const void* v,
                        const unsigned char* mask, const void* dout,
                        const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, float* dq_ws, int BH, int H,
                        int Lq, int Lk, int D, int G, int RH, int KH,
                        int dtype, float scale, const void* seed,
                        unsigned int keep_thresh, float inv_keep,
                        void* stream) {
  const int keys = D <= 128 ? Tiling<128>::kKeys : Tiling<256>::kKeys;
  if (D <= 0 || D > 256 || D % 8 != 0 || Lq <= 0 || Lk <= 0 || BH <= 0 ||
      H <= 0 || BH % H != 0 || G <= 0 || H % G != 0 || RH <= 0 ||
      KH <= 0 || RH % 4 != 0 || KH % 8 != 0 || G * RH > kRows ||
      G * KH > keys || (Lk > KH && dq_ws == nullptr) ||
      (inv_keep > 0.0f && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q,  k,  v,  mask, dout, lse, delta, dq, dk, dv, dq_ws,
                 BH, H,  Lq, Lk,   D,    G,   RH,    KH, scale,
                 static_cast<const int64_t*>(seed), keep_thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = inv_keep > 0.0f;
  if (dtype == 0) {
    return drop ? dispatch_d<float, true>(p, s)
                : dispatch_d<float, false>(p, s);
  }
  if (dtype == 1) {
    return drop ? dispatch_d<bf16, true>(p, s)
                : dispatch_d<bf16, false>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
