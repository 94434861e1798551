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
// this is the direct gather form of the upstream CUDA op.
//
// What bounds it on an H100: not the bytes of its inputs (each value row is
// a corner of many queries, so it is read many times, from L2 or L1) but the
// rate at which the SMs can issue gathers, keep them in flight and take
// their bytes from L1/L2. So the design makes every load instruction move
// as many useful bytes as it can:
// - A warp takes one query across all its heads (or, where a query has
//   fewer than 32 slots, several queries). A lane owns a "slot": V
//   consecutive-in-order channels of one head, read as 16-byte vectors (two
//   float4 for 8 fp32 channels, one uint4 for 8 bf16). At GroundingDINO's
//   8 heads x 32 channels that is 4 lanes a head and one warp a query, and
//   one warp load gathers 8 value rows, one a head, in 64-byte runs.
//   A head_dim that is not a multiple of 8 (or values not 16-byte aligned)
//   takes a narrower vector (4, 2 or 1 channels), another instance of the
//   same kernel; a query of more than 32 slots takes one warp for each
//   32 of them.
// - The corner terms are computed once per (query, head, term): the warp's
//   lanes split them, 4 a lane with their loads issued together (locations
//   read as coalesced float2), write 4 indices and 4 weights per term to a
//   per-warp shared-memory array, and every lane of a head then reads them
//   with two 16-byte shared loads a term.
// - Two terms' corners are loaded (read-only path, predicated off where
//   the weight is 0) before the first of them is added, so each lane has
//   8 corner rows in flight (16 16-byte loads in fp32, 8 in bf16).
// - Warps run b-major, so the warps resident at one time read one batch
//   entry's maps (22.76 MB in fp32 at the encoder's 800x1333 canvas, which
//   fits the 50 MB L2). No tile of the maps is staged in shared memory: the
//   offsets are learned, so no tile is known ahead of time, and L1/L2 serve
//   the reuse.
//
// Every output element is summed in the order of the earlier
// one-warp-per-(query, head) kernel, so the two agree bit for bit: terms
// t = l * P + p in order, corners 00, 01, 10, 11, acc = fma(w, v, acc) in
// fp32, a corner of weight 0 skipped (its value loads as 0, and
// fma(0, 0, acc) == acc since acc is never -0), one rounding at the store.
// Corner math follows corner_terms (sola_torch/trackgen/gdino/deformable.py)
// with the _rn intrinsics, so that nvcc does not contract its products into
// FMAs, and runs in fp32 even for bf16 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 16;
constexpr int kMaxHeadDim = 256;
// Corner entries (4 indices + 4 weights, 32 bytes) a warp keeps per chunk
// of terms. A warp's 32 slots span at most 33 (query, head) groups, each
// needs at least one unrolled step of terms + 1 pad entry:
// 33 * (2 + 1) <= kMaxEntries. At 8 heads, 16 terms a chunk cover a whole
// query: 8 * (16 + 1) = 136.
constexpr int kMaxEntries = 136;
// Terms whose corners a lane loads before adding the first of them, and
// the blocks an SM must hold (1 leaves ptxas the registers it wants). On an
// H100 80GB HBM3 at 700 W, fp32 at ~120 registers (16 warps an SM) was as
// fast as when held to 96 (20 warps); bf16 held to 64 registers (32 warps)
// spilled, and 6 blocks (<= 85 registers, 24 warps) was fastest.
constexpr int kUnroll = 2;
constexpr int kMinBlocksF32 = 1;
constexpr int kMinBlocksBf16 = 6;
// corner entries a lane computes with their location and weight loads
// issued together (a query's 8 heads x 16 terms over 32 lanes)
constexpr int kEntries = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// How one launch maps slots and terms onto warps (set once on the host).
struct Geometry {
  int vph;      // slots (lanes) per head: head_dim / V
  int ns;       // slots per query: heads * vph
  int qpw;      // queries per warp: 32 / ns where ns <= 32, else 1
  int passes;   // warps (passes of 32 slots) over a query group's
                // qpw * ns slots
  int tc;       // terms per chunk, a multiple of the unroll, so an
                // unrolled step never reads past the chunk's entries
  int tcp;      // shared-memory stride of a group: tc or tc + 1, odd, so the
                // groups a warp reads at once fall on different banks
  int loc_vec;  // locations 8-byte aligned: read (x, y) as one float2
  unsigned n_qgroups;  // query groups per batch entry
  unsigned n_groups;   // warps: B * n_qgroups * passes, b-major
};

template <typename T> __host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? kMinBlocksF32 : kMinBlocksBf16;
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

// Read-only load of kBytes (16, 8, 4 or 2) into 32-bit words.
template <int kBytes>
__device__ __forceinline__ void ldg_words(uint32_t* w, const void* p) {
  if constexpr (kBytes == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (kBytes == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (kBytes == 4) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

template <int kBytes>
__device__ __forceinline__ void st_words(void* p, const uint32_t* w) {
  if constexpr (kBytes == 16) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (kBytes == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (kBytes == 4) {
    *static_cast<unsigned int*>(p) = w[0];
  } else {
    *static_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  }
}

// Element j of a slot's words, as fp32 (bf16 -> fp32 is exact).
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[j]);
  } else {
    const uint32_t x = w[j >> 1];
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, min_blocks<T>())
ms_deform_fwd_kernel(const T* __restrict__ value,
                     const float* __restrict__ loc,
                     const float* __restrict__ attn, T* __restrict__ out,
                     const __grid_constant__ Levels lv,
                     const __grid_constant__ Geometry g, int S, int Lq,
                     int H, int D, int L, int P) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));  // a slot's row
  constexpr int kLoads = kBytes > 16 ? kBytes / 16 : 1;     // loads a corner
  constexpr int kLoadBytes = kBytes / kLoads;
  constexpr int kPer = V / kLoads;                          // channels a load
  constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  constexpr int kLoadWords = kWords / kLoads;

  __shared__ int4 s_idx[kWarpsPerBlock][kMaxEntries];
  __shared__ float4 s_w[kWarpsPerBlock][kMaxEntries];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned gid = blockIdx.x * kWarpsPerBlock + warp;
  if (gid >= g.n_groups) return;  // the whole warp leaves together
  // warps run b-major over (batch entry, query group, pass of 32 slots)
  const int pass = static_cast<int>(gid % g.passes);
  const unsigned qg = gid / g.passes;
  const int b = static_cast<int>(qg / g.n_qgroups);
  const int q0 = static_cast<int>(qg - b * g.n_qgroups) * g.qpw;
  const int C = H * D;
  const int LP = L * P;
  const int nvh = g.qpw * H;  // the warp's (query, head) groups
  int4* sidx = s_idx[warp];
  float4* sw = s_w[warp];

  const int vs = pass * 32 + lane;  // this lane's slot among the query
                                    // group's qpw * ns slots
  // the (query, head) groups this warp's 32 slots touch: vh_lo onwards
  const int vh_lo = pass * 32 / g.vph;
  const int n_grp = min(nvh, (pass * 32 + 31) / g.vph + 1) - vh_lo;
  const int vh = vs / g.vph;
  const int qi = vh / H;
  const int h = vh - qi * H;
  const bool active = vs < g.qpw * g.ns && q0 + qi < Lq;
  const int grp = active ? vh - vh_lo : 0;
  const int sv = vs - vh * g.vph;
  // this slot's channels: load k reads kPer of them at (k * vph + sv) *
  // kPer, so the lanes of a head read one contiguous run per load
  const T* vslot =
      value + static_cast<size_t>(b) * S * C + h * D + sv * kPer;
  const int kstride = g.vph * kPer;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < LP; t0 += g.tc) {
    // corner entries of terms t0 .. t0 + tc - 1 of every group, kEntries a
    // lane with their loads issued together; entries past the last term or
    // query stay zero (weight 0: nothing is loaded for them)
    const int n_e = n_grp * g.tc;
    for (int e0 = 0; e0 < n_e; e0 += 32 * kEntries) {
      int pos[kEntries], t[kEntries];
      float lx[kEntries], ly[kEntries], a[kEntries];
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
        const int e = e0 + i * 32 + lane;
        const int gi = e / g.tc;
        const int tt = e - gi * g.tc;
        const int evh = vh_lo + gi;
        const int eqi = evh / H;
        const int q = q0 + eqi;
        pos[i] = e < n_e ? gi * g.tcp + tt : -1;
        t[i] = e < n_e && q < Lq && t0 + tt < LP ? t0 + tt : -1;
        lx[i] = ly[i] = a[i] = 0.f;
        if (t[i] >= 0) {
          const long long k =
              ((static_cast<long long>(b) * Lq + q) * H + (evh - eqi * H)) *
                  LP + t[i];
          if (g.loc_vec) {
            const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + k);
            lx[i] = xy.x;
            ly[i] = xy.y;
          } else {
            lx[i] = __ldg(loc + 2 * k);
            ly[i] = __ldg(loc + 2 * k + 1);
          }
          a[i] = __ldg(attn + k);
        }
      }
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
        int4 ci = make_int4(0, 0, 0, 0);
        float4 cw = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t[i] >= 0) {
          const int l = t[i] / P;
          const int hl = lv.h[l], wl = lv.w[l], st = lv.start[l];
          const float x = __fsub_rn(
              __fmul_rn(lx[i], static_cast<float>(wl)), 0.5f);
          const float y = __fsub_rn(
              __fmul_rn(ly[i], static_cast<float>(hl)), 0.5f);
          const float x0 = floorf(x), y0 = floorf(y);
          const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
          const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
          const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
          corner(y0, x0, __fmul_rn(wy0, wx0), a[i], hl, wl, st, &ci.x,
                 &cw.x);
          corner(y0, x1, __fmul_rn(wy0, wx1), a[i], hl, wl, st, &ci.y,
                 &cw.y);
          corner(y1, x0, __fmul_rn(wy1, wx0), a[i], hl, wl, st, &ci.z,
                 &cw.z);
          corner(y1, x1, __fmul_rn(wy1, wx1), a[i], hl, wl, st, &ci.w,
                 &cw.w);
        }
        if (pos[i] >= 0) {
          sidx[pos[i]] = ci;
          sw[pos[i]] = cw;
        }
      }
    }
    __syncwarp();

    const int n_t = min(g.tc, LP - t0);
    const int4* gidx = sidx + grp * g.tcp;
    const float4* gw = sw + grp * g.tcp;
    for (int tt = 0; tt < n_t; tt += kUnroll) {  // tt + kUnroll <= tc
      float wgt[kUnroll][4];
      uint32_t raw[kUnroll][4][kWords];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int4 ci = gidx[tt + u];
        const float4 cw = gw[tt + u];
        const int idx[4] = {ci.x, ci.y, ci.z, ci.w};
        wgt[u][0] = cw.x; wgt[u][1] = cw.y;
        wgt[u][2] = cw.z; wgt[u][3] = cw.w;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const T* row = vslot + static_cast<long long>(idx[c]) * C;
          const bool take = active && wgt[u][c] != 0.f;
#pragma unroll
          for (int k = 0; k < kLoads; ++k) {
            uint32_t* wk = raw[u][c] + k * kLoadWords;
            if (take) {
              ldg_words<kLoadBytes>(wk, row + k * kstride);
            } else {
#pragma unroll
              for (int i = 0; i < kLoadWords; ++i) wk[i] = 0u;
            }
          }
        }
      }
      // add in term, then corner order: the loads above are all issued
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[j] = __fmaf_rn(wgt[u][c], elem<T>(raw[u][c], j), acc[j]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the entries
  }

  if (active) {
    uint32_t w[kWords];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = __float_as_uint(acc[j]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t bits =
            __bfloat16_as_ushort(__float2bfloat16(acc[j]));
        w[j >> 1] |= bits << (16 * (j & 1));
      }
    }
    T* orow = out + (static_cast<size_t>(b) * Lq + q0 + qi) * C + h * D +
              sv * kPer;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      st_words<kLoadBytes>(orow + k * kstride, w + k * kLoadWords);
    }
  }
}

template <typename T, int V>
int launch_v(const void* value, const float* loc, const float* attn,
             void* out, const Levels& lv, int B, int S, int Lq, int H,
             int D, int L, int P, cudaStream_t stream) {
  Geometry g;
  g.vph = D / V;
  g.ns = H * g.vph;
  g.qpw = g.ns <= 32 ? 32 / g.ns : 1;
  g.passes = (g.qpw * g.ns + 31) / 32;
  int max_grp = 0;
  for (int p = 0; p < g.passes; ++p) {
    const int lo = p * 32 / g.vph;
    const int hi = g.qpw * H < (p * 32 + 31) / g.vph + 1
                       ? g.qpw * H : (p * 32 + 31) / g.vph + 1;
    if (hi - lo > max_grp) max_grp = hi - lo;
  }
  const int lp_up = (L * P + kUnroll - 1) / kUnroll * kUnroll;
  int tc = (kMaxEntries / max_grp - 1) / kUnroll * kUnroll;
  if (tc > lp_up) tc = lp_up;
  if (tc < kUnroll) return static_cast<int>(cudaErrorInvalidValue);
  g.tc = tc;
  g.tcp = tc | 1;
  g.loc_vec = (reinterpret_cast<uintptr_t>(loc) & 7) == 0;
  g.n_qgroups = (Lq + g.qpw - 1) / g.qpw;
  // a warp index fits 32 bits for any input that fits the card's memory
  const long long n_groups =
      static_cast<long long>(B) * g.n_qgroups * g.passes;
  if (n_groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g.n_groups = static_cast<unsigned>(n_groups);
  const unsigned blocks = (g.n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ms_deform_fwd_kernel<T, V><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), lv, g,
      S, Lq, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

// The widest slot (8, 4, 2 or 1 channels) that divides head_dim and keeps
// every vector access of values and output aligned.
template <typename T>
int launch(const void* value, const float* loc, const float* attn,
           void* out, const Levels& lv, int B, int S, int Lq, int H, int D,
           int L, int P, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(value) |
                         reinterpret_cast<uintptr_t>(out);
  int v = 8;
  while (v > 1) {
    const int bytes = v * static_cast<int>(sizeof(T));
    const uintptr_t align = bytes < 16 ? bytes : 16;
    if (D % v == 0 && (ptrs & (align - 1)) == 0) break;
    v /= 2;
  }
  switch (v) {
    case 8:
      return launch_v<T, 8>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P,
                            stream);
    case 4:
      return launch_v<T, 4>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P,
                            stream);
    case 2:
      return launch_v<T, 2>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P,
                            stream);
    default:
      return launch_v<T, 1>(value, loc, attn, out, lv, B, S, Lq, H, D, L, P,
                            stream);
  }
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
  if (B <= 0 || S <= 0 || Lq <= 0 || H <= 0 || D <= 0 || D > kMaxHeadDim ||
      L <= 0 || L > kMaxLevels || P <= 0) {
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
