// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (sola_torch/ops/flash_attention.py loads it with ctypes).
//
// Replaces sola_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _fwd_impl through pl.pallas_call). It computes the same function:
//   O   = softmax(Q K^T / sqrt(D)) V     per (batch*head) row block
//   lse = m + log(l)                     fp32 logsumexp per query row
// with fp32 scores, running max, running sum and accumulator, and P cast to
// V's type before the PV product, as the Pallas kernel does.
//
// Dropout (training): with inv_keep > 0 the P that enters the PV product is
// multiplied by keep x inv_keep, where keep is _keep_mask's counter hash of
// (seed, batch*head, global query, global key) below keep_thresh; the row
// sum l stays undropped (softmax first, then dropout on the probabilities,
// torch SDPA's placement). The hash uses global indices, so the mask does
// not depend on this kernel's tiles and the fused backward kernel
// (flash_attn_bwd.cu) regenerates it exactly. Each accumulator element's
// global (row, column) comes from the PTX ISA's fragment layout of the
// instruction that produced it (wgmma for bf16, mma.sync for fp32).
//
// Masking: the key mask arrives as (B, Lk) bytes shared by the H heads of a
// batch entry. A masked key scores -1e30 (not -inf), so a fully masked row
// returns the mean of V over the real keys, the convention of the dense
// paths (sam2/memory.py). A key past Lk in the ragged last tile is excluded
// (scores -inf and adds nothing), where the Pallas kernel padded keys with
// zeros and scored them -1e30. Key tiles that the mask leaves empty are
// skipped: each block first lists, in shared memory, the key tiles of its
// batch entry that hold a valid key (key_tiles), and every role of the
// block walks that one list.
//
// What bounds it on an H100: at the shapes of the SAM2 main path it is
// compute-bound. Memory cross-attention does 4*B*Lq*Lk*D = 4*4*4096*28736*256
// ~ 0.48 TFLOP per layer for 4 objects (0.28 over the valid keys) against
// ~133 MB of Q, K, V and O, far above the card's ~295 FLOP/byte balance
// point for bf16. Its bound is the tensor cores' 989 TFLOP/s.
//
// Two designs, chosen by the inputs' type (one instance per head-dim bucket
// and dropout on/off):
//
// A. bf16 (memory attention D 256; the D 72 / 128 check shapes; dropout):
//    one block of three warpgroups per (batch*head, 128 query rows). A
//    producer warpgroup gives up its registers (setmaxnreg) and one of its
//    threads issues TMA loads (cp.async.bulk.tensor, 3-D maps over (D, L,
//    BH), 128-byte swizzle, D split into 64-wide chunks) with mbarriers: Q
//    once, then K and V tiles of 64 keys into a ring of 2 stages. Two
//    consumer warpgroups own 64 query rows each: S = Q K^T on
//    wgmma.m64n64k16 (both operands K-major in shared memory), the online
//    softmax on the accumulator fragment in registers, P packed to bf16 in
//    registers and fed to wgmma as the A operand for O += P V (V read
//    MN-major from shared memory). O (64 x 256 fp32 at D 256, 128 registers
//    a thread) stays in registers for the whole key loop.
//
// B. fp32 (Hiera's global blocks D 72, selection D 128): the products run
//    on the tensor cores as three TF32 products (3xTF32): x = hi + lo with
//    hi = tf32(x) and lo = tf32(x - hi), and a*b ~ lo_a*hi_b + hi_a*lo_b +
//    hi_a*hi_b, about 21 of fp32's 24 mantissa bits. TF32 wgmma takes only
//    K-major operands and V is MN-major for PV, so this design uses
//    mma.sync.m16n8k8: 4 warps x 16 query rows, K and V tiles of 32 keys in
//    a cp.async ring of 2 stages, S, P and O in registers. P's accumulator
//    fragment becomes the A fragment without shuffles by reading the key
//    axis in a permuted order (logical k = t <-> key 2t, k = t + 4 <-> key
//    2t + 1) and reading V's rows in the same order. Each key tile's PV
//    starts from a zero accumulator and is added to O in ordinary fp32: the
//    tensor cores' fp32 accumulation truncates, and over a long row that
//    bias grows far past fp32 rounding.
//
// Head dims: any D <= 256 that is a multiple of 8; the caller never pads.
// bf16 pads D to a multiple of 16 (the wgmma depth) through TMA's zero fill
// of the columns past D; fp32 needs no padding (mma depth 8).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

using sola_dropout::Dropout;
using bf16 = __nv_bfloat16;

constexpr float kMaskedScore = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeyTile = 64;  // keys per tile, design A
constexpr int kKeyTile32 = 32;  // keys per tile, design B

// --------------------------------------------------------------------------
// the key-tile walk shared by both designs
// --------------------------------------------------------------------------

constexpr int kMaxListedTiles = 2048;  // longer rows walk every tile

struct KeyTiles {
  const uint16_t* list;  // ascending tiles to visit, or null: tile i is i
  int count;
  __device__ int operator[](int i) const { return list ? list[i] : i; }
};

// The key tiles a block visits for mask row `mb` (Lk keys, tiles of
// `tile_keys`): the tiles that hold a valid key, listed in ascending order
// in shared memory (`list`, kMaxListedTiles entries; `flags`, as many
// bytes; `scratch`, one int a warp). Every tile where there is no mask, no
// valid key (a fully masked row averages V over all keys) or more tiles
// than the list holds: a masked tile adds exactly nothing once a valid key
// has set the running max (exp(-1e30 - m) = 0, and alpha = 0 scales away
// one seen before), so skipping only saves time. Every thread of the block
// calls it, before any role split, so all roles walk the same list.
template <int kThreads>
__device__ KeyTiles key_tiles(const unsigned char* mb, int Lk, int tile_keys,
                              uint16_t* list, unsigned char* flags,
                              int* scratch) {
  constexpr int kWarps = kThreads / 32;
  const int n_tiles = (Lk + tile_keys - 1) / tile_keys;
  if (mb == nullptr || n_tiles > kMaxListedTiles) return {nullptr, n_tiles};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // a warp per tile, its lanes over the tile's keys (coalesced bytes)
#pragma unroll 4
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int k1 = min(Lk, (t + 1) * tile_keys);
    int valid = 0;
    for (int c = t * tile_keys + lane; c < k1; c += 32) valid |= mb[c];
    valid = __any_sync(0xffffffffu, valid != 0);
    if (lane == 0) flags[t] = static_cast<unsigned char>(valid);
  }
  __syncthreads();
  // compaction in order: a thread per tile, ballots and per-warp counts
  int total = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int t = base + static_cast<int>(threadIdx.x);
    const bool valid = t < n_tiles && flags[t];
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    int before = total;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += scratch[w];
      total += scratch[w];
    }
    if (valid) {
      list[before + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(t);
    }
    __syncthreads();  // scratch is reused; the list is complete after the last
  }
  if (total == 0) return {nullptr, n_tiles};
  return {list, total};
}

// score of key `c` (0-based in the tile of kv real keys) after scaling
__device__ inline float masked_score(float s, int c, int kv,
                                     const unsigned char* mk) {
  if (c >= kv) return -INFINITY;             // past Lk: excluded
  if (mk && !mk[c]) return kMaskedScore;     // masked key
  return s;
}

// --------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma, cp.async, mma.sync
// --------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); offsets in bytes, encoded in 16-byte units
__device__ inline uint64_t sw128_desc(const void* p, uint32_t lbo,
                                      uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ inline void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32's 10 mantissa bits (nearest, ties away from zero) by
// integer ops: two instructions where cvt.rna.tf32.f32 costs more, and the
// split runs for every fragment element the products read
__device__ inline uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo in TF32; x - hi is exact in fp32
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

__device__ inline void mma_tf32(float* c, const uint32_t* a,
                                const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a * b[i] in 3xTF32 for the first `live` of N accumulators, the
// small cross terms first. Each term is issued for every accumulator before
// the next term, so the N dependency chains overlap (a warp issues in
// order, and one chain alone waits out each product's latency).
template <int N>
__device__ inline void mma_3xtf32(float (*c)[4], const uint32_t* a_hi,
                                  const uint32_t* a_lo,
                                  const uint32_t (*b_hi)[2],
                                  const uint32_t (*b_lo)[2], int live = N) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < live) mma_tf32(c[i], a_lo, b_hi[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < live) mma_tf32(c[i], a_hi, b_lo[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < live) mma_tf32(c[i], a_hi, b_hi[i]);
  }
}

// d (64 x 64 fp32 accumulator fragment) += A (smem) * B (smem), both K-major
__device__ inline void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (bf16 fragment in registers) * B (smem, MN-major)
__device__ inline void wgmma_rs_n64(float* d, const uint32_t* a,
                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (bf16 fragment in registers) * B (smem, MN-major)
__device__ inline void wgmma_rs_n128(float* d, const uint32_t* a,
                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 fp32) += A (bf16 fragment in registers) * B (smem, MN-major)
__device__ inline void wgmma_rs_n192(float* d, const uint32_t* a,
                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 fp32) += A (bf16 fragment in registers) * B (smem, MN-major)
__device__ inline void wgmma_rs_n256(float* d, const uint32_t* a,
                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DP>
__device__ inline void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (DP == 192) {
    wgmma_rs_n192(d, a, db);
  } else {
    static_assert(DP == 256, "DP is 64, 128, 192 or 256");
    wgmma_rs_n256(d, a, db);
  }
}

// --------------------------------------------------------------------------
// design A: bf16, TMA ring + wgmma, one producer and two consumer warpgroups
// --------------------------------------------------------------------------

constexpr int kRowsA = 128;       // query rows per block: 2 consumers x 64
constexpr int kThreadsA = 384;    // producer + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;        // K/V ring depth
constexpr int kChunkQ = kRowsA * 128;      // bytes of 64 bf16 columns of Q
constexpr int kChunkKV = kKeyTile * 128;   // bytes of 64 bf16 columns of K

// Shared memory of a block for head dims up to DP (a multiple of 64): every
// operand is stored as DP / 64 chunks of 64 columns, each chunk rows x 128
// bytes in TMA's 128-byte swizzle (1024-byte aligned atoms of 8 rows).
template <int DP>
struct SmemA {
  static constexpr int kChunks = DP / 64;
  static constexpr int q = 0;
  static constexpr int kv = kChunks * kChunkQ;  // stage s at kv + s * stage
  static constexpr int stage = 2 * kChunks * kChunkKV;  // K chunks, V chunks
  static constexpr int bars = kv + kStages * stage;
  static constexpr int list = bars + 8 * (2 * kStages + 1);  // key_tiles'
  static constexpr int flags = list + 2 * kMaxListedTiles;
  static constexpr int scratch = flags + kMaxListedTiles;
  static constexpr int total = scratch + 4 * (kThreadsA / 32) + 1024;  // align
};

template <int DP, bool kDrop>
__global__ void __launch_bounds__(kThreadsA, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const unsigned char* __restrict__ mask,
                       bf16* __restrict__ out, float* __restrict__ lse, int H,
                       int Lq, int Lk, int D, float scale, uint32_t seed,
                       uint32_t keep_thresh, float inv_keep) {
  using S = SmemA<DP>;
  constexpr int NC = S::kChunks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRowsA;
  const unsigned char* mb = mask ? mask + static_cast<size_t>(b) * Lk : nullptr;
  const KeyTiles walk = key_tiles<kThreadsA>(
      mb, Lk, kKeyTile, reinterpret_cast<uint16_t*>(smem + S::list),
      smem + S::flags, reinterpret_cast<int*>(smem + S::scratch));

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerThreads);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NC * kChunkQ);
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(smem + S::q + c * kChunkQ, &map_q, q_full, c * 64, q0, bh);
      }
      for (int i = 0; i < walk.count; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) - 1) & 1);
        mbar_expect_tx(full + s, S::stage);
        const int k0 = walk[i] * kKeyTile;
        unsigned char* st = smem + S::kv + s * S::stage;
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(st + c * kChunkKV, &map_k, full + s, c * 64, k0, bh);
          tma_load_3d(st + (NC + c) * kChunkKV, &map_v, full + s, c * 64, k0,
                      bh);
        }
      }
    }
    return;
  }

  // consumers: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread: row0, row0 + 8
  const bool active = q0 + cw * 64 < Lq;          // else only frees the ring
  Dropout drop{0u, keep_thresh, inv_keep};
  if constexpr (kDrop) drop.for_head(seed, bh);
  const int ksteps = (D + 15) / 16;  // wgmma k-steps over D (zero-filled pad)
  const unsigned char* sq = smem + S::q + cw * 64 * 128;

  // accumulator fragment of wgmma m64nN: element 4n + e of this thread is
  // row 16 * warp + g + 8 * (e / 2), column 8n + 2t + e % 2
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int i = 0; i < walk.count; ++i) {
    const int s = i % kStages;
    mbar_wait(full + s, (i / kStages) & 1);
    if (active) {
      const int k0 = walk[i] * kKeyTile;
      const int kv = min(kKeyTile, Lk - k0);
      const unsigned char* sk = smem + S::kv + s * S::stage;
      const unsigned char* sv = sk + NC * kChunkKV;

      // S = Q K^T: K-major operands, 16 columns (32 bytes) per k-step
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      wgmma_fence();
      for (int j = 0; j < ksteps; ++j) {
        const int off = (j % 4) * 32;
        wgmma_ss_n64(sc,
                     sw128_desc(sq + (j / 4) * kChunkQ + off, 16, 1024),
                     sw128_desc(sk + (j / 4) * kChunkKV + off, 16, 1024),
                     j > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 32; ++j) reg_fence(sc[j]);

      // online softmax on the fragment; a row's 64 scores live in the 4
      // threads of a quad
      const unsigned char* mk = mb ? mb + k0 : nullptr;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = masked_score(sc[4 * n + e] * scale,
                                       8 * n + 2 * t + (e & 1), kv, mk);
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // s - m first: exactly 0 on a fully masked row (-1e30 - -1e30),
          // where s log2e - m log2e is not
          const float p = exp2f((sc[4 * n + e] - m[e >> 1]) * kLog2e);
          rs[e >> 1] += p;
          if constexpr (kDrop) {
            sc[4 * n + e] = p * drop.factor(row0 + 8 * (e >> 1),
                                            k0 + 8 * n + 2 * t + (e & 1));
          } else {
            sc[4 * n + e] = p;
          }
        }
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];

      // P as the A fragment of m64k16 (mma.m16n8k16's layout per warp):
      // key block kb is accumulator n-blocks 2kb and 2kb + 1
      uint32_t pa[16];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[4 * kb + r] =
              pack_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n + 0] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // O += P V: V is MN-major (D contiguous); LBO steps a 64-column
      // chunk, SBO 8 keys, each k-step 16 keys (2048 bytes)
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        wgmma_rs<DP>(o, pa + 4 * kb,
                     sw128_desc(sv + kb * 16 * 128, kChunkKV, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) reg_fence(o[j]);
    }
    mbar_arrive(empty + s);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    bf16* orow = out + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D) {
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(o[4 * n + 2 * r] / l_safe, o[4 * n + 2 * r + 1] / l_safe);
      }
    }
    if (t == 0) {
      lse[static_cast<size_t>(bh) * Lq + row] = m[r] + logf(l_safe);
    }
  }
}

// --------------------------------------------------------------------------
// design B: fp32, 3xTF32 mma.sync, cp.async ring
// --------------------------------------------------------------------------

constexpr int kRowsB = 64;      // 4 warps x 16 query rows
constexpr int kThreadsB = 128;

// floats of shared memory for head dim D: Q (64 rows) and 2 stages of K and
// V (32 rows each), rows padded to D + 4 so that a fragment's 8 rows x 4
// columns fall in 32 distinct banks; key_tiles' list, flags and scratch
// follow
__host__ __device__ inline int smem_floats_b(int D) {
  return (kRowsB + 4 * kKeyTile32) * (D + 4);
}
constexpr int kListBytesB = 3 * kMaxListedTiles + 4 * (kThreadsB / 32);

// rows [0, valid) of a (rows, D) fp32 tile into shared memory (leading dim
// ld), zero-filling the rest, as 16-byte cp.async copies
__device__ inline void load_rows_async(float* dst, int ld, const float* src,
                                       int rows, int valid, int D) {
  const int vpr = D / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreadsB) {
    const int r = i / vpr;
    const int c = (i % vpr) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c,
               ok ? src + static_cast<size_t>(r) * D + c : src, ok);
  }
}

// head dims D <= DMAX; up to 128, three blocks share an SM (<= 168
// registers a thread)
template <int DMAX, bool kDrop>
__global__ void __launch_bounds__(kThreadsB, DMAX <= 128 ? 3 : 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ lse, int H,
                      int Lq, int Lk, int D, float scale, uint32_t seed,
                      uint32_t keep_thresh, float inv_keep) {
  constexpr int ND = DMAX / 8;  // n-blocks of 8 columns
  extern __shared__ __align__(16) float smf[];
  const int ld = D + 4;
  float* sq = smf;
  float* skv = smf + kRowsB * ld;  // stage s: K at + s * 64 ld, V 32 ld on

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRowsB;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread: row0, row0 + 8
  const bool active = q0 + warp * 16 < Lq;
  const int nd = D / 8;
  const float* kb = k + static_cast<size_t>(bh) * Lk * D;
  const float* vb = v + static_cast<size_t>(bh) * Lk * D;
  const unsigned char* mb = mask ? mask + static_cast<size_t>(b) * Lk : nullptr;
  unsigned char* lists = reinterpret_cast<unsigned char*>(
      smf + smem_floats_b(D));
  const KeyTiles walk = key_tiles<kThreadsB>(
      mb, Lk, kKeyTile32, reinterpret_cast<uint16_t*>(lists),
      lists + 2 * kMaxListedTiles,
      reinterpret_cast<int*>(lists + 3 * kMaxListedTiles));
  Dropout drop{0u, keep_thresh, inv_keep};
  if constexpr (kDrop) drop.for_head(seed, bh);

  auto load_kv = [&](int i) {
    const int k0 = walk[i] * kKeyTile32;
    const int kv = min(kKeyTile32, Lk - k0);
    float* st = skv + (i & 1) * 2 * kKeyTile32 * ld;
    load_rows_async(st, ld, kb + static_cast<size_t>(k0) * D, kKeyTile32, kv,
                    D);
    load_rows_async(st + kKeyTile32 * ld, ld, vb + static_cast<size_t>(k0) * D,
                    kKeyTile32, kv, D);
  };
  load_rows_async(sq, ld, q + (static_cast<size_t>(bh) * Lq + q0) * D, kRowsB,
                  min(kRowsB, Lq - q0), D);
  load_kv(0);
  cp_async_commit();

  // accumulator fragment of mma m16n8: element e of n-block n is row
  // 16 * warp + g + 8 * (e / 2), column 8n + 2t + e % 2
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums
  const float* qw = sq + warp * 16 * ld;

  for (int i = 0; i < walk.count; ++i) {
    if (i + 1 < walk.count) {
      load_kv(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int k0 = walk[i] * kKeyTile32;
      const int kv = min(kKeyTile32, Lk - k0);
      const float* sk = skv + (i & 1) * 2 * kKeyTile32 * ld;
      const float* sv = sk + kKeyTile32 * ld;

      // S = Q K^T, each fragment split into hi/lo once per load
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        if (j >= nd) break;
        const int c = 8 * j + t;
        uint32_t ah[4], al[4];
        split_tf32(qw[g * ld + c], ah[0], al[0]);
        split_tf32(qw[(g + 8) * ld + c], ah[1], al[1]);
        split_tf32(qw[g * ld + c + 4], ah[2], al[2]);
        split_tf32(qw[(g + 8) * ld + c + 4], ah[3], al[3]);
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          split_tf32(sk[(8 * n + g) * ld + c], bhi[n][0], blo[n][0]);
          split_tf32(sk[(8 * n + g) * ld + c + 4], bhi[n][1], blo[n][1]);
        }
        mma_3xtf32<4>(sc, ah, al, bhi, blo);
      }

      const unsigned char* mk = mb ? mb + k0 : nullptr;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = masked_score(sc[n][e] * scale,
                                       8 * n + 2 * t + (e & 1), kv, mk);
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
      // P as A fragments of m16n8k8 over each 8-key block, the key axis
      // read permuted: logical k = t is key 2t, k = t + 4 is key 2t + 1
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f((sc[n][e] - m[e >> 1]) * kLog2e);
          rs[e >> 1] += p[e];
          if constexpr (kDrop) {
            p[e] *= drop.factor(row0 + 8 * (e >> 1),
                                k0 + 8 * n + 2 * t + (e & 1));
          }
        }
        split_tf32(p[0], ph[n][0], pl[n][0]);  // row g, key 2t
        split_tf32(p[2], ph[n][1], pl[n][1]);  // row g + 8, key 2t
        split_tf32(p[1], ph[n][2], pl[n][2]);  // row g, key 2t + 1
        split_tf32(p[3], ph[n][3], pl[n][3]);  // row g + 8, key 2t + 1
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];

      // O = alpha O + P V, each n-block's product from a zero accumulator,
      // kG n-blocks of 8 columns at a time
      constexpr int kG = ND >= 16 ? 4 : 2;
#pragma unroll
      for (int j0 = 0; j0 < ND; j0 += kG) {
        if (j0 < nd) {
          const int live = min(kG, nd - j0);
          float acc[kG][4];
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.0f;
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t bhi[kG][2], blo[kG][2];
#pragma unroll
            for (int jj = 0; jj < kG; ++jj) {
              if (jj < live) {
                const float* vr = sv + (8 * n + 2 * t) * ld + 8 * (j0 + jj) + g;
                split_tf32(vr[0], bhi[jj][0], blo[jj][0]);   // key 2t
                split_tf32(vr[ld], bhi[jj][1], blo[jj][1]);  // key 2t + 1
              }
            }
            mma_3xtf32<kG>(acc, ph[n], pl[n], bhi, blo, live);
          }
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            if (jj < live) {
              float* oj = o[j0 + jj];
              oj[0] = oj[0] * alpha[0] + acc[jj][0];
              oj[1] = oj[1] * alpha[0] + acc[jj][1];
              oj[2] = oj[2] * alpha[1] + acc[jj][2];
              oj[3] = oj[3] * alpha[1] + acc[jj][3];
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (j < nd) {
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
            make_float2(o[j][2 * r] / l_safe, o[j][2 * r + 1] / l_safe);
      }
    }
    if (t == 0) {
      lse[static_cast<size_t>(bh) * Lq + row] = m[r] + logf(l_safe);
    }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library links without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 3-D map of a (BH, L, D) bf16 tensor as dims (D, L, BH): boxes of 64
// columns x `rows` rows of one batch*head, 128-byte swizzle; boxes past D
// or L read zeros, and never the next head's rows
int make_map(CUtensorMap* map, const void* base, int BH, int L, int D,
             int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * sizeof(bf16),
                                 static_cast<cuuint64_t>(L) * D * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

struct Args {
  const void *q, *k, *v;
  const unsigned char* mask;
  void* out;
  float* lse;
  int BH, H, Lq, Lk, D;
  float scale;
  uint32_t seed, keep_thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <int DP, bool kDrop>
int launch_wgmma(const Args& a) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, a.q, a.BH, a.Lq, a.D, kRowsA);
  if (!err) err = make_map(&mk, a.k, a.BH, a.Lk, a.D, kKeyTile);
  if (!err) err = make_map(&mv, a.v, a.BH, a.Lk, a.D, kKeyTile);
  if (err) return err;
  auto kernel = flash_fwd_wgmma_kernel<DP, kDrop>;
  constexpr int bytes = SmemA<DP>::total;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Lq + kRowsA - 1) / kRowsA, a.BH);
  kernel<<<grid, kThreadsA, bytes, a.stream>>>(
      mq, mk, mv, a.mask, static_cast<bf16*>(a.out),
      a.lse, a.H, a.Lq, a.Lk, a.D, a.scale, a.seed, a.keep_thresh,
      a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, bool kDrop>
int launch_tf32(const Args& a) {
  auto kernel = flash_fwd_tf32_kernel<DMAX, kDrop>;
  const int bytes =
      smem_floats_b(a.D) * static_cast<int>(sizeof(float)) + kListBytesB;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Lq + kRowsB - 1) / kRowsB, a.BH);
  kernel<<<grid, kThreadsB, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask,
      static_cast<float*>(a.out), a.lse, a.H, a.Lq, a.Lk, a.D, a.scale,
      a.seed, a.keep_thresh, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDrop>
int launch(const Args& a, int dtype) {
  if (dtype == 1) {
    if (a.D <= 64) return launch_wgmma<64, kDrop>(a);
    if (a.D <= 128) return launch_wgmma<128, kDrop>(a);
    if (a.D <= 192) return launch_wgmma<192, kDrop>(a);
    return launch_wgmma<256, kDrop>(a);
  }
  if (a.D <= 64) return launch_tf32<64, kDrop>(a);
  if (a.D <= 128) return launch_tf32<128, kDrop>(a);
  return launch_tf32<256, kDrop>(a);
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
      H <= 0 || BH % H != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,  v,     mask, out,         lse,      BH, H,
               Lq, Lk, D, scale, seed, keep_thresh, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return inv_keep > 0.0f ? launch<true>(a, dtype) : launch<false>(a, dtype);
}

}  // extern "C"
