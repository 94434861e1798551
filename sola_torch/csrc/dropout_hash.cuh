// The attention-dropout keep mask shared by the flash forward
// (flash_attn_fwd.cu) and the fused backward kernel (flash_attn_bwd.cu),
// which must regenerate the same mask from the seed: the counter hash of
// sola_tpu/ops/flash_attention.py::_keep_mask / _fmix32 (:28-55). An
// entry (batch*head bh, global query q, global key c) is kept when
//   fmix32(fmix32(seed ^ bh * 0x9E3779B1) ^ q * 0x85EBCA6B ^ c * 0xC2B2AE35)
// is below keep_thresh, and a kept probability is scaled by inv_keep. The
// uint32_t multiplies wrap as the TPU's uint32 lanes do, and the indices
// are global, so the mask does not depend on any kernel's tiles.

#pragma once

#include <stdint.h>

namespace sola_dropout {

// splitmix32 finalizer
__device__ inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  uint32_t base;    // fmix32(seed ^ bh * 0x9E3779B1), set by for_head
  uint32_t thresh;  // keep if the hash is below it
  float inv_keep;

  __device__ inline void for_head(uint32_t seed, int bh) {
    base = fmix32(seed ^ (static_cast<uint32_t>(bh) * 0x9E3779B1u));
  }

  // keep x inv_keep (or 0) for global query q and global key c
  __device__ inline float factor(int q, int c) const {
    const uint32_t h = fmix32(base ^ (static_cast<uint32_t>(q) * 0x85EBCA6Bu) ^
                              (static_cast<uint32_t>(c) * 0xC2B2AE35u));
    return h < thresh ? inv_keep : 0.0f;
  }
};

}  // namespace sola_dropout
