// Canonical mod-p arithmetic on uint32 residues, p < 2^30.
//
// Every value stays in [0, p), except through mulmod_shoup_lazy.  The Shoup product needs the precomputed
// companion w_shoup = floor(w * 2^32 / p): q = mulhi(x, w_shoup) is the
// quotient estimate, and x*w - q*p (mod 2^32) lies in [0, 2p), so one
// conditional subtraction makes it canonical.  Hopper has a native 32x32
// high multiply (__umulhi), which replaces the 16-bit-limb emulation the
// TPU kernels needed (fhetpu/core/modops.py:mulhi32).
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t r = a + b;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t r = a + p - b;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t mulmod_shoup(uint32_t x, uint32_t w, uint32_t w_shoup,
                                                 uint32_t p) {
  const uint32_t q = __umulhi(x, w_shoup);
  const uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

// The Shoup product without its final subtraction, for lazy reduction: for
// ANY x < 2^32, q = mulhi(x, w_shoup) > x*w/p - 2, so x*w - q*p lies in
// [0, 2p) (fhetpu/core/pallas_server.py:_lmul, whose 16-bit limbs compute
// the same exact high product).
__device__ __forceinline__ uint32_t mulmod_shoup_lazy(uint32_t x, uint32_t w,
                                                      uint32_t w_shoup, uint32_t p) {
  return x * w - __umulhi(x, w_shoup) * p;
}
