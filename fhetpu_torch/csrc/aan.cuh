// The two-pass 8x8 AAN DCT on canonical residues, for the DCT-only kernel
// (dct.cu), and the per-lane DCT constants that the fused server kernels
// (server_ycc_dct.cu, server_ycc_dct_strict.cu) share with it.
//
// Constants come from the rows of pack_server_constants (a [24, L*n] table
// indexed by lane): rows 0..12 are the DCT multipliers in the order of
// fhetpu/core/pallas_dct.py:CONST_ORDER (row 12 is encode(0.125)), row 22
// the lane's modulus.  Rows 0..12 hold the same residues as fhetpu's
// pack_dct_constants, so the DCT-only kernel needs no table of its own.
#pragma once

#include <stdint.h>

#include "modarith.cuh"

namespace {

constexpr int kDctRows = 13;  // CONST_ORDER; row 12 is encode(0.125)
constexpr int kPRow = 22;     // the lane's modulus

struct DctConsts {
  uint32_t w[kDctRows];
  uint32_t ws[kDctRows];
};

// Lane j's DCT multipliers and their Shoup companions.
__device__ __forceinline__ DctConsts load_dct_consts(const uint32_t* __restrict__ C,
                                                     const uint32_t* __restrict__ Csh,
                                                     long long lanes, long long j) {
  DctConsts k;
#pragma unroll
  for (int i = 0; i < kDctRows; ++i) {
    k.w[i] = C[i * lanes + j];
    k.ws[i] = Csh[i * lanes + j];
  }
  return k;
}

// One 8-point AAN pass over v[base + stride * i], i = 0..7, in place
// (fhetpu/core/pallas_dct.py:_aan_pass; the reference network
// fhe_image.h:206-284).
__device__ __forceinline__ void aan8(uint32_t* v, int base, int stride, bool scale_eighth,
                                     const DctConsts& k, uint32_t p) {
  auto mul = [&](uint32_t x, int ci) { return mulmod_shoup(x, k.w[ci], k.ws[ci], p); };
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = v[base + stride * i];
  const uint32_t tmp0 = addmod(a[0], a[7], p);
  uint32_t tmp7 = submod(a[0], a[7], p);
  const uint32_t tmp1 = addmod(a[1], a[6], p);
  uint32_t tmp6 = submod(a[1], a[6], p);
  const uint32_t tmp2 = addmod(a[2], a[5], p);
  uint32_t tmp5 = submod(a[2], a[5], p);
  const uint32_t tmp3 = addmod(a[3], a[4], p);
  uint32_t tmp4 = submod(a[3], a[4], p);
  const uint32_t tmp10 = addmod(tmp0, tmp3, p);
  const uint32_t tmp13 = submod(tmp0, tmp3, p);
  const uint32_t tmp11 = addmod(tmp1, tmp2, p);
  const uint32_t tmp12 = submod(tmp1, tmp2, p);
  uint32_t o[8];
  o[0] = addmod(tmp10, tmp11, p);
  o[4] = submod(tmp10, tmp11, p);
  uint32_t z1 = mul(addmod(tmp12, tmp13, p), 0);
  o[2] = addmod(z1, mul(tmp13, 1), p);
  o[6] = addmod(z1, mul(tmp12, 2), p);
  z1 = addmod(tmp4, tmp7, p);
  uint32_t z2 = addmod(tmp5, tmp6, p);
  uint32_t z3 = addmod(tmp4, tmp6, p);
  uint32_t z4 = addmod(tmp5, tmp7, p);
  const uint32_t z5 = mul(addmod(z3, z4, p), 3);
  tmp4 = mul(tmp4, 4);
  tmp5 = mul(tmp5, 5);
  tmp6 = mul(tmp6, 6);
  tmp7 = mul(tmp7, 7);
  z1 = mul(z1, 8);
  z2 = mul(z2, 9);
  z3 = mul(z3, 10);
  z4 = mul(z4, 11);
  z3 = addmod(z3, z5, p);
  z4 = addmod(z4, z5, p);
  o[7] = addmod(addmod(tmp4, z1, p), z3, p);
  o[5] = addmod(addmod(tmp5, z2, p), z4, p);
  o[3] = addmod(addmod(tmp6, z2, p), z3, p);
  o[1] = addmod(addmod(tmp7, z1, p), z4, p);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[base + stride * i] = scale_eighth ? mul(o[i], 12) : o[i];
}

// Row pass over each group g (slots 8g..8g+7), then the column pass over
// each s (slots s, s+8, ..., s+56) with x0.125 (jpeg_encode.py:dct8x8).
__device__ __forceinline__ void dct8x8(uint32_t* v, const DctConsts& k, uint32_t p) {
#pragma unroll
  for (int g = 0; g < 8; ++g) aan8(v, 8 * g, 1, false, k, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) aan8(v, s, 8, true, k, p);
}

}  // namespace
