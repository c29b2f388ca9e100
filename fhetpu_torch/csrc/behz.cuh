// The lazy uint32 arithmetic, row loads and stores and the persistent grid
// of the BEHZ kernels (behz_extend.cu, behz_tensor.cu, behz_floor_convert.cu).
//
// Every multiplier is a table constant w beside its Shoup companion
// floor(w 2^32 / p), packed as a uint2: one __umulhi and two multiplies give
// x w mod p in [0, 2p) for any x < 2^32, which covers residues of one base
// fed to the primes of another.  Sums stay lazy in [0, 2p): a lazy product
// is added and the sum folded back below 2p with one unsigned min (r - 2p
// wraps above r when r < 2p), so nothing leaves 32 bits while p < 2^30
// (4p < 2^32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kBehzThreads = 256;

// r in [0, 2p) -> [0, p)
__device__ __forceinline__ uint32_t fold(uint32_t r, uint32_t p) { return min(r, r - p); }

// x * w mod p in [0, 2p), for any x < 2^32; w = (w, floor(w 2^32 / p))
__device__ __forceinline__ uint32_t lazy_mul(uint32_t x, uint2 w, uint32_t p) {
  return x * w.x - __umulhi(x, w.y) * p;
}

// acc + x, both in [0, 2p), back in [0, 2p)
__device__ __forceinline__ uint32_t lazy_add(uint32_t acc, uint32_t x, uint32_t p2) {
  return fold(acc + x, p2);
}

// a - b mod p, canonical, for a, b in [0, 2p)
__device__ __forceinline__ uint32_t lazy_sub(uint32_t a, uint32_t b, uint32_t p) {
  return fold(fold(a + 2 * p - b, 2 * p), p);
}

// C consecutive residues of one row: one 16-, 8- or 4-byte load
template <int C>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&v)[C]) {
  if constexpr (C == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (C == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// C consecutive residues of one row: one 16-, 8- or 4-byte store
template <int C>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// blocks of kern (kBehzThreads threads) resident on the current device at
// once: SMs x blocks per SM, the persistent grid's size
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kBehzThreads, 0)) !=
      cudaSuccess)
    return e;
  *blocks = sms * per_sm;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// items = m * n / C (component, C coefficients) pairs in a grid of at most
// `blocks` persistent blocks; a row is n = C << row_shift coefficients
template <int C>
inline bool grid_shape(long long m, int n, int blocks, long long* items,
                       int* row_shift, unsigned* grid) {
  if (n < C || (n & (n - 1)) || blocks < 1) return false;
  *row_shift = 0;
  while ((C << *row_shift) < n) ++*row_shift;
  *items = m * (n / C);
  long long g = (*items + kBehzThreads - 1) / kBehzThreads;
  *grid = static_cast<unsigned>(g > blocks ? blocks : g);
  return true;
}
