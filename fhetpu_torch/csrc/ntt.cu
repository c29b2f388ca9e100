// Negacyclic NTT and inverse NTT over RNS limbs, one CTA per (polynomial, limb).
//
// Replaces the Pallas kernel fhetpu/core/pallas_ntt.py:_kernel (forward=True
// and forward=False), built by make_ntt and dispatched from
// fhetpu/core/ntt.py:ntt/intt.
//
// Computes exactly what fhetpu/core/ntt.py:_ntt_impl/_intt_impl compute:
//   forward: Cooley-Tukey, natural order in, bit-reversed out; stage m (m =
//     1, 2, 4, ..., n/2) pairs u = i*2t + j with v = u + t and twiddle
//     psi_br[m + i];
//   inverse: Gentleman-Sande, bit-reversed in, natural out; stage h (h = n/2,
//     ..., 1) pairs the same way with twiddle ipsi_br[h + i], then x n^-1.
// Residues are canonical at every step, so the output is bit-identical to
// the host and TPU transforms.
//
// What bounds it on an H100: the data moves once (4n bytes in and out per
// polynomial).  The fewest integer operations that give these bits (a lazy
// Harvey butterfly of 7: a lazy Shoup product, two adds and one conditional
// subtraction, over log2(n) stages of n/2) take about 0.55 of the HBM time
// at n=4096, so HBM bounds it; this kernel's canonical butterflies and index
// math issue more, and shared-memory traffic adds to them.  The design keeps the whole
// polynomial in shared memory for all stages (one HBM read and one write),
// and reads the twiddles of its limb from the L2-resident tables.  One
// polynomial is 4n bytes: 64 KB at n=16384, above the 48 KB a kernel gets
// without opting in, so the launcher raises the dynamic shared-memory limit
// first and returns any error instead of launching blind.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"

namespace {

template <bool kForward>
__global__ void ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, int L,
                           int logn, const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ tw_shoup,
                           const uint32_t* __restrict__ primes,
                           const uint32_t* __restrict__ n_inv,
                           const uint32_t* __restrict__ n_inv_shoup) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t poly = blockIdx.x;  // flattened (batch, limb)
  const int limb = static_cast<int>(poly % L);
  const uint32_t p = primes[limb];
  const uint32_t* w = tw + static_cast<size_t>(limb) * n;
  const uint32_t* ws = tw_shoup + static_cast<size_t>(limb) * n;
  const uint32_t* src = x + poly * n;
  uint32_t* dst = y + poly * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = src[i];
  __syncthreads();

  for (int s = 0; s < logn; ++s) {
    // forward: t = n/2 .. 1 with m = 1 .. n/2; inverse: t = 1 .. n/2 with h = n/2 .. 1
    const int logt = kForward ? logn - 1 - s : s;
    const int t = 1 << logt;
    const int m = kForward ? 1 << s : n >> (s + 1);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> logt;
      const int u = (i << (logt + 1)) + (k & (t - 1));
      const int v = u + t;
      const uint32_t au = a[u];
      const uint32_t av = a[v];
      if (kForward) {
        const uint32_t wv = mulmod_shoup(av, w[m + i], ws[m + i], p);
        a[u] = addmod(au, wv, p);
        a[v] = submod(au, wv, p);
      } else {
        a[u] = addmod(au, av, p);
        a[v] = mulmod_shoup(submod(au, av, p), w[m + i], ws[m + i], p);
      }
    }
    __syncthreads();
  }

  if (kForward) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = a[i];
  } else {
    const uint32_t ni = n_inv[limb];
    const uint32_t nis = n_inv_shoup[limb];
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = mulmod_shoup(a[i], ni, nis, p);
  }
}

template <bool kForward>
cudaError_t launch(const uint32_t* x, uint32_t* y, long long batch, int L, int n,
                   const uint32_t* tw, const uint32_t* tw_shoup, const uint32_t* primes,
                   const uint32_t* n_inv, const uint32_t* n_inv_shoup, cudaStream_t stream) {
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  if (n < 2 || (1 << logn) != n || L < 1 || batch < 1) return cudaErrorInvalidValue;
  const long long blocks = batch * L;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_kernel<kForward>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ntt_kernel<kForward><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, y, L, logn, tw, tw_shoup, primes, n_inv, n_inv_shoup);
  return cudaGetLastError();
}

}  // namespace

// x, y: uint32 [batch, L, n] (distinct buffers); tw/tw_shoup: [L, n] psi_br
// (forward) or ipsi_br (inverse) with Shoup companions; primes, n_inv,
// n_inv_shoup: [L] (n_inv unused by the forward transform).
extern "C" int fhetpu_ntt(const uint32_t* x, uint32_t* y, long long batch, int L, int n,
                          const uint32_t* tw, const uint32_t* tw_shoup,
                          const uint32_t* primes, const uint32_t* n_inv,
                          const uint32_t* n_inv_shoup, int forward, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      forward ? launch<true>(x, y, batch, L, n, tw, tw_shoup, primes, n_inv, n_inv_shoup, s)
              : launch<false>(x, y, batch, L, n, tw, tw_shoup, primes, n_inv, n_inv_shoup, s);
  return static_cast<int>(e);
}

extern "C" const char* fhetpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
