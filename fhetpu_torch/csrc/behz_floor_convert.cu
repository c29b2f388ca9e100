// BEHZ's scale-and-floor by t/q in Bsk and its exact Shenoy-Kumaresan
// conversion Bsk -> q, in one pass over the inverse NTTs' outputs.
//
// Replaces no TPU kernel: fhetpu computes these steps as XLA ops
// (fhetpu/bfv/rns.py: RnsTool.scale_floor_to_bsk, convert_bsk_to_q).  On a
// CPU tensor the port keeps the torch steps of fhetpu_torch/bfv/rns.py, and
// they are this kernel's oracle: the output is bit-equal, fast floor and
// the centring of alpha included.
//
// For each (component, coefficient) it reads the tensor product, before
// its scaling by t, as L residues mod q_i and K = L + 2 residues mod Bsk =
// {b_0..b_L, m_sk}, and writes L residues mod q_i as int64 (the torch
// steps' dtype):
//   z_i   = x_i * t * qhat_i^-1                               mod q_i
//   z_k   = (x_k * t - sum_i z_i (q/q_i)) * q^-1 * c_k        mod b_k
//           with c_j = Bhat_j^-1 for j <= L and c = B^-1 at m_sk
//   alpha = sum_j z_j (B/b_j) B^-1 - z_msk                    mod m_sk
//   y_i   = sum_j z_j (B/b_j) - alpha_c B                     mod q_i
// alpha_c is alpha centred as the torch code centres it: alpha - m_sk where
// alpha >= floor(m_sk / 2).  Folding t, q^-1, Bhat_j^-1 and B^-1 into the
// tables (core/behz_kernel.py:table_parts) removes 3L + 4 products per
// coefficient; each is an identity mod the prime, so the residues match.
//
// What bounds it on an H100: bytes, then integer throughput.  Per coefficient
// it reads 4(L + K) bytes and writes 8L; at L = 4 that is 72 bytes and 63
// products of a 32-bit operand by a table constant.  Design:
// * Every multiplier is a table constant, so every product is a Shoup
//   product with its companion floor(w 2^32 / p): one __umulhi and two
//   multiplies, valid for any operand below 2^32, which covers residues of
//   one base fed to the primes of another.
// * Sums are lazy in [0, 2p): a lazy product (< 2p) is added and the sum
//   folded back below 2p with one unsigned min (r - 2p wraps above r when
//   r < 2p), so nothing leaves 32 bits (p < 2^30 keeps 4p < 2^32).  Each
//   sum is made canonical once at its end.  The z's that a later sum
//   reads are canonical, as the CRT sums need.
// * Nothing goes to device memory between the steps: a thread holds its
//   coefficients' 2L + 2 residues in registers.
// * A thread takes C consecutive coefficients of one component (C = 4 at
//   L <= 4, 2 at L = 8, 1 above), so each row is one 16-, 8- or 4-byte load,
//   a warp's loads are contiguous, each table constant loaded from shared
//   memory serves C coefficients, and a thread holds about (L + K) C
//   residues at every L.
// * The table (L + K primes, then (w, w_shoup) pairs) is copied into shared
//   memory once per block; a warp reads one address at a time (broadcast).
//   Persistent blocks, one wave, walk the (component, coefficient) items in
//   a grid stride, so any M * n fits in the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "behz.cuh"

namespace {

// The table's layout for L q primes (core/behz_kernel.py:table_parts holds
// the same order): L + K primes, then (w, w_shoup) pairs.
template <int L>
struct Layout {
  static constexpr int K = L + 2, NB = L + 1;  // Bsk primes, B primes
  static constexpr int kA = 0;                 // [L]      t qhat_i^-1 mod q_i
  static constexpr int kU = kA + L;            // [K]      t q^-1 c_k mod b_k
  static constexpr int kV = kU + K;            // [L][K]   (q/q_i) q^-1 c_k mod b_k
  static constexpr int kG = kV + L * K;        // [NB]     (B/b_j) B^-1 mod m_sk
  static constexpr int kE = kG + NB;           // [NB][L]  (B/b_j) mod q_i
  static constexpr int kBQ = kE + NB * L;      // [L]      B mod q_i
  static constexpr int kNBQ = kBQ + L;         // [L]      -B mod q_i
  static constexpr int kPairs = kNBQ + L;
  static constexpr int kPrimeWords = L + K;    // even: the pairs stay 8-byte aligned
  static constexpr int kWords = kPrimeWords + 2 * kPairs;
};

template <int C>
__device__ __forceinline__ void store(long long* p, const uint32_t (&v)[C]) {
  if constexpr (C == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int e = 0; e < C; e += 2)
      reinterpret_cast<longlong2*>(p)[e / 2] = make_longlong2(v[e], v[e + 1]);
  }
}

// items = M * n / C; item -> (component m, first coefficient col); a row is
// n = C << row_shift coefficients
template <int L, int C>
__global__ void __launch_bounds__(kBehzThreads)
    behz_floor_convert_kernel(const uint32_t* __restrict__ xq, const uint32_t* __restrict__ xb,
                              long long* __restrict__ y, long long items, int row_shift,
                              const uint32_t* __restrict__ table) {
  using Lay = Layout<L>;
  constexpr int K = Lay::K, NB = Lay::NB;
  __shared__ __align__(16) uint32_t tab[Lay::kWords];
  for (int w = threadIdx.x; w < Lay::kWords; w += kBehzThreads) tab[w] = table[w];
  __syncthreads();
  const uint32_t* qp = tab;
  const uint32_t* bp = tab + L;
  const uint2* pr = reinterpret_cast<const uint2*>(tab + Lay::kPrimeWords);
  const uint32_t msk = bp[K - 1];
  const long long n = static_cast<long long>(C) << row_shift;
  const long long row_mask = (1LL << row_shift) - 1;

  for (long long it = static_cast<long long>(blockIdx.x) * kBehzThreads + threadIdx.x; it < items;
       it += static_cast<long long>(gridDim.x) * kBehzThreads) {
    const long long m = it >> row_shift, col = (it & row_mask) * C;
    uint32_t zq[L][C], zb[K][C];
#pragma unroll
    for (int i = 0; i < L; ++i) load<C>(xq + (m * L + i) * n + col, zq[i]);
#pragma unroll
    for (int k = 0; k < K; ++k) load<C>(xb + (m * K + k) * n + col, zb[k]);

    // z_i = x_i t qhat_i^-1 mod q_i, canonical
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t p = qp[i];
      const uint2 w = pr[Lay::kA + i];
#pragma unroll
      for (int e = 0; e < C; ++e) zq[i][e] = fold(lazy_mul(zq[i][e], w, p), p);
    }
    // z_k = x_k t q^-1 c_k - sum_i z_i (q/q_i) q^-1 c_k mod b_k, canonical
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t b = bp[k], b2 = 2 * b;
      uint32_t f[C];
#pragma unroll
      for (int e = 0; e < C; ++e) f[e] = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const uint2 v = pr[Lay::kV + i * K + k];
#pragma unroll
        for (int e = 0; e < C; ++e) f[e] = lazy_add(f[e], lazy_mul(zq[i][e], v, b), b2);
      }
      const uint2 u = pr[Lay::kU + k];
#pragma unroll
      for (int e = 0; e < C; ++e) zb[k][e] = lazy_sub(lazy_mul(zb[k][e], u, b), f[e], b);
    }
    // alpha = sum_j z_j (B/b_j) B^-1 - z_msk mod m_sk, then centred:
    // alpha_c = alpha - m_sk where alpha >= floor(m_sk / 2)
    uint32_t am[C];
    bool neg[C];
#pragma unroll
    for (int e = 0; e < C; ++e) am[e] = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint2 g = pr[Lay::kG + j];
#pragma unroll
      for (int e = 0; e < C; ++e) am[e] = lazy_add(am[e], lazy_mul(zb[j][e], g, msk), 2 * msk);
    }
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const uint32_t alpha = lazy_sub(am[e], zb[K - 1][e], msk);
      neg[e] = alpha >= (msk >> 1);
      am[e] = neg[e] ? msk - alpha : alpha;  // |alpha_c|
    }
    // y_i = sum_j z_j (B/b_j) - alpha_c B mod q_i: -alpha_c B is
    // |alpha_c| (B mod q_i) where alpha_c < 0, else |alpha_c| (-B mod q_i)
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t p = qp[i], p2 = 2 * p;
      const uint2 bq = pr[Lay::kBQ + i], nbq = pr[Lay::kNBQ + i];
      uint32_t acc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = lazy_mul(am[e], neg[e] ? bq : nbq, p);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint2 w = pr[Lay::kE + j * L + i];
#pragma unroll
        for (int e = 0; e < C; ++e) acc[e] = lazy_add(acc[e], lazy_mul(zb[j][e], w, p), p2);
      }
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = fold(acc[e], p);
      store<C>(y + (m * L + i) * n + col, acc);
    }
  }
}

template <int L, int C>
cudaError_t launch(const uint32_t* xq, const uint32_t* xb, long long* y, long long m, int n,
                   const uint32_t* table, int table_words, int blocks, cudaStream_t stream) {
  long long items;
  int row_shift;
  unsigned grid;
  if (table_words != Layout<L>::kWords ||
      !grid_shape<C>(m, n, blocks, &items, &row_shift, &grid))
    return cudaErrorInvalidValue;
  behz_floor_convert_kernel<L, C><<<grid, kBehzThreads, 0, stream>>>(xq, xb, y, items,
                                                                       row_shift, table);
  return cudaGetLastError();
}

}  // namespace

// The persistent grid's size for L q primes on the current device, computed
// once per device by core/behz_kernel.py:DeviceBehzTable.
extern "C" int fhetpu_behz_floor_convert_blocks(int L, int* blocks) {
  cudaError_t e;
  switch (L) {
    case 2: e = resident_blocks(behz_floor_convert_kernel<2, 4>, blocks); break;
    case 4: e = resident_blocks(behz_floor_convert_kernel<4, 4>, blocks); break;
    case 8: e = resident_blocks(behz_floor_convert_kernel<8, 2>, blocks); break;
    case 15: e = resident_blocks(behz_floor_convert_kernel<15, 1>, blocks); break;
    case 16: e = resident_blocks(behz_floor_convert_kernel<16, 1>, blocks); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// xq: uint32 [m, L, n], xb: uint32 [m, L + 2, n] (canonical residues, 16-byte
// aligned), y: int64 [m, L, n]; table: uint32 [table_words],
// core/behz_kernel.py:pack_table; blocks: fhetpu_behz_floor_convert_blocks.
// L is one of 2, 4, 8, 15, 16 (the chooser's chains at n = 2048..16384, SEAL
// and native), with C = 4, 4, 2, 1, 1 coefficients a thread; every prime
// < 2^30; n a power of two.
extern "C" int fhetpu_behz_floor_convert(const uint32_t* xq, const uint32_t* xb, long long* y,
                                         long long m, int L, int K, int n, const uint32_t* table,
                                         int table_words, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K != L + 2 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (L) {
    case 2: e = launch<2, 4>(xq, xb, y, m, n, table, table_words, blocks, s); break;
    case 4: e = launch<4, 4>(xq, xb, y, m, n, table, table_words, blocks, s); break;
    case 8: e = launch<8, 2>(xq, xb, y, m, n, table, table_words, blocks, s); break;
    case 15: e = launch<15, 1>(xq, xb, y, m, n, table, table_words, blocks, s); break;
    case 16: e = launch<16, 1>(xq, xb, y, m, n, table, table_words, blocks, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
