// BEHZ's exact base extension q -> Bsk with the m~ = 2^16 Montgomery
// correction (step 1 of the ct x ct multiply), in one pass over a
// ciphertext's uint32 residues.
//
// Replaces no TPU kernel: fhetpu computes this step as XLA ops
// (fhetpu/bfv/rns.py: RnsTool.extend_q_to_bsk).  On a CPU tensor the port
// keeps the torch steps of fhetpu_torch/bfv/rns.py, and they are this
// kernel's oracle: the output is bit-equal, the centring of r included.
//
// For each (component, coefficient) it reads L residues mod q_i and writes
// K = L + 2 residues mod Bsk = {b_0..b_L, m_sk} as uint32, which the
// forward NTT on Bsk takes as they are:
//   z_i = x_i * m~ * qhat_i^-1                                mod q_i
//   r   = -(sum_i z_i (q/q_i)) * q^-1                         mod m~
//   y_k = sum_i z_i (q/q_i) m~^-1 + r_c q m~^-1               mod b_k
// r_c is r centred as the torch code centres it: r - m~ where r >= m~/2.
// Folding m~, qhat_i^-1, m~^-1 and -q^-1 into the tables
// (core/behz_kernel.py:extend_parts) leaves L + L K + K products a
// coefficient; each fold is an identity mod the prime (mod m~ for r), so
// the residues match.
//
// What bounds it on an H100: bytes.  Per coefficient it reads 4L bytes and
// writes 4K (40 B at L = 4) against 34 Shoup products and L plain
// multiply-adds.  Design (the lazy arithmetic and the persistent grid are
// behz.cuh's, shared with behz_floor_convert.cu):
// * Every multiplier mod a prime is a table constant with its Shoup
//   companion; sums are lazy in [0, 2p), canonical once at their end.
// * r is a plain uint32 multiply-add chain: modulo 2^32 it keeps the low 16
//   bits exact, so one mask ends it.  |r_c| <= 2^15 then multiplies
//   q m~^-1 mod b_k, or -q m~^-1 mod b_k where r_c < 0, so nothing leaves
//   32 bits.
// * A thread takes C consecutive coefficients of one component (C = 4 at
//   L <= 4, 2 at L = 8, 1 above), so each row is one 16-, 8- or 4-byte load
//   or store, a warp's are contiguous, each table constant loaded from
//   shared memory serves C coefficients, and a thread holds (L + 2) C
//   residues: the z's, then one output row at a time.
// * The table (L + K primes, then (w, w_shoup) pairs) is copied into shared
//   memory once per block; a warp reads one address at a time (broadcast).
//   Persistent blocks, one wave, walk the (component, coefficient) items in
//   a grid stride, so any M * n fits in the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "behz.cuh"

namespace {

// The table's layout for L q primes (core/behz_kernel.py:extend_parts holds
// the same order): L + K primes, then (w, w_shoup) pairs.
template <int L>
struct ExtendLayout {
  static constexpr int K = L + 2;
  static constexpr int kA = 0;               // [L]     m~ qhat_i^-1 mod q_i
  static constexpr int kV = kA + L;          // [L][K]  (q/q_i) m~^-1 mod b_k
  static constexpr int kQM = kV + L * K;     // [K]     q m~^-1 mod b_k
  static constexpr int kNQM = kQM + K;       // [K]     -q m~^-1 mod b_k
  static constexpr int kR = kNQM + K;        // [L]     -(q/q_i) q^-1 mod m~ (w only)
  static constexpr int kPairs = kR + L;
  static constexpr int kPrimeWords = L + K;  // even: the pairs stay 8-byte aligned
  static constexpr int kWords = kPrimeWords + 2 * kPairs;
};

constexpr uint32_t kMTilde = 1u << 16;

// items = M * n / C; item -> (component m, first coefficient col); a row is
// n = C << row_shift coefficients
template <int L, int C>
__global__ void __launch_bounds__(kBehzThreads)
    behz_extend_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                       long long items, int row_shift, const uint32_t* __restrict__ table) {
  using Lay = ExtendLayout<L>;
  constexpr int K = Lay::K;
  __shared__ __align__(16) uint32_t tab[Lay::kWords];
  for (int w = threadIdx.x; w < Lay::kWords; w += kBehzThreads) tab[w] = table[w];
  __syncthreads();
  const uint32_t* qp = tab;
  const uint32_t* bp = tab + L;
  const uint2* pr = reinterpret_cast<const uint2*>(tab + Lay::kPrimeWords);
  const long long n = static_cast<long long>(C) << row_shift;
  const long long row_mask = (1LL << row_shift) - 1;

  for (long long it = static_cast<long long>(blockIdx.x) * kBehzThreads + threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * kBehzThreads) {
    const long long m = it >> row_shift, col = (it & row_mask) * C;
    uint32_t z[L][C];
#pragma unroll
    for (int i = 0; i < L; ++i) load<C>(x + (m * L + i) * n + col, z[i]);

    // z_i = x_i m~ qhat_i^-1 mod q_i, canonical
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t p = qp[i];
      const uint2 w = pr[Lay::kA + i];
#pragma unroll
      for (int e = 0; e < C; ++e) z[i][e] = fold(lazy_mul(z[i][e], w, p), p);
    }
    // r = sum_i z_i (-(q/q_i) q^-1) mod m~, centred: r_c = r - m~ where
    // r >= m~/2; keep |r_c| and its sign
    uint32_t r[C];
    bool neg[C];
#pragma unroll
    for (int e = 0; e < C; ++e) r[e] = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const uint32_t w = pr[Lay::kR + i].x;
#pragma unroll
      for (int e = 0; e < C; ++e) r[e] += z[i][e] * w;
    }
#pragma unroll
    for (int e = 0; e < C; ++e) {
      r[e] &= kMTilde - 1;
      neg[e] = r[e] >= kMTilde / 2;
      r[e] = neg[e] ? kMTilde - r[e] : r[e];
    }
    // y_k = r_c q m~^-1 + sum_i z_i (q/q_i) m~^-1 mod b_k, canonical
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t b = bp[k], b2 = 2 * b;
      const uint2 qm = pr[Lay::kQM + k], nqm = pr[Lay::kNQM + k];
      uint32_t acc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = lazy_mul(r[e], neg[e] ? nqm : qm, b);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const uint2 v = pr[Lay::kV + i * K + k];
#pragma unroll
        for (int e = 0; e < C; ++e) acc[e] = lazy_add(acc[e], lazy_mul(z[i][e], v, b), b2);
      }
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = fold(acc[e], b);
      store<C>(y + (m * K + k) * n + col, acc);
    }
  }
}

template <int L, int C>
cudaError_t launch(const uint32_t* x, uint32_t* y, long long m, int n, const uint32_t* table,
                   int table_words, int blocks, cudaStream_t stream) {
  long long items;
  int row_shift;
  unsigned grid;
  if (table_words != ExtendLayout<L>::kWords ||
      !grid_shape<C>(m, n, blocks, &items, &row_shift, &grid))
    return cudaErrorInvalidValue;
  behz_extend_kernel<L, C><<<grid, kBehzThreads, 0, stream>>>(x, y, items, row_shift, table);
  return cudaGetLastError();
}

}  // namespace

// The persistent grid's size for L q primes on the current device, computed
// once per device by core/behz_kernel.py:DeviceBehzTable.
extern "C" int fhetpu_behz_extend_blocks(int L, int* blocks) {
  cudaError_t e;
  switch (L) {
    case 2: e = resident_blocks(behz_extend_kernel<2, 4>, blocks); break;
    case 4: e = resident_blocks(behz_extend_kernel<4, 4>, blocks); break;
    case 8: e = resident_blocks(behz_extend_kernel<8, 2>, blocks); break;
    case 15: e = resident_blocks(behz_extend_kernel<15, 1>, blocks); break;
    case 16: e = resident_blocks(behz_extend_kernel<16, 1>, blocks); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// x: uint32 [m, L, n] (residues below 2^32, 16-byte aligned), y: uint32
// [m, L + 2, n]; table: uint32 [table_words], core/behz_kernel.py:
// pack_extend_table; blocks: fhetpu_behz_extend_blocks.  L is one of 2, 4,
// 8, 15, 16 (the chooser's chains at n = 2048..16384, SEAL and native), with
// C = 4, 4, 2, 1, 1 coefficients a thread; every prime < 2^30; n a power of
// two.
extern "C" int fhetpu_behz_extend(const uint32_t* x, uint32_t* y, long long m, int L, int K,
                                  int n, const uint32_t* table, int table_words, int blocks,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K != L + 2 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (L) {
    case 2: e = launch<2, 4>(x, y, m, n, table, table_words, blocks, s); break;
    case 4: e = launch<4, 4>(x, y, m, n, table, table_words, blocks, s); break;
    case 8: e = launch<8, 2>(x, y, m, n, table, table_words, blocks, s); break;
    case 15: e = launch<15, 1>(x, y, m, n, table, table_words, blocks, s); break;
    case 16: e = launch<16, 1>(x, y, m, n, table, table_words, blocks, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
