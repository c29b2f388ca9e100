// BEHZ's tensor product in the NTT domain (step 2 of the ct x ct multiply),
// in one pass over both operands' uint32 residues on q and Bsk.
//
// Replaces no TPU kernel: fhetpu computes this step as XLA ops
// (fhetpu/bfv/rns.py:279, in multiply).  On a CPU tensor the port keeps
// the torch loop of fhetpu_torch/bfv/rns.py (tensor_product), and it is
// this kernel's oracle: the output is bit-equal.
//
// For operands a [..., k1, rows, n] and b [..., k2, rows, n] in NTT form,
// on q (rows = L) and on Bsk = {b_0..b_L, m_sk} (rows = K = L + 2), it
// writes the canonical residues
//   out[..., r, l, j] = sum_{i + i' = r} a[..., i, l, j] b[..., i', l, j]  mod p_l
// for r < k1 + k2 - 1, as uint32 [B, k1 + k2 - 1, rows, n] on each base,
// the layout the inverse NTT takes.  The batch axes broadcast: each operand
// is read through its own strides, 0 along an axis it does not span, so a
// fract ciphertext met by a whole grid is never copied out.
//
// What bounds it on an H100: bytes.  Per (component, coefficient) position
// it reads or writes 4 (L + K) bytes, 40 B at L = 4, against at most
// min(k1, k2) products an output residue.  Design (the row loads and
// stores and the persistent grid are behz.cuh's):
// * A thread owns C = 4 consecutive coefficients of one (batch, prime)
//   row, loads the k1 + k2 input components of that row once, each as one
//   16-byte load (a squared operand once), then forms every output
//   component from registers and stores it with one 16-byte store.  Unlike
//   its sibling kernels, whose threads hold every prime's residues, a
//   thread here holds one prime's, so C does not shrink with L (C = 2 at
//   L = 8 ran a bicubic image's 75 products 15 % slower on an H100).  Up
//   to kRegK components an operand the rows stay in registers (fully
//   unrolled; k1 and k2 are uniform, so their guards do not diverge);
//   larger operands take a loop that reloads its rows through the caches.
// * Products are exact: 32 x 32 -> 64-bit, summed in uint64 and reduced
//   once by Barrett.  Overflow: every prime is below 2^30 and each sum has
//   at most min(k1, k2) terms of at most (p - 1)^2 < 2^60, which the
//   wrapper holds below 2^64 (core/behz_kernel.py:check_limits, at most 16
//   terms).
// * Barrett at an odd p < 2^30: with m = floor(2^64 / p), x m / 2^64 >
//   x / p - 1 for x < 2^64, so h = mulhi64(x, m) satisfies x / p - 2 < h <=
//   x / p and x - h p lies in [0, 2p), below 2^32: its low words suffice,
//   and one fold makes it canonical.
// * A thread walks kGroup consecutive batch entries of its prime row and
//   coefficients: it divides out the first entry's place in each operand
//   once and steps to the next by adding strides, and keeps an operand's
//   rows while its entry repeats (a fract broadcast along the innermost
//   axis is loaded once a run).  Items run group-major, then prime row,
//   then coefficients, so a warp's loads and stores are contiguous and a
//   warp shares its entries, base and prime: every branch on them is
//   uniform.
//   The table (the L + K primes, then each one's m as two words) is copied
//   into shared memory once per block.  Persistent blocks, one wave, walk
//   the items in a grid stride, so any batch fits in the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "behz.cuh"

namespace {

constexpr int kMaxDims = 6;  // core/behz_kernel.py:TENSOR_MAX_DIMS
constexpr int kRegK = 8;     // an operand's components held in registers
constexpr int kC = 4;        // coefficients a thread
constexpr int kGroup = 8;    // consecutive batch entries a thread

// The broadcast batch: its axes, innermost first, and each operand's
// stride along them in its own batch entries, 0 where it is broadcast
struct Batch {
  int dims;
  unsigned size[kMaxDims];
  long long sa[kMaxDims], sb[kMaxDims];
};

struct Operands {
  const uint32_t* aq;  // [.., k1, L, n]
  const uint32_t* ab;  // [.., k1, K, n]
  const uint32_t* bq;  // [.., k2, L, n]
  const uint32_t* bb;  // [.., k2, K, n]
  uint32_t* oq;        // [B, k1 + k2 - 1, L, n]
  uint32_t* ob;        // [B, k1 + k2 - 1, K, n]
  int k1, k2;
};

// x mod p, canonical, for any x < 2^64 and odd p < 2^30; m = floor(2^64 / p)
__device__ __forceinline__ uint32_t barrett(unsigned long long x, uint32_t p,
                                            unsigned long long m) {
  return fold(static_cast<uint32_t>(x) - static_cast<uint32_t>(__umul64hi(x, m)) * p, p);
}

template <int C>
__device__ __forceinline__ void mul_add(unsigned long long (&acc)[C], const uint32_t (&x)[C],
                                        const uint32_t (&y)[C]) {
#pragma unroll
  for (int e = 0; e < C; ++e) acc[e] += static_cast<unsigned long long>(x[e]) * y[e];
}

// items = ceil(B / kGroup) (L + K) n / C; item -> (group of kGroup batch
// entries, prime row, first coefficient col); a row is n = C << row_shift
// coefficients.  KR > 0 holds both operands' rows in registers (k1, k2 <=
// KR) and keeps an operand's rows while its batch entry stays the same;
// KR = 0 reloads them.
template <int L, int KR, int C = kC>
__global__ void __launch_bounds__(kBehzThreads)
    behz_tensor_kernel(Operands o, Batch bt, unsigned batch, long long items, int row_shift,
                       const uint32_t* __restrict__ table, bool square) {
  constexpr int K = L + 2, R = L + K;
  __shared__ __align__(16) uint32_t tab[3 * R];
  for (int w = threadIdx.x; w < 3 * R; w += kBehzThreads) tab[w] = table[w];
  __syncthreads();
  const unsigned long long* mu = reinterpret_cast<const unsigned long long*>(tab + R);
  const long long n = static_cast<long long>(C) << row_shift;
  const long long row_mask = (1LL << row_shift) - 1;
  const int k1 = o.k1, k2 = o.k2, kout = k1 + k2 - 1;

  for (long long it = static_cast<long long>(blockIdx.x) * kBehzThreads + threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * kBehzThreads) {
    const long long col = (it & row_mask) * C;
    const unsigned rest = static_cast<unsigned>(it >> row_shift);
    const int row = rest % R;
    const unsigned b0 = rest / R * kGroup, b1 = min(b0 + kGroup, batch);
    // the operands' batch entries under output entry b0, and its index
    unsigned idx[kMaxDims];
    long long ea = 0, eb = 0;
    unsigned left = b0;
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d < bt.dims) {
        idx[d] = left % bt.size[d];
        left /= bt.size[d];
        ea += idx[d] * bt.sa[d];
        eb += idx[d] * bt.sb[d];
      }
    }
    const bool on_q = row < L;
    const int rows = on_q ? L : K, rr = on_q ? row : row - L;
    const long long step = rows * n;  // one component
    const uint32_t* pa = (on_q ? o.aq : o.ab) + rr * n + col;
    const uint32_t* pb = (on_q ? o.bq : o.bb) + rr * n + col;
    uint32_t* po = (on_q ? o.oq : o.ob) + static_cast<long long>(b0) * kout * step + rr * n + col;
    const uint32_t p = tab[row];
    const unsigned long long m = mu[row];
    uint32_t x[KR > 0 ? KR : 1][C], y[KR > 0 ? KR : 1][C];
    long long held_a = -1, held_b = -1;  // the batch entries x and y hold

    for (unsigned bi = b0; bi < b1; ++bi, po += kout * step) {
      if (bi > b0) {  // the next entry: step the index, carrying outwards
#pragma unroll
        for (int d = 0; d < kMaxDims; ++d) {
          if (d < bt.dims) {
            ea += bt.sa[d];
            eb += bt.sb[d];
            if (++idx[d] < bt.size[d]) break;
            idx[d] = 0;
            ea -= bt.sa[d] * bt.size[d];
            eb -= bt.sb[d] * bt.size[d];
          }
        }
      }
      if constexpr (KR > 0) {
        if (ea != held_a) {  // uniform: a warp shares its group and row
#pragma unroll
          for (int i = 0; i < KR; ++i)
            if (i < k1) load<C>(pa + (ea * k1 + i) * step, x[i]);
          held_a = ea;
          if (square) {
#pragma unroll
            for (int i = 0; i < KR; ++i)
#pragma unroll
              for (int e = 0; e < C; ++e) y[i][e] = x[i][e];
          }
        }
        if (!square && eb != held_b) {
#pragma unroll
          for (int i = 0; i < KR; ++i)
            if (i < k2) load<C>(pb + (eb * k2 + i) * step, y[i]);
          held_b = eb;
        }
#pragma unroll
        for (int r = 0; r < 2 * KR - 1; ++r) {
          if (r < kout) {
            unsigned long long acc[C];
#pragma unroll
            for (int e = 0; e < C; ++e) acc[e] = 0;
#pragma unroll
            for (int i = 0; i < KR; ++i) {
              const int j = r - i;
              if (j >= 0 && j < KR && i < k1 && j < k2) mul_add<C>(acc, x[i], y[j]);
            }
            uint32_t v[C];
#pragma unroll
            for (int e = 0; e < C; ++e) v[e] = barrett(acc[e], p, m);
            store<C>(po + r * step, v);
          }
        }
      } else {
        for (int r = 0; r < kout; ++r) {
          unsigned long long acc[C];
#pragma unroll
          for (int e = 0; e < C; ++e) acc[e] = 0;
          const int hi = r < k1 ? r : k1 - 1;
          for (int i = r < k2 ? 0 : r - k2 + 1; i <= hi; ++i) {
            load<C>(pa + (ea * k1 + i) * step, x[0]);
            load<C>(pb + (eb * k2 + r - i) * step, y[0]);
            mul_add<C>(acc, x[0], y[0]);
          }
          uint32_t v[C];
#pragma unroll
          for (int e = 0; e < C; ++e) v[e] = barrett(acc[e], p, m);
          store<C>(po + r * step, v);
        }
      }
    }
  }
}

template <int L, int KR>
cudaError_t launch(const Operands& o, const Batch& bt, long long batch, int n,
                   const uint32_t* table, int table_words, int blocks, bool square,
                   cudaStream_t stream) {
  long long items;
  int row_shift;
  unsigned grid;
  const long long groups = (batch + kGroup - 1) / kGroup;
  if (table_words != 3 * (2 * L + 2) ||
      !grid_shape<kC>(groups * (2 * L + 2), n, blocks, &items, &row_shift, &grid))
    return cudaErrorInvalidValue;
  behz_tensor_kernel<L, KR><<<grid, kBehzThreads, 0, stream>>>(
      o, bt, static_cast<unsigned>(batch), items, row_shift, table, square);
  return cudaGetLastError();
}

template <int L>
cudaError_t dispatch(const Operands& o, const Batch& bt, long long batch, int n,
                     const uint32_t* table, int table_words, int blocks, bool square,
                     cudaStream_t stream) {
  if (o.k1 <= kRegK && o.k2 <= kRegK)
    return launch<L, kRegK>(o, bt, batch, n, table, table_words, blocks, square, stream);
  return launch<L, 0>(o, bt, batch, n, table, table_words, blocks, square, stream);
}

}  // namespace

// The persistent grid's size for L q primes on the current device (the
// register kernel's, which the reloading one, with fewer registers, also
// fits), computed once per device by core/behz_kernel.py:DeviceBehzTable.
extern "C" int fhetpu_behz_tensor_blocks(int L, int* blocks) {
  cudaError_t e;
  switch (L) {
    case 2: e = resident_blocks(behz_tensor_kernel<2, kRegK>, blocks); break;
    case 4: e = resident_blocks(behz_tensor_kernel<4, kRegK>, blocks); break;
    case 8: e = resident_blocks(behz_tensor_kernel<8, kRegK>, blocks); break;
    case 15: e = resident_blocks(behz_tensor_kernel<15, kRegK>, blocks); break;
    case 16: e = resident_blocks(behz_tensor_kernel<16, kRegK>, blocks); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// aq, ab: uint32 [.., k1, L, n] and [.., k1, L + 2, n], bq, bb: [.., k2, ..]
// likewise, canonical residues, contiguous and 16-byte aligned; oq, ob:
// uint32 [B, k1 + k2 - 1, L, n] and [.., L + 2, n].  The batch: `dims` axes
// (at most kMaxDims), innermost first, of sizes[d] entries, where operand a
// steps sa[d] of its batch entries and b sb[d] (host arrays; 0 where an
// operand is broadcast); B = prod(sizes).  square: b is a, read once.
// table: uint32 [table_words], core/behz_kernel.py:tensor_words; blocks:
// fhetpu_behz_tensor_blocks.  L is one of 2, 4, 8, 15, 16; every prime odd
// and < 2^30, min(k1, k2) terms a sum below 2^64; n a power of two >= 4.
extern "C" int fhetpu_behz_tensor(const uint32_t* aq, const uint32_t* ab, const uint32_t* bq,
                                  const uint32_t* bb, uint32_t* oq, uint32_t* ob, int k1, int k2,
                                  int square, int dims, const int* sizes, const long long* sa,
                                  const long long* sb, int L, int K, int n,
                                  const uint32_t* table, int table_words, int blocks,
                                  void* stream) {
  if (K != L + 2 || k1 < 1 || k2 < 1 || dims < 0 || dims > kMaxDims)
    return static_cast<int>(cudaErrorInvalidValue);
  Batch bt = {};
  bt.dims = dims;
  long long batch = 1;
  for (int d = 0; d < dims; ++d) {
    if (sizes[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    bt.size[d] = static_cast<unsigned>(sizes[d]);
    bt.sa[d] = sa[d];
    bt.sb[d] = sb[d];
    batch *= sizes[d];
    if (batch * (L + K) >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands o = {aq, ab, bq, bb, oq, ob, k1, k2};
  const bool sq = square != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (L) {
    case 2: e = dispatch<2>(o, bt, batch, n, table, table_words, blocks, sq, s); break;
    case 4: e = dispatch<4>(o, bt, batch, n, table, table_words, blocks, sq, s); break;
    case 8: e = dispatch<8>(o, bt, batch, n, table, table_words, blocks, sq, s); break;
    case 15: e = dispatch<15>(o, bt, batch, n, table, table_words, blocks, sq, s); break;
    case 16: e = dispatch<16>(o, bt, batch, n, table, table_words, blocks, sq, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
