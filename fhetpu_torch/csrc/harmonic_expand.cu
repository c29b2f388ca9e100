// The harmonic decode server's expansion: every output position's weighted
// sum of the channel's encrypted harmonics, in NTT form.
//
// Replaces no TPU kernel: fhetpu leaves this loop to XLA as a jitted
// fori_loop (fhetpu/pipelines/rle_decode.py: expand_harmonics_batched).
// On a CPU tensor the port keeps its plain torch loop
// (fhetpu_torch/pipelines/rle_decode.py: expand_harmonics_plain), and it is
// this kernel's oracle: the output is bit-equal.
//
// For every position p, component s and column c = l n + j (prime l, NTT
// slot j) it writes the canonical residue
//   out[p, s, c] = sum_k W[k, p, c] * h[k, s, c]   mod q_l
// from the weight tables W, uint32 [H, P, L n], and the harmonics' NTTs h,
// uint32 [H, S, L n]; out is uint32 [P, S, L n].
//
// What bounds it on an H100: bytes.  At the decode server's shape (H = 25,
// P = 2304, S = 2, L = 2, n = 2048) it reads 943.7 MB of tables, 0.8 MB of
// harmonics and writes 75.5 MB: 0.3045 ms at 3.35 TB/s, against 0.47 G
// products, one 32 x 32 -> 64-bit multiply-add each.  Design:
// * A thread owns four adjacent columns of one prime and walks positions,
//   so every table word is loaded exactly once, as part of one 16-byte
//   load; a warp's load covers 512 contiguous bytes, and the tables stream
//   past the caches (__ldcs).  A thread issues kChunk independent 16-byte
//   loads before it multiplies.  (One column a thread, 4-byte loads, ran at
//   70-72 % of the bound on an H100; this layout at 83 %.)
// * A block is kRows rows of kCols threads over the same 4 kCols columns;
//   the rows take alternate positions.  The block copies its columns' H S
//   harmonic residues once into shared memory (row r at hs[r kCols + x]:
//   conflict-free 16-byte reads) and every row reuses them at every
//   position it covers, so the copy costs half the shared memory a thread.
// * Products are exact: 64-bit multiply-adds into uint64 sums, folded by
//   Barrett into [0, 2q) after every kChunk terms, made canonical once at
//   the end.  Overflow: the wrapper accepts only q < 2^30, so a product is
//   at most (q - 1)^2 < 2^60 - 2^31, and a sum starts at 0 or a fold's
//   value below 2q < 2^31; after kChunk = 16 terms it is below
//   2^31 + 16 (2^60 - 2^31) < 2^64, at any H.
// * Barrett at odd q < 2^30: with m = floor(2^64 / q), x m / 2^64 > x / q - 1
//   for x < 2^64, so qh = mulhi64(x, m) satisfies x / q - 2 < qh <= x / q
//   and x - qh q lies in [0, 2q), below 2^32: its low words suffice.
// * The grid comes from the shape: blockIdx.x covers 4 kCols columns (the
//   ragged last block masked), blockIdx.y strides over positions, and
//   gridDim.y fills one wave of resident blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // threads along the columns, 4 columns each
constexpr int kRows = 2;    // threads along the positions
constexpr int kChunk = 16;  // core/expand_kernel.py:CHUNK
constexpr int kMaxL = 16;   // core/expand_kernel.py:MAX_L

struct Primes {
  uint32_t q[kMaxL];
  unsigned long long m[kMaxL];  // floor(2^64 / q)
};

// x mod q in [0, 2q), for any x < 2^64 and odd q < 2^30
__device__ __forceinline__ uint32_t barrett_lazy(unsigned long long x, uint32_t q,
                                                 unsigned long long m) {
  return static_cast<uint32_t>(x) - static_cast<uint32_t>(__umul64hi(x, m)) * q;
}

__device__ __forceinline__ void mul_add(unsigned long long (&acc)[4], uint4 x, uint4 h) {
  acc[0] += static_cast<unsigned long long>(x.x) * h.x;
  acc[1] += static_cast<unsigned long long>(x.y) * h.y;
  acc[2] += static_cast<unsigned long long>(x.z) * h.z;
  acc[3] += static_cast<unsigned long long>(x.w) * h.w;
}

// a fold's value in [0, 2q) -> [0, q)
__device__ __forceinline__ uint32_t canonical(unsigned long long a, uint32_t q) {
  const uint32_t r = static_cast<uint32_t>(a);
  return r >= q ? r - q : r;
}

// w, h, out as [rows][vcols] uint4: four columns a word
template <int S>
__global__ void __launch_bounds__(kCols * kRows)
    harmonic_expand_kernel(const uint4* __restrict__ w, const uint4* __restrict__ h,
                           uint4* __restrict__ out, int H, int P, int vcols, int log_n,
                           Primes primes) {
  extern __shared__ uint4 hs[];  // [H * S][kCols]
  const int x = threadIdx.x, y = threadIdx.y;
  const int vc = blockIdx.x * kCols + x;
  const bool live = vc < vcols;
  if (live)
    for (int r = y; r < H * S; r += kRows)
      hs[r * kCols + x] = __ldg(h + static_cast<long long>(r) * vcols + vc);
  __syncthreads();
  if (!live) return;
  const int l = (vc * 4) >> log_n;
  const uint32_t q = primes.q[l];
  const unsigned long long m = primes.m[l];

  const long long plane = static_cast<long long>(P) * vcols;  // one harmonic's table
  for (int p = blockIdx.y * kRows + y; p < P; p += gridDim.y * kRows) {
    const uint4* wp = w + static_cast<long long>(p) * vcols + vc;
    unsigned long long acc[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0;
    for (int k0 = 0; k0 < H; k0 += kChunk) {
      uint4 t[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        t[i] = k0 + i < H ? __ldcs(wp + (k0 + i) * plane) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (k0 + i < H) {
          const uint4* hk = hs + (k0 + i) * S * kCols + x;
#pragma unroll
          for (int s = 0; s < S; ++s) mul_add(acc[s], t[i], hk[s * kCols]);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][e] = barrett_lazy(acc[s][e], q, m);
    }
    uint4* op = out + static_cast<long long>(p) * S * vcols + vc;
#pragma unroll
    for (int s = 0; s < S; ++s)
      op[s * vcols] = make_uint4(canonical(acc[s][0], q), canonical(acc[s][1], q),
                                 canonical(acc[s][2], q), canonical(acc[s][3], q));
  }
}

template <int S>
cudaError_t launch(const uint32_t* w, const uint32_t* h, uint32_t* out, int H, int P, int vcols,
                   int log_n, const Primes& primes, cudaStream_t stream) {
  const auto kern = harmonic_expand_kernel<S>;
  const size_t smem = static_cast<size_t>(H) * S * kCols * sizeof(uint4);
  int dev, sms, per_sm;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kCols * kRows,
                                                         smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long gx = (vcols + kCols - 1) / kCols;
  long long gy = (static_cast<long long>(sms) * per_sm + gx - 1) / gx;
  if (gy > (P + kRows - 1) / kRows) gy = (P + kRows - 1) / kRows;
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), dim3(kCols, kRows), smem,
         stream>>>(reinterpret_cast<const uint4*>(w), reinterpret_cast<const uint4*>(h),
                   reinterpret_cast<uint4*>(out), H, P, vcols, log_n, primes);
  return cudaGetLastError();
}

}  // namespace

// w: uint32 [H, P, L, n], h: uint32 [H, S, L, n], out: uint32 [P, S, L, n],
// all contiguous and 16-byte aligned on the current device; primes: the L
// primes (host memory), odd and < 2^30; L <= 16, S 2 or 3, n a power of two
// >= 4, H * S * 512 bytes of shared memory at most what a block may take.
extern "C" int fhetpu_harmonic_expand(const uint32_t* w, const uint32_t* h, uint32_t* out, int H,
                                      int P, int S, int L, int n, const uint32_t* primes,
                                      void* stream) {
  if (H < 1 || P < 1 || L < 1 || L > kMaxL || n < 4 || (n & (n - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Primes pr = {};
  for (int l = 0; l < L; ++l) {
    if (primes[l] < 3 || primes[l] >= (1u << 30) || !(primes[l] & 1))
      return static_cast<int>(cudaErrorInvalidValue);
    pr.q[l] = primes[l];
    pr.m[l] = ~0ull / primes[l];  // floor(2^64 / q), q odd
  }
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int vcols = L * n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (S) {
    case 2: e = launch<2>(w, h, out, H, P, vcols, log_n, pr, s); break;
    case 3: e = launch<3>(w, h, out, H, P, vcols, log_n, pr, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
