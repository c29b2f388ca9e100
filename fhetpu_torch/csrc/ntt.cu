// Negacyclic NTT and inverse NTT over RNS limbs for Hopper: register
// rounds, lazy Harvey butterflies, and each CTA's next polynomial copied in
// while the current one is transformed.
//
// Replaces the Pallas kernel fhetpu/core/pallas_ntt.py:_kernel (forward=True
// and forward=False), built by make_ntt and dispatched from
// fhetpu/core/ntt.py:ntt/intt.
//
// Computes exactly what fhetpu/core/ntt.py:_ntt_impl/_intt_impl compute:
//   forward: Cooley-Tukey, natural order in, bit-reversed out; the stage on
//     index bit b (t = 2^b) pairs u = i*2t + j with v = u + t and twiddle
//     psi_br[m + i], m = n / 2t;
//   inverse: Gentleman-Sande, bit-reversed in, natural out; the same pairs
//     with twiddle ipsi_br[h + i], h = n / 2t, then x n^-1.
// Intermediates are lazy, but the residue is unique, so the canonical output
// is bit-identical to the host and TPU transforms.
//
// What bounds it on an H100: bytes.  At n = 4096 and a 64-block chunk
// (98,304 polynomials of 16 KB) it must read and write 1.61 GB each, 0.962 ms
// at 3.35 TB/s; the fewest integer operations (the lazy butterfly of 7 below)
// take 0.55 ms.  So the design keeps HBM busy and the instruction count low:
//
// * Register rounds.  A thread holds 16 coefficients, those whose index bits
//   lo..lo+3 vary (n/16 threads per polynomial), and runs up to four stages
//   on them in registers with no barrier.  log2(n) stages take 3 rounds at
//   n = 2048/4096 and 4 at 8192/16384, with one exchange through shared
//   memory between rounds (ntt_kernel.py:kernel_rounds holds the same plan).
// * No bank conflicts.  The shared copy of a polynomial is XOR-swizzled on
//   its 16-byte chunk bits (swz): every round's 4-byte accesses hit 32
//   banks per warp, and the 16-byte accesses of the round at bit 0 hit 8
//   bank groups per quarter warp (tests/test_torch_ntt_schedule.py checks
//   both for every round at every n).
// * Copies overlapped with compute.  Persistent CTAs, each on one limb, walk
//   the polynomials of their limb through a ring of kRing = 2 polynomials in
//   shared memory: while one is transformed, the 16-byte cp.async copies of
//   the next are in flight.  A CTA keeps 4n bytes in flight, and an SM holds
//   1024 threads (fhetpu_ntt_occupancy reports the shape; phase 1 of
//   chip_smoke.py prints it): 64 KB in flight per SM at every n, above the
//   25 KB that Little's law asks at 3.35 TB/s and 1 us.
//   The last round puts its results back in shared memory, and the CTA
//   stores the polynomial as 16-byte vectors, a warp 512 contiguous bytes at
//   a time.
// * Lazy Harvey butterflies (needs p < 2^30; the wrapper refuses others).
//   Forward values stay in [0, 4p): X -= 2p if X >= 2p, T = lazy W*Y in
//   [0, 2p), then X + T and X - T + 2p.  Inverse values stay in [0, 2p):
//   X + Y reduced to [0, 2p), lazy W*(X - Y + 2p).  Both are made canonical
//   once, when stored.
// * n^-1 folded into the inverse's last stage: its outputs are lazy
//   products by n^-1 and by ipsi_br[1]*n^-1, so no extra pass.
// * Twiddles read once per round.  The host lays each round's twiddles out
//   as 32-word records (16 twiddles, 16 Shoup companions) in the order the
//   thread uses them (ntt_kernel.py:kernel_twiddles); a thread reads its
//   record with eight 16-byte loads, each just before the stage that needs
//   it.  The rounds above bit 5 share one record per warp; in the others a
//   warp's load reads 32 consecutive vectors, since the host stores vector c
//   of all records of a round together.
//
// At n = 16384 the ring is 128 KB, above the 48 KB a kernel gets without
// opting in, so the launcher raises the dynamic shared-memory limit first
// and returns any error instead of launching blind.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modarith.cuh"

namespace {

// Polynomials in a CTA's ring: one transformed, kRing - 1 copies in flight.
// A third slot gained nothing at n = 4096 and cost 5-10 % at 2048 and 8192
// (PERF.md, measured on an H100), so the ring holds two.
constexpr int kRing = 2;

// ----- the round plan (ntt_kernel.py:kernel_rounds, top round first) -----

__host__ __device__ constexpr int rounds_of(int logn) { return (logn + 3) / 4; }

__host__ __device__ constexpr int act_count(int logn, int r) {
  return logn / rounds_of(logn) + (r < logn % rounds_of(logn) ? 1 : 0);
}

// highest and lowest index bit whose stage round r runs
__host__ __device__ constexpr int act_hi(int logn, int r) {
  return r == 0 ? logn - 1 : act_hi(logn, r - 1) - act_count(logn, r - 1);
}

__host__ __device__ constexpr int act_lo(int logn, int r) {
  return act_hi(logn, r) - act_count(logn, r) + 1;
}

// lowest index bit of the 4-bit window of coefficients a thread holds
__host__ __device__ constexpr int own_lo(int logn, int r) {
  return act_hi(logn, r) >= 3 ? act_hi(logn, r) - 3 : 0;
}

// uint4s of round r's records: 8 per value of the thread bits above the window
__host__ __device__ constexpr int rec_vecs(int logn, int r) {
  return 8 << (logn - own_lo(logn, r) - 4);
}

__host__ __device__ constexpr int rec_off(int logn, int r) {
  return r == 0 ? 0 : rec_off(logn, r - 1) + rec_vecs(logn, r - 1);
}

__host__ __device__ constexpr int table_vecs(int logn) {
  return rec_off(logn, rounds_of(logn));
}

// ----- shared memory -----

// XOR the chunk bits 2..4 of word index i with h(i >> 5), h linear in bits
// 5..8: conflict-free for every round's access pattern.  swz is linear over
// GF(2), so swz(a | b) = swz(a) ^ swz(b) for disjoint bits: a thread
// swizzles its base index once and XORs in a constant per coefficient.
__host__ __device__ constexpr int swz(int i) {
  return i ^ (((((i >> 5) ^ (((i >> 7) & 1) * 3)) & 3) | ((i >> 6) & 4)) << 2);
}

// index of the s-th coefficient thread tid holds in a window at bit kLo:
// elem(tid, 0) | s << kLo
template <int kLo>
__device__ __forceinline__ int elem0(int tid) {
  return (tid & ((1 << kLo) - 1)) | ((tid >> kLo) << (kLo + 4));
}

// The word or vector at a byte offset of the ring.  A slot starts at a
// multiple of n words and a thread's indices within it stay below n, so
// slot | index == slot + index, and every access is one XOR of a per-round
// register with a constant.
template <typename T>
__device__ __forceinline__ T& at(uint32_t* ring, int byte) {
  return *reinterpret_cast<T*>(reinterpret_cast<char*>(ring) + byte);
}

template <int kLo>
__device__ __forceinline__ void load_round(uint32_t (&a)[16], uint32_t* ring, int slot, int tid) {
  const int base = 4 * (slot | swz(elem0<kLo>(tid)));
  if constexpr (kLo == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 v = at<uint4>(ring, base ^ (16 * c));
      a[4 * c] = v.x;
      a[4 * c + 1] = v.y;
      a[4 * c + 2] = v.z;
      a[4 * c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 16; ++s) a[s] = at<uint32_t>(ring, base ^ (4 * swz(s << kLo)));
  }
}

template <int kLo>
__device__ __forceinline__ void store_round(const uint32_t (&a)[16], uint32_t* ring, int slot,
                                            int tid) {
  const int base = 4 * (slot | swz(elem0<kLo>(tid)));
  if constexpr (kLo == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      at<uint4>(ring, base ^ (16 * c)) =
          make_uint4(a[4 * c], a[4 * c + 1], a[4 * c + 2], a[4 * c + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < 16; ++s) at<uint32_t>(ring, base ^ (4 * swz(s << kLo))) = a[s];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy one polynomial into buf: thread tid copies 16-byte chunks tid + c*T.
template <int kLogN>
__device__ __forceinline__ void prefetch(uint32_t* buf, const uint32_t* src, int tid) {
  constexpr int kT = 1 << (kLogN - 4);
  const uint32_t base = smem_addr(buf);
  const int tid_swz = swz(4 * tid);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int q = tid + c * kT;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 4 * (tid_swz ^ swz(4 * c * kT))),
                 "l"(src + 4 * q)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ----- butterflies -----

__device__ __forceinline__ uint32_t red(uint32_t x, uint32_t m) { return min(x, x - m); }

// Record slot of the q-th twiddle of the stage on window bit sb
// (ntt_kernel.py:twiddle_slot): bits 3 and 2 in the first 16-byte vector
// (slots 0, 1..2; slot 3 spare), bit 1 in the second, bit 0 in the last two.
__host__ __device__ constexpr int twiddle_slot(int sb, int q) {
  return (1 << (3 - sb)) - (sb >= 2 ? 1 : 0) + q;
}

__device__ __forceinline__ void ldg4(uint32_t* w, const uint4* v) {
  const uint4 t = __ldg(v);
  w[0] = t.x;
  w[1] = t.y;
  w[2] = t.z;
  w[3] = t.w;
}

// The stages of round kR on the 16 coefficients in a.  Window bit sb pairs
// a[s] with a[s | 2^sb] and reads its twiddles from the record's vectors
// that hold its slots, just before it needs them.
template <bool kFwd, int kLogN, int kR>
__device__ __forceinline__ void butterflies(uint32_t (&a)[16], const uint4* __restrict__ tab,
                                            int tid, uint32_t p) {
  constexpr int kLo = own_lo(kLogN, kR);
  constexpr int kSlo = act_lo(kLogN, kR) - kLo;
  constexpr int kShi = act_hi(kLogN, kR) - kLo;
  // vector c of this thread's record: rec[c * kK], w in c = 0..3, ws in 4..7
  constexpr int kK = 1 << (kLogN - kLo - 4);
  const uint4* rec = tab + rec_off(kLogN, kR) + (tid >> kLo);
  uint32_t w[16], ws[16];
  const uint32_t p2 = 2 * p;
#pragma unroll
  for (int j = 0; j <= kShi - kSlo; ++j) {
    const int sb = kFwd ? kShi - j : kSlo + j;
    const int bit = 1 << sb;
    // vectors of this stage's slots: 0 for bits 3 and 2 (once), 1 for bit 1, 2-3 for bit 0
    if (sb == 1) {
      ldg4(w + 4, rec + kK);
      ldg4(ws + 4, rec + 5 * kK);
    } else if (sb == 0) {
      ldg4(w + 8, rec + 2 * kK);
      ldg4(w + 12, rec + 3 * kK);
      ldg4(ws + 8, rec + 6 * kK);
      ldg4(ws + 12, rec + 7 * kK);
    } else if (j == 0 || sb == (kFwd ? 3 : 2)) {  // the first of bits 3 and 2 to run
      ldg4(w, rec);
      ldg4(ws, rec + 4 * kK);
    }
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if (s & bit) continue;
      const int pos = twiddle_slot(sb, s >> (sb + 1));
      const uint32_t x = a[s], y = a[s | bit];
      if (kFwd) {  // in [0, 4p) -> [0, 4p)
        const uint32_t xr = red(x, p2);
        const uint32_t t = mulmod_shoup_lazy(y, w[pos], ws[pos], p);
        a[s] = xr + t;
        a[s | bit] = xr - t + p2;
      } else if (kR == 0 && sb == 3) {  // the inverse's last stage, x n^-1 folded in
        a[s] = mulmod_shoup_lazy(x + y, w[3], ws[3], p);
        a[s | bit] = mulmod_shoup_lazy(x - y + p2, w[0], ws[0], p);
      } else {  // in [0, 2p) -> [0, 2p)
        a[s] = red(x + y, p2);
        a[s | bit] = mulmod_shoup_lazy(x - y + p2, w[pos], ws[pos], p);
      }
    }
  }
}

// Execution step kE of the transform on the polynomial in the ring's slot
// (a word offset); the last step stores the canonical result to dst.
template <bool kFwd, int kLogN, int kE>
__device__ __forceinline__ void run(uint32_t* ring, int slot, uint32_t* __restrict__ dst,
                                    const uint4* __restrict__ tab, int tid, uint32_t p) {
  constexpr int kNR = rounds_of(kLogN);
  constexpr int kR = kFwd ? kE : kNR - 1 - kE;
  constexpr int kLo = own_lo(kLogN, kR);
  uint32_t a[16];
  load_round<kLo>(a, ring, slot, tid);
  butterflies<kFwd, kLogN, kR>(a, tab, tid, p);
  if constexpr (kE + 1 < kNR) {
    store_round<kLo>(a, ring, slot, tid);
    __syncthreads();
    run<kFwd, kLogN, kE + 1>(ring, slot, dst, tab, tid, p);
  } else {
    // canonical, then through shared memory, so that a warp stores 512
    // contiguous bytes
#pragma unroll
    for (int s = 0; s < 16; ++s) a[s] = kFwd ? red(red(a[s], 2 * p), p) : red(a[s], p);
    store_round<kLo>(a, ring, slot, tid);
    __syncthreads();
    constexpr int kT = 1 << (kLogN - 4);
    const int base = 4 * (slot | swz(4 * tid));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      reinterpret_cast<uint4*>(dst)[tid + c * kT] = at<uint4>(ring, base ^ (4 * swz(4 * c * kT)));
  }
}

// 1024 threads per SM (64 registers each): 8, 4, 2 and 1 CTAs at n = 2048,
// 4096, 8192 and 16384, whose rings fill 128 KB.
template <bool kFwd, int kLogN>
__global__ void __launch_bounds__(1 << (kLogN - 4), 1 << (14 - kLogN))
    ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, long long total, int L,
               const uint4* __restrict__ tables, const uint32_t* __restrict__ primes) {
  constexpr int kN = 1 << kLogN;
  extern __shared__ uint4 ring[];  // kRing polynomials
  uint32_t* smem = reinterpret_cast<uint32_t*>(ring);
  const int tid = threadIdx.x;
  const int limb = blockIdx.x % L;
  const uint32_t p = primes[limb];
  const uint4* tab = tables + static_cast<size_t>(limb) * table_vecs(kLogN);
  const long long step = gridDim.x;
  long long poly = blockIdx.x;
  // the first kRing - 1 polynomials are in flight before the loop
#pragma unroll
  for (int k = 0; k < kRing - 1; ++k) {
    if (poly + k * step < total) prefetch<kLogN>(smem + k * kN, x + (poly + k * step) * kN, tid);
    cp_async_commit();
  }
  for (int cur = 0; poly < total; poly += step, cur = cur == kRing - 1 ? 0 : cur + 1) {
    cp_async_wait_group<kRing - 2>();
    // every copy of this polynomial has landed, and every thread is done
    // with the slot of the previous one, which the next copy fills
    __syncthreads();
    const long long ahead = poly + (kRing - 1) * step;
    const int fill = cur == 0 ? kRing - 1 : cur - 1;
    if (ahead < total) prefetch<kLogN>(smem + fill * kN, x + ahead * kN, tid);
    cp_async_commit();
    run<kFwd, kLogN, 0>(smem, cur * kN, y + poly * kN, tab, tid, p);
  }
}

template <bool kFwd, int kLogN>
cudaError_t occupancy(int* threads, int* smem, int* per_sm, int* regs, int* local_bytes) {
  const auto kern = ntt_kernel<kFwd, kLogN>;
  *threads = 1 << (kLogN - 4);
  *smem = kRing * (1 << kLogN) * static_cast<int>(sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, *threads, *smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <bool kFwd, int kLogN>
cudaError_t launch(const uint32_t* x, uint32_t* y, long long batch, int L, const uint32_t* tables,
                   int table_words, const uint32_t* primes, cudaStream_t stream) {
  if (L < 1 || batch < 1 || table_words != 4 * table_vecs(kLogN)) return cudaErrorInvalidValue;
  int threads, smem, per_sm, regs, local_bytes, dev, sms;
  cudaError_t e = occupancy<kFwd, kLogN>(&threads, &smem, &per_sm, &regs, &local_bytes);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long total = batch * L;
  long long grid = static_cast<long long>(sms) * per_sm / L * L;
  if (grid < L) grid = L;
  if (grid > total) grid = total;  // total is a multiple of L
  ntt_kernel<kFwd, kLogN><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      x, y, total, L, reinterpret_cast<const uint4*>(tables), primes);
  return cudaGetLastError();
}

template <bool kFwd>
cudaError_t dispatch(const uint32_t* x, uint32_t* y, long long batch, int L, int n,
                     const uint32_t* tables, int table_words, const uint32_t* primes,
                     cudaStream_t s) {
  switch (n) {
    case 2048: return launch<kFwd, 11>(x, y, batch, L, tables, table_words, primes, s);
    case 4096: return launch<kFwd, 12>(x, y, batch, L, tables, table_words, primes, s);
    case 8192: return launch<kFwd, 13>(x, y, batch, L, tables, table_words, primes, s);
    case 16384: return launch<kFwd, 14>(x, y, batch, L, tables, table_words, primes, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kFwd>
cudaError_t occupancy_n(int n, int* threads, int* smem, int* per_sm, int* regs, int* local_bytes) {
  switch (n) {
    case 2048: return occupancy<kFwd, 11>(threads, smem, per_sm, regs, local_bytes);
    case 4096: return occupancy<kFwd, 12>(threads, smem, per_sm, regs, local_bytes);
    case 8192: return occupancy<kFwd, 13>(threads, smem, per_sm, regs, local_bytes);
    case 16384: return occupancy<kFwd, 14>(threads, smem, per_sm, regs, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: uint32 [batch, L, n] (distinct, 16-byte aligned); tables: uint32
// [L, table_words], kernel_twiddles of psi_br (forward) or of ipsi_br with
// n^-1 folded in (inverse); primes: [L], each < 2^30.
extern "C" int fhetpu_ntt(const uint32_t* x, uint32_t* y, long long batch, int L, int n,
                          const uint32_t* tables, int table_words, const uint32_t* primes,
                          int forward, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      forward ? dispatch<true>(x, y, batch, L, n, tables, table_words, primes, s)
              : dispatch<false>(x, y, batch, L, n, tables, table_words, primes, s);
  return static_cast<int>(e);
}

// The launch shape of the kernel for n: threads per CTA, dynamic shared
// memory per CTA, resident CTAs per SM, registers per thread, local
// (spilled) bytes per thread.
extern "C" int fhetpu_ntt_occupancy(int n, int forward, int* threads, int* smem, int* per_sm,
                                    int* regs, int* local_bytes) {
  const cudaError_t e = forward ? occupancy_n<true>(n, threads, smem, per_sm, regs, local_bytes)
                                : occupancy_n<false>(n, threads, smem, per_sm, regs, local_bytes);
  return static_cast<int>(e);
}

extern "C" const char* fhetpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
