// The whole JPEG server op in one pass: RGB -> YCbCr, minus Delta*128 on
// component 0 of Y, and the two-pass 8x8 AAN DCT with the x0.125 column
// scaling, over NTT-domain ciphertexts.
//
// One template, two kernels of fhetpu/core/pallas_server.py:
//  * M = 0 replaces _server_kernel (server_ycc_dct_fused with lazy=False):
//    every value stays canonical in [0, p);
//  * M = 1 or 2 replaces _make_lazy_kernel(m) (lazy=True): intermediates
//    ride in [0, k*p) with raw uint32 adds, and are reduced only where the
//    TPU kernel reduces them (_red_to); the output is canonical again and
//    bit-identical to M = 0.  Headroom: the largest intermediate is 8*M*p
//    (16p at M = 2, primes < 2^28; 8p at M = 1, primes < 2^29), and the
//    caller picks M from the primes as fhetpu's lazy_bound_multiple does.
// Same layout as the TPU kernels: x is uint32 [nb, 3, 64, 2, L*n] (block,
// RGB channel, coefficient slot 8*g + s, ciphertext component, lane), where
// a lane is one of the L*n RNS residues and carries its own modulus.  Same
// constants: the rows of fhetpu/core/pallas_server.py:pack_server_constants,
// indexed by lane.  Modular residues do not depend on the order of the
// operations, so the output is bit-identical to the reference network.
//
// Thread mapping: one thread per (block, component, lane); neighbouring
// threads take neighbouring lanes, so every load and store of a warp is one
// contiguous 128-byte segment.  A thread reads its 3 x 64 R, G, B values
// once, keeps Y in registers and parks Cb and Cr in shared memory (its own
// column, so no synchronisation is needed), then runs the row and column
// AAN passes of each channel in registers and writes each result once.
//
// What bounds it on an H100: per block at n=4096 it reads 25.2 MB and
// writes 25.2 MB, the floor for this op (at nb=64, 0.96 ms at 3.35 TB/s).
// The fewest integer operations that give these bits (the lazy graph of
// M = 2: 8.1k per thread, 4k of them multiplies on the FMA pipe) take about
// half that time, so HBM bounds it; the design moves each byte once and
// uses the native __umulhi for every Shoup product.  The lazy variant
// trades each modular add's compare-and-select for a plain add, and drops
// the TPU kernel's 16-bit split companion tables: __umulhi gives the same
// exact high product.

#include <cuda_runtime.h>
#include <stdint.h>

#include "aan.cuh"
#include "modarith.cuh"

namespace {

constexpr int kThreads = 64;
// rows of the constant tables (pack_server_constants) besides aan.cuh's
constexpr int kYccRow = 13;   // 8 YCC multipliers
constexpr int kSubRow = 21;   // NTT(Delta * encode(128))

__host__ __device__ constexpr int red_top(int from) {
  int t = 1;
  while (t * 2 < from) t *= 2;
  return t;
}

// fhetpu/core/pallas_server.py:_red_to: x < FROM*p -> [0, TO*p) by
// conditional subtractions of power-of-two multiples of p.
template <int FROM, int TO>
__device__ __forceinline__ uint32_t red_to(uint32_t x, uint32_t p) {
  constexpr int kTop = red_top(FROM);
#pragma unroll
  for (int t = kTop; t >= TO; t /= 2) {
    const uint32_t tp = p * static_cast<uint32_t>(t);
    x = x >= tp ? x - tp : x;
  }
  return x;
}

// fhetpu/core/pallas_server.py:_aan_pass_lazy over v[base + stride * i] in
// place, inputs < M*p, followed by the reduction the TPU kernel applies to
// its outputs: to [0, M*p) after a row pass, and after the x0.125 column
// scaling (outputs < 2p) to canonical [0, p).
template <int M>
__device__ __forceinline__ void aan8_lazy(uint32_t* v, int base, int stride, bool column,
                                          const DctConsts& k, uint32_t p) {
  auto mul = [&](uint32_t x, int ci) { return mulmod_shoup_lazy(x, k.w[ci], k.ws[ci], p); };
  const uint32_t mp = M * p, mp2 = 2 * M * p, mp4 = 4 * M * p;
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = v[base + stride * i];
  const uint32_t tmp0 = a[0] + a[7];
  uint32_t tmp7 = a[0] + mp - a[7];
  const uint32_t tmp1 = a[1] + a[6];
  uint32_t tmp6 = a[1] + mp - a[6];
  const uint32_t tmp2 = a[2] + a[5];
  uint32_t tmp5 = a[2] + mp - a[5];
  const uint32_t tmp3 = a[3] + a[4];
  uint32_t tmp4 = a[3] + mp - a[4];
  const uint32_t tmp10 = tmp0 + tmp3;  // < 4Mp
  const uint32_t tmp13 = tmp0 + mp2 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2;
  const uint32_t tmp12 = tmp1 + mp2 - tmp2;
  uint32_t o[8];
  o[0] = tmp10 + tmp11;  // < 8Mp
  o[4] = tmp10 + mp4 - tmp11;
  uint32_t z1 = mul(tmp12 + tmp13, 0);  // product input < 8Mp <= 2^32
  o[2] = z1 + mul(tmp13, 1);  // < 4p
  o[6] = z1 + mul(tmp12, 2);
  z1 = tmp4 + tmp7;  // < 4Mp
  uint32_t z2 = tmp5 + tmp6;
  uint32_t z3 = tmp4 + tmp6;
  uint32_t z4 = tmp5 + tmp7;
  const uint32_t z5 = mul(z3 + z4, 3);
  tmp4 = mul(tmp4, 4);
  tmp5 = mul(tmp5, 5);
  tmp6 = mul(tmp6, 6);
  tmp7 = mul(tmp7, 7);
  z1 = mul(z1, 8);
  z2 = mul(z2, 9);
  z3 = mul(z3, 10);
  z4 = mul(z4, 11);
  z3 = z3 + z5;  // < 4p
  z4 = z4 + z5;
  o[7] = tmp4 + z1 + z3;  // < 8p
  o[5] = tmp5 + z2 + z4;
  o[3] = tmp6 + z2 + z3;
  o[1] = tmp7 + z1 + z4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[base + stride * i] = column ? red_to<2, 1>(mul(o[i], 12), p) : red_to<8 * M, M>(o[i], p);
}

template <int M>
__device__ __forceinline__ void dct8x8_lazy(uint32_t* v, const DctConsts& k, uint32_t p) {
#pragma unroll
  for (int g = 0; g < 8; ++g) aan8_lazy<M>(v, 8 * g, 1, false, k, p);
#pragma unroll
  for (int s = 0; s < 8; ++s) aan8_lazy<M>(v, s, 8, true, k, p);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    server_ycc_dct_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ C, const uint32_t* __restrict__ Csh,
                          long long lanes) {
  __shared__ uint32_t parked[2][64][kThreads];  // Cb, Cr of this thread's 64 slots
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= lanes) return;
  const int comp = blockIdx.y;
  const size_t b = blockIdx.z;

  const uint32_t p = C[kPRow * lanes + j];
  uint32_t yw[8], ys[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    yw[i] = C[(kYccRow + i) * lanes + j];
    ys[i] = Csh[(kYccRow + i) * lanes + j];
  }
  // -Delta*128 applies to ciphertext component 0 only; x - 0 is x
  const uint32_t sub = comp == 0 ? C[kSubRow * lanes + j] : 0u;
  auto mul = [&](uint32_t v, int i) {
    if constexpr (M == 0) {
      return mulmod_shoup(v, yw[i], ys[i], p);
    } else {
      return mulmod_shoup_lazy(v, yw[i], ys[i], p);
    }
  };

  // element (b, ch, s, comp, j) lives at (((b*3 + ch)*64 + s)*2 + comp)*lanes + j
  const size_t slot_stride = 2 * static_cast<size_t>(lanes);
  const size_t ch_stride = 64 * slot_stride;
  const size_t base = (b * 3 * 64 * 2 + comp) * static_cast<size_t>(lanes) + j;

  uint32_t v[64];
#pragma unroll
  for (int s = 0; s < 64; ++s) {
    const size_t off = base + s * slot_stride;
    const uint32_t r = x[off];
    const uint32_t g = x[off + ch_stride];
    const uint32_t bl = x[off + 2 * ch_stride];
    if constexpr (M == 0) {
      const uint32_t y = addmod(addmod(mul(r, 0), mul(g, 1), p), mul(bl, 2), p);
      v[s] = submod(y, sub, p);
      parked[0][s][threadIdx.x] = addmod(submod(mul(r, 3), mul(g, 4), p), mul(bl, 5), p);
      parked[1][s][threadIdx.x] = submod(submod(mul(r, 5), mul(g, 6), p), mul(bl, 7), p);
    } else {
      // each sum < 6p before the offsets (pallas_server.py:206-213); y < 7p
      const uint32_t y = mul(r, 0) + mul(g, 1) + mul(bl, 2) + p - sub;
      v[s] = red_to<8, M>(y, p);
      parked[0][s][threadIdx.x] = red_to<8, M>(mul(r, 3) + 2 * p - mul(g, 4) + mul(bl, 5), p);
      parked[1][s][threadIdx.x] = red_to<8, M>(mul(r, 5) + 4 * p - mul(g, 6) - mul(bl, 7), p);
    }
  }

  const DctConsts k = load_dct_consts(C, Csh, lanes, j);
#pragma unroll 1
  for (int ch = 0; ch < 3; ++ch) {
    if (ch > 0) {
#pragma unroll
      for (int s = 0; s < 64; ++s) v[s] = parked[ch - 1][s][threadIdx.x];
    }
    if constexpr (M == 0) {
      dct8x8(v, k, p);
    } else {
      dct8x8_lazy<M>(v, k, p);
    }
    const size_t ch_base = base + ch * ch_stride;
#pragma unroll
    for (int s = 0; s < 64; ++s) out[ch_base + s * slot_stride] = v[s];
  }
}

template <int M>
int launch(const uint32_t* x, uint32_t* out, const uint32_t* consts,
           const uint32_t* consts_shoup, long long nb, long long lanes, void* stream) {
  if (nb < 1 || nb > 65535 || lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((lanes + kThreads - 1) / kThreads), 2,
                  static_cast<unsigned>(nb));
  server_ycc_dct_kernel<M><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, consts, consts_shoup, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: uint32 [nb, 3, 64, 2, lanes] (distinct buffers), lanes = L*n;
// consts, consts_shoup: uint32 [24, lanes] from pack_server_constants.
extern "C" int fhetpu_server_ycc_dct(const uint32_t* x, uint32_t* out, const uint32_t* consts,
                                     const uint32_t* consts_shoup, long long nb, long long lanes,
                                     void* stream) {
  return launch<0>(x, out, consts, consts_shoup, nb, lanes, stream);
}

// The lazy kernel, same arguments plus m = lazy_bound_multiple (1 or 2):
// every prime of the table must be below 2^32 / (8m).
extern "C" int fhetpu_server_ycc_dct_lazy(const uint32_t* x, uint32_t* out,
                                          const uint32_t* consts, const uint32_t* consts_shoup,
                                          long long nb, long long lanes, int m, void* stream) {
  if (m == 2) return launch<2>(x, out, consts, consts_shoup, nb, lanes, stream);
  if (m == 1) return launch<1>(x, out, consts, consts_shoup, nb, lanes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
