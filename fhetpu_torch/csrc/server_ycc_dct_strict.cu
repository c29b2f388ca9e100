// The strict JPEG server op for Hopper: RGB -> YCbCr, minus Delta*128 on
// component 0 of Y, and the two-pass 8x8 AAN DCT with the x0.125 column
// scaling, over NTT-domain ciphertexts; every output residue canonical in
// [0, p), for every prime below 2^30.
//
// Replaces the Pallas kernel fhetpu/core/pallas_server.py:_server_kernel
// (server_ycc_dct_fused with lazy=False).  Same layout as the TPU kernel:
// x is uint32 [nb, 3, 64, 2, L*n] (block, RGB channel, coefficient slot
// 8*g + s, ciphertext component, lane), where a lane is one of the L*n RNS
// residues and carries its own modulus.  Same constants: the rows of
// pack_server_constants, indexed by lane.  Modular residues do not depend on
// the order of the operations, and the output is canonical, so it is
// bit-identical to the reference network whatever the schedule in between.
//
// What bounds it on an H100: bytes.  At n = 4096 and a 64-block chunk it
// must read and write 1.61 GB each (0.96 ms at 3.35 TB/s); its 1,632 SASS
// instructions per thread take about 0.82 ms to issue.  So the design keeps
// enough loads in flight, the dependent chains short and the instruction
// count low:
//
// * Eight threads per 8x8 block.  A CTA of 8 warps takes one (block,
//   component) and 32 consecutive lanes; warp g holds row g, the slots
//   8g..8g+7.  A thread loads its 8 R, 8 G and 8 B residues (each warp load
//   one 128-byte segment), computes Y, Cb and Cr for them and runs the row
//   pass of each channel in registers.  It writes the three rows to shared
//   memory laid out [channel][slot][lane]: word (ch*64 + slot)*32 + lane
//   sits in bank `lane`, so a warp's row writes and column reads each hit 32
//   banks.  After one barrier, warp g reads column g (slots g, g+8, ...,
//   g+56) of each channel, runs the column pass with x0.125 and stores each
//   slot as one 128-byte segment.  A thread holds 24 values, not 64 plus a
//   park of 128: 3 CTAs (24 warps) fit an SM at 80 registers, with 24 KB of
//   shared memory each.  Measured on an H100 (PERF.md): 4 CTAs at 64
//   registers ran 8 % slower, 2 at 104 registers 7 % slower, and the
//   per-lane constants staged in shared memory once per CTA 14 % slower than
//   each thread loading them through L1, as here.  The grid is
//   one-dimensional: lane tile, then component, then block.
// * A lazy schedule.  The strict TPU kernel reduces every sum and product
//   to [0, p): an add, a compare and a select each, in chains up to six
//   deep.  Here a sum is reduced only where its bound would pass 4p, by one
//   conditional subtraction of 2p (a min); a value that feeds only a
//   product is not reduced; the output is made canonical once, at the store.
//
// Headroom, step by step (tests/test_torch_server_schedule.py emulates this
// schedule and asserts every bound).  p < 2^30, so 4p < 2^32: a value below
// 4p never wraps a 32-bit register.
//   1. A product is lazy Shoup: for ANY x < 2^32, x*w - mulhi(x, w')*p lies
//      in [0, 2p) (modarith.cuh), so every product is < 2p.
//   2. red(x) = min(x, x - 2p) maps [0, 4p) onto [0, 2p) (below 2p, x - 2p
//      wraps above x); canon(x) = min(x, x - p) maps [0, 2p) onto [0, p).
//      A difference a - b with b < 2p is a + 2p - b.
//   3. YCbCr from nine products P < 2p, each sum below 4p before its red:
//      Y  = red(red(P0 + P1) + red(P2 + 2p - sub))  (sub < p; 0 on comp 1)
//      Cb = red(red(P3 + 2p - P4) + P5)
//      Cr = red(red(P5' + 2p - P6) + 2p - P7)
//      so each channel enters the row pass below 2p.
//   4. An AAN pass (aan8_lazy) maps inputs < 2p to outputs < 4p:
//      tmp0..tmp7, sums and differences of two inputs, < 4p -> red -> < 2p;
//      tmp10..tmp13 likewise < 4p -> red -> < 2p;
//      out0, out4 = tmp10 +- tmp11 < 4p;
//      z1e = mul(tmp12 + tmp13), its input < 4p; out2 = z1e + mul(tmp13)
//      and out6 = z1e + mul(tmp12) < 4p;
//      z1..z4, sums of two of tmp4..tmp7, < 4p, feed only products, but
//      z3 + z4 would reach 8p, so z5 = mul(red(z3) + red(z4));
//      z3' = red(mul(z3) + z5), z4' = red(mul(z4) + z5) < 2p;
//      out7 = red(mul(tmp4) + mul(z1)) + z3' < 4p, and so out5, out3, out1.
//   5. The row pass's outputs, red -> < 2p, go to shared memory: the column
//      pass's inputs.
//   6. The column pass's outputs (< 4p) feed only the x0.125 product (< 2p);
//      canon makes them canonical, and they are stored.
// The wrapper (core/server_kernel.py) refuses a prime of 2^30 or more before
// any launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "aan.cuh"
#include "modarith.cuh"

namespace {

constexpr int kLanes = 32;               // lanes per CTA, one per thread of a warp
constexpr int kThreads = 8 * kLanes;     // warp g holds row g of the 8x8 block
constexpr int kMinCtasPerSm = 3;         // 24 warps per SM: at most 80 registers
constexpr int kYccRow = 13;              // 8 YCC multipliers (pack_server_constants)
constexpr int kSubRow = 21;              // NTT(Delta * encode(128))

struct Lazy {
  uint32_t p, p2;
  // [0, 4p) -> [0, 2p)
  __device__ __forceinline__ uint32_t red(uint32_t x) const { return min(x, x - p2); }
  // [0, 2p) -> [0, p)
  __device__ __forceinline__ uint32_t canon(uint32_t x) const { return min(x, x - p); }
};

// One 8-point AAN pass over a[0..7] in place (fhe_image.h:206-284): inputs
// < 2p, outputs < 4p (step 4 of the head note).
__device__ __forceinline__ void aan8_lazy(uint32_t (&a)[8], const DctConsts& k, Lazy m) {
  auto mul = [&](uint32_t x, int ci) { return mulmod_shoup_lazy(x, k.w[ci], k.ws[ci], m.p); };
  const uint32_t p2 = m.p2;
  const uint32_t t0 = m.red(a[0] + a[7]), t7 = m.red(a[0] + p2 - a[7]);
  const uint32_t t1 = m.red(a[1] + a[6]), t6 = m.red(a[1] + p2 - a[6]);
  const uint32_t t2 = m.red(a[2] + a[5]), t5 = m.red(a[2] + p2 - a[5]);
  const uint32_t t3 = m.red(a[3] + a[4]), t4 = m.red(a[3] + p2 - a[4]);
  const uint32_t t10 = m.red(t0 + t3), t13 = m.red(t0 + p2 - t3);
  const uint32_t t11 = m.red(t1 + t2), t12 = m.red(t1 + p2 - t2);
  a[0] = t10 + t11;
  a[4] = t10 + p2 - t11;
  const uint32_t z1e = mul(t12 + t13, 0);
  a[2] = z1e + mul(t13, 1);
  a[6] = z1e + mul(t12, 2);
  const uint32_t z1 = t4 + t7, z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  const uint32_t z5 = mul(m.red(z3) + m.red(z4), 3);
  const uint32_t z1m = mul(z1, 8), z2m = mul(z2, 9);
  const uint32_t z3m = m.red(mul(z3, 10) + z5), z4m = m.red(mul(z4, 11) + z5);
  a[7] = m.red(mul(t4, 4) + z1m) + z3m;
  a[5] = m.red(mul(t5, 5) + z2m) + z4m;
  a[3] = m.red(mul(t6, 6) + z2m) + z3m;
  a[1] = m.red(mul(t7, 7) + z1m) + z4m;
}

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    server_ycc_dct_strict_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ C,
                                 const uint32_t* __restrict__ Csh, long long lanes) {
  __shared__ uint32_t rows[3][64][kLanes];  // the row pass's outputs
  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const long long tiles = (lanes + kLanes - 1) / kLanes;
  const long long j0 = (blockIdx.x % tiles) * kLanes + lane;
  const bool live = j0 < lanes;
  // a thread past the last lane computes on lane lanes-1 and stores nothing:
  // it still takes part in the barrier
  const long long j = live ? j0 : lanes - 1;
  const size_t rest = blockIdx.x / tiles;  // comp + 2 * block
  const int comp = static_cast<int>(rest % 2);
  const size_t b = rest / 2;

  // element (b, ch, s, comp, j) lives at (((b*3 + ch)*64 + s)*2 + comp)*lanes + j
  const size_t slot_stride = 2 * static_cast<size_t>(lanes);
  const size_t ch_stride = 64 * slot_stride;
  const size_t base = (b * 3 * 64 * 2 + comp) * static_cast<size_t>(lanes) + j;

  const Lazy m{C[kPRow * lanes + j], 2 * C[kPRow * lanes + j]};
  uint32_t y[8], cb[8], cr[8];
  {
    uint32_t yw[8], ys[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      yw[i] = C[(kYccRow + i) * lanes + j];
      ys[i] = Csh[(kYccRow + i) * lanes + j];
    }
    auto mul = [&](uint32_t v, int i) { return mulmod_shoup_lazy(v, yw[i], ys[i], m.p); };
    // -Delta*128 applies to ciphertext component 0 only; x - 0 is x
    const uint32_t sub = comp == 0 ? C[kSubRow * lanes + j] : 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t off = base + (8 * g + i) * slot_stride;
      const uint32_t r = x[off], gr = x[off + ch_stride], bl = x[off + 2 * ch_stride];
      y[i] = m.red(m.red(mul(r, 0) + mul(gr, 1)) + m.red(mul(bl, 2) + m.p2 - sub));
      cb[i] = m.red(m.red(mul(r, 3) + m.p2 - mul(gr, 4)) + mul(bl, 5));
      cr[i] = m.red(m.red(mul(r, 5) + m.p2 - mul(gr, 6)) + m.p2 - mul(bl, 7));
    }
  }

  const DctConsts k = load_dct_consts(C, Csh, lanes, j);
  aan8_lazy(y, k, m);
  aan8_lazy(cb, k, m);
  aan8_lazy(cr, k, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[0][8 * g + i][lane] = m.red(y[i]);
    rows[1][8 * g + i][lane] = m.red(cb[i]);
    rows[2][8 * g + i][lane] = m.red(cr[i]);
  }
  __syncthreads();

#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rows[ch][g + 8 * i][lane];
    aan8_lazy(v, k, m);
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[base + ch * ch_stride + (g + 8 * i) * slot_stride] =
            m.canon(mulmod_shoup_lazy(v[i], k.w[12], k.ws[12], m.p));
    }
  }
}

}  // namespace

// x, out: uint32 [nb, 3, 64, 2, lanes] (distinct buffers), lanes = L*n;
// consts, consts_shoup: uint32 [24, lanes] from pack_server_constants, every
// modulus below 2^30.
extern "C" int fhetpu_server_ycc_dct(const uint32_t* x, uint32_t* out, const uint32_t* consts,
                                     const uint32_t* consts_shoup, long long nb, long long lanes,
                                     void* stream) {
  const long long ctas = (lanes + kLanes - 1) / kLanes * 2 * nb;
  if (nb < 1 || lanes < 1 || ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  server_ycc_dct_strict_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(x, out, consts,
                                                                      consts_shoup, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The strict kernel's launch shape: threads and static shared memory per
// CTA, resident CTAs per SM, registers and local (spilled) bytes per thread.
extern "C" int fhetpu_server_ycc_dct_occupancy(int* threads, int* smem, int* per_sm, int* regs,
                                               int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, server_ycc_dct_strict_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, server_ycc_dct_strict_kernel,
                                                    kThreads, 0);
  return static_cast<int>(e);
}
