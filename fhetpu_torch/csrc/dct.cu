// The homomorphic 8x8 DCT alone: the two-pass AAN network with the x0.125
// column scaling over NTT-domain ciphertexts, every residue canonical in
// [0, p).  The --quantize server path runs it between the YCC transform and
// the per-slot quantize multiplies, which the fused kernel leaves no room
// for.
//
// Replaces the Pallas kernel fhetpu/core/pallas_dct.py:_dct_kernel_limb
// (dct8x8_pallas).  The TPU kernel transposes its input to
// [nb, ch, L, 8, 8, 2n] to fill (8, 128) tiles; here the kernel works on the
// native layout x = uint32 [nb, ch, 64, 2, L*n] (block, channel, coefficient
// slot 8*g + s, ciphertext component, lane), so no transpose pass is paid.
// Constants: rows 0..12 and 22 of pack_server_constants' [24, L*n] tables,
// the ones the evaluator already holds on the device for the fused kernel;
// they carry the residues of fhetpu's pack_dct_constants, lane by lane.
//
// Thread mapping: one thread per (block, channel, component, lane) keeps
// its 64 slots in registers and runs both passes there (aan.cuh, the same
// device code as the fused kernel's DCT); no shared memory.  Neighbouring
// threads take neighbouring lanes, so each warp load and store is one
// contiguous 128-byte segment.  The grid is one-dimensional (lane tile,
// then component, then block*channel), so a chunk of any block count the
// strict fused kernel takes fits it.
//
// What bounds it on an H100: every input byte is read once and every output
// byte written once (at nb=64, ch=3, n=4096: 1.61 GB each way, 0.96 ms at
// 3.35 TB/s).  The fewest integer operations that give these bits (the lazy
// AAN graph: 1728 per thread, 768 of them multiplies on the FMA pipe) take
// about a third of that time, so HBM bounds it; the design moves each byte
// once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "aan.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    dct8x8_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ C, const uint32_t* __restrict__ Csh,
                  long long lanes) {
  const long long tiles = (lanes + kThreads - 1) / kThreads;
  const long long j = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (j >= lanes) return;
  const size_t rest = blockIdx.x / tiles;  // comp + 2 * (block * ch + channel)
  const int comp = static_cast<int>(rest % 2);
  const size_t bc = rest / 2;

  // element (bc, s, comp, j) lives at ((bc*64 + s)*2 + comp)*lanes + j
  const size_t slot_stride = 2 * static_cast<size_t>(lanes);
  const size_t base = (bc * 64 * 2 + comp) * static_cast<size_t>(lanes) + j;
  const uint32_t p = C[kPRow * lanes + j];
  const DctConsts k = load_dct_consts(C, Csh, lanes, j);

  uint32_t v[64];
#pragma unroll
  for (int s = 0; s < 64; ++s) v[s] = x[base + s * slot_stride];
  dct8x8(v, k, p);
#pragma unroll
  for (int s = 0; s < 64; ++s) out[base + s * slot_stride] = v[s];
}

}  // namespace

// x, out: uint32 [nb, ch, 64, 2, lanes] (distinct buffers), lanes = L*n;
// consts, consts_shoup: uint32 [24, lanes] from pack_server_constants.
extern "C" int fhetpu_dct8x8(const uint32_t* x, uint32_t* out, const uint32_t* consts,
                             const uint32_t* consts_shoup, long long nb, long long ch,
                             long long lanes, void* stream) {
  const long long ctas = (lanes + kThreads - 1) / kThreads * 2 * nb * ch;
  if (nb < 1 || ch < 1 || lanes < 1 || ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dct8x8_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      x, out, consts, consts_shoup, lanes);
  return static_cast<int>(cudaGetLastError());
}
