// The uint16 store epilogues of the destripe step, shared by K4
// (band.cu: syn_x_exp, plane, dual and row-shard forms) and the dual-band
// blend (blend.cu), so the two cannot drift apart. Each takes one float32
// output value and rounds it as the plain PyTorch twins do
// (ops/flatfield.py: flatfield_correction, wrap_cast), operation for
// operation: IEEE subtraction and division (no fast math), a clip to
// [0, 65535] (NaN to 0, as the twins' cast gives) and truncation toward 0.

#pragma once

#include <cuda_runtime.h>

namespace destripe {

// Flat-field correction: dark subtracted (x <= dark -> 0), divided by the
// flat, clipped to [0, 65535] and truncated to uint16.
__device__ __forceinline__ unsigned short epi_flat(float e, float dk,
                                                   float fl) {
  float u = (e <= dk) ? 0.0f : e - dk;
  u = u / fl;
  u = fminf(fmaxf(u, 0.0f), 65535.0f);
  return (unsigned short)__float2int_rz(u);
}

// The zarr store's cast: truncated to int32 (saturating), modulo 2^16.
__device__ __forceinline__ unsigned short epi_wrap(float e) {
  int m = __float2int_rz(e) % 65536;
  if (m < 0) m += 65536;
  return (unsigned short)m;
}

}  // namespace destripe
