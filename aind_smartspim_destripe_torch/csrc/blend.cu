// Dual-band blend of the destripe step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   destripe_blend <- aind_smartspim_destripe_tpu/ops/pallas_blend.py:blend_smooth_mix
//
// Per plane b with centre c = centers[b]:
//   frac   = 1 / (1 + exp(-(x - c) / crossover))
//   smooth = box17_cols(box17_rows(frac) / 17) / 17   (edge-replicated)
//   out    = fore * smooth + back * (1 - smooth)
// fore is plane b and back plane b + B of the stacked (2B, H, W) band pair
// (or two separate (B, H, W) buffers: the wrapper passes both pointers).
//
// What bounds it: 14 bytes per output (uint16 x, the two f32 bands, the f32
// output) against ~40 flops and one exp, so device memory. The TPU kernel
// carries the row pass through a sequential grid in VMEM scratch. Blocks
// here run in no order, so each block owns a 2-D output tile and stages the
// sigmoid of the tile plus an 8-row/8-column halo in shared memory, with
// clamped source indices (replicating frac at the plane's edges equals
// replicating x, since the sigmoid is elementwise). It then runs the row
// pass (17 direct taps in order, no running prefix sum, so no f32 drift
// along the 2000 columns) into a second shared array, the column pass, and
// the mix; x is re-read only for the halo (1.9x of its 2 bytes per pixel),
// the bands and the output once each.
//
// Numerics follow the plain twin (ops/cuda_blend.py:blend_bands) operation
// for operation: IEEE division and round-to-nearest adds and multiplies
// (no FMA contraction), the taps summed from the left, two divisions by 17
// (the JAX package's XLA reference; the TPU kernel multiplies by 1/289).
// Only expf may differ from the twin's exp, by an ulp.
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRadius = 8;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileRows = 32, kTileCols = 64;
constexpr int kRowsIn = kTileRows + 2 * kRadius;  // 48 staged rows
constexpr int kColsIn = kTileCols + 2 * kRadius;  // 80 staged columns
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
    blend_kernel(const TI* __restrict__ x, const float* __restrict__ fore,
                 const float* __restrict__ back,
                 const float* __restrict__ centers, float* __restrict__ out,
                 int H, int W, float crossover) {
  __shared__ float frac[kRowsIn][kColsIn];
  __shared__ float rows[kRowsIn][kTileCols];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileRows, c0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)b * H * W;
  const TI* xb = x + plane;
  const float c = centers[b];

  // sigmoid of the tile and its halo, source indices clamped to the plane
  for (int i = tid; i < kRowsIn * kColsIn; i += kThreads) {
    const int rr = min(max(r0 - kRadius + i / kColsIn, 0), H - 1);
    const int cc = min(max(c0 - kRadius + i % kColsIn, 0), W - 1);
    const float v = to_f32(xb[(size_t)rr * W + cc]);
    const float z = __fdiv_rn(-__fsub_rn(v, c), crossover);
    frac[i / kColsIn][i % kColsIn] =
        __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(z)));
  }
  __syncthreads();

  // row pass (along x) over every staged row
  for (int i = tid; i < kRowsIn * kTileCols; i += kThreads) {
    const int r = i / kTileCols, j = i % kTileCols;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) s = __fadd_rn(s, frac[r][j + k]);
    rows[r][j] = __fdiv_rn(s, static_cast<float>(kTaps));
  }
  __syncthreads();

  // column pass (along y) and the band mix
  for (int i = tid; i < kTileRows * kTileCols; i += kThreads) {
    const int r = i / kTileCols, j = i % kTileCols;
    const int rr = r0 + r, cc = c0 + j;
    if (rr >= H || cc >= W) continue;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) s = __fadd_rn(s, rows[r + k][j]);
    const float sm = __fdiv_rn(s, static_cast<float>(kTaps));
    const size_t o = plane + (size_t)rr * W + cc;
    out[o] = __fadd_rn(__fmul_rn(fore[o], sm),
                       __fmul_rn(back[o], __fsub_rn(1.0f, sm)));
  }
}

}  // namespace

extern "C" {

// x (B, H, W) uint16 (x_u16=1) or f32; fore, back (B, H, W) f32 (planes of
// one stacked buffer or two buffers); centers (B,) f32; crossover > 0;
// radius must be 8 -> out (B, H, W) f32. Returns cudaErrorInvalidValue for
// another radius.
int destripe_blend(const void* x, int x_u16, const float* fore,
                   const float* back, const float* centers, float* out, int B,
                   int H, int W, float crossover, int radius, void* stream) {
  if (radius != kRadius) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTileCols - 1) / kTileCols,
                  (H + kTileRows - 1) / kTileRows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_u16) {
    blend_kernel<unsigned short><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(x), fore, back, centers, out, H, W,
        crossover);
  } else {
    blend_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), fore, back, centers, out, H, W,
        crossover);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
