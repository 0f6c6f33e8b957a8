// One pipelined FP32 GEMM tile for NVIDIA Hopper (sm_90a), shared by the
// dense levels' products (dense.cu), the row-sharded route's per-plane
// notch product (notch.cu's notch_select) and the plane path's notch tails
// (notch.cu's notch_delta and the exact-rank projection and synthesis,
// through the tile's two hooks: a transform of each A element as it is
// loaded and an epilogue in place of the store).
//
// A block of BM * BN / 64 threads computes a BM x BN output tile of
// c = a @ b, each thread 8 x 8 outputs laid out as two 4 x 4 quadrants
// BM / 2 rows and BN / 2 columns apart, so that every shared-memory read of
// the inner loop is a conflict-free 16-byte load: 4 loads feed 64 FMAs. A
// warp holds 4 x 8 threads, so a load of the A tile touches 64 bytes and a
// load of the B tile 128 bytes. Both operands are staged in shared memory
// k-major (As[k][m], Bs[k][n], rows padded by 4 floats so that the
// transposing stores hit 32 distinct banks) in a ring of kStages K-steps of
// kBK: the loads of step t + kStages - 1 are issued before the FMAs of step
// t, with one barrier per step.
//
// Copy instructions cost this tile time on an H100: the halo route's
// level-0 notch product runs slower with one 4-byte copy per element than
// with 8-byte ones (chip_smoke.py times each product at the planned and at
// 4-byte copies; PERF.md). So the fewest copy instructions that the
// operands' real alignment allows:
// - A (k along its rows) is loaded into registers during the FMAs of the
//   step before and stored transposed after them, V consecutive k per load:
//   8 bytes where its rows are 8-byte aligned, else 4;
// - B with unit-stride columns (the notch bank, planes in operator @
//   planes) is copied untransposed with cp.async, 8 or 4 bytes per copy by
//   the same rule; B read along k (an operator's transpose) one element per
//   cp.async.
// None of the path's widths is a multiple of 4 floats (503, 403, 254 at
// dense level 2; 9002 and 4503 at the halo route's levels 0 and 1; the
// no-cells operator starts w columns into the (w, 2w) bank), so 16-byte
// copies would need a ragged head and tail on nearly every row; the width
// is the wrapper's choice, made from the pointers and strides. Rows and
// columns past the edge are clamped (A) or zero-filled (B), k past K reads
// as zero, and no copy reads past the end of a row it does not need.
//
// The order contract, held by every instance: each output is accumulated by
// exactly one thread, from 0.0f, in ascending k, one fmaf per term; no
// split-K, no second partial sum per output (a thread's 64 independent
// outputs give the ILP) and no tensor cores. So the tile, the fold of the
// batch and the instance may be chosen per shape without changing a bit:
// c equals the sum taken term by term in k order at any shape.
//
// No tensor cores, and why: dense_matmul's fixed order rules them out; for
// the notch products a 3xTF32 wgmma split would change the bits, its PSNR cost is
// not measured, and it would run above the FP32 bound the smoke run reckons.
// It stays an option, gated on measuring that PSNR first.
//
// Bound: 2 m n K FP32 operations per plane against the CUDA cores' FP32
// peak; the operands come from L2 (each A tile is read by every column
// block, each B tile by every row block).

#pragma once

#include <cuda_runtime.h>

namespace gemm_f32 {

constexpr int kBK = 8;      // k per stage
constexpr int kStages = 3;  // the ring of K-steps in shared memory
constexpr int kPad = 4;     // floats of padding per staged row

template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = BM * BN / 64;
  static constexpr int kWarpsX = BN / 64;  // warps of 8 thread columns
  // registers: at most 65536 / (kThreads * kMinBlocks) = 128 per thread
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);
  static_assert(BM % 64 == 0 && BN % 64 == 0, "tile edges of 64 or 128");
  static_assert(kThreads % kBK == 0 && kThreads >= BN, "loader maps");
};

// cp.async of BYTES (4 or 8) into shared memory, of which the first
// src_bytes are read from src and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The two hooks of tile_product, identity by default, so that an instance
// without them compiles to the plain product:
// - an A-element transform, applied by KMajorLoader::load to each loaded
//   value with k < K (k >= K still reads 0): prepare() is called once per
//   block, before the first load, with the loader (whose lines a thread
//   keeps across K-steps), and f(e, v) maps the value v of the thread's
//   e-th line;
// - an epilogue in place of the plain store, called once per stored output
//   with its row, column and sum.
struct AIdentity {
  template <class Loader>
  __device__ __forceinline__ void prepare(const Loader&, int, int) {}
  __device__ __forceinline__ float operator()(int, float v) const {
    return v;
  }
};

struct CStore {
  __device__ __forceinline__ void operator()(float* c, long long ldc, int r,
                                             int col, float acc) const {
    c[r * ldc + col] = acc;
  }
};

// A kBK x LINES slab of an operand whose k runs along its lines, line l and
// step k at src[l * sl + k * sk], staged into dst[k][l] (pitch LINES +
// kPad) through registers: load() issues the global loads of a K-step,
// store() writes them, transposed, after the FMAs of the step before.
// Thread t reads V consecutive k (one 4- or 8-byte load; V == 2 needs
// sk == 1 and 8-byte aligned lines) of the lines t / (kBK / V) + e * step:
// a warp's loads cover 32 / (kBK / V) lines x 32 bytes, and its stores hit
// 32 distinct banks. Lines past nlines are clamped to the last one (their
// outputs are not stored); k >= K reads as 0.
template <int LINES, int THREADS, int V>
struct KMajorLoader {
  static constexpr int kChunks = kBK / V;  // loads per line and step
  static constexpr int kLoads = LINES * kChunks / THREADS;
  static constexpr int kLineStep = THREADS / kChunks;
  float r[kLoads][V];
  int line, kc;

  __device__ __forceinline__ KMajorLoader() {
    line = threadIdx.x / kChunks;
    kc = (threadIdx.x % kChunks) * V;
  }

  // the (clamped) line of the thread's e-th load
  __device__ __forceinline__ int line_of(int e, int line0,
                                         int nlines) const {
    return min(line0 + line + e * kLineStep, nlines - 1);
  }

  template <class F>
  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int line0, int nlines, long long sl,
                                       long long sk, int k0, int K,
                                       const F& f) {
    const int k = k0 + kc;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const float* p = src + line_of(e, line0, nlines) * sl + k * sk;
      if constexpr (V == 2) {
        if (k + 2 <= K) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(p));
          r[e][0] = f(e, v.x);
          r[e][1] = f(e, v.y);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        r[e][j] = k + j < K ? f(e, __ldg(p + j * sk)) : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int e = 0; e < kLoads; ++e)
#pragma unroll
      for (int j = 0; j < V; ++j)
        dst[(kc + j) * (LINES + kPad) + line + e * kLineStep] = r[e][j];
  }
};

// A kBK x LINES slab of an operand whose lines are unit stride apart (B
// with sbn == 1), copied untransposed with cp.async: thread t copies the V
// lines from (t % (LINES / V)) * V (one 4- or 8-byte copy; V == 2 needs
// 8-byte aligned rows) of the steps t / (LINES / V) + e * step, so a warp
// copies 32 * V consecutive floats of a row. Lines past nlines and k >= K
// are zero-filled, never read.
template <int LINES, int THREADS, int V>
struct NMajorLoader {
  static constexpr int kChunks = LINES / V;  // copies per step row
  static constexpr int kKStep = THREADS / kChunks;
  static constexpr int kLoads = kBK / kKStep;
  int j, kr, bytes;

  __device__ __forceinline__ NMajorLoader(int line0, int nlines) {
    j = (threadIdx.x % kChunks) * V;
    kr = threadIdx.x / kChunks;
    bytes = 4 * max(0, min(V, nlines - line0 - j));
  }

  __device__ __forceinline__ void copy(float* dst, const float* src,
                                       int line0, long long sk, int k0,
                                       int K) const {
    const float* p = src + line0 + j + (k0 + kr) * sk;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int k = kr + e * kKStep;
      const int n = k0 + k < K ? bytes : 0;
      cp_async<4 * V>(dst + k * (LINES + kPad) + j,
                      n ? p + e * kKStep * sk : src, n);
    }
  }
};

// The same slab as KMajorLoader, copied with cp.async one element at a
// time (B read along k through op.t(), or any other strides): thread t
// takes k = t % kBK and the lines t / kBK + e * (THREADS / kBK).
template <int LINES, int THREADS>
struct KMajorCopier {
  static constexpr int kLoads = LINES * kBK / THREADS;
  int line, kk;

  __device__ __forceinline__ KMajorCopier() {
    kk = threadIdx.x % kBK;
    line = threadIdx.x / kBK;
  }

  __device__ __forceinline__ void copy(float* dst, const float* src,
                                       int line0, int nlines, long long sl,
                                       long long sk, int k0, int K) const {
    const bool in = k0 + kk < K;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int l = line + e * (THREADS / kBK);
      const float* p = src + min(line0 + l, nlines - 1) * sl + (k0 + kk) * sk;
      cp_async<4>(dst + kk * (LINES + kPad) + l, in ? p : src, in ? 4 : 0);
    }
  }
};

// c[r, j] = sum_k f(a[r * sam + k * sak]) * b[k * sbk + j * sbn] for the
// tile at (row0, col0) of the m x n output, c row-major with row pitch ldc,
// f the A-element transform a_op, each sum handed to the epilogue epi.
// a is staged by KMajorLoader<VA>; b by NMajorLoader<VB> where
// kBUnitN (sbn == 1), else by KMajorCopier. Called by every thread of the
// block.
template <int BM, int BN, int VA, bool kBUnitN, int VB,
          class AOp = AIdentity, class Epi = CStore>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a, long long sam, long long sak,
    const float* __restrict__ b, long long sbk, long long sbn,
    float* __restrict__ c, long long ldc, int m, int n, int K, int row0,
    int col0, AOp a_op = AOp(), const Epi& epi = Epi()) {
  using T = Tile<BM, BN>;
  __shared__ __align__(16) float As[kStages][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[kStages][kBK][BN + kPad];

  KMajorLoader<BM, T::kThreads, VA> load_a;
  a_op.prepare(load_a, row0, m);
  const NMajorLoader<BN, T::kThreads, VB> copy_bn(col0, n);
  const KMajorCopier<BN, T::kThreads> copy_bk;
  auto copy_b = [&](int s, int k0) {
    if constexpr (kBUnitN) {
      copy_bn.copy(&Bs[s][0][0], b, col0, sbk, k0, K);
    } else {
      copy_bk.copy(&Bs[s][0][0], b, col0, n, sbn, sbk, k0, K);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp % T::kWarpsX) * 8 + (lane & 7);
  const int ty = (warp / T::kWarpsX) * 4 + (lane >> 3);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int steps = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_a.load(a, row0, m, sam, sak, s * kBK, K, a_op);
      load_a.store(&As[s][0][0]);
      copy_b(s, s * kBK);
    }
    cp_async_commit();
  }

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t landed
    __syncthreads();  // everyone's, and everyone is done with step t - 1
    const int next = t + kStages - 1;
    const int sn = next % kStages;  // the slot of step t - 1
    if (next < steps) {
      load_a.load(a, row0, m, sam, sak, next * kBK, K, a_op);
      copy_b(sn, next * kBK);
    }
    cp_async_commit();
    const int s = t % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][kk][ty * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4 + BN / 2]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // read at step next, after the barriers of steps t + 1 and next
    if (next < steps) load_a.store(&As[sn][0][0]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 4 + (i & 3) + (i >> 2) * (BM / 2);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx * 4 + (j & 3) + (j >> 2) * (BN / 2);
      if (col < n) epi(c, ldc, r, col, acc[i][j]);
    }
  }
}

}  // namespace gemm_f32
