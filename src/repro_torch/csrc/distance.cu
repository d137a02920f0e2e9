// All-pairs distance, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/distance.py::_dist_kernel (line
// 26; pallas_call at line 79). Semantics: the port's kernels/ref.py::
// pairwise_dist: q[Bq, D] x x[N, D] -> f32[Bq, N], l2 ``‖q‖² − 2q·x +
// ‖x‖²`` or ip ``−q·x``, with f32, bf16 or f16 inputs widened exactly to
// f32 and every product and sum in f32.
//
// Bound on the H100: operations at every shape the port uses. The work is
// 2*Bq*N*D flops against 4*Bq*N bytes written (plus the inputs read once),
// D/2 flops per output byte: at D = 128, 64 flops per byte, past the
// card's 20 for f32 on the CUDA cores. No tensor cores: TF32 would keep
// about three decimal digits and break the 1e-5 parity that every
// distance of the port keeps, and 3xTF32 or bf16 wgmma with TMA are a later
// design's work.
//
// Design: one block of 256 threads per 64x64 output tile; K-tiles of 32
// columns of q and x are loaded with their rows' lanes on consecutive
// addresses, decoded to f32 and staged in shared memory ([64][33], the pad
// keeps every access conflict-free); each thread keeps a 4x4 register tile
// of dots (q rows ty + 16i, x rows tx + 16j) and runs f32 FFMAs. The norm
// terms accumulate in the same K-loop, two warps summing one staged row
// each, as the TPU kernel fuses them: no second pass over the output.
// Ragged Bq, N and D are masked on load (zeros) and on store; nothing is
// padded or copied outside the kernel.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output rows and columns per block
constexpr int kK = 32;        // K columns per staged tile
constexpr int kThreads = 256;
constexpr int kPad = kK + 1;

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dist_kernel(const T* __restrict__ q, const T* __restrict__ x,
            float* __restrict__ out, int Bq, int N, int D, int metric) {
  __shared__ float qs[kTile][kPad];
  __shared__ float xs[kTile][kPad];
  __shared__ float qn[kTile];
  __shared__ float xn[kTile];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // threads 0-63: ‖q row t‖²; 64-127: ‖x row t-64‖²

  for (int k0 = 0; k0 < D; k0 += kK) {
    // stage: element e = t + 256 s of each 64x32 tile is (row e/32, col
    // e%32), so a warp reads 32 consecutive columns of one row
#pragma unroll
    for (int s = 0; s < kTile * kK / kThreads; ++s) {
      const int e = t + s * kThreads;
      const int row = e / kK, col = e % kK;
      const int k = k0 + col;
      const int qr = r0 + row, xr = c0 + row;
      qs[row][col] = (qr < Bq && k < D)
                         ? widen(q[static_cast<size_t>(qr) * D + k])
                         : 0.f;
      xs[row][col] = (xr < N && k < D)
                         ? widen(x[static_cast<size_t>(xr) * D + k])
                         : 0.f;
    }
    __syncthreads();
    if (t < 2 * kTile) {  // warps 0-3: the norms, same K-loop
      const float* r = t < kTile ? qs[t] : xs[t - kTile];
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) nrm = fmaf(r[kk], r[kk], nrm);
    }
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < kTile) qn[t] = nrm;
  else if (t < 2 * kTile) xn[t - kTile] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= Bq) continue;
    float* orow = out + static_cast<size_t>(r) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= N) continue;
      const float dot = acc[i][j];
      // l2 as the plain version orders it: (qq - 2 dot) + xx (2*dot is
      // exact, so a contracted fma rounds the same)
      orow[c] = metric == rt::kMetricL2
                    ? (qn[ty + 16 * i] - 2.0f * dot) + xn[tx + 16 * j]
                    : -dot;
    }
  }
}

template <typename T>
int launch(const void* q, const void* x, void* out, int Bq, int N, int D,
           int metric, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (Bq + kTile - 1) / kTile);
  dist_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<float*>(out), Bq, N, D, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [Bq, D] and x [N, D], both of `dtype` (0 f32, 1 bf16, 2 f16), ->
// out f32[Bq, N]; metric 0 l2, 1 ip. Bq <= 65535 * 64.
RT_API int rt_pairwise_dist(const void* q, const void* x, void* out, int Bq,
                            int N, int D, int dtype, int metric,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, x, out, Bq, N, D, metric, s);
    case 1: return launch<__nv_bfloat16>(q, x, out, Bq, N, D, metric, s);
    case 2: return launch<__half>(q, x, out, Bq, N, D, metric, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
