// Gather + masked distance for beam search, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::_gather_dist_kernel
// (line 48; pallas_call at line 200). Semantics: kernels/ref.py::gather_dist
// of the port: out[b, j] = ||x||^2 - 2 x.q_b + ||q_b||^2 (l2) or -x.q_b (ip)
// for x = table[ids[b, j]], +inf where ids[b, j] < 0. f32 table.
//
// Bound on the H100: memory. Each valid id reads one d*4-byte row at a
// random address and does 4d flops on it, far below the card's 20 flops
// per byte; the least time is B*M*(d*4+8) + B*d*4 bytes over the memory
// rate. Design: one block per query row, the query in shared memory, one
// warp per gathered id with coalesced 16-byte loads (a d=128 row is four
// 128-byte sectors, one load instruction per lane), the two dots reduced
// with shuffles. -1 slots read nothing. The TPU kernel's 128-lane padding,
// its SMEM/VMEM double copy of the ids and its diagonal-extract MXU product
// do not carry over.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gather_dist_kernel(const float* __restrict__ q, const float* __restrict__ table,
                   const int* __restrict__ ids, float* __restrict__ out, int M,
                   int d, int n, int metric, int vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  rt::load_query(q + static_cast<size_t>(b) * d, qs, d);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float qq = rt::warp_norm2(qs, d);
  for (int j = warp; j < M; j += kThreads / 32) {
    const int id = ids[static_cast<size_t>(b) * M + j];
    float r = INFINITY;
    if (id >= 0) {  // uniform over the warp
      float xx, xq;
      rt::row_dots(table + static_cast<size_t>(min(id, n - 1)) * d, qs, d,
                   vec4 != 0, xx, xq);
      r = rt::combine(xx, xq, qq, metric);
    }
    if (lane == 0) out[static_cast<size_t>(b) * M + j] = r;
  }
}

}  // namespace

// q f32[B, d], table f32[n, d], ids int32[B, M] -> out f32[B, M].
RT_API int rt_gather_dist(const void* q, const void* table, const void* ids,
                          void* out, int B, int M, int d, int n, int metric,
                          void* stream) {
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  gather_dist_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table),
      static_cast<const int*>(ids), static_cast<float*>(out), M, d, n, metric,
      vec4);
  return static_cast<int>(cudaGetLastError());
}
