// Gather + masked distance for beam search, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::_gather_dist_kernel
// (line 48; pallas_call at line 200). Semantics: kernels/ref.py::gather_dist
// of the port: out[b, j] = ||x||^2 - 2 x.q_b + ||q_b||^2 (l2) or -x.q_b (ip)
// for x = the decoded table[ids[b, j]], +inf where ids[b, j] < 0. One
// instantiation per stored layout (f32, bf16, f16, int8 + scales, PQ codes
// + codebook: the TPU kernel's static `codec` bodies, lines 98-110), picked
// by the one C entry.
//
// Bound on the H100: memory. Each valid id reads one stored row at a
// random address (512 B f32, 256 B bf16/f16, 128 + 4 B int8, 32 B PQ at
// d = 128) and does 4d flops on it, far below the card's 20 flops per
// byte; the least time is the ids, the queries, the outputs and those rows
// (the PQ codebook once) over the memory rate. Design: one block per query
// row, the query in shared memory, one warp per gathered id with coalesced
// loads and the decode in registers (common.cuh row_dots), the two dots
// reduced with shuffles. -1 slots read nothing. The int8 kernel reads each
// id's scale itself, beside its row, where the TPU wrapper gathers the
// scales in a separate pass (gather_distance.py:173). The PQ codebook stays
// in global memory, served from L1/L2, not copied per block. The TPU
// kernel's 128-lane padding, its SMEM/VMEM double copy of the ids and its
// diagonal-extract MXU product do not carry over.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
gather_dist_kernel(const float* __restrict__ q, rt::Rows t,
                   const int* __restrict__ ids, float* __restrict__ out, int M,
                   int n, int metric) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int d = t.d;
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
      rt::row_dots<LAYOUT>(t, min(id, n - 1), qs, xx, xq);
      r = rt::combine(xx, xq, qq, metric);
    }
    if (lane == 0) out[static_cast<size_t>(b) * M + j] = r;
  }
}

template <int LAYOUT>
void launch(const float* q, const rt::Rows& t, const int* ids, float* out,
            int B, int M, int n, int metric, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>((t.d + 3) / 4) * sizeof(float4);
  gather_dist_kernel<LAYOUT><<<B, kThreads, smem, stream>>>(q, t, ids, out, M,
                                                             n, metric);
}

}  // namespace

// q f32[B, d], a table of n rows in `layout` (data, aux: see rt::Rows;
// sub = PQ subspaces, else 0), ids int32[B, M] -> out f32[B, M].
RT_API int rt_gather_dist(const void* q, const void* data, const void* aux,
                          const void* ids, void* out, int B, int M, int d,
                          int n, int sub, int layout, int metric,
                          void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  const float* qf = static_cast<const float*>(q);
  const int* idp = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case rt::kF32: launch<rt::kF32>(qf, t, idp, o, B, M, n, metric, s); break;
    case rt::kBF16: launch<rt::kBF16>(qf, t, idp, o, B, M, n, metric, s); break;
    case rt::kF16: launch<rt::kF16>(qf, t, idp, o, B, M, n, metric, s); break;
    case rt::kInt8: launch<rt::kInt8>(qf, t, idp, o, B, M, n, metric, s); break;
    case rt::kPQ: launch<rt::kPQ>(qf, t, idp, o, B, M, n, metric, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
