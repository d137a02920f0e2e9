// Edge improvisation (paper Algorithm 1), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/edge_select.py::_edge_select_kernel
// (line 52; pallas_call at line 197), dedup="lazy". Semantics: the port's
// kernels/ref.py::select_edges: for each frontier node (u, L, R), the first
// m_out distinct valid ids of u's packed edge block in flat-position order,
// -1 padded. Bit-identical to the plain version.
//
// Bound on the H100: memory. Each frontier node reads its K = layers*m
// ids (1344 B at n = 1M, m = 16) and writes m_out ids, with a few integer
// ops per id; the least time is F*K*4 + F*m_out*4 bytes (plus the u/L/R
// reads) over the memory rate. Design: one warp per frontier node; the
// row-wide first-covered layer and the skip-layer set are two ballots over
// lanes = layers, then the warp scans the block in 32-id chunks (one
// coalesced 128-byte load each), drops ids already emitted and earlier
// duplicates in the chunk, and emits by ballot rank. The scan stops once
// m_out ids are out, so most rows read only their upper layers. The TPU
// kernel's m_out masked-argmin steps over all K positions do not carry
// over.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
edge_select_kernel(const int* __restrict__ nbrs, const int* __restrict__ us,
                   const int* __restrict__ L, const int* __restrict__ R,
                   int* __restrict__ out, int F, int n, int layers, int m,
                   int logn, int skip_layers, int m_out) {
  extern __shared__ int sel[];  // [kWarps][m_out]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= F) return;  // whole warp
  int* o = sel + warp * m_out;
  rt::warp_select_edges(nbrs, n, layers, m, logn, us[row], L[row], R[row],
                        skip_layers != 0, m_out, o);
  for (int i = lane; i < m_out; i += 32)
    out[static_cast<size_t>(row) * m_out + i] = o[i];
}

}  // namespace

// nbrs int32[n, layers, m], us/L/R int32[F] -> out int32[F, m_out].
RT_API int rt_edge_select(const void* nbrs, const void* us, const void* L,
                          const void* R, void* out, int F, int n, int layers,
                          int m, int logn, int skip_layers, int m_out,
                          void* stream) {
  const int blocks = (F + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * m_out * sizeof(int);
  edge_select_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbrs), static_cast<const int*>(us),
      static_cast<const int*>(L), static_cast<const int*>(R),
      static_cast<int*>(out), F, n, layers, m, logn, skip_layers, m_out);
  return static_cast<int>(cudaGetLastError());
}
