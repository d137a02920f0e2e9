// Edge improvisation (paper Algorithm 1), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/edge_select.py::_edge_select_kernel
// (line 52; pallas_call at line 197), dedup="lazy". Semantics: the port's
// kernels/ref.py::select_edges: for each frontier node (u, L, R), the first
// m_out distinct valid ids of u's packed edge block in flat-position order,
// -1 padded. Bit-identical to the plain version.
//
// Bound on the H100: memory, and the chain of dependent round trips. Each
// frontier node reads its (u, L, R), the ids of the layers it scans (at
// most K = layers*m: 1344 B at n = 1M, m = 16) and writes m_out ids, with
// a few integer ops per id; the least time is those bytes over the memory
// rate, some 0.0006 ms at the search's frontier (F = 4,000). A launch that
// reads its inputs in two dependent round trips cannot take less than the
// two round trips (chip_smoke.py measures that floor with edge_floor_kernel
// below). A design that walks the edge block 32 ids at a time from global
// memory, the positions of unscanned layers included, pays up to K / 32
// round trips a node. Design: CTAs of kWarps warps, one frontier row a
// warp; the CTA loads its rows' (u, L, R) in one go (round trip 1); each
// warp then finds the layers Algorithm 1 scans (two ballots), copies just
// those layers' ids into its K-int slice of shared memory by cp.async, all
// at once (round trip 2), and selects there: common.cuh warp_select_staged,
// the fused hop's phase 1 (hop.cu), so both run one code path. The TPU
// kernel's m_out masked-argmin steps over all K positions do not carry
// over.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Dynamic shared memory of one CTA (kernels/edge_select.py::edge_smem
// mirrors it for the budget check): per warp a K-int slice of edge ids,
// its m_out selected ids and the 32 scanned layers' indices; the CTA's
// (u, L, R).
size_t edge_smem(int K, int m_out) {
  return (static_cast<size_t>(kWarps) * (K + m_out + 32) + 3 * kWarps) *
         sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
edge_select_kernel(const int* __restrict__ nbrs, const int* __restrict__ us,
                   const int* __restrict__ L, const int* __restrict__ R,
                   int* __restrict__ out, int F, int n, int layers, int m,
                   int logn, int skip_layers, int m_out, int vec) {
  extern __shared__ int4 smem4[];
  const int K = layers * m;
  int* blk = reinterpret_cast<int*>(smem4);  // [kWarps][K], 16-byte aligned
  int* sel = blk + kWarps * K;               // [kWarps][m_out]
  int* lays = sel + kWarps * m_out;          // [kWarps][32]
  int* ulr = lays + kWarps * 32;             // [3][kWarps]: u, L, R
  const int row0 = blockIdx.x * kWarps;
  const int t = threadIdx.x;
  if (t < 3 * kWarps) {
    const int r = row0 + t % kWarps;
    const int* src = t < kWarps ? us : t < 2 * kWarps ? L : R;
    ulr[t] = r < F ? __ldg(src + r) : -1;
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const int row = row0 + warp;
  if (row >= F) return;  // whole warp; no block barrier follows
  int* o = sel + warp * m_out;
  rt::warp_select_staged(nbrs, n, layers, m, logn, skip_layers != 0,
                         vec != 0, ulr[warp], ulr[kWarps + warp],
                         ulr[2 * kWarps + warp], m_out, blk + warp * K,
                         lays + warp * 32, o);
  for (int i = lane; i < m_out; i += 32)
    out[static_cast<size_t>(row) * m_out + i] = o[i];
}

// The design's latency floor, for measurement only (no path launches it):
// the same CTAs and the same two dependent round trips -- each row's u,
// then the first 32 ids of u's edge block -- and no selection; out[row] =
// the sum of those ids, so that no load is dead.
__global__ void __launch_bounds__(kThreads)
edge_floor_kernel(const int* __restrict__ nbrs, const int* __restrict__ us,
                  int* __restrict__ out, int F, int n, int K) {
  __shared__ int u_s[kWarps];
  const int row0 = blockIdx.x * kWarps;
  const int t = threadIdx.x;
  if (t < kWarps) u_s[t] = row0 + t < F ? __ldg(us + row0 + t) : 0;
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const int row = row0 + warp;
  if (row >= F) return;
  const int u = min(max(u_s[warp], 0), n - 1);
  const int v = lane < K ? __ldg(nbrs + static_cast<size_t>(u) * K + lane)
                         : 0;
  const int s = __reduce_add_sync(rt::kFull, v);
  if (lane == 0) out[row] = s;
}

}  // namespace

// nbrs int32[n, layers, m], us/L/R int32[F] -> out int32[F, m_out].
RT_API int rt_edge_select(const void* nbrs, const void* us, const void* L,
                          const void* R, void* out, int F, int n, int layers,
                          int m, int logn, int skip_layers, int m_out,
                          void* stream) {
  if (layers > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = edge_smem(layers * m, m_out);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        edge_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = (F + kWarps - 1) / kWarps;
  const int* table = static_cast<const int*>(nbrs);
  edge_select_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int*>(us), static_cast<const int*>(L),
      static_cast<const int*>(R), static_cast<int*>(out), F, n, layers, m,
      logn, skip_layers, m_out, rt::edge_copy_vec(table, m));
  return static_cast<int>(cudaGetLastError());
}

// The latency floor's probe: nbrs int32[n, K], us int32[F] -> out int32[F].
RT_API int rt_edge_floor(const void* nbrs, const void* us, void* out, int F,
                         int n, int K, void* stream) {
  const int blocks = (F + kWarps - 1) / kWarps;
  edge_floor_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbrs), static_cast<const int*>(us),
      static_cast<int*>(out), F, n, K);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory one CTA of rt_edge_select takes at K edge ids
// a frontier row, exported for kernels/edge_select.py::edge_smem.
RT_API long long rt_edge_smem(int K, int m_out) {
  return static_cast<long long>(edge_smem(K, m_out));
}
