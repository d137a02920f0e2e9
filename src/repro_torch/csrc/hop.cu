// One whole beam-search hop in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hop.py::_hop_kernel (line 61;
// pallas_call at line 347). Semantics: the port's kernels/ref.py::hop, i.e.
// select_edges -> bitset.test_and_set -> gather_dist for one query's W
// frontier rows: integer outputs (edges, the newly-visited mask, the
// visited words) bit-identical, distances bit-identical to the composed
// hop's (gather_distance.cu runs the same common.cuh warp_dists). One
// instantiation per stored vector layout (f32, bf16, f16, int8 + scales, PQ
// codes + codebook, as the TPU kernel compiles one body per static `codec`,
// hop.py:180-232) and row width (VPL, as in gather_distance.cu), picked by
// the one C entry.
//
// Bound on the H100: memory, and the chain of dependent round trips. Per
// query the hop reads the frontier's edge ids that the selection needs,
// the visited words of the W*m_out candidates, and the stored rows of the
// newly visited ids (512 B f32, 256 B bf16/f16, 128 + 4 B int8, 32 B PQ
// at d = 128; 4 KB f32 at d = 1,024; the PQ codebook counted once), and
// writes the outputs; the least time is those bytes over the memory rate
// (flops are 4d per new row). The main path launches it at the search's
// frontier (B = 1,000 queries, W = 4, m_out = 16, K = 336 edge ids a node
// at n = 1M) and at the server's batch (B = 64, d = 1,024). A design that
// walks an edge block 32 ids at a time, reads one visited word at a time
// and one row per warp at a time pays about 30 round trips a query.
// Design: one CTA per query, so no other CTA touches its visited row and
// there is no cross-CTA race; the plan (kernels/gather_distance.py::plan)
// gives it 4 warps, 16 where B is too small to fill the SMs. Four round
// trips (frontier, edge ids, visited words, rows) in three phases:
//   1. the last warp brings the query row into shared memory by cp.async;
//      one warp per frontier row loads (u, L, R, exp_ok), finds the layers
//      Algorithm 1 scans (two ballots), copies just those layers' edge ids
//      into shared memory by cp.async, all at once, and runs the selection
//      there (common.cuh warp_select_staged, edge_select.cu's code path);
//   2. one thread per candidate slot reads its visited word in GLOBAL
//      memory (at n = 1M a visited row is 125 KB and a hop touches W*m_out
//      words of it, so the TPU kernel's practice of holding the tile's
//      bitset in fast memory does not carry over), drops a slot whose id an
//      earlier slot holds (the lowest slot wins, as in core/bitset.py: a
//      scan of the earlier warps' slots and __match_any_sync within the
//      warp), sets the bits of the new ids with atomicOr (distinct ids can
//      share a word; a slot's own bit is set by no other slot), and a
//      ballot compacts the new ids into a work list;
//   3. the warps take R rows of the list at a time, all their loads in
//      flight, and store each distance, as gather_distance.cu does
//      (warp_dists); the int8 scale of each new id is read beside its
//      row: the counterpart of the TPU kernel's second DMA (hop.py:180-
//      215). The PQ codebook stays in global memory (L1/L2), not copied
//      per CTA.
// At 64 registers a thread an SM holds eight 4-warp CTAs: the 1,000
// queries of the frontier run in one wave. What is left (device time with
// L2 cold on an H100 80GB HBM3 at 700 W, PERF.md §6): the chain of four
// round trips and the selection's steps on shared memory, at 44% of the
// bound at the frontier (f32) and about 34% at the server's 64 queries,
// whose 16 warps a CTA fill only 64 SMs.
// `visited` is updated in place.
#include "common.cuh"

namespace {

// Dynamic shared memory of one CTA (kernels/gather_distance.py::hop_smem
// mirrors it for the plan's limit): the query row (dp floats) and its
// ||q||^2 (16 B), the W frontier rows' edge ids of the scanned layers (K each), per candidate
// slot its selected id, its id if expandable, and the work list's id and
// slot; each frontier row's scanned layers (32), the count.
size_t hop_smem(int d, int W, int K, int m_out) {
  const int dp = (d + 3) & ~3;
  const size_t WM = static_cast<size_t>(W) * m_out;
  return static_cast<size_t>(dp) * 4 + 16 + static_cast<size_t>(W) * K * 4 +
         WM * 16 + static_cast<size_t>(W) * 32 * 4 + 4;
}

template <int LAYOUT, int VPL>
__global__ void __launch_bounds__(rt::kMaxWarps * 32,
                                  rt::kMinWarpsPerSM / rt::kMaxWarps)
hop_kernel(const float* __restrict__ q, rt::Rows t,
           const int* __restrict__ nbrs, const int* __restrict__ u,
           const int* __restrict__ L, const int* __restrict__ R,
           unsigned* __restrict__ visited,
           const unsigned char* __restrict__ exp_ok, int* __restrict__ nbr_out,
           float* __restrict__ dist_out,
           unsigned char* __restrict__ nvalid_out, int W, int n, int layers,
           int m, int logn, int skip_layers, int m_out, int words,
           int metric, int edge_vec) {
  extern __shared__ float4 smem4[];
  const int d = t.d;
  const int dp = (d + 3) & ~3;
  const int K = layers * m;
  const int WM = W * m_out;
  float* qs = reinterpret_cast<float*>(smem4);              // [dp]
  float* qq = qs + dp;                                       // [1], 16 B
  int* blk = reinterpret_cast<int*>(qq + 4);                 // [W][K]
  int* sel = blk + W * K;                                    // [WM]
  int* selm = sel + WM;                                      // [WM]
  int* wid = selm + WM;                                      // [WM]
  int* wpos = wid + WM;                                      // [WM]
  int* lays = wpos + WM;                                     // [W][32]
  int* count = lays + W * 32;                                // [1]

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) *count = 0;
  if (warp == nwarps - 1)
    rt::warp_copy_row_async(q + static_cast<size_t>(b) * d, qs, d);

  // 1. edge improvisation, one warp per frontier row, from shared memory
  for (int w = warp; w < W; w += nwarps) {
    const int row = b * W + w;
    const int us = __ldg(u + row), Lr = __ldg(L + row), Rr = __ldg(R + row);
    const bool ok = __ldg(exp_ok + row) != 0;
    int* o = sel + w * m_out;
    rt::warp_select_staged(nbrs, n, layers, m, logn, skip_layers != 0,
                           edge_vec != 0, us, Lr, Rr, m_out, blk + w * K,
                           lays + w * 32, o);
    for (int i = lane; i < m_out; i += 32) selm[w * m_out + i] = ok ? o[i] : -1;
  }
  rt::copy_async_wait();
  __syncthreads();

  // 2. visited test-and-set with the lowest-slot-wins dedup, one thread a
  // slot (the plan keeps WM <= the CTA's threads)
  if (warp == 0) {
    const float v = rt::warp_norm2(qs, d);
    if (lane == 0) *qq = v;
  }
  unsigned* vis = visited + static_cast<size_t>(b) * words;
  const int j = threadIdx.x;
  const int id = j < WM ? sel[j] : -1;
  const bool valid = j < WM && selm[j] >= 0;
  const unsigned word = valid ? vis[id >> 5] : 0u;
  bool dup = false;
  if (valid)
    for (int i = 0; i < (j & ~31); ++i) dup |= selm[i] == id;
  const unsigned same = __match_any_sync(rt::kFull, valid ? id : -1 - lane);
  dup |= (same & rt::lanes_below(lane)) != 0;
  const bool fresh = valid && !dup && !((word >> (id & 31)) & 1u);
  if (fresh) atomicOr(vis + (id >> 5), 1u << (id & 31));
  float* dist = dist_out + static_cast<size_t>(b) * WM;
  if (j < WM) {
    nbr_out[static_cast<size_t>(b) * WM + j] = id;
    nvalid_out[static_cast<size_t>(b) * WM + j] = fresh;
    if (!fresh) dist[j] = INFINITY;
  }
  const unsigned bal = __ballot_sync(rt::kFull, fresh);
  int base = 0;
  if (lane == 0 && bal) base = atomicAdd(count, __popc(bal));
  base = __shfl_sync(rt::kFull, base, 0);
  if (fresh) {
    const int k = base + __popc(bal & rt::lanes_below(lane));
    wid[k] = min(id, n - 1);
    wpos[k] = j;
  }
  __syncthreads();

  // 3. gather + distance of the newly visited ids, R rows a warp at a time
  constexpr int kRows = rt::rows_in_flight<LAYOUT, VPL>();
  rt::warp_dists<LAYOUT, VPL>(t, wid, wpos, *count, warp * kRows,
                              nwarps * kRows, qs, *qq, metric, dist);
}

template <int LAYOUT, int VPL>
int launch(const float* q, const rt::Rows& t, const int* nbrs, const int* u,
           const int* L, const int* R, unsigned* visited,
           const unsigned char* exp_ok, int* nbr_out, float* dist_out,
           unsigned char* nvalid_out, int B, int W, int n, int layers, int m,
           int logn, int skip_layers, int m_out, int words, int metric,
           int warps, cudaStream_t stream) {
  const int K = layers * m;
  // a thread a candidate slot, at most 32 scanned layers a frontier row
  if (warps < 1 || warps > rt::kMaxWarps || W * m_out > warps * 32 ||
      layers > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int edge_vec = rt::edge_copy_vec(nbrs, m);
  auto kernel = hop_kernel<LAYOUT, VPL>;
  const size_t smem = hop_smem(t.d, W, K, m_out);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<B, warps * 32, smem, stream>>>(
      q, t, nbrs, u, L, R, visited, exp_ok, nbr_out, dist_out, nvalid_out,
      W, n, layers, m, logn, skip_layers, m_out, words, metric, edge_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32[B, d], a table of n rows in `layout` (data, aux: see rt::Rows;
// sub = PQ subspaces, else 0), nbrs int32[n, layers, m], u int32[B, W],
// L/R int32[B*W], visited int32[B, words] (in place), exp_ok bool[B, W]
// -> nbr int32[B, W*m_out], dist f32[B, W*m_out], nvalid bool[B, W*m_out],
// by CTAs of `warps` warps (kernels/gather_distance.py::plan with the hop's
// edges). The row width's instantiation, the rows in flight and the shared
// memory follow from the table and the edges here.
RT_API int rt_hop(const void* q, const void* data, const void* aux,
                  const void* nbrs, const void* u, const void* L,
                  const void* R, void* visited, const void* exp_ok,
                  void* nbr_out, void* dist_out, void* nvalid_out, int B,
                  int W, int n, int d, int sub, int layout, int layers, int m,
                  int logn, int skip_layers, int m_out, int words, int metric,
                  int warps, void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = rt::vpl_of(layout, d, t.vec);
#define RT_HOP(LAYOUT, VPL)                                                  \
  return launch<LAYOUT, VPL>(                                                \
      static_cast<const float*>(q), t, static_cast<const int*>(nbrs),       \
      static_cast<const int*>(u), static_cast<const int*>(L),               \
      static_cast<const int*>(R), static_cast<unsigned*>(visited),          \
      static_cast<const unsigned char*>(exp_ok), static_cast<int*>(nbr_out), \
      static_cast<float*>(dist_out),                                         \
      static_cast<unsigned char*>(nvalid_out), B, W, n, layers, m, logn,    \
      skip_layers, m_out, words, metric, warps, s)
#define RT_HOP_WIDTHS(LAYOUT)   \
  switch (vpl) {                \
    case 0: RT_HOP(LAYOUT, 0);  \
    case 1: RT_HOP(LAYOUT, 1);  \
    case 8: RT_HOP(LAYOUT, 8);  \
    default: break;             \
  }                             \
  break
  switch (layout) {
    case rt::kF32: RT_HOP_WIDTHS(rt::kF32);
    case rt::kBF16: RT_HOP_WIDTHS(rt::kBF16);
    case rt::kF16: RT_HOP_WIDTHS(rt::kF16);
    case rt::kInt8: RT_HOP_WIDTHS(rt::kInt8);
    case rt::kPQ: RT_HOP(rt::kPQ, 0);
    default: break;
  }
#undef RT_HOP_WIDTHS
#undef RT_HOP
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory one CTA of rt_hop takes, exported for the
// plan's Python mirror (kernels/gather_distance.py::hop_smem).
RT_API long long rt_hop_smem(int d, int W, int K, int m_out) {
  return static_cast<long long>(hop_smem(d, W, K, m_out));
}
