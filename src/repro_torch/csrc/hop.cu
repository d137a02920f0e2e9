// One whole beam-search hop in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hop.py::_hop_kernel (line 61;
// pallas_call at line 347). Semantics: the port's kernels/ref.py::hop, i.e.
// select_edges -> bitset.test_and_set -> gather_dist for one query's W
// frontier rows: integer outputs (edges, the newly-visited mask, the
// visited words) bit-identical, distances to f32 tolerance.
//
// Bound on the H100: memory. Per query the hop reads the frontier's edge
// blocks (W*K ids), the visited words of the W*m_out candidates, and the
// d*4-byte rows of the newly visited ids, and writes the outputs; the
// least time is those bytes over the memory rate (flops are 4d per new
// row). Design: one block per query, so no other block touches that
// query's visited row and there is no cross-block race.
//   1. one warp per frontier row runs rt::warp_select_edges into shared
//      memory;
//   2. one thread per candidate slot does the strictly-earlier in-row dedup
//      (the lowest slot wins, as in core/bitset.py), then tests its bit in
//      the visited row in GLOBAL memory: at n = 1M a row is 125 KB and a
//      hop touches only W*m_out words of it, so the TPU kernel's practice
//      of holding the tile's bitset in fast memory does not carry over;
//      after a barrier the new ids set their bits with atomicOr (distinct
//      ids can share a word);
//   3. one warp per newly visited id gathers its row with 16-byte loads and
//      computes the distance, as gather_distance.cu does.
// `visited` is updated in place.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hop_kernel(const float* __restrict__ q, const float* __restrict__ table,
           const int* __restrict__ nbrs, const int* __restrict__ u,
           const int* __restrict__ L, const int* __restrict__ R,
           unsigned* __restrict__ visited,
           const unsigned char* __restrict__ exp_ok, int* __restrict__ nbr_out,
           float* __restrict__ dist_out,
           unsigned char* __restrict__ nvalid_out, int W, int n, int d,
           int layers, int m, int logn, int skip_layers, int m_out, int words,
           int metric, int vec4) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);           // [dp]
  int* sel = reinterpret_cast<int*>(qs + dp);             // [W * m_out]
  const int WM = W * m_out;
  unsigned char* nv = reinterpret_cast<unsigned char*>(sel + WM);  // [WM]

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  rt::load_query(q + static_cast<size_t>(b) * d, qs, d);

  // 1. edge improvisation, one warp per frontier row
  for (int w = warp; w < W; w += kWarps) {
    const int row = b * W + w;
    rt::warp_select_edges(nbrs, n, layers, m, logn, u[row], L[row], R[row],
                          skip_layers != 0, m_out, sel + w * m_out);
  }
  __syncthreads();

  // 2. visited test-and-set with strictly-earlier in-row dedup
  unsigned* vis = visited + static_cast<size_t>(b) * words;
  const unsigned char* ok = exp_ok + static_cast<size_t>(b) * W;
  for (int j = threadIdx.x; j < WM; j += kThreads) {
    const int id = sel[j];
    const bool valid = id >= 0 && ok[j / m_out];
    bool fresh = valid;
    for (int i = 0; fresh && i < j; ++i)
      fresh = !(sel[i] == id && ok[i / m_out]);
    if (fresh) fresh = !((vis[id >> 5] >> (id & 31)) & 1u);
    nv[j] = fresh;
    nbr_out[static_cast<size_t>(b) * WM + j] = id;
    nvalid_out[static_cast<size_t>(b) * WM + j] = fresh;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < WM; j += kThreads)
    if (nv[j]) atomicOr(vis + (sel[j] >> 5), 1u << (sel[j] & 31));

  // 3. gather + distance of the newly visited ids, one warp per slot
  const float qq = rt::warp_norm2(qs, d);
  for (int j = warp; j < WM; j += kWarps) {
    float r = INFINITY;
    if (nv[j]) {  // uniform over the warp
      float xx, xq;
      rt::row_dots(table + static_cast<size_t>(min(sel[j], n - 1)) * d, qs,
                   d, vec4 != 0, xx, xq);
      r = rt::combine(xx, xq, qq, metric);
    }
    if (lane == 0) dist_out[static_cast<size_t>(b) * WM + j] = r;
  }
}

}  // namespace

// q f32[B, d], table f32[n, d], nbrs int32[n, layers, m], u int32[B, W],
// L/R int32[B*W], visited int32[B, words] (in place), exp_ok bool[B, W]
// -> nbr int32[B, W*m_out], dist f32[B, W*m_out], nvalid bool[B, W*m_out].
RT_API int rt_hop(const void* q, const void* table, const void* nbrs,
                  const void* u, const void* L, const void* R, void* visited,
                  const void* exp_ok, void* nbr_out, void* dist_out,
                  void* nvalid_out, int B, int W, int n, int d, int layers,
                  int m, int logn, int skip_layers, int m_out, int words,
                  int metric, void* stream) {
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  const int dp = (d + 3) & ~3;
  const int WM = W * m_out;
  const size_t smem = static_cast<size_t>(dp) * sizeof(float) +
                      static_cast<size_t>(WM) * (sizeof(int) + 1);
  hop_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table),
      static_cast<const int*>(nbrs), static_cast<const int*>(u),
      static_cast<const int*>(L), static_cast<const int*>(R),
      static_cast<unsigned*>(visited),
      static_cast<const unsigned char*>(exp_ok), static_cast<int*>(nbr_out),
      static_cast<float*>(dist_out), static_cast<unsigned char*>(nvalid_out),
      W, n, d, layers, m, logn, skip_layers, m_out, words, metric, vec4);
  return static_cast<int>(cudaGetLastError());
}
