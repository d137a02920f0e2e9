// One whole beam-search hop in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hop.py::_hop_kernel (line 61;
// pallas_call at line 347). Semantics: the port's kernels/ref.py::hop, i.e.
// select_edges -> bitset.test_and_set -> gather_dist for one query's W
// frontier rows: integer outputs (edges, the newly-visited mask, the
// visited words) bit-identical, distances to f32 tolerance. One
// instantiation per stored vector layout (f32, bf16, f16, int8 + scales, PQ
// codes + codebook), as the TPU kernel compiles one body per static `codec`
// (hop.py:180-232), picked by the one C entry.
//
// Bound on the H100: memory. Per query the hop reads the frontier's edge
// blocks (W*K ids), the visited words of the W*m_out candidates, and the
// d*4-byte rows of the newly visited ids, and writes the outputs; the
// least time is those bytes over the memory rate (flops are 4d per new
// row); a new row is 512 B f32, 256 B bf16/f16, 128 + 4 B int8, 32 B PQ
// at d = 128 (the PQ codebook counted once). Design: one block per query, so no other block touches that
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
//   3. one warp per newly visited id gathers its stored row, decodes it in
//      registers and computes the distance with the same device function
//      as gather_distance.cu (common.cuh row_dots). The int8 scale of each
//      new id is read here, beside its row: the counterpart of the TPU
//      kernel's second DMA (hop.py:180-215), which exists there because
//      the ids are found inside the kernel. The PQ codebook stays in
//      global memory (L1/L2), not copied per block: one block per query
//      would copy it 1,000 times per hop.
// `visited` is updated in place.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const float* __restrict__ q, rt::Rows t,
           const int* __restrict__ nbrs, const int* __restrict__ u,
           const int* __restrict__ L, const int* __restrict__ R,
           unsigned* __restrict__ visited,
           const unsigned char* __restrict__ exp_ok, int* __restrict__ nbr_out,
           float* __restrict__ dist_out,
           unsigned char* __restrict__ nvalid_out, int W, int n, int layers,
           int m, int logn, int skip_layers, int m_out, int words,
           int metric) {
  extern __shared__ float4 smem4[];
  const int d = t.d;
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
      rt::row_dots<LAYOUT>(t, min(sel[j], n - 1), qs, xx, xq);
      r = rt::combine(xx, xq, qq, metric);
    }
    if (lane == 0) dist_out[static_cast<size_t>(b) * WM + j] = r;
  }
}

}  // namespace

// q f32[B, d], a table of n rows in `layout` (data, aux: see rt::Rows;
// sub = PQ subspaces, else 0), nbrs int32[n, layers, m], u int32[B, W],
// L/R int32[B*W], visited int32[B, words] (in place), exp_ok bool[B, W]
// -> nbr int32[B, W*m_out], dist f32[B, W*m_out], nvalid bool[B, W*m_out].
RT_API int rt_hop(const void* q, const void* data, const void* aux,
                  const void* nbrs, const void* u, const void* L,
                  const void* R, void* visited, const void* exp_ok,
                  void* nbr_out, void* dist_out, void* nvalid_out, int B,
                  int W, int n, int d, int sub, int layout, int layers, int m,
                  int logn, int skip_layers, int m_out, int words, int metric,
                  void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  const int dp = (d + 3) & ~3;
  const int WM = W * m_out;
  const size_t smem = static_cast<size_t>(dp) * sizeof(float) +
                      static_cast<size_t>(WM) * (sizeof(int) + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_HOP_LAUNCH(LAYOUT)                                                \
  hop_kernel<LAYOUT><<<B, kThreads, smem, s>>>(                              \
      static_cast<const float*>(q), t, static_cast<const int*>(nbrs),       \
      static_cast<const int*>(u), static_cast<const int*>(L),               \
      static_cast<const int*>(R), static_cast<unsigned*>(visited),          \
      static_cast<const unsigned char*>(exp_ok), static_cast<int*>(nbr_out), \
      static_cast<float*>(dist_out),                                         \
      static_cast<unsigned char*>(nvalid_out), W, n, layers, m, logn,        \
      skip_layers, m_out, words, metric)
  switch (layout) {
    case rt::kF32: RT_HOP_LAUNCH(rt::kF32); break;
    case rt::kBF16: RT_HOP_LAUNCH(rt::kBF16); break;
    case rt::kF16: RT_HOP_LAUNCH(rt::kF16); break;
    case rt::kInt8: RT_HOP_LAUNCH(rt::kInt8); break;
    case rt::kPQ: RT_HOP_LAUNCH(rt::kPQ); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_HOP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
