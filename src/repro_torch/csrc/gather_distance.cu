// Gather + masked distance for beam search, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::_gather_dist_kernel
// (line 48; pallas_call at line 200). Semantics: kernels/ref.py::gather_dist
// of the port: out[b, j] = ||x||^2 - 2 x.q_b + ||q_b||^2 (l2) or -x.q_b (ip)
// for x = the decoded table[ids[b, j]], +inf where ids[b, j] < 0. One
// instantiation per stored layout (f32, bf16, f16, int8 + scales, PQ codes
// + codebook: the TPU kernel's static `codec` bodies, lines 98-110) and
// row width (VPL: a lane's 4-element units of a row, 1 at d = 128, 8 at d
// = 1,024, 0 a loop over any d), picked by the one C entry.
//
// Bound on the H100: memory, and the time to have enough of it in flight.
// Each valid id reads one stored row at a random address (512 B f32, 256 B
// bf16/f16, 128 + 4 B int8, 32 B PQ at d = 128; 4 KB f32 at d = 1,024) and
// does 4d flops on it, far below the card's 20 flops per byte; the least
// time is the ids, the queries, the outputs and each distinct row once
// (the PQ codebook once) over the memory rate. Reaching it takes about 2.3
// MB in flight across the card (3.35 TB/s x ~0.7 us), some 35 rows of 512
// B per SM, and the launch's short chain of dependent round trips. The
// main path launches it at four shapes:
//   * the build's sibling search, B = 32,768 (d = 128) or 4,096 (d =
//     1,024) query rows of M = 64 slots, most of them -1 after the first
//     hops; at the lowest levels the rows come from device memory, at the
//     highest a chunk's rows stay in L2;
//   * the entry points, M = 3, at B = 32,768 and 1,000;
//   * the composed hop at the search's frontier, B = 1,000, M = 64;
//   * the server's batch, B = 64, M = 64 at d = 1,024.
// Design: one warp per task, a query row's slots or a part of them
// (kernels/gather_distance.py::plan: a part where B alone would leave
// the SMs short of warps, as at the server's B = 64), 4 warps a CTA and
// no block barrier, so a warp that finishes takes the SM's next task. At
// 64 registers a thread an SM holds 32 warps: 4,224 tasks in flight
// across the card. Two round trips a task:
//   1. each lane loads the ids of two slots (one coalesced read) while
//      cp.async brings the query row into the warp's shared memory;
//   2. a ballot compacts the valid slots into the warp's work list and
//      the -1 slots store +inf at once; the warp then takes R =
//      rows_in_flight rows of the list at a time and issues all their
//      loads before the first FMA (common.cuh warp_dists: 4 rows of 512
//      B in f32 at d = 128, 8 in bf16/f16/int8, 1 row of 4 KB at d =
//      1,024), the decode in registers, the R rows' 2R sums reduced in
//      one transposed butterfly, each result stored by one lane.
// An SM thus keeps 64-128 KB of rows in flight where it has tasks, and a
// task pays its own latency only. What is left at each shape (device
// time with L2 cold on an H100 80GB HBM3 at 700 W, PERF.md §6):
//   * the 1M build's steps reach 54-62% of the distinct-row bound: each
//     row is read once per query row that holds it;
//   * the lm build's low step reads each distinct 4 KB row 3.8 times
//     and 240 MB of them do not stay in L2: it runs at the memory rate of
//     what it reads, 30% of the distinct-row bound;
//   * the entries and the frontier's small rows (int8, PQ) are set by the
//     launch and two round trips a task, not by bytes (7-29%);
//   * the server's 64 queries split into 1,024 tasks: 43%.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a CTA (kernels/gather_distance.py::WARPS)

// Dynamic shared memory of one CTA (kernels/gather_distance.py::
// gather_smem mirrors it for the plan's limit): per warp its query row (dp
// floats) and its work list (row id and slot a valid slot), padded to 16
// bytes.
size_t gather_smem(int d, int slots) {
  const int dp = (d + 3) & ~3;
  return static_cast<size_t>(kWarps) * (dp + ((2 * slots + 3) & ~3)) * 4;
}

// Task w: query row w / split, slots j0 = (w % split) * slots .. + slots
// (at most 64: two a lane).
template <int LAYOUT, int VPL>
__global__ void __launch_bounds__(kWarps * 32,
                                  rt::kMinWarpsPerSM / kWarps)
gather_dist_kernel(const float* __restrict__ q, rt::Rows t,
                   const int* __restrict__ ids, float* __restrict__ out, int B,
                   int M, int n, int metric, int split, int slots) {
  extern __shared__ float4 smem4[];
  const int d = t.d;
  const int dp = (d + 3) & ~3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = reinterpret_cast<float*>(smem4) +
              warp * (dp + ((2 * slots + 3) & ~3));
  int* wid = reinterpret_cast<int*>(qs + dp);
  int* wpos = wid + slots;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= B * split) return;  // the whole warp; no block barrier below
  const int b = task / split, j0 = (task % split) * slots;
  const int ns = min(slots, M - j0);
  const size_t row0 = static_cast<size_t>(b) * M + j0;
  const int id0 = lane < ns ? __ldg(ids + row0 + lane) : -1;
  const int id1 = lane + 32 < ns ? __ldg(ids + row0 + lane + 32) : -1;
  rt::warp_copy_row_async(q + static_cast<size_t>(b) * d, qs, d);

  const unsigned v0 = __ballot_sync(rt::kFull, id0 >= 0);
  const unsigned v1 = __ballot_sync(rt::kFull, id1 >= 0);
  const unsigned below = rt::lanes_below(lane);
  if (id0 >= 0) {
    const int k = __popc(v0 & below);
    wid[k] = min(id0, n - 1);
    wpos[k] = lane;
  } else if (lane < ns) {
    out[row0 + lane] = INFINITY;
  }
  if (id1 >= 0) {
    const int k = __popc(v0) + __popc(v1 & below);
    wid[k] = min(id1, n - 1);
    wpos[k] = lane + 32;
  } else if (lane + 32 < ns) {
    out[row0 + lane + 32] = INFINITY;
  }
  rt::copy_async_wait();
  __syncwarp();
  const float qq = rt::warp_norm2(qs, d);
  rt::warp_dists<LAYOUT, VPL>(t, wid, wpos, __popc(v0) + __popc(v1), 0,
                              rt::rows_in_flight<LAYOUT, VPL>(), qs, qq,
                              metric, out + row0);
}

template <int LAYOUT, int VPL>
int launch(const float* q, const rt::Rows& t, const int* ids, float* out,
           int B, int M, int n, int metric, int split, int slots,
           cudaStream_t stream) {
  // every slot in one task of at most 64 (two a lane)
  if (split < 1 || slots < 1 || slots > 64 ||
      static_cast<long long>(split) * slots < M)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gather_dist_kernel<LAYOUT, VPL>;
  const size_t smem = gather_smem(t.d, slots);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long tasks = static_cast<long long>(B) * split;
  const int grid = static_cast<int>((tasks + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, t, ids, out, B, M, n,
                                              metric, split, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32[B, d], a table of n rows in `layout` (data, aux: see rt::Rows;
// sub = PQ subspaces, else 0), ids int32[B, M] -> out f32[B, M]; a query
// row's slots over `split` tasks of `slots` each (kernels/
// gather_distance.py::plan). The row width's instantiation, the rows in
// flight and the shared memory follow from the table here.
RT_API int rt_gather_dist(const void* q, const void* data, const void* aux,
                          const void* ids, void* out, int B, int M, int d,
                          int n, int sub, int layout, int metric, int split,
                          int slots, void* stream) {
  const rt::Rows t{data, static_cast<const float*>(aux), d, sub,
                   rt::rows_vec(layout, data, aux, d, sub)};
  const float* qf = static_cast<const float*>(q);
  const int* idp = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = rt::vpl_of(layout, d, t.vec);
#define RT_GATHER(LAYOUT, VPL)                                           \
  return launch<LAYOUT, VPL>(qf, t, idp, o, B, M, n, metric, split, slots, \
                             s)
#define RT_GATHER_WIDTHS(LAYOUT)   \
  switch (vpl) {                   \
    case 0: RT_GATHER(LAYOUT, 0);  \
    case 1: RT_GATHER(LAYOUT, 1);  \
    case 8: RT_GATHER(LAYOUT, 8);  \
    default: break;                \
  }                                \
  break
  switch (layout) {
    case rt::kF32: RT_GATHER_WIDTHS(rt::kF32);
    case rt::kBF16: RT_GATHER_WIDTHS(rt::kBF16);
    case rt::kF16: RT_GATHER_WIDTHS(rt::kF16);
    case rt::kInt8: RT_GATHER_WIDTHS(rt::kInt8);
    case rt::kPQ: RT_GATHER(rt::kPQ, 0);
    default: break;
  }
#undef RT_GATHER_WIDTHS
#undef RT_GATHER
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory one CTA of rt_gather_dist takes at (d, slots):
// the bytes the launch asks for, exported so that the plan's Python mirror
// (kernels/gather_distance.py::gather_smem) can be held to it.
RT_API long long rt_gather_smem(int d, int slots) {
  return static_cast<long long>(gather_smem(d, slots));
}
