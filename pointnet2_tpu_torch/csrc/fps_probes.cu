// The two FPS design probes: index-only farthest point sampling with the
// padding slots re-masked every step, and with G clouds served by one cluster.
//
// Replaces: tools/fps_mask_probe.py:28 `_kernel` (reached through
//           `fps(xyz, npoint, remask)`, :70-104, call :79), entry
//           `pn2_fps_remask`;
//           tools/fps_packed_probe.py:43 `_fps_packed_kernel` (reached
//           through `fps_packed(xyz, npoint, g)`, :91-135, call :112), entry
//           `pn2_fps_packed`.
//
// Semantics: row 6's (fps.cu, `pn2_farthest_point_sample`), bit for bit:
// slot 0 is index 0; each of the npoint-1 steps folds the squared distance
// to the last chosen point, ((x-x1)^2 + (y-y1)^2) + (z-z1)^2 in float32,
// into a running minimum that starts at 1e38, and picks the first index of
// its maximum. Neither variant changes what fps.cu's kernels compute.
//
// What the probes ask. The TPU kernel seeds the padded lanes' minimum at -1
// once; `remask` replaces their distance with -1 on every step as well. The
// packed probe asks whether one program serving G clouds pays the per-step
// latency once for G of them: on the TPU grid programs run one after
// another on one core, so fewer programs cost less.
//
// What bounds it on the H100: the chain of npoint-1 dependent exchanges
// between the blocks of a cluster (each step needs the whole cloud's argmax
// before the next can start), and then the scan's issue rate: about 10
// instructions a point and step with no FMA (bit parity needs `__fmul_rn`
// and `-fmad=false`), some 4096 points an SM and step at the probe shape.
//
// Design. One body, fps_probe<PPT, kRemask>, for both entries: the
// re-masking kernel is its G = 1 case, the packed kernel G = 2, 4, 8 (a
// kernel argument). A cluster of C blocks serves G clouds; each block's
// threads split into G groups of `threads` (a multiple of 32), group g
// holding cloud g's slice [r * slice, (r + 1) * slice) of block r, PPT points
// a thread (row 6's layout within the group: lanes, warps and blocks in index
// order). So a thread holds one cloud's points, the registers are row 6's
// for PPT, and the G clouds' scans run side by side on different warps
// rather than one after another in each thread (G x PPT points stacked in
// each thread would run G warp argmaxes and G record reductions in series).
// A step is:
// - the scan: each thread folds its points' distances into their minima and
//   keeps only the largest minimum (one FMNMX a point); with kRemask, only a
//   warp that holds a slot past the slice or past N replaces those slots'
//   distances with -1 (a warp-uniform choice, made once, between two copies
//   of the step loop): every other warp runs the no-remask loop, so the
//   re-mask costs nothing where no slot is padding, as at the probe shape;
// - the warp argmax: `redux.sync` max of the value's bit pattern + 1, the
//   lowest lane holding it (least index), and in that lane the first of its
//   points holding it; the coordinates come from the block's copy of its
//   slice in shared memory, one 16-byte load, so the scan carries no
//   coordinates or indices (a tree argmax carrying them moves five
//   registers a point);
// - the exchange: lanes 0..C-1 of each warp send its record, (key, x, y, z)
//   as one 16-byte `st.async ... v4.b32` (not a (key, index) pair and a
//   float4, 24 bytes), into its slot in every block of the cluster,
//   counted on the receiving block's mbarrier. The index does not travel:
//   the block and warp that own the winning slot write it from their own
//   copy. One record a block (the warps' winners reduced in shared memory
//   first) made the exchange alone faster and a step slower (and the
//   run-time switch to it, even off, cost 7-19 % a step), and a named
//   barrier a group (`bar.sync 1 + g`, a run-time id) made ptxas reserve
//   all 16 barriers a block (PERF.md §6); neither is kept;
// - one mbarrier phase a step for all G clouds: each block's barrier
//   expects the G x C x W records of 16 bytes, so the chain is paid once for
//   G clouds; a group whose cloud lies past B still sends (key 0) records;
// - every warp reduces its own cloud's records (one load a lane up to 32;
//   slots in index order, ties to the lowest) and takes the winner's
//   coordinates by shuffles.
// Slots and barriers are double-buffered by step parity, as in fps.cu; with
// C = 1 the records go to shared memory behind one __syncthreads. The
// barriers a block's warps may reach from either copy of the step loop are
// `barrier.sync` without `.aligned`. ptxas (-Xptxas -v): 32-64 registers
// up to PPT 8, 98-99 at PPT 16, 1 barrier, no spill; the measured times
// are in PERF.md ("The TPU probe kernels").
// `pn2_fps_probe_chain` runs the exchange alone (the same layout, sends and
// waits, no scan), for timing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

using pn2_fps::allow;
using pn2_fps::dist2;
using pn2_fps::kFull;
using pn2_fps::map_rank;
using pn2_fps::mbar_expect;
using pn2_fps::mbar_init;
using pn2_fps::mbar_wait;
using pn2_fps::smem_u32;
using pn2_fps::valid_plan;

// Shared memory: two mbarriers; [2][g][c x warps] records of 16 bytes
// (key, x, y, z); [g][warps x 32 x ppt] float4 points (ppt = 0: none).
struct Layout {
  int records, points, bytes;  // byte offsets, and the total

  __host__ __device__ Layout(int g, int c, int warps, int ppt) {
    records = 16;
    points = records + 2 * g * c * warps * 16;
    bytes = points + g * warps * 32 * ppt * 16;
  }
};

// __syncthreads without `.aligned`: the threads of a block may reach it from
// different instructions (the re-masking kernel's warps run one of two
// copies of the step loop).
__device__ __forceinline__ void block_sync() { asm volatile("barrier.sync 0;" ::: "memory"); }

// One 16-byte record into the shared memory of a block of the cluster, its
// bytes counted on that block's barrier.
__device__ __forceinline__ void st_async16(unsigned addr, unsigned bar, unsigned key, float x, float y,
                                           float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(
          addr),
      "r"(key), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(__float_as_uint(z)), "r"(bar)
      : "memory");
}

// The records of `records` slots (in index order): the largest key, the
// lowest slot holding it, returned; its coordinates in every lane.
__device__ __forceinline__ int reduce_records(const float4* rec, int records, int lane, float& x, float& y,
                                              float& z) {
  if (records <= 32) {
    const float4 r = lane < records ? rec[lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const unsigned key = __float_as_uint(r.x);
    const unsigned top = __reduce_max_sync(kFull, key);
    const int win = __ffs(__ballot_sync(kFull, key == top)) - 1;
    x = __shfl_sync(kFull, r.y, win);
    y = __shfl_sync(kFull, r.z, win);
    z = __shfl_sync(kFull, r.w, win);
    return win;
  }
  unsigned k2 = 0u;
  int s2 = lane;
  for (int s = lane; s < records; s += 32) {
    const unsigned k = __float_as_uint(rec[s].x);
    if (k > k2) {
      k2 = k;
      s2 = s;
    }
  }
  const unsigned top = __reduce_max_sync(kFull, k2);
  const int win = (int)__reduce_min_sync(kFull, k2 == top ? (unsigned)s2 : 0xffffffffu);
  const float4 r = rec[win];
  x = r.y;
  y = r.z;
  z = r.w;
  return win;
}

// The exchange of one cluster serving `groups` clouds: where a step's
// records lie, how they get there, and who owns the winner.
struct Exchange {
  float4* records;  // [2][groups][stride]
  unsigned bars;
  int c, rank, groups, warps, stride;
  unsigned tx;

  __device__ Exchange(unsigned char* smem, const Layout& lay, const cg::cluster_group& cluster, int groups_,
                      int warps_)
      : groups(groups_), warps(warps_) {
    c = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    stride = c * warps;
    bars = smem_u32(smem);
    records = reinterpret_cast<float4*>(smem + lay.records);
    tx = (unsigned)(groups * stride * 16);
  }

  __device__ int at(int j, int g) const { return ((j & 1) * groups + g) * stride; }

  // Before the first step: the barriers of steps 1 and 2 (parities 1 and 0)
  // set, and every block of the cluster running, before any record is sent.
  __device__ void start(const cg::cluster_group& cluster, int npoint) const {
    if (c == 1) return;
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(bars + 8, tx);
      if (npoint > 2) mbar_expect(bars, tx);
    }
    cluster.sync();
  }

  // Warp w of group g offers its winner (key `key` in every lane, held by
  // lane `src` at the block's slot `slot`) for step j; `coords(slot)` gives
  // a slot's point. Sends the warp's record of the cloud to every block;
  // returns its slot, all lanes.
  template <class Coords>
  __device__ int send(int j, int g, int w, int lane, unsigned key, int src, int slot, Coords coords) {
    const int own = __shfl_sync(kFull, slot, src);
    const int to = at(j, g) + rank * warps + w;
    if (c == 1) {
      if (lane == 0) {
        const float4 p = coords(own);
        records[to] = make_float4(__uint_as_float(key), p.x, p.y, p.z);
      }
      return own;
    }
    if (lane < c) {
      const float4 p = coords(own);
      st_async16(map_rank(smem_u32(records + to), lane), map_rank(bars + 8 * (j & 1), lane), key, p.x, p.y,
                 p.z);
    }
    return own;
  }

  // Until this block holds every record of step j (all groups).
  __device__ void wait(int j, int npoint) const {
    if (c == 1) {
      block_sync();
      return;
    }
    const unsigned bar = bars + 8 * (j & 1);
    mbar_wait(bar, (unsigned)((j - 1) >> 1) & 1u);  // step j is use (j - 1) / 2 of its barrier
    // The phase of step j + 2 on this barrier: no record of it can come
    // before this block has sent its records of step j + 1.
    if (threadIdx.x == 0 && j + 2 < npoint) mbar_expect(bar, tx);
  }

  // Cloud g's winner of step j: its coordinates; whether this block's warp
  // w sent it.
  __device__ bool reduce(int j, int g, int w, int lane, float& x, float& y, float& z) const {
    return reduce_records(records + at(j, g), stride, lane, x, y, z) == rank * warps + w;
  }

  // No block leaves while a record sent to it may be in flight.
  __device__ void finish(const cg::cluster_group& cluster) const {
    if (c > 1) cluster.sync();
  }
};

// The scan of one step: each point's distance to (x1, y1, z1) folded into
// its minimum (kMask: -1 for the slots k >= kv); returns the largest minimum.
template <bool kMask, int kPPT>
__device__ __forceinline__ float scan(const float (&px)[kPPT], const float (&py)[kPPT], const float (&pz)[kPPT],
                                      float (&md)[kPPT], int kv, float x1, float y1, float z1) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    float d = dist2(px[k], py[k], pz[k], x1, y1, z1);
    if (kMask) d = k < kv ? d : -1.0f;
    md[k] = fminf(md[k], d);
    m = k == 0 ? md[0] : fmaxf(m, md[k]);
  }
  return m;
}

// Steps 1..npoint-1 of one warp (kMask: the re-mask in the scan); `out`
// is its cloud's row of idx, null for a cloud past b.
template <bool kMask, int kPPT>
__device__ __forceinline__ void steps(Exchange& ex, const float (&px)[kPPT], const float (&py)[kPPT],
                                      const float (&pz)[kPPT], float (&md)[kPPT], float& x1, float& y1, float& z1,
                                      const float4* points, int kv, int local, int g, int w, int lane, int npoint,
                                      int slice, int* out) {
  for (int j = 1; j < npoint; ++j) {
    const float m = scan<kMask>(px, py, pz, md, kv, x1, y1, z1);
    // Warp argmax: the largest key; the lowest lane holding it has the
    // least index, and in it the first point holding the maximum.
    const unsigned key = m >= 0.0f ? __float_as_uint(m) + 1u : 0u;
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const int src = __ffs(__ballot_sync(kFull, key == wkey)) - 1;
    int first = kPPT - 1;
#pragma unroll
    for (int k = kPPT - 2; k >= 0; --k) first = md[k] == m ? k : first;
    const int own = ex.send(j, g, w, lane, wkey, src, local + first, [points](int slot) { return points[slot]; });
    ex.wait(j, npoint);
    if (ex.reduce(j, g, w, lane, x1, y1, z1) && out != nullptr && lane == 0) out[j] = ex.rank * slice + own;
  }
}

// Grid: ceil(b / groups) x C blocks in clusters of C, groups x threads
// threads (threads a multiple of 32), threads * kPPT >= slice = ceil(n / C);
// shared memory Layout(groups, C, threads / 32, kPPT).bytes.
template <int kPPT, bool kRemask>
__device__ __forceinline__ void fps_probe(const float* __restrict__ xyz, int b, int n, int npoint, int slice,
                                          int groups, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int warps = (int)(blockDim.x / groups) >> 5;
  const int lane = threadIdx.x & 31;
  const int g = (int)(threadIdx.x >> 5) / warps;
  const int w = (int)(threadIdx.x >> 5) - g * warps;
  const Layout lay(groups, (int)cluster.num_blocks(), warps, kPPT);
  Exchange ex(smem, lay, cluster, groups, warps);
  const int cloud = (int)(blockIdx.x / ex.c) * groups + g;
  const bool live = cloud < b;

  // This thread's points: slots local + k of the block's slice, k < kv;
  // past kv (past the slice or n, or a cloud past b) they hold -1 (kRemask:
  // 1e38, and -1 in place of their distance every step).
  const int local = w * 32 * kPPT + lane * kPPT;
  const int base = ex.rank * slice + local;
  const int kv = live ? max(0, min(kPPT, min(slice - local, n - base))) : 0;
  const float* pts = xyz + (size_t)cloud * n * 3;
  float4* points = reinterpret_cast<float4*>(smem + lay.points) + g * warps * 32 * kPPT;
  float px[kPPT], py[kPPT], pz[kPPT], md[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const bool in = k < kv;
    px[k] = in ? pts[(base + k) * 3 + 0] : 0.0f;
    py[k] = in ? pts[(base + k) * 3 + 1] : 0.0f;
    pz[k] = in ? pts[(base + k) * 3 + 2] : 0.0f;
    md[k] = (kRemask || in) ? 1e38f : -1.0f;
    points[local + k] = make_float4(px[k], py[k], pz[k], 0.0f);
  }
  const bool remask = kRemask && __any_sync(kFull, kv < kPPT);  // warp-uniform
  float x1 = live ? pts[0] : 0.0f, y1 = live ? pts[1] : 0.0f, z1 = live ? pts[2] : 0.0f;
  __syncthreads();  // the points' copy
  ex.start(cluster, npoint);
  if (live && ex.rank == 0 && w == 0 && lane == 0) idx[(size_t)cloud * npoint] = 0;

  // A warp runs one copy of the step loop for all steps: one with no
  // padding slot runs the no-remask loop.
  int* out = live ? idx + (size_t)cloud * npoint : nullptr;
  if (remask) {
    steps<true>(ex, px, py, pz, md, x1, y1, z1, points, kv, local, g, w, lane, npoint, slice, out);
  } else {
    steps<false>(ex, px, py, pz, md, x1, y1, z1, points, kv, local, g, w, lane, npoint, slice, out);
  }
  ex.finish(cluster);
}

template <bool kRemask, int kPPT>
__global__ void __launch_bounds__(PN2_FPS_MAX_THREADS(kPPT))
    fps_remask_kernel(const float* __restrict__ xyz, int b, int n, int npoint, int slice, int* __restrict__ idx) {
  fps_probe<kPPT, kRemask>(xyz, b, n, npoint, slice, 1, idx);
}

template <int kPPT>
__global__ void __launch_bounds__(PN2_FPS_MAX_THREADS(kPPT))
    fps_packed_kernel(const float* __restrict__ xyz, int b, int n, int npoint, int slice, int groups,
                      int* __restrict__ idx) {
  fps_probe<kPPT, false>(xyz, b, n, npoint, slice, groups, idx);
}

// The exchange alone: npoint-1 steps of the probes' sends and waits in the
// same layout, no scan, no reduction (as fps.cu's barrier_chain_kernel).
__global__ void fps_probe_chain_kernel(int npoint, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int warps = (int)(blockDim.x / groups) >> 5;
  const int g = (int)(threadIdx.x >> 5) / warps;
  const int w = (int)(threadIdx.x >> 5) - g * warps;
  const Layout lay(groups, (int)cluster.num_blocks(), warps, 0);
  Exchange ex(smem, lay, cluster, groups, warps);
  ex.start(cluster, npoint);
  for (int j = 1; j < npoint; ++j) {
    ex.send(j, g, w, threadIdx.x & 31, 0u, 0, 0, [](int) { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); });
    ex.wait(j, npoint);
  }
  ex.finish(cluster);
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int clusters, int cluster, int threads, size_t smem,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's leave for clusters of 16 and, past 48 KB (a block's points:
// 16 bytes a slot), for its shared memory.
template <auto kKernel>
cudaError_t prepare(size_t smem, int device) {
  const cudaError_t err = allow<kKernel>(device);
  if (err != cudaSuccess) return err;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Shared memory of a block of g groups of `threads` holding ppt points a thread.
size_t smem_of(int g, int cluster, int threads, int ppt) {
  return (size_t)Layout(g, cluster, threads / 32, ppt).bytes;
}

template <auto kKernel, class... Args>
cudaError_t launch(int b, int g, int cluster, int threads, int ppt, int device, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_of(g, cluster, threads, ppt);
  cudaError_t err = prepare<kKernel>(smem, device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(&attr, (b + g - 1) / g, cluster, g * threads, smem, stream);
  err = cudaLaunchKernelEx(&cfg, kKernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <auto kKernel>
cudaError_t active(int g, int cluster, int threads, int ppt, int device, int* out) {
  const size_t smem = smem_of(g, cluster, threads, ppt);
  const cudaError_t err = prepare<kKernel>(smem, device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(&attr, 1, cluster, g * threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, kKernel, &cfg);
}

// g clouds a cluster of `cluster` blocks, each g groups of `threads`
// threads holding ppt points each: the block within row 6's limits for ppt.
bool valid_shape(int g, int cluster, int threads, int ppt) {
  return (g == 1 || g == 2 || g == 4 || g == 8) && threads % 32 == 0 && valid_plan(cluster, g * threads, ppt);
}

cudaError_t check(int b, int n, int npoint, int g, int cluster, int threads, int ppt) {
  const int slice = (n + cluster - 1) / cluster;
  if (b < 1 || n < 1 || npoint < 1 || npoint > n || !valid_shape(g, cluster, threads, ppt) ||
      threads * ppt < slice)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// xyz (b, n, 3) f32 -> idx (b, npoint) i32, row 6's function; remask != 0
// re-masks the slots past n every step. Clusters of `cluster` blocks of
// `threads` threads holding `ppt` points each (threads * ppt >= ceil(n /
// cluster); row 6's plan). Returns cudaGetLastError() after the launch.
int pn2_fps_remask(const float* xyz, int b, int n, int npoint, int* idx, int remask, int cluster, int threads,
                   int ppt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check(b, n, npoint, 1, cluster, threads, ppt);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int slice = (n + cluster - 1) / cluster;
#define PN2_REMASK_CASE(P)                                                                              \
  case P:                                                                                               \
    return (int)(remask ? launch<fps_remask_kernel<true, P>>(b, 1, cluster, threads, P, device, s,    \
                                                             xyz, b, n, npoint, slice, idx) \
                        : launch<fps_remask_kernel<false, P>>(b, 1, cluster, threads, P, device, s,   \
                                                              xyz, b, n, npoint, slice, idx));
  switch (ppt) {
    PN2_REMASK_CASE(1)
    PN2_REMASK_CASE(2)
    PN2_REMASK_CASE(4)
    PN2_REMASK_CASE(8)
    PN2_REMASK_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PN2_REMASK_CASE
}

// xyz (b, n, 3) f32 -> idx (b, npoint) i32, row 6's function, g clouds a
// cluster: ceil(b / g) clusters of `cluster` blocks of g groups of
// `threads` threads, each holding `ppt` points of its group's cloud (g in 1,
// 2, 4, 8; g * threads within row 6's block limit for ppt; threads * ppt >=
// ceil(n / cluster)). Returns cudaGetLastError() after the launch.
int pn2_fps_packed(const float* xyz, int b, int n, int npoint, int* idx, int g, int cluster, int threads, int ppt,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check(b, n, npoint, g, cluster, threads, ppt);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int slice = (n + cluster - 1) / cluster;
#define PN2_PACKED_CASE(P)                                                                                 \
  case P:                                                                                                  \
    return (int)launch<fps_packed_kernel<P>>(b, g, cluster, threads, P, device, s, xyz, b, n, npoint, \
                                             slice, g, idx);
  switch (ppt) {
    PN2_PACKED_CASE(1)
    PN2_PACKED_CASE(2)
    PN2_PACKED_CASE(4)
    PN2_PACKED_CASE(8)
    PN2_PACKED_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PN2_PACKED_CASE
}

// How many clusters of the packed kernel of this shape the device holds at once, into *out.
int pn2_fps_packed_active_clusters(int g, int cluster, int threads, int ppt, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(g, cluster, threads, ppt)) return (int)cudaErrorInvalidValue;
  switch (ppt) {
    case 1:
      return (int)active<fps_packed_kernel<1>>(g, cluster, threads, 1, device, out);
    case 2:
      return (int)active<fps_packed_kernel<2>>(g, cluster, threads, 2, device, out);
    case 4:
      return (int)active<fps_packed_kernel<4>>(g, cluster, threads, 4, device, out);
    case 8:
      return (int)active<fps_packed_kernel<8>>(g, cluster, threads, 8, device, out);
    case 16:
      return (int)active<fps_packed_kernel<16>>(g, cluster, threads, 16, device, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// npoint-1 steps of the probes' exchange alone in `clusters` clusters laid
// out as pn2_fps_packed's (g groups of `threads` threads a block): the
// chain the kernels pay, for timing only. Returns cudaGetLastError().
int pn2_fps_probe_chain(int clusters, int npoint, int g, int cluster, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1 || npoint < 1 || !valid_shape(g, cluster, threads, 1)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(&attr, clusters, cluster, g * threads, smem_of(g, cluster, threads, 0), (cudaStream_t)stream);
  err = allow<fps_probe_chain_kernel>(device);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, fps_probe_chain_kernel, npoint, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pn2_fps_remask_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_fps_packed_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_fps_packed_active_clusters_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_fps_probe_chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
