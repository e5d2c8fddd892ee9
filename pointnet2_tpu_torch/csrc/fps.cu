// Farthest point sampling, with the chosen rows (fps_centroids) or without
// them (farthest_point_sample): one kernel, the rows a template parameter.
//
// Replaces: pointnet2_tpu/ops/pallas/fps.py:89 `_fps_fused_kernel`
//           (reached through `fps_centroids_pallas`, fps.py:168-215), entry
//           `pn2_fps_centroids`;
//           pointnet2_tpu/ops/pallas/fps.py:40 `_fps_kernel` (reached through
//           `farthest_point_sample_pallas`, fps.py:252-283), entry
//           `pn2_farthest_point_sample`. Both give the same indices bit for bit.
//
// Semantics: slot 0 is index 0. Each of the npoint-1 steps folds the squared
// distance to the last chosen point, (x-x1)^2+(y-y1)^2+(z-z1)^2 in float32 and
// in that order, into a running minimum that starts at 1e38, and picks the
// first index of its maximum. The chosen rows are copied out bit for bit.
//
// What bounds it on the H100: neither bytes nor operations but a chain of
// npoint-1 dependent exchanges between the blocks of a cluster. The work
// (about 10 operations a point and step) is some 10 us at SA1 for B=8 and 20
// us for B=16; each step has to see the whole cloud's argmax before the next
// can start, so the least time is npoint-1 times one exchange.
// `pn2_fps_barrier_chain` runs that chain alone, the same layout and
// exchange with no work (`tools/op_bench.py` reports it beside each FPS row
// as `chain_ms`). On an H100 (700 W) at SA1, clusters of 8 blocks of 128
// threads, it takes 0.24-0.28 ms for the 1023 steps (0.23-0.27 us a step)
// against 0.51-0.57 ms for the kernel and 0.010-0.020 ms of operations: the
// kernel runs at about twice its chain bound (PERF.md). A cluster barrier
// (`cluster.sync()`) in place of the exchange below took 0.45-0.85 ms alone.
//
// Design: one thread block cluster of C blocks per cloud (C from the plan in
// ops/cuda/fps.py: the largest power of two up to 16 for which all B clusters
// are resident at once and each block keeps >= 1024 points), so a batch of B
// clouds runs on B x C SMs instead of B. Block r owns the points
// [r * slice, (r + 1) * slice), slice = ceil(N / C); warp w of it the 32 *
// PPT from w * 32 * PPT on, lane l of that the PPT from l * PPT on, so lanes,
// warps and blocks run in index order. Each thread holds its PPT points and
// their running minimum in registers (PPT a template parameter, staged once
// from device memory): a step's scan touches no memory. A step is:
// - the scan, and a tree argmax over the thread's points that keeps the
//   lower index on ties and carries the coordinates;
// - a warp argmax: `redux.sync` max of the value's bit pattern + 1 (monotonic
//   for the non-negative minima), then the lowest lane that holds it
//   (`__ballot_sync`), whose point has the least index; its coordinates and
//   index by shuffles;
// - the exchange: lanes 0..C-1 of each warp store that record into the
//   step's slot of the warp in every block of the cluster with `st.async`,
//   which counts its bytes on the receiving block's barrier (an mbarrier
//   expecting C x W records a step); every warp waits on its own block's
//   barrier. No cluster-wide barrier: a block waits only for the records it
//   needs. With C = 1 the records go to shared memory behind one
//   `__syncthreads`;
// - every warp reduces the C x W records itself (one a lane up to 32: the
//   same max and lowest lane; slots run in index order) and takes the
//   winner's coordinates by shuffles: no load waits on the exchange.
// The slots and the barriers are double-buffered by step parity. A block
// writes parity p again two steps later, and that needs the records of the
// step between, which no block sends before it has read parity p. Only one
// thread writes the output, and no fence or barrier waits for its stores.
// The exchange and the records' reduction live in fps_exchange.cuh, which
// fps_probes.cu shares.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

using pn2_fps::allow;
using pn2_fps::cluster_config;
using pn2_fps::dist2;
using pn2_fps::kFull;
using pn2_fps::Record;
using pn2_fps::reduce_records;
using pn2_fps::valid_plan;
using Exchange = pn2_fps::Exchange<1>;

// kRows: also copy each chosen row to out_xyz (unused, may be null, without).
// Grid: b x C blocks in clusters of C, threads a multiple of 32, threads *
// kPPT >= slice = ceil(n / C).
template <bool kRows, int kPPT>
__global__ void __launch_bounds__(PN2_FPS_MAX_THREADS(kPPT))
    fps_kernel(const float* __restrict__ xyz, int n, int npoint, int slice,
               int* __restrict__ idx, float* __restrict__ out_xyz) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(smem, cluster);
  const int cloud = blockIdx.x / ex.c;
  const int lane = threadIdx.x & 31;
  const float* pts = xyz + (size_t)cloud * n * 3;
  int* idx_b = idx + (size_t)cloud * npoint;
  float* out_b = kRows ? out_xyz + (size_t)cloud * npoint * 3 : nullptr;
  const bool writer = cluster.block_rank() == 0 && threadIdx.x == 0;

  // This thread's points: base + k, k < kPPT; past the slice or n they hold
  // -1, which no running minimum (>= 0) loses to.
  const int local = (threadIdx.x >> 5) * 32 * kPPT + lane * kPPT;  // in the block's slice
  const int base = (int)cluster.block_rank() * slice + local;
  float px[kPPT], py[kPPT], pz[kPPT], md[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int i = base + k;
    const bool in = local + k < slice && i < n;
    px[k] = in ? pts[i * 3 + 0] : 0.0f;
    py[k] = in ? pts[i * 3 + 1] : 0.0f;
    pz[k] = in ? pts[i * 3 + 2] : 0.0f;
    md[k] = in ? 1e38f : -1.0f;
  }
  float x1 = pts[0], y1 = pts[1], z1 = pts[2];
  ex.start(cluster, npoint);
  if (writer) {
    idx_b[0] = 0;
    if (kRows) {
      out_b[0] = x1;
      out_b[1] = y1;
      out_b[2] = z1;
    }
  }

  for (int j = 1; j < npoint; ++j) {
    float v[kPPT], bx[kPPT], by[kPPT], bz[kPPT];
    int bk[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      md[k] = fminf(md[k], dist2(px[k], py[k], pz[k], x1, y1, z1));
      v[k] = md[k];
      bx[k] = px[k];
      by[k] = py[k];
      bz[k] = pz[k];
      bk[k] = k;
    }
    // Tree argmax over neighbours, so the left one always holds the lower
    // indices: the right one wins only when strictly larger.
#pragma unroll
    for (int w = 1; w < kPPT; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < kPPT; k += 2 * w) {
        if (v[k + w] > v[k]) {
          v[k] = v[k + w];
          bx[k] = bx[k + w];
          by[k] = by[k + w];
          bz[k] = bz[k + w];
          bk[k] = bk[k + w];
        }
      }
    }
    // Warp argmax: the largest key; the lowest lane holding it has the least index.
    const unsigned key = v[0] >= 0.0f ? __float_as_uint(v[0]) + 1u : 0u;
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const int src = __ffs(__ballot_sync(kFull, key == wkey)) - 1;
    const float wx = __shfl_sync(kFull, bx[0], src);
    const float wy = __shfl_sync(kFull, by[0], src);
    const float wz = __shfl_sync(kFull, bz[0], src);
    const unsigned wi = (unsigned)__shfl_sync(kFull, base + bk[0], src);

    ex.send_and_wait(j, npoint, lane, wkey, wi, wx, wy, wz);

    // Every warp reduces the cluster's records; slots run in index order.
    const Record* kr = ex.keys + (j & 1) * ex.records;
    const float4* pr = ex.pos + (j & 1) * ex.records;
    Record r;
    float4 p;
    reduce_records(kr, pr, ex.records, lane, r, p);
    x1 = p.x;
    y1 = p.y;
    z1 = p.z;
    if (writer) {
      idx_b[j] = (int)r.index;
      if (kRows) {
        out_b[j * 3 + 0] = x1;
        out_b[j * 3 + 1] = y1;
        out_b[j * 3 + 2] = z1;
      }
    }
  }
  ex.finish(cluster);
}

// The chain alone: npoint-1 exchange steps of the same layout, no work.
__global__ void barrier_chain_kernel(int npoint) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(smem, cluster);
  ex.start(cluster, npoint);
  for (int j = 1; j < npoint; ++j) {
    ex.send_and_wait(j, npoint, threadIdx.x & 31, 0u, 0u, 0.0f, 0.0f, 0.0f);
  }
  ex.finish(cluster);
}

template <bool kRows>
cudaError_t launch_fps(const float* xyz, int b, int n, int npoint, int* idx, float* out_xyz,
                       int cluster, int threads, int ppt, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slice = (n + cluster - 1) / cluster;
  if (!valid_plan(cluster, threads, ppt) || threads * ppt < slice) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, b, cluster, threads, stream);
#define PN2_FPS_CASE(P)                                                                     \
  case P:                                                                                   \
    err = allow<fps_kernel<kRows, P>>(device);                                              \
    if (err != cudaSuccess) return err;                                                     \
    err = cudaLaunchKernelEx(&cfg, fps_kernel<kRows, P>, xyz, n, npoint, slice, idx, out_xyz); \
    break;
  switch (ppt) {
    PN2_FPS_CASE(1)
    PN2_FPS_CASE(2)
    PN2_FPS_CASE(4)
    PN2_FPS_CASE(8)
    PN2_FPS_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef PN2_FPS_CASE
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kRows, int kPPT>
cudaError_t active_clusters(int cluster, int threads, int device, int* out) {
  cudaError_t err = allow<fps_kernel<kRows, kPPT>>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, cluster, threads, nullptr);
  return cudaOccupancyMaxActiveClusters(out, fps_kernel<kRows, kPPT>, &cfg);
}

}  // namespace

extern "C" {

// xyz (b, n, 3) f32 -> idx (b, npoint) i32, out_xyz (b, npoint, 3) f32, in
// clusters of `cluster` blocks of `threads` threads holding `ppt` points
// each (threads * ppt >= ceil(n / cluster); ops/cuda/fps.py `plan`).
// Returns cudaGetLastError() after the launch.
int pn2_fps_centroids(const float* xyz, int b, int n, int npoint, int* idx, float* out_xyz,
                      int cluster, int threads, int ppt, int device, void* stream) {
  return (int)launch_fps<true>(xyz, b, n, npoint, idx, out_xyz, cluster, threads, ppt, device,
                               (cudaStream_t)stream);
}

// xyz (b, n, 3) f32 -> idx (b, npoint) i32. Returns cudaGetLastError().
int pn2_farthest_point_sample(const float* xyz, int b, int n, int npoint, int* idx,
                              int cluster, int threads, int ppt, int device, void* stream) {
  return (int)launch_fps<false>(xyz, b, n, npoint, idx, nullptr, cluster, threads, ppt, device,
                                (cudaStream_t)stream);
}

// How many clusters of this shape the device holds at once, into *out.
int pn2_fps_active_clusters(int rows, int cluster, int threads, int ppt, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_plan(cluster, threads, ppt)) return (int)cudaErrorInvalidValue;
#define PN2_FPS_CASE(P)                                                              \
  case P:                                                                            \
    return (int)(rows ? active_clusters<true, P>(cluster, threads, device, out)      \
                      : active_clusters<false, P>(cluster, threads, device, out));
  switch (ppt) {
    PN2_FPS_CASE(1)
    PN2_FPS_CASE(2)
    PN2_FPS_CASE(4)
    PN2_FPS_CASE(8)
    PN2_FPS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PN2_FPS_CASE
}

// npoint-1 empty exchange steps of b clusters of this shape: the FPS chain's
// latency bound, for timing only. Returns cudaGetLastError().
int pn2_fps_barrier_chain(int b, int npoint, int cluster, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_plan(cluster, threads, 1)) return (int)cudaErrorInvalidValue;
  err = allow<barrier_chain_kernel>(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, b, cluster, threads, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, barrier_chain_kernel, npoint);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pn2_fps_centroids_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_farthest_point_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_fps_active_clusters_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* pn2_fps_barrier_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
