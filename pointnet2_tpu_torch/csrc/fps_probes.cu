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
// once; `remask` replaces their distance with -1 on every step as well. On
// the H100 the padding is a thread's slots past N (the last block's tail)
// and past its block's slice: with kRemask = false their minimum is seeded
// at -1 once, which no distance (>= 0) lowers and no key of a point beats;
// with kRemask = true every slot starts at 1e38 and a slot past N takes -1
// in place of its distance on every step, one select a slot and step.
// The packed probe asks whether one program serving G clouds pays the
// per-step latency once for G of them. Rows 1 and 6 are bound by the chain
// of npoint-1 dependent exchanges between the blocks of a cluster (0.23-0.27
// us a step on the H100, fps.cu), and a batch of B clouds needs B clusters:
// where they are not all resident at once the plan in ops/cuda/fps.py falls
// back to smaller clusters (more work a block) or runs in waves. Here one
// cluster holds G clouds (G = 2, 4, 8, a template parameter): each thread
// keeps PPT points of each of its G clouds in registers (G x PPT points, 4
// registers each, the budget row 6 has for PPT), a step scans all G and
// makes G warp argmaxes, and the exchange carries G records a warp, so the
// chain is paid once for G clouds and ceil(B / G) clusters hold the batch.
// Its launch plan is row 6's over ceil(B / G) clusters with G x PPT points a
// thread (ops/cuda/probes.py). A slot of the last cluster past B holds no
// point and writes nothing.
//
// What bounds it: the chain, as rows 1 and 6; the work is 10 operations a
// point and step.
//
// Design: rows 1 and 6's (fps.cu's header), with the exchange of
// fps_exchange.cuh. Both kernels are one body, fps_probe<G, PPT, kRemask>:
// the re-masking kernel is its G = 1 case, which with kRemask = false is also
// the packed kernel's G = 1, so the packed kernel is built for G >= 2 only.

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

// Grid: ceil(b / kG) x C blocks in clusters of C, threads a multiple of 32,
// threads * kPPT >= slice = ceil(n / C); shared memory smem_bytes(C,
// threads, kG).
template <int kG, int kPPT, bool kRemask>
__device__ __forceinline__ void fps_probe(const float* __restrict__ xyz, int b, int n, int npoint,
                                          int slice, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  pn2_fps::Exchange<kG> ex(smem, cluster);
  const int first = (int)(blockIdx.x / ex.c) * kG;  // the group's first cloud
  const int lane = threadIdx.x & 31;
  const bool writer = cluster.block_rank() == 0 && threadIdx.x == 0;

  const int local = (threadIdx.x >> 5) * 32 * kPPT + lane * kPPT;  // in the block's slice
  const int base = (int)cluster.block_rank() * slice + local;
  float px[kG][kPPT], py[kG][kPPT], pz[kG][kPPT], md[kG][kPPT];
  float x1[kG], y1[kG], z1[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const bool live = first + g < b;
    const float* pts = xyz + (size_t)(first + g) * n * 3;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int i = base + k;
      const bool in = live && local + k < slice && i < n;
      px[g][k] = in ? pts[i * 3 + 0] : 0.0f;
      py[g][k] = in ? pts[i * 3 + 1] : 0.0f;
      pz[g][k] = in ? pts[i * 3 + 2] : 0.0f;
      md[g][k] = (kRemask || in) ? 1e38f : -1.0f;
    }
    x1[g] = live ? pts[0] : 0.0f;
    y1[g] = live ? pts[1] : 0.0f;
    z1[g] = live ? pts[2] : 0.0f;
  }
  ex.start(cluster, npoint);
  if (writer) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (first + g < b) idx[(size_t)(first + g) * npoint] = 0;
    }
  }

  for (int j = 1; j < npoint; ++j) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float v[kPPT], bx[kPPT], by[kPPT], bz[kPPT];
      int bk[kPPT];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        float d = dist2(px[g][k], py[g][k], pz[g][k], x1[g], y1[g], z1[g]);
        if (kRemask) d = (local + k < slice && base + k < n) ? d : -1.0f;
        md[g][k] = fminf(md[g][k], d);
        v[k] = md[g][k];
        bx[k] = px[g][k];
        by[k] = py[g][k];
        bz[k] = pz[g][k];
        bk[k] = k;
      }
      // Tree argmax over neighbours: the right one wins only when strictly larger.
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
      if constexpr (kG == 1) {
        ex.send_and_wait(j, npoint, lane, wkey, wi, wx, wy, wz);  // row 6's step, as it is
      } else {
        ex.send(j, g, lane, wkey, wi, wx, wy, wz);  // travels while the next cloud is scanned
      }
    }
    if constexpr (kG > 1) ex.wait(j, npoint);

#pragma unroll
    for (int g = 0; g < kG; ++g) {
      Record r;
      float4 p;
      reduce_records(ex.keys + ex.at(j, g), ex.pos + ex.at(j, g), ex.records, lane, r, p);
      x1[g] = p.x;
      y1[g] = p.y;
      z1[g] = p.z;
      if (writer && first + g < b) idx[(size_t)(first + g) * npoint + j] = (int)r.index;
    }
  }
  ex.finish(cluster);
}

template <bool kRemask, int kPPT>
__global__ void __launch_bounds__(PN2_FPS_MAX_THREADS(kPPT))
    fps_remask_kernel(const float* __restrict__ xyz, int b, int n, int npoint, int slice,
                      int* __restrict__ idx) {
  fps_probe<1, kPPT, kRemask>(xyz, b, n, npoint, slice, idx);
}

template <int kG, int kPPT>
__global__ void __launch_bounds__(PN2_FPS_MAX_THREADS(kG * kPPT))
    fps_packed_kernel(const float* __restrict__ xyz, int b, int n, int npoint, int slice,
                      int* __restrict__ idx) {
  fps_probe<kG, kPPT, false>(xyz, b, n, npoint, slice, idx);
}

// The kernel's leave for clusters of 16 and, past 48 KB (the packed
// kernel's records: 2 x G x C x warps x 24 bytes), for its shared memory.
template <auto kKernel>
cudaError_t prepare(int g, int cluster, int threads, int device) {
  const cudaError_t err = allow<kKernel>(device);
  if (err != cudaSuccess) return err;
  const size_t smem = pn2_fps::smem_bytes(cluster, threads, g);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <auto kKernel>
cudaError_t launch(const float* xyz, int b, int n, int npoint, int* idx, int g, int cluster,
                   int threads, int device, cudaStream_t stream) {
  cudaError_t err = prepare<kKernel>(g, cluster, threads, device);
  if (err != cudaSuccess) return err;
  const int slice = (n + cluster - 1) / cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, (b + g - 1) / g, cluster, threads, stream, g);
  err = cudaLaunchKernelEx(&cfg, kKernel, xyz, b, n, npoint, slice, idx);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <auto kKernel>
cudaError_t active(int g, int cluster, int threads, int device, int* out) {
  const cudaError_t err = prepare<kKernel>(g, cluster, threads, device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, cluster, threads, nullptr, g);
  return cudaOccupancyMaxActiveClusters(out, kKernel, &cfg);
}

// The packed instantiations: G x PPT <= 16 points a thread, as row 6's largest PPT.
#define PN2_PACKED_CASES(DO) \
  DO(2, 1) DO(2, 2) DO(2, 4) DO(2, 8) DO(4, 1) DO(4, 2) DO(4, 4) DO(8, 1) DO(8, 2)

cudaError_t check(int b, int n, int npoint, int g, int cluster, int threads, int ppt) {
  const int slice = (n + cluster - 1) / cluster;
  if (b < 1 || n < 1 || npoint < 1 || npoint > n || !valid_plan(cluster, threads, g * ppt) ||
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
int pn2_fps_remask(const float* xyz, int b, int n, int npoint, int* idx, int remask, int cluster,
                   int threads, int ppt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check(b, n, npoint, 1, cluster, threads, ppt);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
#define PN2_REMASK_CASE(P)                                                                       \
  case P:                                                                                        \
    return (int)(remask ? launch<fps_remask_kernel<true, P>>(xyz, b, n, npoint, idx, 1, cluster, \
                                                              threads, device, s)                \
                        : launch<fps_remask_kernel<false, P>>(xyz, b, n, npoint, idx, 1,         \
                                                               cluster, threads, device, s));
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
// cluster: ceil(b / g) clusters of `cluster` blocks of `threads` threads,
// each holding `ppt` points of each of its g clouds (g in 2, 4, 8; g *
// ppt <= 16; threads * ppt >= ceil(n / cluster)). Returns
// cudaGetLastError() after the launch.
int pn2_fps_packed(const float* xyz, int b, int n, int npoint, int* idx, int g, int cluster,
                   int threads, int ppt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check(b, n, npoint, g, cluster, threads, ppt);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
#define PN2_PACKED_LAUNCH(G, P)                                                              \
  if (g == G && ppt == P)                                                                    \
    return (int)launch<fps_packed_kernel<G, P>>(xyz, b, n, npoint, idx, G, cluster, threads, \
                                                 device, s);
  PN2_PACKED_CASES(PN2_PACKED_LAUNCH)
#undef PN2_PACKED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the packed kernel of this shape the device holds at once, into *out.
int pn2_fps_packed_active_clusters(int g, int cluster, int threads, int ppt, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_plan(cluster, threads, g * ppt)) return (int)cudaErrorInvalidValue;
#define PN2_PACKED_ACTIVE(G, P) \
  if (g == G && ppt == P) return (int)active<fps_packed_kernel<G, P>>(G, cluster, threads, device, out);
  PN2_PACKED_CASES(PN2_PACKED_ACTIVE)
#undef PN2_PACKED_ACTIVE
  return (int)cudaErrorInvalidValue;
}

const char* pn2_fps_remask_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_fps_packed_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

const char* pn2_fps_packed_active_clusters_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
