// The cluster exchange of the FPS kernels, shared by fps.cu (rows 1 and 6)
// and fps_probes.cu (the re-masking and packed probes): the per-step records,
// their `st.async` delivery counted on an mbarrier of each receiving block,
// the reduction of a step's records, and the launch helpers. fps.cu's header
// comment describes the design; the packed kernel sends kG records a warp
// and step (one a cloud), the others one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pn2_fps {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

struct Record {
  unsigned key;  // bit pattern of the running minimum + 1; 0 for no point
  unsigned index;
};
constexpr int kRecordBytes = (int)(sizeof(Record) + sizeof(float4));
constexpr int kBarrierBytes = 16;  // two mbarriers, one a parity

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float x1, float y1, float z1) {
  // Explicit round-to-nearest ops: no FMA contraction, so the sum is the
  // oracle's ((dx*dx + dy*dy) + dz*dz) bit for bit.
  const float dx = __fsub_rn(x, x1);
  const float dy = __fsub_rn(y, y1);
  const float dz = __fsub_rn(z, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The largest block for `regs` points a thread (4 registers a point): 64
// registers a thread at 1024 threads, 128 at 512.
#define PN2_FPS_MAX_THREADS(regs) ((regs) <= 4 ? 1024 : 512)

// Two barriers, then [2][g][records] (key, index) pairs and [2][g][records] coordinates.
inline size_t smem_bytes(int cluster, int threads, int g = 1) {
  return kBarrierBytes + 2 * (size_t)g * cluster * (threads / 32) * kRecordBytes;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// One arrival, and tx more bytes to come, for the barrier's current phase.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tx)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0u;
}

// Until the phase of this parity has completed; acquires what the remote
// blocks stored with it. A phase that never completes (a fault in the
// exchange) traps after some seconds rather than hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 32)) __trap();  // some 2 s at the H100's clocks
  }
}

// A record into the shared memory of a block of the cluster, its bytes
// counted on that block's barrier.
__device__ __forceinline__ void st_async(unsigned key_addr, unsigned pos_addr, unsigned bar,
                                         unsigned key, unsigned index, float x, float y,
                                         float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];" ::"r"(
          key_addr),
      "r"(key), "r"(index), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(pos_addr),
      "f"(x), "f"(y), "f"(z), "f"(0.0f), "r"(bar)
      : "memory");
}

// The cluster's records of one step, kG a warp (one a cloud): where they lie
// and how they get there.
template <int kG>
struct Exchange {
  Record* keys;   // [2][kG][records]
  float4* pos;    // [2][kG][records]
  unsigned bars;  // two barriers
  int c, records, slot;
  unsigned tx;  // bytes a block receives a step

  __device__ Exchange(unsigned char* smem, const cg::cluster_group& cluster) {
    c = (int)cluster.num_blocks();
    const int warps = blockDim.x >> 5;
    records = c * warps;
    slot = (int)cluster.block_rank() * warps + (threadIdx.x >> 5);
    bars = smem_u32(smem);
    keys = reinterpret_cast<Record*>(smem + kBarrierBytes);
    pos = reinterpret_cast<float4*>(keys + 2 * kG * records);
    tx = (unsigned)(kG * records * kRecordBytes);
  }

  // Where cloud g's records of step j lie: records in index order.
  __device__ int at(int j, int g) const { return ((j & 1) * kG + g) * records; }

  // Before the first step: the barriers of steps 1 and 2 (parities 1 and 0)
  // set, and every block of the cluster running, before any record is sent.
  __device__ void start(const cg::cluster_group& cluster, int npoint) {
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

  // One record a warp (kG = 1): the warp's record of step j to every block
  // (lanes 0..C-1 send one each); returns when this block holds all records
  // of step j. Rows 1 and 6 take this body as it is: the same work split
  // into send() and wait() cost row 1 a register and 16 % at SA1, B=16 on
  // the H100 (PERF.md, the probe kernels).
  __device__ void send_and_wait(int j, int npoint, int lane, unsigned key, unsigned index, float x,
                                float y, float z) {
    static_assert(kG == 1, "send_and_wait sends one record a warp");
    const int par = j & 1;
    const int at = par * records + slot;
    if (c == 1) {
      if (lane == 0) {
        keys[at] = Record{key, index};
        pos[at] = make_float4(x, y, z, 0.0f);
      }
      __syncthreads();
      return;
    }
    const unsigned bar = bars + 8 * par;
    if (lane < c) {
      st_async(map_rank(smem_u32(keys + at), lane), map_rank(smem_u32(pos + at), lane),
               map_rank(bar, lane), key, index, x, y, z);
    }
    mbar_wait(bar, (unsigned)((j - 1) >> 1) & 1u);  // step j is use (j - 1) / 2 of its barrier
    // The phase of step j + 2 on this barrier: no record of it can come
    // before this block has sent its records of step j + 1.
    if (threadIdx.x == 0 && j + 2 < npoint) mbar_expect(bar, tx);
  }

  // kG records a warp: the warp's record of cloud g at step j to every block
  // (lanes 0..C-1 send one each); wait() then returns when this block holds
  // all records of step j.
  __device__ void send(int j, int g, int lane, unsigned key, unsigned index, float x, float y,
                       float z) {
    const int to = at(j, g) + slot;
    if (c == 1) {
      if (lane == 0) {
        keys[to] = Record{key, index};
        pos[to] = make_float4(x, y, z, 0.0f);
      }
      return;
    }
    if (lane < c) {
      st_async(map_rank(smem_u32(keys + to), lane), map_rank(smem_u32(pos + to), lane),
               map_rank(bars + 8 * (j & 1), lane), key, index, x, y, z);
    }
  }

  __device__ void wait(int j, int npoint) {
    if (c == 1) {
      __syncthreads();
      return;
    }
    const unsigned bar = bars + 8 * (j & 1);
    mbar_wait(bar, (unsigned)((j - 1) >> 1) & 1u);
    if (threadIdx.x == 0 && j + 2 < npoint) mbar_expect(bar, tx);
  }

  // No block leaves while a record sent to it may be in flight.
  __device__ void finish(const cg::cluster_group& cluster) {
    if (c > 1) cluster.sync();
  }
};

// Every warp reduces `records` records itself (slots in index order): the
// largest key, the lowest slot holding it; its index and coordinates in
// every lane.
__device__ __forceinline__ void reduce_records(const Record* kr, const float4* pr, int records,
                                               int lane, Record& r, float4& p) {
  if (records <= 32) {
    r = lane < records ? kr[lane] : Record{0u, 0u};
    p = lane < records ? pr[lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const unsigned gkey = __reduce_max_sync(kFull, r.key);
    const int win = __ffs(__ballot_sync(kFull, r.key == gkey)) - 1;
    r.index = (unsigned)__shfl_sync(kFull, (int)r.index, win);
    p.x = __shfl_sync(kFull, p.x, win);
    p.y = __shfl_sync(kFull, p.y, win);
    p.z = __shfl_sync(kFull, p.z, win);
  } else {
    unsigned k2 = 0u;
    int s2 = lane;
    for (int s = lane; s < records; s += 32) {
      const unsigned k = kr[s].key;
      if (k > k2) {
        k2 = k;
        s2 = s;
      }
    }
    const unsigned gkey = __reduce_max_sync(kFull, k2);
    const unsigned gs = __reduce_min_sync(kFull, k2 == gkey ? (unsigned)s2 : 0xffffffffu);
    r = kr[gs];
    p = pr[gs];
  }
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int b, int cluster,
                                         int threads, cudaStream_t stream, int g = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(cluster, threads, g);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of 16 (past the portable 8) need the kernel's leave, once a device.
template <auto kKernel>
cudaError_t allow(int device) {
  static unsigned done = 0u;  // a bit a device, for this kernel
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (bit && (done & bit)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// `regs`: the points a thread holds (PPT, or G x PPT for the packed kernel).
inline bool valid_plan(int cluster, int threads, int regs) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         threads >= 32 && threads % 32 == 0 && threads <= PN2_FPS_MAX_THREADS(regs);
}

}  // namespace pn2_fps
