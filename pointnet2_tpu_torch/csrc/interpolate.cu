// three_interpolate forward: out[q, c] = w0*p[i0, c] + w1*p[i1, c] + w2*p[i2, c].
//
// Replaces: pointnet2_tpu/ops/pallas/interpolate.py:48 `_ti_kernel`
//           (reached through `_ti_fwd`, interpolate.py:68-109, and
//           `three_interpolate_pallas`, interpolate.py:187-192).
//
// Semantics: the inverse-distance blend of three gathered feature rows per
// query, accumulated in float32 in the order j = 0, 1, 2 with a rounding
// after every product and sum (no FMA), as the plain PyTorch version does.
//
// What bounds it on the H100: bytes. Each output element costs 5 flops and 4
// bytes written, far below the card's 20 flops a byte; the (B, N, C) output
// is most of the traffic, and the (B, M, C) feature rows, read three times a
// query, stay in the 50 MB L2.
//
// Design: a gather-blend, one thread per output element, consecutive threads
// on consecutive channels, so the writes and the row reads are coalesced and
// a warp reads each query's three indices and weights at one address. The TPU
// kernel instead builds a dense (tile, M) weight block and multiplies it on
// the MXU, because Mosaic has no vector gather; on this card that would do
// M/3 times the work for nothing.

#include <cuda_runtime.h>

namespace {

__global__ void three_interpolate_kernel(const float* __restrict__ points,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ weight, int m,
                                         int n, int c, int total,
                                         float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = t % c;
  const int q = t / c;  // b * n + row
  const float* p = points + (size_t)(q / n) * m * c + ch;
  const int* iq = idx + (size_t)q * 3;
  const float* wq = weight + (size_t)q * 3;
  float acc = __fmul_rn(wq[0], p[(size_t)iq[0] * c]);
  acc = __fadd_rn(acc, __fmul_rn(wq[1], p[(size_t)iq[1] * c]));
  acc = __fadd_rn(acc, __fmul_rn(wq[2], p[(size_t)iq[2] * c]));
  out[t] = acc;
}

}  // namespace

extern "C" {

// points (b, m, c), idx (b, n, 3) i32, weight (b, n, 3) f32 -> out (b, n, c) f32.
// b * n * c must fit in an int. Returns cudaGetLastError() after the launch.
int pn2_three_interpolate(const float* points, const int* idx, const float* weight,
                          int b, int m, int n, int c, float* out, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int total = b * n * c;
  const int blocks = (int)(((long long)total + threads - 1) / threads);
  three_interpolate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      points, idx, weight, m, n, c, total, out);
  return (int)cudaGetLastError();
}

const char* pn2_three_interpolate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
