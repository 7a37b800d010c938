// RG-LRU linear recurrence for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:
// _rglru_kernel and computes what it computes: for each row b and channel
// w, h_t = a_t * h_{t-1} + b_t with h_{-1} = 0, written as y_t (fp32). Its
// reverse mode is the adjoint for the backward: for g = dL/dy,
// c_t = g_t + a_{t+1} * c_{t+1} (c past the end is 0), db_t = c_t and
// da_t = c_t * y_{t-1} (0 at t = 0).
//
// What bounds it on this card: HBM bytes. Each element of a and b is read
// once and each of y written once (the reverse mode reads a, g and y and
// writes da and db), a few operations per element. The design:
//  * One thread per (b, w) channel keeps h (or c) in a register and walks T;
//    the 32 threads of a warp take 32 neighbouring channels, so every step's
//    loads and stores are 128-byte coalesced. On the TPU the state lived in
//    VMEM scratch across the grid's sequential T tiles.
//  * There are only B * W threads (8192 at B=2, W=4096: two warps an SM),
//    so each thread loads kUnroll steps of its inputs into registers before
//    it computes any of them, to keep enough bytes in flight per SM.
//  * No padding: the TPU padded T to its tile with identity steps; here the
//    loop bound handles a ragged T.
//  * Products and sums are rounded one by one (no fused multiply-add), the
//    order of the plain PyTorch version, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_forward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ y, int T, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * T * W + w;
  float h = 0.f;
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t o = base + (size_t)(t0 + u) * W;
      av[u] = t0 + u < T ? __ldg(a + o) : 0.f;
      bv[u] = t0 + u < T ? __ldg(b + o) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        y[base + (size_t)(t0 + u) * W] = h;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_reverse_kernel(const float* __restrict__ a, const float* __restrict__ g,
                     const float* __restrict__ y, float* __restrict__ da,
                     float* __restrict__ db, int T, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * T * W + w;
  float c = 0.f;
  float a_next = 0.f;  // a_{t+1}
  for (int t1 = T - 1; t1 >= 0; t1 -= kUnroll) {
    // steps t1, t1 - 1, ..., t1 - kUnroll + 1
    float av[kUnroll], gv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      const size_t o = base + (size_t)t * W;
      av[u] = t >= 0 ? __ldg(a + o) : 0.f;
      gv[u] = t >= 0 ? __ldg(g + o) : 0.f;
      yv[u] = t >= 1 ? __ldg(y + o - W) : 0.f;  // y_{t-1}
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        c = t == T - 1 ? gv[u] : __fadd_rn(gv[u], __fmul_rn(a_next, c));
        const size_t o = base + (size_t)t * W;
        db[o] = c;
        da[o] = t >= 1 ? __fmul_rn(c, yv[u]) : 0.f;
        a_next = av[u];
      }
    }
  }
}

}  // namespace

// a: (B, T, W) fp32, contiguous. reverse = 0: u = b (input), y the output.
// reverse = 1: u = g = dL/dy (input), y the forward's output (input), da
// and db the outputs. Launches on `stream` and returns the CUDA error code
// of the launch (0 on success); does not synchronise.
extern "C" int rglru_scan_launch(const void* a, const void* u, void* y,
                                 void* da, void* db, int B, int T, int W,
                                 int reverse, void* stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  if (T <= 0 || B > 65535 || (reverse && (da == nullptr || db == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reverse)
    rglru_reverse_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(u),
        static_cast<const float*>(y), static_cast<float*>(da),
        static_cast<float*>(db), T, W);
  else
    rglru_forward_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(u),
        static_cast<float*>(y), T, W);
  return cudaGetLastError();
}
