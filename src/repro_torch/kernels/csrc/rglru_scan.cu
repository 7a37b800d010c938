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
// writes da and db), a few operations per element. Reaching the memory's
// rate takes some 2-3 MB in flight across the card, 20-30 KB an SM, and
// the walk itself is sequential in T. The design:
//  * Each (b, w) channel is walked in T order by one thread that keeps h
//    (or c) in a register, with every product and sum rounded on its own
//    (no fused multiply-add) in the plain PyTorch version's order, so the
//    two agree bit for bit. T is never split: a split would change the
//    order of the roundings.
//  * A block is one warp and owns a stripe of `C` neighbouring channels of
//    one row (C = 32: 128-byte rows, or 16: 64-byte rows, as the host's
//    plan picks to fill every SM). It streams the stripe's (steps x C)
//    tiles of its inputs through a ring of `stages` stages in shared
//    memory with cp.async: before it walks stage k it issues the copies of
//    stage k + stages - 1, so stages - 1 stages (a stage is 2 KB of each
//    input) are in flight while it computes. The TPU kept the state in
//    VMEM scratch across the grid's sequential T tiles; here the ring's
//    depth, not the number of threads, sets the bytes in flight.
//  * A whole stage is walked without a branch, its shared loads issued
//    before its first step: with a branch a step the compiler left half
//    of them inside the walk, and each step waited on one.
//  * Copies are 16 bytes where W % 4 == 0 and every input is 16-byte
//    aligned, else 4 bytes. Rows past T (or before 0) and channels past W
//    are never copied: a ragged T or W needs no padding and no other
//    kernel.
//  * Outputs are stored straight from the walking lanes, one coalesced
//    C * 4-byte row a step.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;          // one warp a block
constexpr int kStageFloats = 512;   // floats of one array a stage holds
constexpr int kMaxStages = 8;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's committed groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Copies one array's rows of a stage into `dst` (S rows of C floats): row
// u holds step t0 + u * dt of the stripe that starts at `src`, if that
// step is in [0, T); only its first `ncols` channels exist.
template <int C, bool kVec>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int T, int W, int t0, int dt,
                                           int ncols) {
  constexpr int kWidth = kVec ? 4 : 1;          // floats a copy
  constexpr int kPerRow = C / kWidth;
  constexpr int kCopies = kStageFloats / kWidth;
  static_assert(kCopies % kLanes == 0, "whole copies a lane");
#pragma unroll
  for (int i = 0; i < kCopies / kLanes; ++i) {
    const int e = threadIdx.x + i * kLanes;
    const int u = e / kPerRow, col = (e % kPerRow) * kWidth;
    const int t = t0 + u * dt;
    if (t >= 0 && t < T && col < ncols) {
      const float* s = src + (size_t)t * W + col;
      if (kVec)
        cp_async16(dst + u * C + col, s);
      else
        cp_async4(dst + u * C + col, s);
    }
  }
}

template <int C, bool kVec>
__global__ void __launch_bounds__(kLanes)
rglru_forward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ y, int T, int W, int stages) {
  constexpr int S = kStageFloats / C;           // steps a stage
  extern __shared__ __align__(16) float ring[];  // stages x {a, b} x S x C
  const int w0 = blockIdx.x * C;
  const int ncols = min(C, W - w0);
  const size_t off = (size_t)blockIdx.y * T * W + w0;
  const int n_stages = (T + S - 1) / S;
  auto issue = [&](int k) {
    if (k < n_stages) {
      float* slot = ring + (k % stages) * 2 * kStageFloats;
      stage_rows<C, kVec>(slot, a + off, T, W, k * S, 1, ncols);
      stage_rows<C, kVec>(slot + kStageFloats, b + off, T, W, k * S, 1,
                          ncols);
    }
    cp_async_commit();        // one group a stage, empty past the end
  };
  for (int k = 0; k < stages - 1; ++k) issue(k);
  const int c = threadIdx.x;
  float* yc = y + off + c;
  float h = 0.f;
  for (int k = 0; k < n_stages; ++k) {
    // the slot refilled here was walked in the last iteration, which
    // every lane has left (the __syncwarp below)
    issue(k + stages - 1);
    cp_async_wait(stages - 1);  // this lane's copies of stage k landed
    __syncwarp();               // and every other lane's
    if (c < ncols) {
      const float* sa = ring + (k % stages) * 2 * kStageFloats + c;
      const float* sb = sa + kStageFloats;
      float* yk = yc + (size_t)k * S * W;
      const int n = min(S, T - k * S);
      if (n == S) {
        // a whole stage: no branch inside, so every shared load is issued
        // ahead of the walk and none waits between two steps
        float av[S], bv[S];
#pragma unroll
        for (int u = 0; u < S; ++u) {
          av[u] = sa[u * C];
          bv[u] = sb[u * C];
        }
#pragma unroll
        for (int u = 0; u < S; ++u) {
          h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
          yk[(size_t)u * W] = h;
        }
      } else {
        for (int u = 0; u < n; ++u) {
          h = __fadd_rn(__fmul_rn(sa[u * C], h), sb[u * C]);
          yk[(size_t)u * W] = h;
        }
      }
    }
    __syncwarp();
  }
}

template <int C, bool kVec>
__global__ void __launch_bounds__(kLanes)
rglru_reverse_kernel(const float* __restrict__ a, const float* __restrict__ g,
                     const float* __restrict__ y, float* __restrict__ da,
                     float* __restrict__ db, int T, int W, int stages) {
  constexpr int S = kStageFloats / C;
  // stages x {a_t, g_t, y_{t-1}} x S x C; row u of stage k is step
  // t = T - 1 - k * S - u: the walk runs from the end
  extern __shared__ __align__(16) float ring[];
  const int w0 = blockIdx.x * C;
  const int ncols = min(C, W - w0);
  const size_t off = (size_t)blockIdx.y * T * W + w0;
  const int n_stages = (T + S - 1) / S;
  auto issue = [&](int k) {
    if (k < n_stages) {
      float* slot = ring + (k % stages) * 3 * kStageFloats;
      const int t1 = T - 1 - k * S;
      stage_rows<C, kVec>(slot, a + off, T, W, t1, -1, ncols);
      stage_rows<C, kVec>(slot + kStageFloats, g + off, T, W, t1, -1,
                          ncols);
      stage_rows<C, kVec>(slot + 2 * kStageFloats, y + off, T, W, t1 - 1,
                          -1, ncols);
    }
    cp_async_commit();
  };
  for (int k = 0; k < stages - 1; ++k) issue(k);
  const int c = threadIdx.x;
  float* dac = da + off + c;
  float* dbc = db + off + c;
  float cs = 0.f;
  float a_next = 0.f;  // a_{t+1}
  for (int k = 0; k < n_stages; ++k) {
    issue(k + stages - 1);
    cp_async_wait(stages - 1);
    __syncwarp();
    if (c < ncols) {
      const float* sa = ring + (k % stages) * 3 * kStageFloats + c;
      const float* sg = sa + kStageFloats;
      const float* sy = sg + kStageFloats;
      const int t1 = T - 1 - k * S;
      if (k > 0 && t1 >= S) {
        // a whole stage past the first step and before the last: no
        // branch inside (see the forward mode)
        float av[S], gv[S], yv[S];
#pragma unroll
        for (int u = 0; u < S; ++u) {
          av[u] = sa[u * C];
          gv[u] = sg[u * C];
          yv[u] = sy[u * C];
        }
#pragma unroll
        for (int u = 0; u < S; ++u) {
          const size_t o = (size_t)(t1 - u) * W;
          cs = __fadd_rn(gv[u], __fmul_rn(a_next, cs));
          dbc[o] = cs;
          dac[o] = __fmul_rn(cs, yv[u]);
          a_next = av[u];
        }
      } else {
        const int n = min(S, t1 + 1);
        for (int u = 0; u < n; ++u) {
          const int t = t1 - u;
          const float gv = sg[u * C];
          cs = t == T - 1 ? gv : __fadd_rn(gv, __fmul_rn(a_next, cs));
          dbc[(size_t)t * W] = cs;
          dac[(size_t)t * W] = t >= 1 ? __fmul_rn(cs, sy[u * C]) : 0.f;
          a_next = sa[u * C];
        }
      }
    }
    __syncwarp();
  }
}

template <int C, bool kVec>
cudaError_t launch(const float* a, const float* u, float* y, float* da,
                   float* db, int B, int T, int W, bool reverse, int stages,
                   cudaStream_t st) {
  const dim3 grid((W + C - 1) / C, B);
  const size_t smem = (size_t)stages * (reverse ? 3 : 2) * kStageFloats *
                      sizeof(float);      // at most 48 KB: no opt-in
  if (reverse)
    rglru_reverse_kernel<C, kVec><<<grid, kLanes, smem, st>>>(
        a, u, y, da, db, T, W, stages);
  else
    rglru_forward_kernel<C, kVec><<<grid, kLanes, smem, st>>>(a, u, y, T, W,
                                                              stages);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

// a: (B, T, W) fp32, contiguous. reverse = 0: u = b (input), y the output.
// reverse = 1: u = g = dL/dy (input), y the forward's output (input), da
// and db the outputs. `channels` (16 or 32) is the stripe a block walks,
// `stages` (2..8) the depth of its ring; both come from the host's plan,
// and any pair gives the same bits. Launches on `stream` and returns the
// CUDA error code of the launch (0 on success); does not synchronise.
extern "C" int rglru_scan_launch(const void* a, const void* u, void* y,
                                 void* da, void* db, int B, int T, int W,
                                 int reverse, int channels, int stages,
                                 void* stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  if (T <= 0 || B > 65535 || (reverse && (da == nullptr || db == nullptr)) ||
      (channels != 16 && channels != 32) || stages < 2 ||
      stages > kMaxStages)
    return cudaErrorInvalidValue;
  // 16-byte copies of the inputs where every row of every stripe starts
  // on 16 bytes; outputs are stored a float at a time
  const bool vec = W % 4 == 0 && aligned16(a) && aligned16(u) &&
                   (!reverse || aligned16(y));
  const auto* fa = static_cast<const float*>(a);
  const auto* fu = static_cast<const float*>(u);
  auto* fy = static_cast<float*>(y);
  auto* fda = static_cast<float*>(da);
  auto* fdb = static_cast<float*>(db);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0;
  if (channels == 32)
    return vec ? launch<32, true>(fa, fu, fy, fda, fdb, B, T, W, rev, stages,
                                  st)
               : launch<32, false>(fa, fu, fy, fda, fdb, B, T, W, rev,
                                   stages, st);
  return vec ? launch<16, true>(fa, fu, fy, fda, fdb, B, T, W, rev, stages,
                                st)
             : launch<16, false>(fa, fu, fy, fda, fdb, B, T, W, rev, stages,
                                 st);
}
