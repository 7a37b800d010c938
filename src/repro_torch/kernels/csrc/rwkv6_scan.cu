// RWKV6 (Finch) chunked WKV for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:
// _rwkv_kernel and computes what it computes: for each row b and head h,
//   out_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// with w_t = exp(logw_t) and S_{-1} = 0, in chunks of C <= 16 tokens. Per
// chunk, with lc the inclusive and lce the exclusive cumulative log decay
// inside the chunk and a0 = lc_0 (the per-chunk exponent shift):
//   scores[t][j] = (r_t e^(lce_t - a0)) . (k_j e^(a0 - lc_j))  for j < t,
//   scores[t][t] = r_t . (u k_t),
//   out_t = sum_j scores[t][j] v_j + (r_t e^(lce_t)) S,
//   S <- diag(e^(lc_last)) S + sum_j (k_j e^(lc_last - lc_j)) v_j^T.
// The largest exponent, a0 - lc_j, reaches 5 * (C - 1) = 75 for logw >= -5
// at C = 16, under fp32's 88.7; the wrapper refuses larger chunks. It reads
// r, k, v (float32 or bfloat16) and logw, u (float32) in place in their
// (B, T, H, N) and (H, N) layouts and writes out (B, T, H, N) and the last
// state (B, H, N, N) in float32.
//
// What bounds it on this card: operations. At the training cell's shape
// (B=2, T=4096, H=16, N=160, C=16) the work, per row and head, is 4N flop
// for each visible (t, j <= t) pair of a chunk (the score and its product
// with v), N a token for u k, 2N^2 a token for the state update and 2N^2
// a token past the first chunk for the carried state's product: 1.41e10
// flop, 0.211 ms at fp32 SIMT's 67 TFLOP/s; its bytes (r, k, v bf16, logw
// and out fp32, u and the last state) are 297 MB, 0.089 ms at 3.35 TB/s.
// The design:
//  * The TPU ran a grid of (B, H, chunks) with the chunk axis sequential and
//    the (N, N) state in VMEM. Here a loop inside the block walks the
//    chunks, and the state lives in shared memory.
//  * (B * H) blocks would be 32 at the cell's shape, on 132 SMs. A value
//    column m of the state needs only v[:, m], so each block takes 32
//    columns: B * H * ceil(N / 32) blocks (160 at the cell), each keeping
//    its N x 32 fp32 slice of the state (20 KB at N = 160). Each block
//    recomputes the chunk's C x C scores, which span all N.
//  * One thread per key channel n loads a chunk's r, k, v, logw (coalesced
//    over n), walks the cumulative decay and stages the decayed rows in
//    shared memory. Then lane m of each warp owns state column m and keeps
//    v[:, m] of the chunk in registers for the output and the update.
//  * Row strides are padded so the 16-byte loads of the score products
//    fall in distinct banks; shared rows past N are zero.
//  * Ragged T: tokens past T load r = k = v = 0 and logw = 0, which leave
//    the state unchanged, and write nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 16;        // largest chunk
constexpr int kCols = 32;     // state (value) columns per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKoLd = kC + 4; // row stride of the transposed k_out tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Smem {
  float* q;    // [kC][ld]  r_t e^(lce_t - a0)
  float* k;    // [kC][ld]  k_t e^(a0 - lc_t)
  float* ra;   // [kC][ld]  r_t e^(lce_t)
  float* bu;   // [kC][ld]  r_t u k_t
  float* ko;   // [Np][kKoLd]  k_t e^(lc_last - lc_t), transposed
  float* v;    // [kC][kCols]
  float* sc;   // [kC][kC]  scores, the bonus on the diagonal
  float* dec;  // [Np]      e^(lc_last)
  float* st;   // [Np][kCols] the block's state columns
};

__host__ __device__ inline int padded_n(int N) { return (N + 3) & ~3; }

__host__ __device__ inline size_t smem_floats(int N) {
  const int Np = padded_n(N), ld = Np + 4;
  return (size_t)4 * kC * ld + (size_t)Np * kKoLd + kC * kCols + kC * kC +
         Np + (size_t)Np * kCols;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ out,
                 float* __restrict__ s_last, int T_len, int H, int N, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Np = padded_n(N), ld = Np + 4;
  Smem s;
  s.q = smem;
  s.k = s.q + kC * ld;
  s.ra = s.k + kC * ld;
  s.bu = s.ra + kC * ld;
  s.ko = s.bu + kC * ld;
  s.v = s.ko + Np * kKoLd;
  s.sc = s.v + kC * kCols;
  s.dec = s.sc + kC * kC;
  s.st = s.dec + Np;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int col = blockIdx.y * kCols + lane;  // this lane's state column
  const size_t row_stride = (size_t)H * N;    // one token
  const size_t base = (size_t)b * T_len * row_stride + (size_t)h * N;

  // every row and column past N stays 0, as does the state to begin with
  const int total = (int)smem_floats(N);
  for (int i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int n_chunks = (T_len + C - 1) / C;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    // ---- stage the chunk: one thread per key channel n ------------------
    for (int n = tid; n < N; n += kThreads) {
      float rv[kC], kv[kC], lw[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const bool live = t < C && t0 + t < T_len;
        const size_t o = base + (size_t)(t0 + t) * row_stride + n;
        rv[t] = live ? to_f(r[o]) : 0.f;
        kv[t] = live ? to_f(k[o]) : 0.f;
        lw[t] = live ? logw[o] : 0.f;
      }
      const float un = u[h * N + n];
      float lc = 0.f, a0 = 0.f, lcs[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        if (t < C) {
          const float lce = lc;
          lc += lw[t];
          if (t == 0) a0 = lc;
          lcs[t] = lc;
          s.q[t * ld + n] = rv[t] * expf(lce - a0);
          s.k[t * ld + n] = kv[t] * expf(a0 - lc);
          s.ra[t * ld + n] = rv[t] * expf(lce);
          s.bu[t * ld + n] = rv[t] * un * kv[t];
        }
      }
      s.dec[n] = expf(lc);
#pragma unroll
      for (int t = 0; t < kC; ++t)
        if (t < C) s.ko[n * kKoLd + t] = kv[t] * expf(lc - lcs[t]);
    }
    for (int i = tid; i < C * kCols; i += kThreads) {
      const int t = i / kCols, m = blockIdx.y * kCols + i % kCols;
      const bool live = t0 + t < T_len && m < N;
      s.v[i] = live ? to_f(v[base + (size_t)(t0 + t) * row_stride + m]) : 0.f;
    }
    __syncthreads();

    // ---- scores: thread (t, j0) takes (t, j0) and (t, j0 + 8) -----------
    {
      const int t = tid >> 3, j0 = tid & 7;
      if (t < C) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * e;
          if (j >= C) continue;
          float acc = 0.f;
          if (j <= t) {
            const float4* a = reinterpret_cast<const float4*>(
                (j < t ? s.q : s.bu) + t * ld);
            const float4* bq = reinterpret_cast<const float4*>(s.k + j * ld);
            for (int n4 = 0; n4 < Np / 4; ++n4) {
              const float4 x = a[n4];
              if (j < t) {
                const float4 y = bq[n4];
                acc = fmaf(x.x, y.x, acc);
                acc = fmaf(x.y, y.y, acc);
                acc = fmaf(x.z, y.z, acc);
                acc = fmaf(x.w, y.w, acc);
              } else {
                acc += (x.x + x.y) + (x.z + x.w);
              }
            }
          }
          s.sc[t * kC + j] = acc;
        }
      }
    }
    __syncthreads();

    // ---- outputs: lane m, warp w takes rows t = w, w + 4, ... -----------
    float vr[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) vr[j] = j < C ? s.v[j * kCols + lane] : 0.f;
    {
      constexpr int kRows = kC / kWarps;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int n4 = 0; n4 < Np; n4 += 4) {
        const float s0 = s.st[(n4 + 0) * kCols + lane];
        const float s1 = s.st[(n4 + 1) * kCols + lane];
        const float s2 = s.st[(n4 + 2) * kCols + lane];
        const float s3 = s.st[(n4 + 3) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int t = warp + kWarps * i;
          if (t < C) {
            const float4 q =
                *reinterpret_cast<const float4*>(s.ra + t * ld + n4);
            acc[i] = fmaf(q.x, s0, acc[i]);
            acc[i] = fmaf(q.y, s1, acc[i]);
            acc[i] = fmaf(q.z, s2, acc[i]);
            acc[i] = fmaf(q.w, s3, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = warp + kWarps * i;
        if (t < C) {
          float intra = 0.f;
#pragma unroll
          for (int j = 0; j < kC; ++j)
            if (j <= t) intra = fmaf(s.sc[t * kC + j], vr[j], intra);
          if (t0 + t < T_len && col < N)
            out[base + (size_t)(t0 + t) * row_stride + col] = intra + acc[i];
        }
      }
    }
    __syncthreads();  // the outputs read the state the update overwrites

    // ---- state update: lane m, warp w takes key rows n = w, w + 4, ... --
    for (int n = warp; n < N; n += kWarps) {
      const float4* kr = reinterpret_cast<const float4*>(s.ko + n * kKoLd);
      float acc = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kC / 4; ++j4) {
        const float4 x = kr[j4];
        acc = fmaf(x.x, vr[4 * j4 + 0], acc);
        acc = fmaf(x.y, vr[4 * j4 + 1], acc);
        acc = fmaf(x.z, vr[4 * j4 + 2], acc);
        acc = fmaf(x.w, vr[4 * j4 + 3], acc);
      }
      float* sp = s.st + n * kCols + lane;
      *sp = fmaf(s.dec[n], *sp, acc);
    }
    __syncthreads();  // the next chunk restages what this one read
  }

  if (col < N) {
    float* dst = s_last + (size_t)bh * N * N + col;
    for (int n = warp; n < N; n += kWarps)
      dst[(size_t)n * N] = s.st[n * kCols + lane];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* out, void* s_last, int B, int T_len, int H,
           int N, int C, cudaStream_t stream) {
  const size_t bytes = smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kCols - 1) / kCols);
  rwkv6_wkv_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(s_last), T_len, H, N, C);
  return cudaGetLastError();
}

}  // namespace

// r, k, v: (B, T, H, N) of `dtype` (0 float32, 1 bfloat16); logw: (B, T, H,
// N) float32; u: (H, N) float32; all contiguous. out: (B, T, H, N) float32;
// s_last: (B, H, N, N) float32, the state after the last token. C: the
// chunk, 1..16 (min(chunk, T)). Launches on `stream` and returns the CUDA
// error code of the launch (0 on success); does not synchronise.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, void* out,
                                void* s_last, int B, int T, int H, int N,
                                int C, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return cudaSuccess;
  if (T <= 0 || C < 1 || C > kC || N > 256 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, out, s_last, B, T, H, N,
                                 C, st);
  return launch<float>(r, k, v, logw, u, out, s_last, B, T, H, N, C, st);
}
