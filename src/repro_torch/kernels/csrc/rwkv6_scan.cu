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
// The TPU ran a grid of (B, H, chunks) with the chunk axis sequential and
// the (N, N) state in VMEM. Here one call launches two kernels:
//  * The chunk pass, one block per (b, h, chunk), all chunks at once: what
//    does not need the state. It walks each channel's cumulative decay,
//    takes the C x C scores (the bonus on the diagonal) and the intra-chunk
//    output, and writes to an fp32 scratch what the state pass reads: the
//    rows r_t e^(lce_t), k_t e^(lc_last - lc_t), e^(lc_last), v_t and the
//    intra-chunk output, laid out as the state pass's shared memory holds
//    them.
//  * The state pass, one block per (b, h, slice of kCols = 32 state
//    columns), walking the chunks in order: 160 blocks at the cell, where
//    one block per (b, h) would leave 100 SMs idle. A state column m needs
//    only v[:, m], so the slices are independent. Its two products, the
//    inter-chunk (r e^lce) S and the rank-C update k_out^T v, are 16 x 32
//    x N and N x 32 x 16 a chunk: on the SIMT units every operand would be
//    read from shared memory once per multiply-add, and the shared-memory
//    pipe, not the arithmetic, would set the pace (3.35 ms at the cell on
//    an H100 80GB HBM3 at 700 W, chip_smoke.py's timing). So
//    they run on the tensor cores (mma.sync m16n8k8, tf32), each operand
//    split into two tf32 parts and each product taken as three (3xTF32),
//    which keeps fp32's accuracy where one tf32 product (10-bit mantissa)
//    would not. The state stays in the accumulator registers across
//    chunks. Each chunk's rows stream through a ring of three shared-memory
//    buffers by cp.async, two chunks ahead. Its share of the products
//    bounds the pass (about 17 cycles a tf32 mma.sync on a sub-partition).
//  * Ragged T: tokens past T load r = k = v = 0 and logw = 0, which leave
//    the state unchanged, and write nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                       // largest chunk
constexpr int kChunkThreads = 128;           // a chunk block
constexpr int kThreads = 128;                // a state block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                    // state columns a state block
constexpr int kStages = 3;                   // the state pass's ring
constexpr int kVPitch = kCols + 8;           // v rows in shared memory
constexpr int kRedPitch = kC + 1;            // partial product rows
// scratch rows of a chunk: r e^lce, k_out (kC each), e^lc_last, v and the
// intra-chunk output (kC each)
constexpr int kRa = 0, kKo = kC, kDec = 2 * kC, kV = 2 * kC + 1,
              kIntra = 3 * kC + 1, kRows = 4 * kC + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ inline int padded_n(int N) { return (N + 3) & ~3; }
// row pitch of the scratch rows: N rounded up to 8, then to 8 past a
// multiple of 32, so the tensor-core operand loads of the 8 x 4 lanes fall
// in distinct banks
__host__ __device__ inline int state_pitch(int N) {
  const int n8 = (N + 7) & ~7;
  return n8 + ((40 - n8 % 32) % 32);
}
// one buffer of the state pass: the r e^lce, k_out and e^lc_last rows
// whole, and the block's kCols columns of the v and intra-chunk rows
__host__ __device__ inline int state_buf_floats(int N) {
  return (2 * kC + 1) * state_pitch(N) + kC * kVPitch + kC * kCols;
}

__host__ inline size_t chunk_smem_floats(int N) {
  return (size_t)4 * kC * (padded_n(N) + 4) + kC * kC;
}
__host__ inline size_t state_smem_floats(int N) {
  return (size_t)kStages * state_buf_floats(N) +
         kWarps * kCols * kRedPitch;
}

// ----------------------------------------------------------- chunk pass
// Block (b, h, chunk c) of a 1-D grid, chunk fastest: a thread per key
// channel, then per (t, j) score. A channel's 4 x 16 loads are all issued
// before any is used (loading a token at a time, with the stores between,
// left few in flight and took the pass from 0.35 to 0.5 ms on an H100
// 80GB HBM3 at 700 W). Shared rows have a stride of Np + 4 floats, so the
// 16-byte loads of the score products fall in distinct banks; rows and
// columns past C and N stay 0.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, float* __restrict__ scratch,
                   int T_len, int H, int N, int C, int nc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Np = padded_n(N), ld = Np + 4;
  float* q_s = smem;              // [kC][ld]  r_t e^(lce_t - a0)
  float* k_s = q_s + kC * ld;     // [kC][ld]  k_t e^(a0 - lc_t)
  float* bu_s = k_s + kC * ld;    // [kC][ld]  r_t u k_t
  float* v_s = bu_s + kC * ld;    // [kC][ld]
  float* sc = v_s + kC * ld;      // [kC][kC]  scores, the bonus on the diagonal

  const int tid = threadIdx.x;
  const int c = blockIdx.x % nc;
  const int bh = blockIdx.x / nc, b = bh / H, h = bh % H;
  const int t0 = c * C;
  const size_t row_stride = (size_t)H * N;    // one token
  const size_t base = (size_t)b * T_len * row_stride + (size_t)h * N;
  const int P = state_pitch(N);
  // this chunk's scratch rows, zero past C and N
  float* rows = scratch + ((size_t)bh * nc + c) * kRows * P;
  for (int n = Np + tid; n < P; n += kChunkThreads)
    for (int t = 0; t < kRows; ++t) rows[t * P + n] = 0.f;

  // ---- one thread per key channel n: decays, staged and scratch rows ---
  for (int n = tid; n < Np; n += kChunkThreads) {
    float rv[kC], kv[kC], vv[kC], lw[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const bool live = n < N && t < C && t0 + t < T_len;
      const size_t o = base + (size_t)(t0 + t) * row_stride + n;
      rv[t] = live ? to_f(r[o]) : 0.f;
      kv[t] = live ? to_f(k[o]) : 0.f;
      vv[t] = live ? to_f(v[o]) : 0.f;
      lw[t] = live ? logw[o] : 0.f;
    }
    const float un = n < N ? u[h * N + n] : 0.f;
    float lc = 0.f, a0 = 0.f, lcs[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const float lce = lc;
      lc += lw[t];
      if (t == 0) a0 = lc;
      lcs[t] = lc;
      q_s[t * ld + n] = rv[t] * expf(lce - a0);
      k_s[t * ld + n] = kv[t] * expf(a0 - lc);
      bu_s[t * ld + n] = rv[t] * un * kv[t];
      v_s[t * ld + n] = vv[t];
      rows[(kRa + t) * P + n] = rv[t] * expf(lce);
      rows[(kV + t) * P + n] = vv[t];
    }
    rows[kDec * P + n] = expf(lc);
#pragma unroll
    for (int t = 0; t < kC; ++t)
      rows[(kKo + t) * P + n] = kv[t] * expf(lc - lcs[t]);
  }
  __syncthreads();

  // ---- scores (t, j), four partial sums over n each --------------------
  for (int i = tid; i < kC * kC; i += kChunkThreads) {
    const int t = i / kC, j = i % kC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (j <= t) {
      const float4* a = reinterpret_cast<const float4*>(
          (j < t ? q_s : bu_s) + t * ld);
      const float4* bq = reinterpret_cast<const float4*>(k_s + j * ld);
      for (int n4 = 0; n4 < Np / 4; ++n4) {
        const float4 x = a[n4];
        if (j < t) {
          const float4 y = bq[n4];
          acc[0] = fmaf(x.x, y.x, acc[0]);
          acc[1] = fmaf(x.y, y.y, acc[1]);
          acc[2] = fmaf(x.z, y.z, acc[2]);
          acc[3] = fmaf(x.w, y.w, acc[3]);
        } else {
          acc[0] += x.x;
          acc[1] += x.y;
          acc[2] += x.z;
          acc[3] += x.w;
        }
      }
    }
    sc[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();

  // ---- the intra-chunk output: one thread per value channel -------------
  for (int n = tid; n < Np; n += kChunkThreads) {
    float vj[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) vj[j] = v_s[j * ld + n];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j <= t; ++j) acc = fmaf(sc[t * kC + j], vj[j], acc);
      rows[(kIntra + t) * P + n] = acc;
    }
  }
}

// ----------------------------------------------------------- state pass
// 16-byte global -> shared copy; with `pred` false it writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x as big + small, each a tf32 (10-bit mantissa): big + small keeps about
// 21 bits of x, and big*big + big*small + small*big (3xTF32) the product
// to about fp32's accuracy
struct Tf32x2 {
  uint32_t big, small;
};
__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  Tf32x2 r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r.big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(r.small)
      : "f"(x - __uint_as_float(r.big)));
  return r;
}

// c += a * b on the tensor cores: a 16x8 tf32 (row), b 8x8 tf32 (col), c
// 16x8 fp32. Lane 4g + t holds a (g, t), (g+8, t), (g, t+4), (g+8, t+4);
// b (t, g), (t+4, g); c (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// the same in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const Tf32x2 (&a)[4],
                                     Tf32x2 b0, Tf32x2 b1) {
  mma_tf32(c, a[0].small, a[1].small, a[2].small, a[3].small, b0.big,
           b1.big);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b0.small, b1.small);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b0.big, b1.big);
}

// Block (b, h, column slice) of a 1-D grid, slice fastest. The block keeps
// S^T, its kCols = 32 state columns as rows m (two 16-row tiles), in the
// accumulator fragments of 8-column tiles over the key channels n: warp w
// holds tiles nt = w, w + 4, ..., at most MAXT of them. Per chunk, in
// 3xTF32 on the tensor cores:
//   out^T += S^T (r e^lce)^T   M = 32 (m), N = 16 (t), K = the warp's n,
//   S^T <- S^T diag(e^lc_last) + v^T k_out   M = 32, N = 8 a tile, K = 16 (t).
// The first takes S^T's fragments as its A operand as they are, its K axis
// in the order (2t, 2t+1) the accumulator holds; B, r e^lce, is read from
// shared memory in the same order. The warps' partial products meet in
// shared memory, beside the intra-chunk output.
template <typename T, int MAXT>
__global__ void __launch_bounds__(kThreads)
rwkv6_state_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                   float* __restrict__ s_last, int T_len, int H, int N,
                   int C, int nc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NT = (N + 7) / 8;                  // 8-column tiles over n
  const int P = state_pitch(N);
  const int buf_floats = state_buf_floats(N);
  float* red = smem + kStages * buf_floats;    // [kWarps][kCols][kRedPitch]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n_slices = (N + kCols - 1) / kCols;
  const int bh = blockIdx.x / n_slices, b = bh / H, h = bh % H;
  const int col0 = (blockIdx.x % n_slices) * kCols;
  const size_t row_stride = (size_t)H * N;
  const size_t base = (size_t)b * T_len * row_stride + (size_t)h * N;
  const int my_tiles = warp < NT ? (NT - warp + kWarps - 1) / kWarps : 0;

  // chunk c's rows into buffer c % kStages: the first 2 kC + 1 whole (the
  // chunk pass wrote them as the buffer holds them), then the block's
  // columns of the v and intra-chunk rows, zero past the rows' pitch
  auto stage = [&](int c) {
    float* buf = smem + (c % kStages) * buf_floats;
    const float* src = scratch + ((size_t)bh * nc + c) * kRows * P;
    for (int i = 4 * tid; i < (2 * kC + 1) * P; i += 4 * kThreads)
      cp_async16(buf + i, src + i);
    float* vs = buf + (2 * kC + 1) * P;
    float* is = vs + kC * kVPitch;
    for (int i = tid; i < 2 * kC * (kCols / 4); i += kThreads) {
      const int row = i / (kCols / 4), q = 4 * (i % (kCols / 4));
      const bool live = col0 + q < P;
      const int col = live ? col0 + q : 0;
      if (row < kC)
        cp_async16(vs + row * kVPitch + q, src + (kV + row) * P + col, live);
      else
        cp_async16(is + (row - kC) * kCols + q,
                   src + (kIntra + row - kC) * P + col, live);
    }
  };

  float st[MAXT][2][4];
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][mt][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nc) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c is in; every thread is done with c - 1
    if (c + kStages - 1 < nc) stage(c + kStages - 1);
    cp_async_commit();

    const float* buf = smem + (c % kStages) * buf_floats;
    const float* ra = buf + kRa * P;
    const float* ko = buf + kKo * P;
    const float* dec = buf + kDec * P;
    const float* vs = buf + (2 * kC + 1) * P;
    const float* is = vs + kC * kVPitch;
    // v^T, rows m and columns t, the update's A operand for every tile
    Tf32x2 va[2][2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* v0 = vs + (8 * k + tq) * kVPitch + 16 * mt + g;
        va[k][mt][0] = split_tf32(v0[0]);
        va[k][mt][1] = split_tf32(v0[8]);
        va[k][mt][2] = split_tf32(v0[4 * kVPitch]);
        va[k][mt][3] = split_tf32(v0[4 * kVPitch + 8]);
      }
    // out^T partial sums, one set for even and one for odd tiles, so that
    // the dependent tensor-core products run as more, shorter chains
    float acc[2][2][2][4] = {};
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j < my_tiles) {
        const int n0 = 8 * (warp + kWarps * j);
        // out^T += S^T (r e^lce)^T over this tile's 8 channels
        Tf32x2 sa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          sa[mt][0] = split_tf32(st[j][mt][0]);
          sa[mt][1] = split_tf32(st[j][mt][2]);
          sa[mt][2] = split_tf32(st[j][mt][1]);
          sa[mt][3] = split_tf32(st[j][mt][3]);
        }
#pragma unroll
        for (int tn = 0; tn < 2; ++tn) {
          const float2 r2 = *reinterpret_cast<const float2*>(
              ra + (8 * tn + g) * P + n0 + 2 * tq);
          const Tf32x2 b0 = split_tf32(r2.x), b1 = split_tf32(r2.y);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(acc[j & 1][tn][mt], sa[mt], b0, b1);
        }
        // S^T <- S^T diag(e^lc_last) + v^T k_out
        const float2 d = *reinterpret_cast<const float2*>(dec + n0 + 2 * tq);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          st[j][mt][0] *= d.x;
          st[j][mt][1] *= d.y;
          st[j][mt][2] *= d.x;
          st[j][mt][3] *= d.y;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const Tf32x2 b0 = split_tf32(ko[(8 * k + tq) * P + n0 + g]);
          const Tf32x2 b1 = split_tf32(ko[(8 * k + tq + 4) * P + n0 + g]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma3(st[j][mt], va[k][mt], b0, b1);
        }
      }
    }
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* r0 = red + (warp * kCols + 16 * mt + g) * kRedPitch + 8 * tn +
                    2 * tq;
        r0[0] = acc[0][tn][mt][0] + acc[1][tn][mt][0];
        r0[1] = acc[0][tn][mt][1] + acc[1][tn][mt][1];
        r0[8 * kRedPitch] = acc[0][tn][mt][2] + acc[1][tn][mt][2];
        r0[8 * kRedPitch + 1] = acc[0][tn][mt][3] + acc[1][tn][mt][3];
      }
    __syncthreads();
    const int t0 = c * C;
#pragma unroll
    for (int i = 0; i < kC * kCols / kThreads; ++i) {
      const int o = tid + i * kThreads, t = o / kCols, m = o % kCols;
      if (t < C && t0 + t < T_len && col0 + m < N) {
        float x = is[t * kCols + m];
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          x += red[(w * kCols + m) * kRedPitch + t];
        out[base + (size_t)(t0 + t) * row_stride + col0 + m] = x;
      }
    }
  }

  float* dst = s_last + (size_t)bh * N * N;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < my_tiles) {
      const int n = 8 * (warp + kWarps * j) + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nn = n + (e & 1), m = col0 + 16 * mt + g + 8 * (e >> 1);
          if (nn < N && m < N) dst[(size_t)nn * N + m] = st[j][mt][e];
        }
    }
  }
}

template <typename T, int MAXT>
int launch_state(const float* rows, void* out, void* s_last, int B,
                 int T_len, int H, int N, int C, int nc,
                 cudaStream_t stream) {
  const size_t bytes = state_smem_floats(N) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_state_kernel<T, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_slices = (N + kCols - 1) / kCols;
  rwkv6_state_kernel<T, MAXT><<<B * H * n_slices, kThreads, bytes, stream>>>(
      rows, static_cast<float*>(out), static_cast<float*>(s_last), T_len, H,
      N, C, nc);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* out, void* s_last, void* scratch, int B,
           int T_len, int H, int N, int C, cudaStream_t stream) {
  const int nc = (T_len + C - 1) / C;
  float* rows = static_cast<float*>(scratch);

  const size_t chunk_bytes = chunk_smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)chunk_bytes);
  if (err != cudaSuccess) return err;
  rwkv6_chunk_kernel<T><<<B * H * nc, kChunkThreads, chunk_bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), rows, T_len, H, N, C, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the state tiles a warp holds: ceil(ceil(N / 8) / 4), at most 2, 5 or 8
  const int tiles = ((N + 7) / 8 + kWarps - 1) / kWarps;
  if (tiles <= 2)
    return launch_state<T, 2>(rows, out, s_last, B,
                              T_len, H, N, C, nc, stream);
  if (tiles <= 5)
    return launch_state<T, 5>(rows, out, s_last, B,
                              T_len, H, N, C, nc, stream);
  return launch_state<T, 8>(rows, out, s_last, B,
                            T_len, H, N, C, nc, stream);
}

}  // namespace

// r, k, v: (B, T, H, N) of `dtype` (0 float32, 1 bfloat16); logw: (B, T, H,
// N) float32; u: (H, N) float32; all contiguous. out: (B, T, H, N) float32;
// s_last: (B, H, N, N) float32, the state after the last token. scratch:
// float32, 16-byte aligned, of rwkv6_wkv_scratch_floats(B, T, H, N, C)
// elements. C: the chunk, 1..16 (min(chunk, T)). Launches the chunk pass
// and the state pass on `stream` and returns the CUDA error code of the
// launches (0 on success); does not synchronise.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, void* out,
                                void* s_last, void* scratch, int B, int T,
                                int H, int N, int C, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return cudaSuccess;
  if (T <= 0 || C < 1 || C > kC || N > 256 || (dtype != 0 && dtype != 1) ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, out, s_last, scratch, B,
                                 T, H, N, C, st);
  return launch<float>(r, k, v, logw, u, out, s_last, scratch, B, T, H, N,
                       C, st);
}

// float32 elements of the scratch the two passes share: for every (b, h)
// and chunk, kC rows of r e^lce, kC of k e^(lc_last - lc), one of
// e^lc_last, kC of v and kC of the intra-chunk output, each
// state_pitch(N) wide.
extern "C" long long rwkv6_wkv_scratch_floats(int B, int T, int H, int N,
                                              int C) {
  if (B <= 0 || T <= 0 || H <= 0 || N <= 0 || C < 1) return 0;
  return (long long)B * H * ((T + C - 1) / C) * kRows * state_pitch(N);
}
