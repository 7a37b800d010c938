// Flash attention (training and prefill forward) for Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel and computes what it computes: query head h reading KV
// head h / G, query i attending keys j < Skv with j <= i (causal, Sq ==
// Skv) and j > i - window (with a window), or with j < prefix whatever
// the band says (PaliGemma's prefix-LM rule); without causality Sq and Skv
// may differ (an encoder, a decoder's cross-attention). Scores are taken
// in fp32, scaled and softcapped, c*tanh(s/c), before the mask; the
// softmax is online in fp32, a row that sees no key gives 0 (acc / max(l,
// 1e-30)), and the output is written in q's dtype. It also writes each
// row's fp32 log-sum-exp, m + log(l) (1e30 for a row that sees no key),
// which the backward needs.
//
// What bounds it on this card: operations. At the training shapes (S =
// 4096, D = 128 or 256) each (query, key) pair costs 4*D operations and
// each key is reused by up to thousands of queries, far above the card's
// 295 operations per byte. Both designs below share:
//  * q, k and v are read in place in their (B, S, heads, D) layout, with a
//    stride of heads*D between positions; the TPU wrapper transposed them to
//    (B, H, S, D) and padded S, these kernels mask the ragged tail instead.
//  * One block per (tile of query rows, query head, b). The block walks
//    only the key tiles its rows can see, [max(0, q0 - window + 1),
//    min(Skv, q0 + rows)) for causal layers: the TPU's grid skip of tiles
//    above the diagonal and outside the band, done as a loop bound. A
//    prefix widens the range to [0, max(q0 + rows, prefix)): the keys
//    below it stay visible outside the band.
//  * K and V tiles are staged in shared memory with 16-byte cp.async copies
//    into two buffers, the next tile's copies in flight while the block
//    computes on the current one.
//
// bf16 (wgmma): the products run on the tensor cores as Hopper's
// warpgroup products (wgmma.mma_async, fp32 accumulate). A block of two
// warpgroups takes 128 query rows, each warpgroup 64 of them, against
// shared stages of 64 keys, so that one warpgroup's softmax overlaps the
// other's products. Q, K and V sit in shared memory in the layout of the
// 128-byte swizzle (D zero-filled up to a multiple of 64) and are read by
// descriptor: S = Q K^T with both operands K-major, O += P V with V
// MN-major. The online softmax runs on the fp32 score registers, which
// become PV's A operand without leaving them: P is rounded to bf16 there
// (the reference keeps it fp32), as the tensor cores take it. The scale
// multiplies the fp32 scores; the softcap is 1 - 2 / (exp(2x) + 1),
// within c * 1e-7 of c * tanh(s / c). Only the stages that cross the
// diagonal, the window's edge or the ragged tail are masked, and a
// warpgroup skips a stage none of its rows can see.
//
// fp32 (simt): the products run on the fp32 SIMT units, so the card-vs-CPU
// training parity keeps fp32 products (TF32 would lose it). The query tile
// sits in shared memory in fp32, scaled; tiles of 32 keys of K and V in
// their own dtype. Each thread computes a 2 x 4 block of the 64 x 32
// scores, rows r and r + 32, keys c, c + 8, c + 16, c + 24 (neighbouring
// lanes on neighbouring key rows, so the 16-byte shared loads do not
// conflict); the 8 lanes that share a row merge its max and sum by
// shuffles. P*V: the probabilities go through shared memory; each thread
// owns 4 rows x NJ chunks of 4 output columns of the fp32 accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

constexpr int kBQ = 64;        // simt: query rows per block
constexpr int kBK = 32;        // simt: keys per staged tile
constexpr int kThreads = 256;  // simt: 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = 1e30f;
using bf16 = __nv_bfloat16;

// four consecutive elements as floats (16-byte aligned for float, 8-byte
// for bf16, whose fp32 value is its 16 bits as the float's high half)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  // round to nearest even, as torch casts
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 r;
  r.x = *reinterpret_cast<unsigned*>(&lo);
  r.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// shared memory of one block, in bytes, for head dim D
template <typename T>
size_t smem_bytes(int D) {
  const int ldq = D + 4, ldk = D + 16 / (int)sizeof(T), ldp = kBK + 1;
  return (size_t)kBQ * ldq * sizeof(float) +
         (size_t)4 * kBK * ldk * sizeof(T) +
         (size_t)(kBQ * ldp + 2 * kBQ) * sizeof(float);
}

// the key range [lo, hi) that query rows [q0, q0 + rows) can see. PREFIX:
// the call may have a prefix (> 0). The wgmma kernel takes it as a
// template argument, so that its prefix-free instance, which the causal
// and windowed layers run, is the code it was before prefixes existed: a
// runtime prefix test in its mask made the compiler branch on every
// element of a masked stage, and those layers slower
template <bool PREFIX>
__device__ __forceinline__ void key_range(int q0, int rows, int Skv,
                                          int causal, int window, int prefix,
                                          int& lo, int& hi) {
  lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  hi = causal ? min(Skv, q0 + rows) : Skv;
  if (PREFIX && prefix > 0) {
    lo = 0;
    hi = max(hi, min(prefix, Skv));
  }
}

// whether query qpos sees key kpos below hi: in the band, or in the prefix.
// Bitwise, not short-circuit, so that it compiles to predicates rather
// than to a branch an element (the wgmma kernel's prefix-free instance
// keeps the parent's short-circuit test, which its compiler predicates)
__device__ __forceinline__ bool visible(int qpos, int kpos, int hi,
                                        int causal, int window, int prefix) {
  return (kpos < hi) & ((((!causal) | (kpos <= qpos)) &
                         ((window < 0) | (kpos > qpos - window))) |
                        (kpos < prefix));
}

// NJ: chunks of 4 output columns per thread, ceil(D / 64).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int Skv, int H, int KV,
                       int D, int causal, int window, int prefix, int qoff,
                       float scale, float softcap) {
  const int G = H / KV;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int ldq = D + 4;                  // floats
  const int ldk = D + 16 / (int)sizeof(T);  // elements of T (16-byte pad)
  const int ldp = kBK + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);            // [kBQ][ldq]
  T* sK = reinterpret_cast<T*>(sQ + kBQ * ldq);              // [2][kBK][ldk]
  T* sV = sK + 2 * kBK * ldk;                                // [2][kBK][ldk]
  float* sP = reinterpret_cast<float*>(sV + 2 * kBK * ldk);  // [kBQ][ldp]
  float* sAlpha = sP + kBQ * ldp;                            // [kBQ]
  float* sL = sAlpha + kBQ;                                  // [kBQ]

  // the keys this block's rows can see
  int lo, hi;
  key_range<true>(qoff + q0, kBQ, Skv, causal, window, prefix, lo, hi);

  const int chunks = D * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kPiece = 16 / sizeof(T);
  auto stage = [&](int k0, int buf) {
    T* tk = sK + buf * kBK * ldk;
    T* tv = sV + buf * kBK * ldk;
    for (int i = tid; i < kBK * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPiece;
      const bool ok = k0 + r < hi;
      const size_t off = ok ? (((size_t)b * Skv + k0 + r) * KV + kvh) * D + c
                            : 0;
      attn::cp_async16(tk + r * ldk + c, k + off, ok);
      attn::cp_async16(tv + r * ldk + c, v + off, ok);
    }
    attn::cp_async_commit();
  };
  if (lo < hi) stage(lo, 0);

  // the query tile, fp32 and scaled; rows past S are 0
  for (int i = tid; i < kBQ * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = load4(q + (((size_t)b * S + q0 + r) * H + h) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    store4(sQ + r * ldq + c, x);
  }

  const int sr = tid / 8, sc = tid % 8;   // scores: rows sr + 32i, keys sc + 8j
  const int pr = tid / 16, pc = tid % 16; // P*V: rows pr + 16i, chunks pc + 16j
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  int buf = 0;
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    if (k0 + kBK < hi) {
      stage(k0 + kBK, buf ^ 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sK + buf * kBK * ldk;
    const T* tv = sV + buf * kBK * ldk;

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qa = load4(sQ + sr * ldq + d);
      const float4 qb = load4(sQ + (sr + 32) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = load4(tk + (sc + 8 * j) * ldk + d);
        s[0][j] = fmaf(qa.x, kk.x, s[0][j]);
        s[0][j] = fmaf(qa.y, kk.y, s[0][j]);
        s[0][j] = fmaf(qa.z, kk.z, s[0][j]);
        s[0][j] = fmaf(qa.w, kk.w, s[0][j]);
        s[1][j] = fmaf(qb.x, kk.x, s[1][j]);
        s[1][j] = fmaf(qb.y, kk.y, s[1][j]);
        s[1][j] = fmaf(qb.z, kk.z, s[1][j]);
        s[1][j] = fmaf(qb.w, kk.w, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sr + 32 * i;
      const int qpos = qoff + q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + sc + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = visible(qpos, kpos, hi, causal, window, prefix);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_r[i], row_max8(mx));
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha = m_r[i] <= kNegInf / 2 ? 0.f : expf(m_r[i] - safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= kNegInf / 2 ? 0.f : expf(s[i][j] - safe);
        sP[row * ldp + sc + 8 * j] = p;
        psum += p;
      }
      l_r[i] = alpha * l_r[i] + row_sum8(psum);
      m_r[i] = m_new;
      if (sc == 0) sAlpha[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[pr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= a;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(pr + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = (pc + 16 * j) * 4;
        if (c < D) {
          const float4 vv = load4(tv + kk * ldk + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(p[i], vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p[i], vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(p[i], vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(p[i], vv.w, acc[i][j][3]);
          }
        }
      }
    }
    // every thread is done with this buffer, sP and sAlpha before the next
    // tile's copies and scores overwrite them
    __syncthreads();
    buf ^= 1;
  }

  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sr + 32 * i;
      sL[row] = l_r[i];
      if (q0 + row < S)
        lse[((size_t)b * H + h) * S + q0 + row] =
            l_r[i] > 0.f ? m_r[i] + logf(l_r[i]) : kEmptyLse;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = pr + 16 * i;
    if (q0 + row >= S) continue;
    const float l = fmaxf(sL[row], 1e-30f);
    T* orow = out + (((size_t)b * S + q0 + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = (pc + 16 * j) * 4;
      if (c < D)
        store4(orow + c, make_float4(acc[i][j][0] / l, acc[i][j][1] / l,
                                     acc[i][j][2] / l, acc[i][j][3] / l));
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int Skv, int H, int KV, int D,
                   int causal, int window, int prefix, int qoff, float scale,
                   float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, Skv, H, KV, D, causal, window, prefix,
      qoff, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int Skv, int H, int KV, int D,
                     int causal, int window, int prefix, int qoff,
                     float scale, float softcap, cudaStream_t stream) {
#define FLASH_LAUNCH(NJ)                                                     \
  return launch<T, NJ>(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,      \
                       window, prefix, qoff, scale, softcap, stream)
  if (D <= 64) FLASH_LAUNCH(1);
  if (D <= 128) FLASH_LAUNCH(2);
  FLASH_LAUNCH(4);
#undef FLASH_LAUNCH
}

// ----------------------------------------------------------------- wgmma

// a shared-memory matrix descriptor for wgmma in the 128-byte swizzle:
// start address, leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the generic-proxy writes of cp.async made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (+)= A B, m64n64k16: A (64 x 16) and B (64 x 16), both K-major, from
// shared memory by descriptor; accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[OFF .. OFF + 8) += A B, m64n64k16: A (64 x 16) from registers, each
// warp's 16 rows in mma.sync's A fragment layout; B (16 x 64) from shared
// memory by descriptor, MN-major (transposed)
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  static_assert(OFF + 8 <= NT, "accumulator tiles");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]),
        "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
        "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]),
        "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]),
        "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
        "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]),
        "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]),
        "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
        "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]),
        "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
        "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
        "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d[OFF .. OFF + 16) += A B, m64n128k16: A (64 x 16) from registers, each
// warp's 16 rows in mma.sync's A fragment layout; B (16 x 128) from shared
// memory by descriptor, MN-major (transposed)
template <int OFF, int NT>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[NT][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  static_assert(OFF + 16 <= NT, "accumulator tiles");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]),
        "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
        "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]),
        "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
        "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]),
        "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
        "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]),
        "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
        "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]),
        "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
        "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]),
        "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
        "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]),
        "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
        "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]),
        "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]),
        "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]),
        "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
        "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]),
        "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]),
        "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]),
        "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]),
        "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]),
        "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
        "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]),
        "+f"(d[OFF + 12][2]), "+f"(d[OFF + 12][3]),
        "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]),
        "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]),
        "+f"(d[OFF + 14][0]), "+f"(d[OFF + 14][1]),
        "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
        "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]),
        "+f"(d[OFF + 15][2]), "+f"(d[OFF + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// DP: D rounded up to a multiple of 64 (the zero-filled depth). Two
// warpgroups (8 warps) per block of 128 query rows, each warpgroup its own
// 64 rows against the block's shared stages of kWK keys, so that one
// warpgroup's softmax runs while the other's products do. Every tile (Q,
// and each stage's K and V) lies in shared memory as the 128-byte swizzle
// wants it: DP / 64 blocks of 64 columns, each block rows x 128 bytes, the
// 16-byte chunk c of row r at c ^ (r % 8). S = Q K^T is a chain of
// m64n64k16 products, both operands read by descriptor (K-major); P leaves
// the score registers as the A operand of PV's m64nDk16 products, V read
// by descriptor (MN-major). A warpgroup skips a stage none of its rows
// can see (the block walks the union of its two halves' key ranges).
constexpr int kWK = 64;    // keys a stage
constexpr int kWQ = 128;   // query rows a block
constexpr int kWThreads = 256;

template <int DP, bool PREFIX>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int S, int Skv, int H, int KV,
                   int D, int causal, int window, int prefix, int qoff,
                   float scale, float softcap) {
  constexpr int NB = DP / 64;       // 64-column blocks of a row
  constexpr int CH = DP / 8;        // 16-byte chunks of a row
  constexpr int TQ = kWQ * 128;     // bytes of one column block of Q
  constexpr int TK = kWK * 128;     // ... of K or V
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: align to 1024
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = sQ + NB * TQ;       // [2][NB][kWK][128 B]
  unsigned char* sV = sK + 2 * NB * TK;   // [2][NB][kWK][128 B]

  const int G = H / KV;
  const int q0 = blockIdx.x * kWQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;              // this thread's warpgroup
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qw = q0 + 64 * wg;          // the warpgroup's first row
  const int aw = qoff + qw;             // ... as an absolute position
  // the keys the block's rows can see, and the warpgroup's own
  int lo, hi, wlo, whi;
  key_range<PREFIX>(qoff + q0, kWQ, Skv, causal, window, prefix, lo, hi);
  key_range<PREFIX>(aw, 64, Skv, causal, window, prefix, wlo, whi);

  // byte offset of row r, chunk c in a tile of `rows` rows
  auto swz = [](int r, int c, int rows) {
    return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  };
  for (int i = tid; i < kWQ * CH; i += kWThreads) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = q0 + r < S && c * 8 < D;
    const bf16* src =
        ok ? q + (((size_t)b * S + q0 + r) * H + h) * D + c * 8 : q;
    attn::cp_async16(sQ + swz(r, c, kWQ), src, ok);
  }
  attn::cp_async_commit();
  auto stage = [&](int k0, int buf) {
    for (int i = tid; i < kWK * CH; i += kWThreads) {
      const int r = i / CH;
      const int c = i - r * CH;
      const bool ok = k0 + r < hi && c * 8 < D;
      const size_t off =
          ok ? (((size_t)b * Skv + k0 + r) * KV + kvh) * D + c * 8 : 0;
      const int at = buf * NB * TK + swz(r, c, kWK);
      attn::cp_async16(sK + at, k + off, ok);
      attn::cp_async16(sV + at, v + off, ok);
    }
    attn::cp_async_commit();
  };

  float m[2] = {attn::kNegInf, attn::kNegInf}, l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  // this lane's rows: rq0, rq0 + 8
  const int rq0 = qw + ((tid >> 5) & 3) * 16 + g;
  const float two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;
  const unsigned char* qa = sQ + wg * 64 * 128;  // the warpgroup's rows
  if (lo < hi) stage(lo, 0);
  int buf = 0;
  for (int k0 = lo; k0 < hi; k0 += kWK) {
    if (k0 + kWK < hi) {
      stage(k0 + kWK, buf ^ 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    if (k0 + kWK > wlo && k0 < whi) {  // warpgroup-uniform
      const unsigned char* tk = sK + buf * NB * TK;
      const unsigned char* tv = sV + buf * NB * TK;
      float s[kWK / 8][4];
#pragma unroll
      for (int n = 0; n < kWK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(
            s, smem_desc(qa + (kk >> 2) * TQ + (kk & 3) * 32, 16, 1024),
            smem_desc(tk + (kk >> 2) * TK + (kk & 3) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // a stage every row of the warpgroup sees whole needs no mask: one
      // inside every row's band, or inside the prefix
      bool whole = k0 + kWK <= whi &&
                   (!causal || k0 + kWK - 1 <= aw) &&
                   (window < 0 || k0 > aw + 63 - window);
      if constexpr (PREFIX) whole = whole || k0 + kWK <= min(whi, prefix);
#pragma unroll
      for (int n = 0; n < kWK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (softcap > 0.f)
            x = attn::softcap_fast(x, softcap, two_over_cap);
          if (!whole) {
            const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = qoff + rq0 + 8 * (e >> 1);
            bool ok;
            if constexpr (PREFIX)
              ok = visible(qpos, kpos, hi, causal, window, prefix);
            else
              ok = kpos < hi && (!causal || kpos <= qpos) &&
                   (window < 0 || kpos > qpos - window);
            x = ok ? x : attn::kNegInf;
          }
          s[n][e] = x;
        }
      attn::softmax_step<kWK, DP / 8>(s, m, l, o);

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kWK / 16; ++j) {
        // P's keys 16j .. 16j+15 as the A operand, rounded to bf16
        const uint32_t a[4] = {
            attn::pack_bf16(s[2 * j][0], s[2 * j][1]),
            attn::pack_bf16(s[2 * j][2], s[2 * j][3]),
            attn::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
            attn::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        // V's keys 16j .. 16j+15: two 8-row groups (1024 bytes apart),
        // the column blocks TK apart
        if constexpr (DP == 64) {
          wgmma_rs_n64<0>(o, a, smem_desc(tv + j * 2048, TK, 1024));
        } else {
          wgmma_rs_n128<0>(o, a, smem_desc(tv + j * 2048, TK, 1024));
          if constexpr (DP == 256)
            wgmma_rs_n128<16>(o, a,
                              smem_desc(tv + 2 * TK + j * 2048, TK, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    // every thread is done with `buf` before the next step refills it
    __syncthreads();
    buf ^= 1;
  }
  attn::cp_async_wait<0>();
  attn::reduce_rows(l);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rq0 + 8 * i;
    if (row >= S) continue;
    if (t4 == 0)
      lse[((size_t)b * H + h) * S + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kEmptyLse;
    bf16* orow = out + (((size_t)b * S + row) * H + h) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int col = d * 8 + 2 * t4;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            attn::pack_bf16(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int Skv, int H,
                         int KV, int D, int causal, int window, int prefix,
                         int qoff, float scale, float softcap,
                         cudaStream_t stream) {
  const int smem = 1024 + (DP / 64) * (kWQ + 4 * kWK) * 128;
  auto kernel = prefix > 0 ? flash_wgmma_kernel<DP, true>
                           : flash_wgmma_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kWQ - 1) / kWQ, H, B);
  kernel<<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, Skv, H, KV, D, causal, window, prefix,
      qoff, scale, softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int S, int Skv, int H,
                           int KV, int D, int causal, int window, int prefix,
                           int qoff, float scale, float softcap,
                           cudaStream_t stream) {
  if (D <= 64)
    return launch_wgmma<64>(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,
                            window, prefix, qoff, scale, softcap, stream);
  if (D <= 128)
    return launch_wgmma<128>(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,
                             window, prefix, qoff, scale, softcap, stream);
  return launch_wgmma<256>(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,
                           window, prefix, qoff, scale, softcap, stream);
}

}  // namespace

// q, out: (B, S, H, D); k, v: (B, Skv, KV, D); lse: (B, H, S) fp32. All
// contiguous and 16-byte aligned, D a multiple of 8 up to 256. causal 0/1
// (causal needs qoff + S <= Skv; the wrapper asks Skv == S of a call
// without an offset); window < 0 turns the
// window off, prefix <= 0 the prefix, softcap <= 0 the softcap. qoff: the
// absolute position of query row 0 (one rank's slice of the queries under
// context parallelism), which every mask and key range reads. dtype 0 = float32 (SIMT kernel),
// 1 = bfloat16 (wgmma kernel). Launches on `stream` and returns the CUDA
// error code (0 on success); does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int Skv, int H, int KV,
                                      int D, int causal, int window,
                                      int prefix, int qoff, float scale,
                                      float softcap, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      H > 65535 || B > 65535 || Skv < 0 || qoff < 0 ||
      (causal && qoff + S > Skv))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,
                           window, prefix, qoff, scale, softcap, st);
  if (dtype == 1)
    return dispatch_wgmma(q, k, v, out, lse, B, S, Skv, H, KV, D, causal,
                          window, prefix, qoff, scale, softcap, st);
  return cudaErrorInvalidValue;
}
