// Flash attention (training and prefill forward) for Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel and computes what it computes: self-attention with Sq ==
// Skv, query head h reading KV head h / G, query i attending keys j <= i
// (causal) and j > i - window (with a window). Scores are taken on q*scale
// in fp32 and softcapped, c*tanh(s/c), before the mask; the softmax is
// online in fp32, a row that sees no key gives 0 (acc / max(l, 1e-30)), and
// the output is written in q's dtype. It also writes each row's fp32
// log-sum-exp, m + log(l) (1e30 for a row that sees no key), which the
// backward needs.
//
// What bounds it on this card: operations. At the training shapes (S =
// 4096, D = 128 or 256) each (query, key) pair costs 4*D operations and
// each key is reused by up to thousands of queries, far above the card's
// 295 operations per byte. This first version runs the products on the
// fp32 SIMT units (tensor cores, wgmma and TMA are later work). The design:
//  * q, k and v are read in place in their (B, S, heads, D) layout, with a
//    stride of heads*D between positions; the TPU wrapper transposed them to
//    (B, H, S, D) and padded S, this kernel masks the ragged tail instead.
//  * One block per (tile of 64 query rows, query head, b). The block walks
//    only the key tiles its rows can see, [max(0, q0 - window + 1),
//    min(S, q0 + 64)) for causal layers: the TPU's grid skip of tiles above
//    the diagonal and outside the band, done as a loop bound.
//  * The query tile sits in shared memory in fp32, scaled. Tiles of 32
//    keys of K and V are staged in shared memory in their own dtype with
//    16-byte cp.async copies into two buffers, the next tile's copies in
//    flight while the block computes on the current one.
//  * Scores: each thread computes a 2 x 4 block of the 64 x 32 tile, rows
//    r and r + 32, keys c, c + 8, c + 16, c + 24 (neighbouring lanes on
//    neighbouring key rows, so the 16-byte shared loads do not conflict).
//    The 8 lanes that share a row merge its max and sum by shuffles; each
//    row keeps its online-softmax state (m, l) in fp32.
//  * P*V: the probabilities go through shared memory; each thread owns 4
//    rows x NJ chunks of 4 output columns of the fp32 accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per staged tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = 1e30f;

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

// 16-byte global -> shared copy that bypasses the registers; with `pred`
// false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// NJ: chunks of 4 output columns per thread, ceil(D / 64).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KV, int D,
                       int causal, int window, float scale, float softcap) {
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
  const int lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(S, q0 + kBQ) : S;

  const int chunks = D * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kPiece = 16 / sizeof(T);
  auto stage = [&](int k0, int buf) {
    T* tk = sK + buf * kBK * ldk;
    T* tv = sV + buf * kBK * ldk;
    for (int i = tid; i < kBK * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPiece;
      const bool ok = k0 + r < hi;
      const size_t off = ok ? (((size_t)b * S + k0 + r) * KV + kvh) * D + c
                            : 0;
      cp_async16(tk + r * ldk + c, k + off, ok);
      cp_async16(tv + r * ldk + c, v + off, ok);
    }
    cp_async_commit();
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + sc + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos < hi && (!causal || kpos <= qpos) &&
                        (window < 0 || kpos > qpos - window);
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
                   void* lse, int B, int S, int H, int KV, int D, int causal,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, KV, D, causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int H, int KV, int D,
                     int causal, int window, float scale, float softcap,
                     cudaStream_t stream) {
#define FLASH_LAUNCH(NJ)                                                   \
  return launch<T, NJ>(q, k, v, out, lse, B, S, H, KV, D, causal, window, \
                       scale, softcap, stream)
  if (D <= 64) FLASH_LAUNCH(1);
  if (D <= 128) FLASH_LAUNCH(2);
  FLASH_LAUNCH(4);
#undef FLASH_LAUNCH
}

}  // namespace

// q, out: (B, S, H, D); k, v: (B, S, KV, D); lse: (B, H, S) fp32. All
// contiguous and 16-byte aligned, D a multiple of 8 up to 256. causal 0/1;
// window < 0 turns the window off, softcap <= 0 the softcap. dtype 0 =
// float32, 1 = bfloat16. Launches on `stream` and returns the CUDA error
// code (0 on success); does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int H, int KV, int D,
                                      int causal, int window, float scale,
                                      float softcap, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, B, S, H, KV, D, causal, window,
                           scale, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, B, S, H, KV, D, causal,
                                   window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
