// Flash-decoding attention for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:
// _decode_kernel and computes what it computes: for each sequence b and KV
// head, the G query heads h = kv * G + g (one query each) attend the cache
// slots kpos < valid_len[b], and with a window only kpos > valid_len[b] - 1
// - window. Scores are taken on q*scale in fp32, optionally tanh-softcapped;
// the softmax is online in fp32, a row that sees no key gives 0
// (acc / max(l, 1e-30)), and the output is written in q's dtype.
//
// What bounds it on this card: HBM bytes. Every (b, kv head) must read the
// K and V rows of its visible keys once, plus its queries and outputs; the
// arithmetic is 4*D operations per (query, key) pair, far below the card's
// compute rate. The design:
//  * The cache is read in place, (B, S, KV, D) with a stride of KV*D
//    between keys (the TPU version transposed and padded it first), and the
//    walk covers only the visible keys [max(0, valid-window), min(valid, S))
//    instead of masking every tile.
//  * One key row per half-warp: its 16 lanes each load 16 bytes of K and of
//    V straight into registers (16-byte loads, neighbouring lanes on
//    neighbouring addresses), and each half-warp has several keys' loads in
//    flight before it computes. The G query rows of the KV head sit in the
//    same lanes' registers, so each key is read once for all G heads.
//  * Each half-warp keeps its own online-softmax state (m, l, acc); the
//    block merges its 8 states at the end (shuffles, then shared memory).
//  * When B * KV alone would leave SMs idle, or the cache is long, the key
//    range is split over blocks (grid x); each writes its (m, l, acc) and a
//    second kernel merges the splits. On the TPU the key range was the
//    grid's innermost, sequential dimension with m/l/acc in VMEM.
//
// Layout: grid (splits, KV * row groups, B), 4 warps a block. A row group
// is up to GB of the G query heads of one KV head; lane c of a half-warp
// owns 16-byte chunks c, c + 16, ... of each row (NC chunks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kLanesPerKey = 16;                          // a half-warp
constexpr int kSubWarps = kWarps * 32 / kLanesPerKey;     // 8 per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

// the elements of one 16-byte chunk as floats, without taking the chunk's
// address (which would put it in local memory)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  // bf16 -> fp32 is exact: the 16 bits become the float's high half; the
  // element at the lower address is the word's low half
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// weight of a softmax state with max m against the merged max: 0 for a
// state that saw no key
__device__ __forceinline__ float rescale(float m, float safe_max) {
  return m <= kNegInf / 2 ? 0.f : expf(m - safe_max);
}
__device__ __forceinline__ float safe(float m) {
  return m <= kNegInf / 2 ? 0.f : m;
}

// NC: 16-byte chunks per lane per row (D * sizeof(T) / 256, rounded up);
// GB: query heads per block. Each half-warp has U keys in flight per step.
template <typename T, int NC, int GB>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ valid_len,
                        T* __restrict__ out, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int S, int H, int KV,
                        int D, int window, int keys_per_split, float scale,
                        float softcap) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int U = 4 / NC;             // keys in flight per half-warp
  const int G = H / KV;
  const int n_groups = (G + GB - 1) / GB;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int kvh = blockIdx.y / n_groups;
  const int g0 = (blockIdx.y - kvh * n_groups) * GB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid / kLanesPerKey;     // this half-warp's index
  const int c = lane & (kLanesPerKey - 1);
  const int C = D / kVec;                 // chunks per row

  // visible keys of row b, and this split's share of them
  const int vl = valid_len[b];
  const int hi = min(vl, S);
  const int lo = (window >= 0 ? max(0, vl - window) : 0)
                 + split * keys_per_split;
  const int end = min(hi, lo + keys_per_split);

  // this lane's chunks of the GB query rows, times the scale
  float qr[GB][NC][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int chunk = c + n * kLanesPerKey;
      if (g0 + g < G && chunk < C) {
        const int h = kvh * G + g0 + g;
        unpack(load16(q + ((size_t)b * H + h) * D + chunk * kVec),
               qr[g][n]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][n][e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[g][n][e] = 0.f;
      }
    }
  }

  float m[GB], l[GB], acc[GB][NC][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][n][e] = 0.f;
  }

  const size_t kstride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kvh) * D;
  const T* vb = v + ((size_t)b * S * KV + kvh) * D;
  for (int k0 = lo; k0 < end; k0 += kSubWarps * U) {
    // every load of the step first, then the arithmetic
    uint4 kr[U][NC], vr[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = k0 + u * kSubWarps + sub;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int chunk = c + n * kLanesPerKey;
        if (t < end && chunk < C) {
          kr[u][n] = load16(kb + t * kstride + chunk * kVec);
          vr[u][n] = load16(vb + t * kstride + chunk * kVec);
        } else {
          kr[u][n] = make_uint4(0, 0, 0, 0);
          vr[u][n] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NC][kVec];
#pragma unroll
      for (int n = 0; n < NC; ++n) unpack(kr[u][n], kf[n]);
      const bool valid = k0 + u * kSubWarps + sub < end;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < kVec; ++e) x = fmaf(qr[g][n][e], kf[n][e], x);
        // the dot product over the half-warp's 16 lanes
#pragma unroll
        for (int o = kLanesPerKey / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][g] = valid ? x : kNegInf;
      }
    }
    float vf[U][NC][kVec];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NC; ++n) unpack(vr[u][n], vf[u][n]);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float sm = safe(m_new);
      const float alpha = rescale(m[g], sm);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = rescale(s[u][g], sm);
        psum += p[u];
      }
      m[g] = m_new;
      l[g] = alpha * l[g] + psum;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float a = acc[g][n][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][n][e], a);
          acc[g][n][e] = a;
        }
    }
  }

  // merge the two half-warps of each warp
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], kLanesPerKey);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], kLanesPerKey);
    const float mx = fmaxf(m[g], mo);
    const float a = rescale(m[g], safe(mx));
    const float w = rescale(mo, safe(mx));
    m[g] = mx;
    l[g] = a * l[g] + w * lo_;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float other =
            __shfl_xor_sync(0xffffffffu, acc[g][n][e], kLanesPerKey);
        acc[g][n][e] = a * acc[g][n][e] + w * other;
      }
  }

  // then the warps, through shared memory
  extern __shared__ float smem[];
  float* s_acc = smem;                          // [kWarps][GB][D]
  float* s_m = s_acc + kWarps * GB * D;         // [kWarps][GB]
  float* s_l = s_m + kWarps * GB;               // [kWarps][GB]
  if (lane < kLanesPerKey) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int chunk = c + n * kLanesPerKey;
        if (chunk < C) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            s_acc[(warp * GB + g) * D + chunk * kVec + e] = acc[g][n][e];
        }
      }
      if (lane == 0) {
        s_m[warp * GB + g] = m[g];
        s_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < GB * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GB + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = rescale(s_m[w * GB + g], safe(mx));
      lsum += wt * s_l[w * GB + g];
      a += wt * s_acc[(w * GB + g) * D + d];
    }
    const size_t bh = (size_t)b * H + kvh * G + g0 + g;
    if (n_splits == 1) {
      store(out + bh * D + d, a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(bh * n_splits + split) * D + d] = a;
      if (d == 0) {
        part_ml[(bh * n_splits + split) * 2] = mx;
        part_ml[(bh * n_splits + split) * 2 + 1] = lsum;
      }
    }
  }
}

// second pass when the key range was split: merge the splits' softmax
// states of one (b, h) row. One block per row.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int n_splits, int D) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_splits * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f;
  for (int s = 0; s < n_splits; ++s)
    lsum += rescale(ml[2 * s], safe(mx)) * ml[2 * s + 1];
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += rescale(ml[2 * s], safe(mx)) * part_acc[(bh * n_splits + s) * D + d];
    store(out + bh * D + d, a / denom);
  }
}

template <typename T, int NC, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* out, void* part_ml,
                   void* part_acc, int B, int S, int H, int KV, int D,
                   int window, int n_splits, int keys_per_split, float scale,
                   float softcap, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(n_splits, KV * ((G + GB - 1) / GB), B);
  const size_t smem = (size_t)(kWarps * GB * D + 2 * kWarps * GB) *
                      sizeof(float);
  decode_attention_kernel<T, NC, GB><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<T*>(out), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), S, H, KV, D, window, keys_per_split,
      scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  combine_kernel<T><<<B * H, 128, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), n_splits, D);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, void* part_ml,
                     void* part_acc, int B, int S, int H, int KV, int D,
                     int window, int n_splits, int keys_per_split,
                     float scale, float softcap, cudaStream_t stream) {
  // query heads per block: the next power of two of G, at most 8 (4 where
  // a row's chunks per lane already take 16 registers)
  constexpr int kMaxGB = NC * (16 / sizeof(T)) >= 16 ? 4 : 8;
#define DECODE_LAUNCH(GB)                                                    \
  return launch<T, NC, GB>(q, k, v, valid_len, out, part_ml, part_acc, B, S, \
                           H, KV, D, window, n_splits, keys_per_split,       \
                           scale, softcap, stream)
  if (G <= 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if constexpr (kMaxGB == 4) {
    DECODE_LAUNCH(4);
  } else {
    if (G <= 4) DECODE_LAUNCH(4);
    DECODE_LAUNCH(8);
  }
#undef DECODE_LAUNCH
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, void* part_ml,
                     void* part_acc, int B, int S, int H, int KV, int D,
                     int window, int n_splits, int keys_per_split,
                     float scale, float softcap, cudaStream_t stream) {
  // chunks per row: at most 32 in bf16 and 64 in fp32 (D <= 256)
  const int chunks = D / (16 / (int)sizeof(T));
  const int G = H / KV;
  if (chunks <= kLanesPerKey)
    return by_group<T, 1>(G, q, k, v, valid_len, out, part_ml, part_acc, B,
                          S, H, KV, D, window, n_splits, keys_per_split,
                          scale, softcap, stream);
  if (sizeof(T) == 2 || chunks <= 2 * kLanesPerKey)
    return by_group<T, 2>(G, q, k, v, valid_len, out, part_ml, part_acc, B,
                          S, H, KV, D, window, n_splits, keys_per_split,
                          scale, softcap, stream);
  if constexpr (sizeof(T) == 4)
    return by_group<T, 4>(G, q, k, v, valid_len, out, part_ml, part_acc, B,
                          S, H, KV, D, window, n_splits, keys_per_split,
                          scale, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, H, D); k, v: (B, S, KV, D); valid_len: (B,) int32. All
// contiguous and 16-byte aligned. window < 0 turns the window off, softcap
// <= 0 the softcap. With n_splits > 1 the key range of each row is split
// into n_splits ranges of keys_per_split keys, and part_ml (B, H,
// n_splits, 2) and part_acc (B, H, n_splits, D), fp32, hold the splits'
// states for the second pass. dtype 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns the CUDA error code of the launches (0 on success);
// does not synchronise.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid_len,
                                       void* out, void* part_ml,
                                       void* part_acc, int B, int S, int H,
                                       int KV, int D, int window,
                                       int n_splits, int keys_per_split,
                                       float scale, float softcap, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256 || S <= 0 ||
      n_splits <= 0 || keys_per_split <= 0 ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, valid_len, out, part_ml, part_acc, B, S,
                           H, KV, D, window, n_splits, keys_per_split, scale,
                           softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, valid_len, out, part_ml,
                                   part_acc, B, S, H, KV, D, window, n_splits,
                                   keys_per_split, scale, softcap, st);
  return cudaErrorInvalidValue;
}
