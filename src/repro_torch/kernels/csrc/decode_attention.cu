// Flash-decoding attention for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:
// _decode_kernel and computes what it computes: for each sequence b and KV
// head, the G query heads h = kv * G + g (one query each) attend the cache
// slots kpos < valid_len[b], and with a window only kpos > valid_len[b] - 1
// - window. Scores are taken on q*scale in fp32, optionally softcapped
// (c * tanh(s / c)); the softmax is online in fp32, P stays fp32 through
// PV, a row that sees no key gives 0 (acc / max(l, 1e-30)), and the output
// is written in q's dtype. On request (a non-null `lse`) the launch also
// writes each row's fp32 log-sum-exp of its scaled scores, m + log(l), or
// -inf for a row that sees no key: what a caller needs to merge attentions
// over disjoint key ranges (the mesh path's sequence-sharded caches).
//
// What bounds it on this card: HBM bytes. Every (b, kv head) must read the
// K and V rows of its visible keys once, plus its queries and outputs; the
// arithmetic is 4*D operations per (query, key) pair, far below the card's
// compute rate. The design:
//  * The cache is read in place, (B, S, KV, D) with a stride of KV*D
//    between keys (the TPU version transposed and padded it first), and the
//    walk covers only the visible keys [max(0, valid-window), min(valid, S))
//    instead of masking every tile.
//  * The key range of a row is split over blocks (grid x). The wrapper
//    plans the splits from the shapes alone (never from valid_len, which
//    would cost a sync), so that the grid fills at most one wave at the
//    occupancy this kernel gets (decode_attention_occupancy); splits past
//    a row's visible keys find no tile and weigh 0 in the merge.
//  * Each block streams its keys through a ring of kStages = 3 shared-memory
//    stages of TK keys (16 KB of K and V rows a stage) with 16-byte
//    cp.async copies: while tile i is scored and accumulated, tiles i+1
//    and i+2 are in flight. One barrier a tile.
//  * Compute: one key row per half-warp, its 16 lanes each reading 16
//    bytes of K and of V from the stage (conflict-free: a half-warp reads
//    one 256-byte row). The G query rows of the KV head sit in the same
//    lanes' registers, so each key is read once for all G heads. Each
//    half-warp keeps its own online-softmax state; the block merges its 16
//    states at the end (shuffles, then shared memory). Eight warps a block
//    rather than four: a short row (the serve cell's 128 keys) is then 2
//    keys a half-warp a stage, and its dependent rounds are fewer.
//  * The splits merge in the same launch: each split writes its (m, l,
//    acc) to fp32 partials, and the last split of a row to arrive (a
//    per-row counter, left at 0 for the next call) merges them. The
//    log-sum-exp, where asked for, is written where the output is: by the
//    one split, or by the merge from every split's (m, l).
//  * The softcap is c * (1 - 2 / (exp(2s / c) + 1)) with 2 / c precomputed
//    (attn::softcap_fast), within about 1e-7 * c of c * tanh(s / c).
//
// Layout: grid (splits, KV * row groups, B), 8 warps a block. A row group
// is up to GB of the G query heads of one KV head; lane c of a half-warp
// owns 16-byte chunks c, c + 16, ... of each row (NC chunks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

using attn::allow_smem;
using attn::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerKey = 16;                          // a half-warp
constexpr int kSubWarps = kThreads / kLanesPerKey;        // 16 per block
constexpr int kStages = 3;

// keys a half-warp takes from each stage (U) and keys a stage holds (TK =
// U * 16): 16 KB of K and V rows a stage, at least one key per half-warp
// (32 KB at D * sizeof(T) > 512)
template <int NC>
__host__ __device__ constexpr int keys_per_half_warp() {
  return 32 / NC / kSubWarps > 0 ? 32 / NC / kSubWarps : 1;
}
template <int NC>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * keys_per_half_warp<NC>() * kSubWarps * 2 * NC * 256;
}

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

// weight of a softmax state with max m against the merged max: 0 for a
// state that saw no key
__device__ __forceinline__ float rescale(float m, float safe_max) {
  return m <= kNegInf / 2 ? 0.f : __expf(m - safe_max);
}
__device__ __forceinline__ float safe(float m) {
  return m <= kNegInf / 2 ? 0.f : m;
}
// log-sum-exp of a softmax state (max m, sum l against safe(m)): -inf for a
// state that saw no key
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.f ? safe(m) + logf(l) : -INFINITY;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  float* part;     // (B, H, n_splits, 2) m, l, then (B, H, n_splits, D) acc
  int* counters;   // one per (b, kv head, row group), 0 between calls
  float* lse;      // (B, H) log-sum-exp of the scaled scores, or null
  int B, S, H, KV, D, window, n_splits, keys_per_split;
  float scale, softcap;
};

// NC: 16-byte chunks per lane per row (D * sizeof(T) / 256, rounded up to
// 1, 2 or 4); GB: query heads per block. A stage holds TK = 32 / NC keys,
// U = TK / 8 for each half-warp.
template <typename T, int NC, int GB>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(T);          // elements per chunk
  constexpr int kPitch = NC * kLanesPerKey;     // chunks per staged row
  constexpr int U = keys_per_half_warp<NC>();
  constexpr int TK = U * kSubWarps;
  constexpr int kStageChunks = TK * 2 * kPitch; // 16-byte chunks a stage
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int S = a.S, H = a.H, KV = a.KV, D = a.D;
  const int G = H / KV;
  const int n_groups = (G + GB - 1) / GB;
  const int split = blockIdx.x;
  const int n_splits = a.n_splits;
  const int kvh = blockIdx.y / n_groups;
  const int group = blockIdx.y - kvh * n_groups;
  const int g0 = group * GB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid / kLanesPerKey;     // this half-warp's index
  const int c = lane & (kLanesPerKey - 1);
  const int C = D / kVec;                 // chunks per row

  // this lane's chunks of the GB query rows, issued beside valid_len's
  // load (neither waits on the other)
  uint4 qraw[GB][NC];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int chunk = c + n * kLanesPerKey;
      qraw[g][n] = make_uint4(0, 0, 0, 0);
      if (g0 + g < G && chunk < C)
        qraw[g][n] = __ldg(reinterpret_cast<const uint4*>(
            q + ((size_t)b * H + kvh * G + g0 + g) * D + chunk * kVec));
    }
  const int vl = __ldg(a.valid_len + b);

  // visible keys of row b, and this split's share of them
  const int hi = min(vl, S);
  const int lo = (a.window >= 0 ? max(0, vl - a.window) : 0) +
                 split * a.keys_per_split;
  const int end = min(hi, lo + a.keys_per_split);
  const int n_tiles = end > lo ? (end - lo + TK - 1) / TK : 0;

  extern __shared__ uint4 smem[];        // the ring, later the merge
  const size_t kstride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kvh) * D;
  const T* vb = v + ((size_t)b * S * KV + kvh) * D;
  // stage tile i: TK keys x kPitch chunks of K, then of V; keys past the
  // split's end and chunks past the row are zero-filled, reading nothing
  auto stage = [&](int i) {
    uint4* sk = smem + (i % kStages) * kStageChunks;
    uint4* sv = sk + TK * kPitch;
    const int t0 = lo + i * TK;
#pragma unroll
    for (int j = tid; j < TK * kPitch; j += kThreads) {
      const int key = j / kPitch, chunk = j % kPitch;
      const bool live = t0 + key < end && chunk < C;
      const size_t off = live ? (t0 + key) * kstride + chunk * kVec : 0;
      attn::cp_async16(sk + j, kb + off, live);
      attn::cp_async16(sv + j, vb + off, live);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) stage(i);
    attn::cp_async_commit();
  }

  float qr[GB][NC][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      unpack(qraw[g][n], qr[g][n]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[g][n][e] *= a.scale;
    }
  const float softcap = a.softcap;
  const float two_over_cap = softcap > 0.f ? 2.f / softcap : 0.f;

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

  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<kStages - 2>();
    __syncthreads();   // tile it is in; every warp is done with tile it-1
    if (it + kStages - 1 < n_tiles) stage(it + kStages - 1);
    attn::cp_async_commit();

    const uint4* sk = smem + (it % kStages) * kStageChunks;
    const uint4* sv = sk + TK * kPitch;
    const int t0 = lo + it * TK;
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = u * kSubWarps + sub;
      float kf[NC][kVec];
#pragma unroll
      for (int n = 0; n < NC; ++n) unpack(sk[key * kPitch + c + n * 16], kf[n]);
      const bool valid = t0 + key < end;
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
        if (softcap > 0.f) x = attn::softcap_fast(x, softcap, two_over_cap);
        s[u][g] = valid ? x : kNegInf;
      }
    }
    float vf[U][NC][kVec];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        unpack(sv[(u * kSubWarps + sub) * kPitch + c + n * 16], vf[u][n]);
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
          float x = acc[g][n][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) x = fmaf(p[u], vf[u][n][e], x);
          acc[g][n][e] = x;
        }
    }
  }

  // merge the two half-warps of each warp
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], kLanesPerKey);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], kLanesPerKey);
    const float mx = fmaxf(m[g], mo);
    const float wa = rescale(m[g], safe(mx));
    const float wb = rescale(mo, safe(mx));
    m[g] = mx;
    l[g] = wa * l[g] + wb * lo_;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float other =
            __shfl_xor_sync(0xffffffffu, acc[g][n][e], kLanesPerKey);
        acc[g][n][e] = wa * acc[g][n][e] + wb * other;
      }
  }

  // then the warps, through the shared memory the ring used
  attn::cp_async_wait<0>();
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);  // [kWarps][GB][D]
  float* s_m = s_acc + kWarps * GB * D;           // [kWarps][GB]
  float* s_l = s_m + kWarps * GB;                 // [kWarps][GB]
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
  T* out = static_cast<T*>(a.out);
  float* part_ml = a.part;
  float* part_acc = a.part + (size_t)a.B * H * n_splits * 2;
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GB + g]);
    float lsum = 0.f, x = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = rescale(s_m[w * GB + g], safe(mx));
      lsum += wt * s_l[w * GB + g];
      x += wt * s_acc[(w * GB + g) * D + d];
    }
    const size_t bh = (size_t)b * H + kvh * G + g0 + g;
    if (n_splits == 1) {
      store(out + bh * D + d, x / fmaxf(lsum, 1e-30f));
      if (a.lse != nullptr && d == 0) a.lse[bh] = log_sum_exp(mx, lsum);
    } else {
      part_acc[(bh * n_splits + split) * D + d] = x;
      if (d == 0) {
        part_ml[(bh * n_splits + split) * 2] = mx;
        part_ml[(bh * n_splits + split) * 2 + 1] = lsum;
      }
    }
  }
  if (n_splits == 1) return;

  // the last split of this row group to arrive merges every split's state
  __threadfence();       // this split's partials before its arrival
  __syncthreads();
  int arrived = 0;
  if (tid == 0) {
    int* counter = a.counters + ((size_t)b * KV + kvh) * n_groups + group;
    arrived = atomicAdd(counter, 1) == n_splits - 1;
    if (arrived) *counter = 0;    // every split has arrived: reset it
  }
  if (!__syncthreads_or(arrived)) return;
  __threadfence();
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    if (g0 + g >= G) continue;
    const size_t bh = (size_t)b * H + kvh * G + g0 + g;
    const float* ml = part_ml + bh * n_splits * 2;
    float mx = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, __ldcg(ml + 2 * sp));
    float lsum = 0.f, x = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float wt = rescale(__ldcg(ml + 2 * sp), safe(mx));
      if (wt == 0.f) continue;              // a split that saw no key
      lsum += wt * __ldcg(ml + 2 * sp + 1);
      x += wt * __ldcg(part_acc + (bh * n_splits + sp) * D + d);
    }
    store(out + bh * D + d, x / fmaxf(lsum, 1e-30f));
    if (a.lse != nullptr && d == 0) a.lse[bh] = log_sum_exp(mx, lsum);
  }
}

// calls f.template operator()<T, NC, GB>() for the instance that serves
// head dim D and G heads a KV head: NC chunks per lane (at most 32 in bf16
// and 64 in fp32, D <= 256), GB the next power of two of G, at most 8 (4
// where a row's chunks per lane already take 16 registers)
template <typename T, typename F>
cudaError_t by_shape(int D, int G, F&& f) {
  const int chunks = D / (16 / (int)sizeof(T));
  auto by_group = [&](auto nc) -> cudaError_t {
    constexpr int NC = decltype(nc)::value;
    constexpr int kMaxGB = NC * (16 / sizeof(T)) >= 16 ? 4 : 8;
    if (G <= 1) return f.template operator()<T, NC, 1>();
    if (G <= 2) return f.template operator()<T, NC, 2>();
    if (kMaxGB == 4 || G <= 4) return f.template operator()<T, NC, 4>();
    return f.template operator()<T, NC, kMaxGB>();
  };
  if (chunks <= kLanesPerKey)
    return by_group(std::integral_constant<int, 1>());
  if (chunks <= 2 * kLanesPerKey)
    return by_group(std::integral_constant<int, 2>());
  if constexpr (sizeof(T) == 4)
    return by_group(std::integral_constant<int, 4>());
  return cudaErrorInvalidValue;
}

struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <typename T, int NC, int GB>
  cudaError_t operator()() const {
    const int G = a.H / a.KV;
    const dim3 grid(a.n_splits, a.KV * ((G + GB - 1) / GB), a.B);
    const cudaError_t err =
        allow_smem<decode_attention_kernel<T, NC, GB>>(smem_bytes<NC>());
    if (err != cudaSuccess) return err;
    decode_attention_kernel<T, NC, GB>
        <<<grid, kThreads, smem_bytes<NC>(), stream>>>(a);
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* blocks;
  template <typename T, int NC, int GB>
  cudaError_t operator()() const {
    const cudaError_t err =
        allow_smem<decode_attention_kernel<T, NC, GB>>(smem_bytes<NC>());
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_attention_kernel<T, NC, GB>, kThreads,
        smem_bytes<NC>());
  }
};

bool bad_shape(int H, int KV, int D) {
  return KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256;
}

}  // namespace

// q, out: (B, H, D); k, v: (B, S, KV, D); valid_len: (B,) int32. All
// contiguous and 16-byte aligned. window < 0 turns the window off, softcap
// <= 0 the softcap. The key range of each row is split into n_splits
// ranges of keys_per_split keys; with n_splits > 1, `part` holds (B * H *
// n_splits * (D + 2)) fp32 of scratch and `counters` one int32 per (b, KV
// head, row group of the instance's heads), all 0 on entry and left 0.
// `lse`, where not null, receives (B, H) fp32 log-sum-exps.
// dtype 0 = float32, 1 = bfloat16. Launches one kernel on `stream` and
// returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid_len,
                                       void* out, void* part, void* counters,
                                       void* lse, int B, int S, int H,
                                       int KV, int D, int window,
                                       int n_splits,
                                       int keys_per_split, float scale,
                                       float softcap, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(H, KV, D) || S <= 0 || n_splits <= 0 ||
      keys_per_split <= 0 ||
      (n_splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(valid_len), out,
               static_cast<float*>(part), static_cast<int*>(counters),
               static_cast<float*>(lse), B, S, H, KV, D, window, n_splits,
               keys_per_split, scale, softcap};
  const Launch launch{a, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_shape<float>(D, H / KV, launch);
  if (dtype == 1) return by_shape<__nv_bfloat16>(D, H / KV, launch);
  return cudaErrorInvalidValue;
}

// Blocks of the instance that serves (H, KV, D, dtype) one SM holds at
// once, into *blocks: the occupancy the split plan fills one wave with.
extern "C" int decode_attention_occupancy(int H, int KV, int D, int dtype,
                                          int* blocks) {
  if (H <= 0 || bad_shape(H, KV, D)) return cudaErrorInvalidValue;
  const Occupancy occ{blocks};
  if (dtype == 0) return by_shape<float>(D, H / KV, occ);
  if (dtype == 1) return by_shape<__nv_bfloat16>(D, H / KV, occ);
  return cudaErrorInvalidValue;
}
