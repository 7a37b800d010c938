// Paged attention for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// _paged_kernel and computes exactly what it computes: for each sequence b
// and KV head, the (S*G, D) tile of query rows (S query tokens times the G
// query heads that share the KV head; row r is token r / G of head
// kv * G + r % G) attends the KV pool pages named by the block table
// tables[b, :]. Block i of a table covers the logical positions [i*bt,
// (i+1)*bt), whatever pool row backs it, and row r sees the keys with
// kpos <= qpos[b, r / G]. Scores are taken in fp32 and scaled, optionally
// tanh-softcapped, then masked; the softmax is online in fp32, a row that
// sees no key gives 0, and the output is written in q's dtype.
//
// What bounds it on this card: HBM bytes. Every (b, kv head) must read the
// K and V rows its visible positions need, plus its queries and outputs;
// the arithmetic is 4*D operations per (row, visible key) pair. Pages are
// not contiguous: a page row is D elements with a stride of KV*D, and the
// kernels read them in place (on the TPU, scalar prefetch brought the
// table ahead of the grid, and the grid's innermost, sequential dimension
// walked it with m/l/acc in VMEM). At the serve path's shapes the bytes
// are few, so what the designs fight is latency: every design splits the
// table's key range [0, NW*bt) over blocks, n_splits ranges of
// keys_per_split keys fixed from the shapes alone (the host never reads
// qpos), so that a long row is walked by many blocks side by side. Each
// block reads its rows' positions, looks up the pool rows of its keys
// once, and walks only the keys its rows can see; a split wholly past
// them writes a neutral state (m = -inf, l = 0) and exits. A second pass,
// launched by the same call, merges the splits (one warp a row). Three
// designs, chosen by the wrapper from the dtype and the shapes:
//
//  * mma16 (bf16, S*G <= 16: the decode steps): a block takes 16 rows of
//    the (S*G, D) tile (the G heads of a decode step, padded), and its 4
//    warps share them, each walking a quarter of every staged key tile
//    with its own softmax state; the warps' states merge through shared
//    memory at the end, so no warp idles at G = 7.
//  * mma64 (bf16, S*G > 16: the prefill chunks): a block takes 64 rows,
//    one warp per 16, each warp walking every staged key. Tile row r is
//    token r / G of head kv * G + r % G, with its own qpos mask.
//  * simt (f32): one key row per half-warp, its 16 lanes loading 16 bytes
//    of K and of V straight into registers shared by the block's rows (up
//    to GB of them), as the flash-decoding kernel does; the products stay
//    fp32, so the card-vs-CPU serve parity keeps its exact tokens.
//
// In mma16 and mma64 QK^T and PV run on the tensor cores (mma.sync.m16n8k16,
// bf16 in, fp32 accumulate). K/V pages are staged by 16-byte cp.async
// copies into a ring of padded shared-memory stages and read into
// fragments by ldmatrix; D is zero-filled up to a multiple of 32. The
// scale multiplies the fp32 scores, so a bf16 x bf16 product summed in
// fp32 is as exact as the reference's fp32 product. P goes through PV as
// three bf16 parts (8 + 8 + 8 bits, each product with bf16 V exact in
// fp32), so PV is the reference's fp32 PV up to summation order, at a cost
// hidden behind the page reads.
//
// The earlier design (one block per 16 rows, KV head and b, 32-key
// tiles walked serially on the SIMT units) stays below as
// paged_attention_tile16_launch, the yardstick chip_smoke.py times the
// redesign against; no wrapper of the serve path calls it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

using attn::kNegInf;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                // 4 warps
constexpr int kLanesPerKey = 16;             // split: a half-warp a key
constexpr int kSubWarps = kThreads / kLanesPerKey;
constexpr int kMaxSplitKeys = 4096;          // keys a split walks, at most

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
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

// the pool row (page * bt + slot) of each of a split's n keys from lo on,
// 0 past the table's end: a block's page lookups (a division by bt and a
// table read a key), done once, before its walk
__device__ __forceinline__ void pool_rows(int* s_row, const int* table,
                                          int lo, int n, int bt, int NW) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = lo + i;
    const int e = pos / bt;
    s_row[i] = e < NW ? table[e] * bt + (pos - e * bt) : 0;
  }
}

// weight of a softmax state with max m against the merged max: 0 for a
// state that saw no key
__device__ __forceinline__ float rescale(float m, float safe_max) {
  return m <= kNegInf / 2 ? 0.f : expf(m - safe_max);
}
__device__ __forceinline__ float safe(float m) {
  return m <= kNegInf / 2 ? 0.f : m;
}

// ------------------------------------------------------------------- simt

// fp32 throughout. NC: 16-byte chunks per lane per row (D / 64, rounded
// up); GB: query rows per block. Each half-warp has U keys in flight per
// step.
template <int NC, int GB>
__global__ void __launch_bounds__(kThreads)
paged_simt_kernel(const float* __restrict__ q,
                  const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ tables,
                  const int* __restrict__ qpos, float* __restrict__ out,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int S, int H, int KV, int D, int bt, int NW,
                  int keys_per_split, float scale, float softcap) {
  constexpr int kVec = 4;               // floats per 16-byte chunk
  constexpr int U = 4 / NC;             // keys in flight per half-warp
  const int G = H / KV;
  const int n_rows = S * G;
  const int n_groups = (n_rows + GB - 1) / GB;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int kvh = blockIdx.y / n_groups;
  const int r0 = (blockIdx.y - kvh * n_groups) * GB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid / kLanesPerKey;     // this half-warp's index
  const int c = lane & (kLanesPerKey - 1);
  const int C = D / kVec;                 // chunks per row

  // the rows' positions (-1 past the tile: such a row sees no key) and the
  // keys any of them can see
  int qp[GB];
  int qmax = -1;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int r = r0 + g;
    qp[g] = r < n_rows ? qpos[b * S + r / G] : -1;
    qmax = max(qmax, qp[g]);
  }
  const int lo = split * keys_per_split;
  // the pool rows of this split's keys, looked up while the positions are
  // in flight (the merge's buffers come first in shared memory)
  extern __shared__ float smem[];
  constexpr int kWarps = kThreads / 32;
  float* s_acc = smem;                          // [kWarps][GB][D]
  float* s_m = s_acc + kWarps * GB * D;         // [kWarps][GB]
  float* s_l = s_m + kWarps * GB;               // [kWarps][GB]
  int* s_row = reinterpret_cast<int*>(s_l + kWarps * GB);
  pool_rows(s_row, tables + (size_t)b * NW, lo, keys_per_split, bt, NW);
  const int kend = min(qmax + 1, NW * bt);
  const int end = min(kend, lo + keys_per_split);

  // output row of group row g: (b, token, head) flattened
  auto out_row = [&](int g) -> size_t {
    const int r = r0 + g;
    return ((size_t)b * S + r / G) * H + kvh * G + r % G;
  };

  if (lo >= end) {
    // nothing of this split is visible: a neutral state (a single split
    // writes the rows' zeros directly)
    for (int i = tid; i < GB * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      if (r0 + g >= n_rows) continue;
      if (n_splits == 1) {
        store(out + out_row(g) * D + d, 0.f);
      } else if (d == 0) {
        part_ml[(out_row(g) * n_splits + split) * 2] = kNegInf;
        part_ml[(out_row(g) * n_splits + split) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // this lane's chunks of the GB query rows, times the scale
  float qr[GB][NC][kVec];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int chunk = c + n * kLanesPerKey;
      if (r0 + g < n_rows && chunk < C) {
        unpack(load16(q + out_row(g) * D + chunk * kVec), qr[g][n]);
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

  __syncthreads();  // s_row
  for (int k0 = lo; k0 < end; k0 += kSubWarps * U) {
    // every load of the step first, then the arithmetic
    uint4 kr[U][NC], vr[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = k0 + u * kSubWarps + sub;
      size_t off = 0;
      if (t < end) off = ((size_t)s_row[t - lo] * KV + kvh) * D;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int chunk = c + n * kLanesPerKey;
        if (t < end && chunk < C) {
          kr[u][n] = load16(k + off + chunk * kVec);
          vr[u][n] = load16(v + off + chunk * kVec);
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
      const int t = k0 + u * kSubWarps + sub;
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
        s[u][g] = (t < end && t <= qp[g]) ? x : kNegInf;
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
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    if (r0 + g >= n_rows) continue;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GB + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = rescale(s_m[w * GB + g], safe(mx));
      lsum += wt * s_l[w * GB + g];
      a += wt * s_acc[(w * GB + g) * D + d];
    }
    const size_t row = out_row(g);
    if (n_splits == 1) {
      store(out + row * D + d, a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(row * n_splits + split) * D + d] = a;
      if (d == 0) {
        part_ml[(row * n_splits + split) * 2] = mx;
        part_ml[(row * n_splits + split) * 2 + 1] = lsum;
      }
    }
  }
}

// second pass: merge the splits' softmax states, one warp per output row.
// Lane i takes split i's state (32 splits a round) and the warp reduces
// the maximum and the weighted sum; then each lane sums its 4-column
// pieces of the row over the splits, the weights passed along by shuffles.
// A split that saw no key (m = -inf, l = 0) gets weight 0, and its
// accumulator, never written, is not read; a row no split saw gives 0.
constexpr int kMergeRows = 4;  // rows (warps) per block

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  uint2 r;
  r.x = attn::pack_bf16(x.x, x.y);
  r.y = attn::pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = r;
}

template <typename T>
__global__ void __launch_bounds__(kMergeRows * 32)
paged_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int rows, int n_splits, int D) {
  const size_t row = (size_t)blockIdx.x * kMergeRows + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  const float* ml = part_ml + row * n_splits * 2;
  float mx = kNegInf;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, ml[2 * s]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float sm = safe(mx);
  float lsum = 0.f;
  for (int s = lane; s < n_splits; s += 32)
    lsum += rescale(ml[2 * s], sm) * ml[2 * s + 1];
  for (int o = 16; o > 0; o >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  const float* acc = part_acc + row * n_splits * D;
  // every lane walks every column group, so that the shuffles below see
  // all 32 lanes whatever D is; lanes past D load and store nothing
  for (int c0 = 0; c0 < D; c0 += 128) {
    const int c = c0 + 4 * lane;
    const bool live = c < D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_splits; s0 += 32) {
      const int n = min(32, n_splits - s0);
      const float w_lane =
          lane < n ? rescale(ml[2 * (s0 + lane)], sm) : 0.f;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        // the same for the whole warp (one row): an empty split's
        // accumulator is neither read nor counted
        const float w = __shfl_sync(0xffffffffu, w_lane, i);
        if (live && w > 0.f) {
          const float4 x = *reinterpret_cast<const float4*>(
              acc + (size_t)(s0 + i) * D + c);
          a.x = fmaf(w, x.x, a.x);
          a.y = fmaf(w, x.y, a.y);
          a.z = fmaf(w, x.z, a.z);
          a.w = fmaf(w, x.w, a.w);
        }
      }
    }
    if (live)
      store4(out + row * D + c,
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T>
cudaError_t launch_merge(const void* part_ml, const void* part_acc,
                         void* out, int rows, int n_splits, int D,
                         cudaStream_t stream) {
  paged_merge_kernel<T>
      <<<(rows + kMergeRows - 1) / kMergeRows, kMergeRows * 32, 0, stream>>>(
          static_cast<const float*>(part_ml),
          static_cast<const float*>(part_acc), static_cast<T*>(out), rows,
          n_splits, D);
  return cudaGetLastError();
}

template <int NC, int GB>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* tables, const void* qpos, void* out,
                        void* part_ml, void* part_acc, int B, int S, int H,
                        int KV, int D, int bt, int NW, int n_splits,
                        int keys_per_split, float scale, float softcap,
                        cudaStream_t stream) {
  const int n_rows = S * (H / KV);
  const dim3 grid(n_splits, KV * ((n_rows + GB - 1) / GB), B);
  const size_t smem = (size_t)(4 * GB * D + 2 * 4 * GB) * sizeof(float) +
                      keys_per_split * sizeof(int);
  paged_simt_kernel<NC, GB><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<float*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, KV,
      D, bt, NW, keys_per_split, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return launch_merge<float>(part_ml, part_acc, out, B * S * H, n_splits, D,
                             stream);
}

template <int NC>
cudaError_t simt_by_rows(const void* q, const void* k, const void* v,
                         const void* tables, const void* qpos, void* out,
                         void* part_ml, void* part_acc, int B, int S, int H,
                         int KV, int D, int bt, int NW, int n_splits,
                         int keys_per_split, float scale, float softcap,
                         cudaStream_t stream) {
  // rows per block: the next power of two of S*G, at most 8 (4 where a
  // row's chunks per lane already take 16 registers)
  constexpr int kMaxGB = NC >= 4 ? 4 : 8;
  const int n_rows = S * (H / KV);
#define SIMT_LAUNCH(GB)                                                   \
  return launch_simt<NC, GB>(q, k, v, tables, qpos, out, part_ml,        \
                             part_acc, B, S, H, KV, D, bt, NW, n_splits, \
                             keys_per_split, scale, softcap, stream)
  if (n_rows <= 1) SIMT_LAUNCH(1);
  if (n_rows <= 2) SIMT_LAUNCH(2);
  if constexpr (kMaxGB == 4) {
    SIMT_LAUNCH(4);
  } else {
    if (n_rows <= 4) SIMT_LAUNCH(4);
    SIMT_LAUNCH(8);
  }
#undef SIMT_LAUNCH
}

cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          const void* tables, const void* qpos, void* out,
                          void* part_ml, void* part_acc, int B, int S, int H,
                          int KV, int D, int bt, int NW, int n_splits,
                          int keys_per_split, float scale, float softcap,
                          cudaStream_t stream) {
  // 16-byte chunks a row: at most 64 (D <= 256)
#define SIMT_NC(NC)                                                          \
  return simt_by_rows<NC>(q, k, v, tables, qpos, out, part_ml, part_acc, B, \
                          S, H, KV, D, bt, NW, n_splits, keys_per_split,    \
                          scale, softcap, stream)
  if (D <= 64) SIMT_NC(1);
  if (D <= 128) SIMT_NC(2);
  SIMT_NC(4);
#undef SIMT_NC
}

// -------------------------------------------------------------------- mma

// DP: D rounded up to a multiple of 32 (the zero-filled depth); BK: keys a
// stage; NS: stages in the ring; RW: warps along the rows. RW = 4 (prefill
// chunks): a block takes 64 rows, one warp per 16, each warp walking every
// staged key. RW = 1 (decode): a block takes 16 rows, shared by its 4 warps,
// and each warp walks a quarter of every staged key tile with its own
// softmax state; the warps' states are merged through shared memory at the
// end, so no warp idles however few rows the KV head has. Shared memory: the
// query tile, a ring of NS stages of K and V (NS - 1 in flight while the
// block computes on one), each row padded by 16 bytes so that ldmatrix's 8
// row reads of a matrix fall in distinct banks, and the pool rows of the
// block's keys. Grid (row tiles x splits, KV, B): like the simt design, each
// block walks one of n_splits ranges of keys_per_split keys (a multiple of
// BK); with one split the block writes the output, else its state for the
// merge pass.
template <int DP, int BK, int NS, int RW>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ tables,
                 const int* __restrict__ qpos, bf16* __restrict__ out,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int S, int H, int KV, int D, int bt, int NW,
                 int keys_per_split, float scale, float softcap) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;          // 16-byte chunks of a row
  constexpr int ROWS = 16 * RW;       // query rows a block
  constexpr int WK = BK * RW / 4;     // keys of a stage a warp walks
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* sK = sQ + ROWS * LD;                     // [NS][BK][LD]
  bf16* sV = sK + NS * BK * LD;                  // [NS][BK][LD]
  int* s_row = reinterpret_cast<int*>(sV + NS * BK * LD);
  __shared__ int s_qpos[ROWS];
  __shared__ int s_kend;

  const int G = H / KV;
  const int n_rows = S * G;
  const int n_splits = gridDim.x / ((n_rows + ROWS - 1) / ROWS);
  const int split = blockIdx.x % n_splits;
  const int row0 = (blockIdx.x / n_splits) * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = RW == 1 ? 0 : warp * 16;  // the warp's first tile row
  const int wkey = RW == 1 ? warp * WK : 0;  // its first key of a stage
  const int lo = split * keys_per_split;

  if (tid < ROWS) {
    const int r = row0 + tid;
    s_qpos[tid] = r < n_rows ? qpos[b * S + r / G] : -1;
  }
  pool_rows(s_row, tables + (size_t)b * NW, lo, keys_per_split, bt, NW);
  __syncthreads();
  if (tid < 32) {
    // no row of the tile sees a key past its largest position, and the
    // table ends at NW * bt
    int mx = -1;
    for (int i = tid; i < ROWS; i += 32) mx = max(mx, s_qpos[i]);
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tid == 0) s_kend = min(mx + 1, NW * bt);
  }
  __syncthreads();
  const int end = min(s_kend, lo + keys_per_split);
  const int qp[2] = {s_qpos[wrow + g], s_qpos[wrow + g + 8]};
  // output row of tile row r: (b, token, head) flattened
  auto out_row = [&](int r) -> size_t {
    return ((size_t)b * S + r / G) * H + kvh * G + r % G;
  };

  if (lo >= end && n_splits > 1) {
    // nothing of this split is visible: a neutral state
    if (tid < ROWS && row0 + tid < n_rows) {
      const size_t row = out_row(row0 + tid);
      part_ml[(row * n_splits + split) * 2] = kNegInf;
      part_ml[(row * n_splits + split) * 2 + 1] = 0.f;
    }
    return;
  }

  // the query tile, rows past the tile's end and depth past D zero-filled
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int lr = i / CH;
    const int c = (i - lr * CH) * 8;
    const int r = row0 + lr;
    const bool ok = r < n_rows && c < D;
    const bf16* src = ok ? q + out_row(r) * D + c : q;
    attn::cp_async16(sQ + lr * LD + c, src, ok);
  }
  attn::cp_async_commit();

  // stage keys k0 .. k0+BK-1 of this kv head from the pool rows the table
  // names; keys past end and depth past D are zero-filled
  auto stage = [&](int k0, int buf) {
    bf16* dk = sK + buf * BK * LD;
    bf16* dv = sV + buf * BK * LD;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int j = i / CH;
      const int c = (i - j * CH) * 8;
      const int pos = k0 + j;
      const bool ok = pos < end && c < D;
      const size_t off =
          ok ? ((size_t)s_row[pos - lo] * KV + kvh) * D + c : 0;
      attn::cp_async16(dk + j * LD + c, k + off, ok);
      attn::cp_async16(dv + j * LD + c, v + off, ok);
    }
    attn::cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  // the first NS - 1 stages; a stage past the end commits an empty group,
  // so that the number of groups in flight stays NS - 1
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (lo + i * BK < end) {
      stage(lo + i * BK, i);
    } else {
      attn::cp_async_commit();
    }
  }
  int buf = 0;
  for (int k0 = lo; k0 < end; k0 += BK) {
    attn::cp_async_wait<NS - 2>();  // this stage (and the query tile) landed
    // ... for every thread, and every warp is done with the stage that the
    // next copies refill
    __syncthreads();
    const int next = k0 + (NS - 1) * BK;
    if (next < end) {
      stage(next, (buf + NS - 1) % NS);
    } else {
      attn::cp_async_commit();
    }
    float s[WK / 8][4];
    attn::qk_tile<WK>(s, sQ + wrow * LD, LD,
                      sK + (buf * BK + wkey) * LD, LD, DP / 16, lane);
#pragma unroll
    for (int n = 0; n < WK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + wkey + n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[n][e] = (kpos < end && kpos <= qp[e >> 1]) ? x : kNegInf;
      }
    attn::softmax_step<WK, DP / 8>(s, m, l, o);
    attn::pv_tile<WK, DP / 8>(o, s, sV + (buf * BK + wkey) * LD, LD,
                                 lane);
    buf = (buf + 1) % NS;
  }
  attn::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  attn::reduce_rows(l);

  // the state of tile row r, columns [c0, c0 + 2): one lane's
  auto emit = [&](int r, int c0, float mm, float ll, float a0, float a1) {
    const size_t row = out_row(r);
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(ll, 1e-30f);
      *reinterpret_cast<uint32_t*>(out + row * D + c0) =
          attn::pack_bf16(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(part_acc + (row * n_splits + split) * D +
                                 c0) = make_float2(a0, a1);
      if (c0 == 0) {
        part_ml[(row * n_splits + split) * 2] = mm;
        part_ml[(row * n_splits + split) * 2 + 1] = ll;
      }
    }
  };

  if constexpr (RW == 1) {
    // merge the 4 warps' states of the 16 rows through shared memory, in
    // the stages' place
    float* s_o = reinterpret_cast<float*>(sK);  // [kWarps][16][DP]
    __shared__ float s_m[kWarps][16], s_l[kWarps][16];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
#pragma unroll
      for (int d = 0; d < DP / 8; ++d)
        *reinterpret_cast<float2*>(s_o + (warp * 16 + r) * DP + d * 8 +
                                   2 * t4) =
            make_float2(o[d][2 * i], o[d][2 * i + 1]);
      if (t4 == 0) {
        s_m[warp][r] = m[i];
        s_l[warp][r] = l[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < 16 * (D / 2); i += kThreads) {
      const int r = i / (D / 2);
      const int c0 = 2 * (i - r * (D / 2));
      if (row0 + r >= n_rows) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
      float ll = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = rescale(s_m[w][r], safe(mx));
        const float2 x =
            *reinterpret_cast<const float2*>(s_o + (w * 16 + r) * DP + c0);
        ll += wt * s_l[w][r];
        a0 += wt * x.x;
        a1 += wt * x.y;
      }
      emit(row0 + r, c0, mx, ll, a0, a1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + wrow + g + 8 * i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        const int c0 = d * 8 + 2 * t4;
        if (c0 < D) emit(r, c0, m[i], l[i], o[d][2 * i], o[d][2 * i + 1]);
      }
    }
  }
}

template <int DP, int BK, int NS, int RW>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* tables, const void* qpos, void* out,
                       void* part_ml, void* part_acc, int B, int S, int H,
                       int KV, int D, int bt, int NW, int n_splits,
                       int keys_per_split, float scale, float softcap,
                       cudaStream_t stream) {
  static_assert(RW == 4 || 4 * 16 * DP * 4 <= 2 * NS * BK * (DP + 8) * 2,
                "the warps' merge reuses the K/V stages");
  if (keys_per_split % BK) return cudaErrorInvalidValue;
  const int smem = (16 * RW + 2 * NS * BK) * (DP + 8) * (int)sizeof(bf16) +
                   keys_per_split * (int)sizeof(int);
  auto kernel = paged_mma_kernel<DP, BK, NS, RW>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = 16 * RW;
  const int tiles = (S * (H / KV) + rows - 1) / rows;
  const dim3 grid(tiles * n_splits, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<bf16*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), S, H, KV,
      D, bt, NW, keys_per_split, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return launch_merge<bf16>(part_ml, part_acc, out, B * S * H, n_splits, D,
                            stream);
}

template <int RW>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* tables, const void* qpos, void* out,
                         void* part_ml, void* part_acc, int B, int S, int H,
                         int KV, int D, int bt, int NW, int n_splits,
                         int keys_per_split, float scale, float softcap,
                         cudaStream_t stream) {
  // a warp walks at least 16 keys of a stage: RW = 1 stages 64; three
  // stages but where they would not fit two blocks an SM (RW = 1 at D = 256
  // takes two)
#define MMA_LAUNCH(DP, BK)                                                  \
  return launch_mma<DP, (RW == 1 ? 64 : BK),                                \
                    (RW == 1 && DP == 256 ? 2 : 3), RW>(                    \
      q, k, v, tables, qpos, out, part_ml, part_acc, B, S, H, KV, D, bt, NW, \
      n_splits, keys_per_split, scale, softcap, stream)
  if (D <= 32) MMA_LAUNCH(32, 64);
  if (D <= 64) MMA_LAUNCH(64, 64);
  if (D <= 128) MMA_LAUNCH(128, 32);
  MMA_LAUNCH(256, 32);
#undef MMA_LAUNCH
}

// --------------------------------------------- earlier design (tile16)

namespace tile16 {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileKeys = 32;                 // keys staged per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one block of 4 warps per (16 query rows, kv head, b), each warp 4 rows;
// for QK^T lane j takes key j of the staged tile, for PV lane l owns output
// dims l, l+32, ... NV = ceil(D / 32) rounded up to a power of two.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ tables,
       const int* __restrict__ qpos, T* __restrict__ out, int S, int H,
       int KV, int D, int bt, int NW, float scale, float softcap) {
  constexpr int kVec = 16 / sizeof(T);
  const int ld = D + kVec;
  const int tile = kTileKeys * ld;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);       // [kRows][D] q * scale
  T* sk = reinterpret_cast<T*>(sq + kRows * D);     // [2][kTileKeys][ld]
  T* sv = sk + 2 * tile;                            // [2][kTileKeys][ld]
  __shared__ int s_qpos[kRows];
  __shared__ int s_kend;

  const int G = H / KV;
  const int n_rows = S * G;
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid < kRows) {
    const int r = row0 + tid;
    s_qpos[tid] = r < n_rows ? qpos[b * S + r / G] : -1;
  }
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int lr = i / D, d = i - lr * D, r = row0 + lr;
    float x = 0.f;
    if (r < n_rows) {
      const int h = kvh * G + r % G;
      x = to_float(q[((size_t)(b * S + r / G) * H + h) * D + d]) * scale;
    }
    sq[i] = x;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int i = 0; i < kRows; ++i) mx = max(mx, s_qpos[i]);
    s_kend = min(mx + 1, NW * bt);
  }
  __syncthreads();
  const int kend = s_kend;

  const int chunks_per_row = D / kVec;
  auto stage = [&](int k0, int buf) {
    T* dk = sk + buf * tile;
    T* dv = sv + buf * tile;
    for (int i = tid; i < kTileKeys * chunks_per_row; i += blockDim.x) {
      const int j = i / chunks_per_row;
      const int c = (i - j * chunks_per_row) * kVec;
      const int pos = k0 + j;
      T* tk = dk + j * ld + c;
      T* tv = dv + j * ld + c;
      if (pos < kend) {
        const size_t page = (size_t)tables[b * NW + pos / bt];
        const size_t off = ((page * bt + pos % bt) * KV + kvh) * D + c;
        attn::cp_async16(tk, k + off);
        attn::cp_async16(tv, v + off);
      } else {
        *reinterpret_cast<uint4*>(tk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(tv) = make_uint4(0, 0, 0, 0);
      }
    }
    attn::cp_async_commit();
  };

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NV];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;
  }

  stage(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < kend; k0 += kTileKeys) {
    if (k0 + kTileKeys < kend) {
      stage(k0 + kTileKeys, buf ^ 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const T* krow = sk + buf * tile + lane * ld;
    const T* vbuf = sv + buf * tile;
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int lr = warp * kRowsPerWarp + rr;
      const int qp = s_qpos[lr];
      if (qp < k0) continue;
      const float* qrow = sq + lr * D;
      float s = 0.f;
      for (int c = 0; c < D; c += kVec) {
        float kf[kVec];
        unpack(*reinterpret_cast<const uint4*>(krow + c), kf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(qrow[c + e], kf[e], s);
      }
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool valid = kpos <= qp && kpos < kend;
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float p = valid ? expf(s - safe_m) : 0.f;
      const float alpha = m[rr] <= kNegInf / 2 ? 0.f : expf(m[rr] - safe_m);
      m[rr] = m_new;
      l[rr] = alpha * l[rr] + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < kTileKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const T* vrow = vbuf + j * ld;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] = fmaf(pj, to_float(vrow[d]), acc[rr][i]);
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + warp * kRowsPerWarp + rr;
    if (r >= n_rows) continue;
    const int h = kvh * G + r % G;
    T* orow = out + ((size_t)(b * S + r / G) * H + h) * D;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(orow + d, acc[rr][i] / denom);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* qpos, void* out, int B,
                   int S, int H, int KV, int D, int bt, int NW, float scale,
                   float softcap, cudaStream_t stream) {
  const size_t ld = D + 16 / sizeof(T);
  const size_t smem = kRows * D * sizeof(float)
                      + 4 * kTileKeys * ld * sizeof(T);
  auto fn = kernel<T, NV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S * (H / KV) + kRows - 1) / kRows, KV, B);
  fn<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<T*>(out), S, H, KV, D, bt,
      NW, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* tables, const void* qpos, void* out, int B,
                     int S, int H, int KV, int D, int bt, int NW,
                     float scale, float softcap, cudaStream_t stream) {
  const int nv = (D + 31) / 32;
#define TILE16_LAUNCH(NV)                                                 \
  return launch<T, NV>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt, NW, \
                       scale, softcap, stream)
  if (nv <= 1) TILE16_LAUNCH(1);
  if (nv <= 2) TILE16_LAUNCH(2);
  if (nv <= 4) TILE16_LAUNCH(4);
  TILE16_LAUNCH(8);
#undef TILE16_LAUNCH
}

}  // namespace tile16

bool bad_shape(int B, int S, int H, int KV, int D, int bt, int NW) {
  return KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
         bt <= 0 || NW <= 0 || B > 65535 || KV > 65535;
}

}  // namespace

// q, out: (B, S, H, D); k, v: (NB, bt, KV, D); tables: (B, NW) int32 pool
// rows; qpos: (B, S) int32. All contiguous, q/k/v 16-byte aligned. dtype 0 =
// float32, 1 = bfloat16. design 0 = simt (float32 only), 1 = mma64, 2 =
// mma16 (bfloat16 only, keys_per_split a multiple of 64). Each walks
// n_splits ranges of keys_per_split (at most 4096) keys over [0, NW*bt);
// with n_splits > 1, part_ml (B*S*H, n_splits, 2) and part_acc (B*S*H,
// n_splits, D), fp32, hold the splits' states for the merge pass. softcap <=
// 0 turns the softcap off. Launches on `stream` and returns the CUDA error
// code of the launches (0 on success); does not synchronise.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* qpos, void* out,
                                      void* part_ml, void* part_acc, int B,
                                      int S, int H, int KV, int D, int bt,
                                      int NW, int n_splits,
                                      int keys_per_split, float scale,
                                      float softcap, int dtype, int design,
                                      void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (bad_shape(B, S, H, KV, D, bt, NW) || n_splits <= 0 ||
      keys_per_split <= 0 || keys_per_split > kMaxSplitKeys ||
      (long long)n_splits * keys_per_split < (long long)NW * bt ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1 && dtype == 1)
    return dispatch_mma<4>(q, k, v, tables, qpos, out, part_ml, part_acc, B,
                           S, H, KV, D, bt, NW, n_splits, keys_per_split,
                           scale, softcap, st);
  if (design == 2 && dtype == 1)
    return dispatch_mma<1>(q, k, v, tables, qpos, out, part_ml, part_acc, B,
                           S, H, KV, D, bt, NW, n_splits, keys_per_split,
                           scale, softcap, st);
  if (design == 0 && dtype == 0)
    return dispatch_simt(q, k, v, tables, qpos, out, part_ml, part_acc, B, S,
                         H, KV, D, bt, NW, n_splits, keys_per_split, scale,
                         softcap, st);
  return cudaErrorInvalidValue;
}

// The earlier design, for timing against: the same arguments as above
// without the plan and the partials.
extern "C" int paged_attention_tile16_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* qpos, void* out, int B, int S, int H, int KV, int D, int bt,
    int NW, float scale, float softcap, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (bad_shape(B, S, H, KV, D, bt, NW)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tile16::dispatch<float>(q, k, v, tables, qpos, out, B, S, H, KV,
                                   D, bt, NW, scale, softcap, st);
  if (dtype == 1)
    return tile16::dispatch<bf16>(q, k, v, tables, qpos, out, B, S, H, KV,
                                  D, bt, NW, scale, softcap, st);
  return cudaErrorInvalidValue;
}
