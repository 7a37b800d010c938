// Paged attention for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// _paged_kernel and computes exactly what it computes: for each sequence b
// and KV head, the (S*G, D) tile of query rows (S query tokens times the G
// query heads that share the KV head) attends the KV pool pages named by
// the block table tables[b, :]. Block i of a table covers the logical
// positions [i*bt, (i+1)*bt), whatever pool row backs it, and row r (token
// s = r / G) sees the keys with kpos <= qpos[b, s]. Scores are taken on
// q*scale in fp32, optionally tanh-softcapped, then masked; the softmax is
// online in fp32 and the output is written in q's dtype.
//
// What bounds it on this card: HBM bytes. Every (b, kv-head) must read the
// K and V pages its visible positions need, plus its queries and outputs;
// the arithmetic is 4*D operations per (row, visible key) pair, far below
// the card's compute rate for these tile sizes. The design reads each
// staged K/V element once per block from device memory into shared memory
// and reuses it for the block's 16 query rows, reads only the table blocks
// some row of the tile can see (the walk stops at max qpos of the tile),
// and keeps m, l and the accumulator in registers, so nothing but q, the
// pages and the output crosses HBM. The page walk is a loop inside the
// block (on the TPU the grid's innermost dimension walked the table in
// order, with m/l/acc in VMEM), and the S*G rows are tiled over blocks
// because one block cannot hold a whole prefill chunk's tile. Each step of
// the walk stages 32 keys of K and V with 16-byte cp.async copies into one
// of two shared-memory buffers while the block computes on the other, so
// the page reads overlap the arithmetic instead of waiting on it.
//
// Layout: one block of 4 warps per (tile of 16 query rows, kv head, b);
// each warp owns 4 rows. For QK^T lane j takes key j of the staged tile;
// for PV lane l owns output dims l, l+32, ...

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTileKeys = 32;                 // keys staged per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
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

// the elements of one 16-byte chunk as floats, without taking the
// chunk's address (which would put it in local memory)
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

// 16-byte global -> shared copy that bypasses the registers (and L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NV = ceil(D / 32) rounded up to a power of two: output dims per lane.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ tables,
                       const int* __restrict__ qpos, T* __restrict__ out,
                       int S, int H, int KV, int D, int bt, int NW,
                       float scale, float softcap) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  // staged rows are padded by 16 bytes: rows stay 16-byte aligned, and the
  // 8 lanes of one 16-byte shared load phase hit distinct banks
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

  // tile row r is query token s = r / G of head kvh * G + r % G; rows past
  // the tile's end get qpos -1 and see no key
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
    // no row of the tile sees a key past its largest position, and the
    // table ends at NW * bt
    s_kend = min(mx + 1, NW * bt);
  }
  __syncthreads();
  const int kend = s_kend;

  // stage keys k0 .. k0+31 of this kv head into buffer `buf`, from the
  // pool rows the table names (a block reads its own table entries: there
  // is no scalar prefetch); keys past kend are zero-filled
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
        cp_async16(tk, k + off);
        cp_async16(tv, v + off);
      } else {
        *reinterpret_cast<uint4*>(tk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(tv) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
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
    // prefetch the next tile into the other buffer, then wait for this one
    if (k0 + kTileKeys < kend) {
      stage(k0 + kTileKeys, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* krow = sk + buf * tile + lane * ld;  // this lane's key
    const T* vbuf = sv + buf * tile;
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int lr = warp * kRowsPerWarp + rr;
      const int qp = s_qpos[lr];
      // a tile this row cannot see leaves m, l and acc as they are (warp-
      // uniform branch: one row per warp at a time)
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
    // every warp is done with `buf` before the next step refills it
    __syncthreads();
    buf ^= 1;
  }

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
                      + 4 * kTileKeys * ld * sizeof(T);  // K, V x 2 buffers
  auto kernel = paged_attention_kernel<T, NV>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S * (H / KV) + kRows - 1) / kRows, KV, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
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
  if (nv <= 1)
    return launch<T, 1>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt, NW,
                        scale, softcap, stream);
  if (nv <= 2)
    return launch<T, 2>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt, NW,
                        scale, softcap, stream);
  if (nv <= 4)
    return launch<T, 4>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt, NW,
                        scale, softcap, stream);
  return launch<T, 8>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt, NW,
                      scale, softcap, stream);
}

}  // namespace

// q, out: (B, S, H, D); k, v: (NB, bt, KV, D); tables: (B, NW) int32 pool
// rows; qpos: (B, S) int32. All contiguous, q/k/v 16-byte aligned. dtype
// 0 = float32, 1 = bfloat16. softcap <= 0 turns the softcap off. Launches
// on `stream` and returns the CUDA error code of the launch (0 on
// success); does not synchronise.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* qpos, void* out, int B,
                                      int S, int H, int KV, int D, int bt,
                                      int NW, float scale, float softcap,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      bt <= 0 || NW <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, tables, qpos, out, B, S, H, KV, D, bt,
                           NW, scale, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, tables, qpos, out, B, S, H, KV,
                                   D, bt, NW, scale, softcap, st);
  return cudaErrorInvalidValue;
}
