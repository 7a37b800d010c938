// Device helpers of the attention kernels (paged_attention.cu,
// flash_attention.cu): asynchronous copies, the online-softmax step on the
// fp32 score fragments of a 16-row warp tile (the layout of mma.sync's and
// wgmma's accumulators alike), and, for the paged kernel, ldmatrix and the
// bf16 tensor-core product mma.sync.m16n8k16 with fp32 accumulation.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4): the accumulator c[0..1] holds row g, columns 2t and 2t+1
// of an 8-column tile, c[2..3] row g + 8, the same columns. A warp tile of
// 16 rows x N columns is N / 8 such tiles, so each lane owns two rows (g
// and g + 8) and 2 * N / 8 columns of each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 16-byte global -> shared copy that bypasses the registers (and L1); with
// `pred` false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred = true) {
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

// four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and lane (4g + t) receives row g, columns 2t and
// 2t+1 of each (with .trans: column g, rows 2t and 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a * b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, x in the low half (the lower column), each
// rounded to nearest even as torch casts
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c * tanh(s / c) as c * (1 - 2 / (exp(2s / c) + 1)), given two_over_cap =
// 2 / c: exact at both tails (exp overflow gives c, underflow -c) and
// within about 1e-7 * c of it, at a few instructions and no division
__device__ __forceinline__ float softcap_fast(float s, float cap,
                                              float two_over_cap) {
  const float e = __expf(s * two_over_cap);
  return cap * (1.f - __fdividef(2.f, e + 1.f));
}

// S = Q K^T for one warp's 16 query rows against BK staged keys: q points
// at the warp's first row, k at the first key, both bf16 in shared memory
// with row strides ldq and ldk (elements, rows 16-byte aligned); nk steps
// of 16 along the depth. s[n] is the 8-key tile n of the result.
template <int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4],
                                        const __nv_bfloat16* q, int ldq,
                                        const __nv_bfloat16* k, int ldk,
                                        int nk, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  // A: rows lane % 16, columns 8 * (lane / 16); B (K rows [key][depth],
  // read untransposed as the col-major operand): keys lane % 8 + 8 * (lane
  // / 16), columns 8 * ((lane / 8) % 2)
  const __nv_bfloat16* qa = q + (lane & 15) * ldq + (lane >> 4) * 8;
  const __nv_bfloat16* kb =
      k + ((lane & 7) + ((lane >> 4) << 3)) * ldk + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, kb + n * 8 * ldk + kk * 16);
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

// The online-softmax step for one warp tile. On entry s holds the tile's
// fp32 scores, masked ones at kNegInf; m[i] and l[i] are the running max
// and this lane's partial sum of row g + 8i, o the unnormalised output.
// On exit s holds the probabilities exp(s - m_new), o is rescaled by
// exp(m_old - m_new) and l updated. A row that has seen no key yet keeps m
// at kNegInf and gets p = 0, alpha = 0 (exp2 of about -1.4e30).
template <int BK, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[NO][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    // the four lanes of a row (same g) hold its columns
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float neg = -safe * kLog2e;
    // exactly 1 while the max stands, so o and l keep their scale
    const float alpha = exp2f((m[i] - safe) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = exp2f(fmaf(s[n][e], kLog2e, neg));
        s[n][e] = p;
        sum += p;
      }
    }
    m[i] = m_new;
    l[i] = alpha * l[i] + sum;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      o[d][2 * i] *= alpha;
      o[d][2 * i + 1] *= alpha;
    }
  }
}

// o += P V for one warp tile: p the probabilities of BK keys (the score
// fragments, reused as the A operand 16 keys at a time), v the staged
// values [key][depth] in shared memory (row stride ldv), NO output tiles
// of 8 columns. P is taken as three bf16 parts, each the rounding of what
// the ones before leave: they carry all of fp32's 24 bits (8 + 8 + 8), and
// each part's product with bf16 V is exact in fp32.
template <int BK, int NO>
__device__ __forceinline__ void pv_tile(float (&o)[NO][4],
                                        const float (&p)[BK / 8][4],
                                        const __nv_bfloat16* v, int ldv,
                                        int lane) {
  // B by .trans from V rows [key][depth]: keys lane % 16, columns 8 *
  // (lane / 16)
  const __nv_bfloat16* vb = v + (lane & 15) * ldv + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    // A fragment of keys 16j .. 16j+15: score tiles 2j (a0, a1) and 2j+1
    // (a2, a3), rows g (x[0], x[1]) and g + 8 (x[2], x[3])
    float x[4][2] = {{p[2 * j][0], p[2 * j][1]},
                     {p[2 * j][2], p[2 * j][3]},
                     {p[2 * j + 1][0], p[2 * j + 1][1]},
                     {p[2 * j + 1][2], p[2 * j + 1][3]}};
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = pack_bf16(x[r][0], x[r][1]);
        x[r][0] -= __uint_as_float(a[r] << 16);
        x[r][1] -= __uint_as_float(a[r] & 0xffff0000u);
      }
      // one pass over the output tiles per part, so no two products in a
      // row wait on the same accumulator
#pragma unroll
      for (int d = 0; d < NO; d += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + j * 16 * ldv + d * 8);
        mma_bf16(o[d], a, b[0], b[1]);
        mma_bf16(o[d + 1], a, b[2], b[3]);
      }
    }
  }
}

// the rows' sums over their four lanes, at the end of the walk
__device__ __forceinline__ void reduce_rows(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

}  // namespace attn
