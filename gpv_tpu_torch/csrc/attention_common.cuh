// Pieces shared by the attention kernels of gpv_tpu_torch/csrc: the mask
// value, warp reductions, 16- and 4-byte asynchronous copies, the bf16 row
// copy for any head dim, and the bf16 tensor-core fragments (ldmatrix,
// mma.sync m16n8k16). Every kernel's name starts with `gpv_attn_`, so a
// profiler groups them by that prefix.
//
// Head dims above kMaxCols (the JAX package takes any): a block computes
// the scores over the whole head dim but only kMaxCols or fewer columns of
// the output, and the wrapper launches ceil(Dh / cols) such blocks per
// (batch, head, query block); each holds all of Q's and K's columns and
// only its own of V's in shared memory. The wrapper's plan picks `cols`
// (the head dim split evenly, rounded up to 16) and cuts the key tile, the
// warps or the rows of a block until it fits kMaxSmem.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gpv_attn {

constexpr float kNeg = -1e9f;  // the TPU kernel's additive mask value
constexpr float kLog2e = 1.4426950408889634f;
// The bf16 kernels keep scores in the log2 domain, t = s * log2(e), so that
// softmax's e^(s - max) is one ex2: kNeg2 is the mask value there. Like
// -1e9 in the natural domain it absorbs any score of a fully masked row
// (|s| below 32), so such a row stays uniform.
constexpr float kNeg2 = kNeg * kLog2e;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory one H100 block may have (227 KB).
constexpr int kMaxSmem = 232448;
// Output columns one block computes at most; wider heads are split.
constexpr int kMaxCols = 128;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 2^x in one MUFU.EX2 (2 ulp; results below 2^-126 flush to 0); -inf
// gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes and
// reads nothing (the ragged edges of a tile).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4-byte global -> shared copy (cp.async takes 4 bytes only through L1);
// src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The sum of the two bf16 values of a bf16x2 register, in fp32.
__device__ __forceinline__ float sum_bf16x2(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}

// 16-byte chunks in one shared-memory row of `d` bf16 values (d rounded up
// to a multiple of 8), made odd: eight rows read at the same column then
// fall in eight different 16-byte bank groups, so ldmatrix and 16-byte
// loads are free of bank conflicts without a swizzle.
__host__ __device__ constexpr int row_chunks(int d) {
  return ((d + 7) / 8) | 1;
}
__host__ __device__ constexpr int ceil8(int d) { return (d + 7) / 8 * 8; }

// bf16 values one copy moves at head dim Dh: 8 (16 bytes) when Dh is a
// multiple of 8, 2 (4 bytes) when it is even, else 1 (a plain load and
// store). Every row of a (B, T, H, Dh) tensor with a 16-byte-aligned base,
// and every column that is a multiple of 16, is then aligned to it.
__host__ __device__ constexpr int bf16_unit(int Dh) {
  return Dh % 8 == 0 ? 8 : Dh % 2 == 0 ? 2 : 1;
}

// Rows [r0, r0 + n) of NSRC bf16 tensors (rs elements between two rows),
// columns [c0, c0 + w) (w a multiple of 8), into shared rows of `stride`
// values: column c of a row is read when the row lies below `limit` and c
// below `valid`, else written as zero. U values a copy (bf16_unit); threads
// `tid` of `count` share the copy. U 1 stores synchronously, so the
// barrier or __syncwarp that follows the wait publishes it like the rest.
template <int U, int NSRC>
__device__ __forceinline__ void copy_bf16(
    __nv_bfloat16* const (&dst)[NSRC], const __nv_bfloat16* const (&src)[NSRC],
    int r0, int n, int limit, int c0, int w, int valid, size_t rs,
    int stride, int tid, int count) {
  const int per = w / U;  // copies a row
  for (int i = tid; i < n * per; i += count) {
    const int r = i / per, c = (i - r * per) * U;
    const bool ok = r0 + r < limit && c < valid;
    const size_t off = ok ? (size_t)(r0 + r) * rs + c0 + c : 0;
#pragma unroll
    for (int x = 0; x < NSRC; ++x) {
      __nv_bfloat16* d = dst[x] + r * stride + c;
      if constexpr (U == 8)
        cp_async16(d, src[x] + off, ok ? 16 : 0);
      else if constexpr (U == 2)
        cp_async4(d, src[x] + off, ok ? 4 : 0);
      else
        *d = ok ? src[x][off] : __float2bfloat16(0.f);
    }
  }
}
template <int NSRC>
__device__ __forceinline__ void copy_bf16_rows(
    int unit, __nv_bfloat16* const (&dst)[NSRC],
    const __nv_bfloat16* const (&src)[NSRC], int r0, int n, int limit,
    int c0, int w, int valid, size_t rs, int stride, int tid, int count) {
  if (unit == 8)
    copy_bf16<8, NSRC>(dst, src, r0, n, limit, c0, w, valid, rs, stride, tid,
                       count);
  else if (unit == 2)
    copy_bf16<2, NSRC>(dst, src, r0, n, limit, c0, w, valid, rs, stride, tid,
                       count);
  else
    copy_bf16<1, NSRC>(dst, src, r0, n, limit, c0, w, valid, rs, stride, tid,
                       count);
}

// Two adjacent bf16 outputs: one 4-byte store where Dh is even (the pair
// then lies inside the row and on a 4-byte boundary), else one or two
// 2-byte stores (`both`: the second lies inside the row).
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* dst, float a,
                                                float b, bool even,
                                                bool both) {
  if (even) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
  } else {
    dst[0] = __float2bfloat16(a);
    if (both) dst[1] = __float2bfloat16(b);
  }
}

// Output columns a block computes at head dim Dh: `cols` from the plan
// above kMaxCols, else all of them; and the blocks a head needs.
__host__ __device__ constexpr int block_cols(int Dh, int cols) {
  return Dh > kMaxCols ? cols : Dh;
}
__host__ __device__ constexpr int col_blocks(int Dh, int cols) {
  return (Dh + block_cols(Dh, cols) - 1) / block_cols(Dh, cols);
}
// The plan's `cols` is valid: 0 up to kMaxCols, else a multiple of 16 in
// [16, kMaxCols].
__host__ __device__ constexpr bool bad_cols(int Dh, int cols) {
  return Dh > kMaxCols ? (cols < 16 || cols > kMaxCols || cols % 16 != 0)
                       : cols != 0;
}

}  // namespace gpv_attn
