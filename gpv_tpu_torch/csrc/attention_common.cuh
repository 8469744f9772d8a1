// Pieces shared by the attention kernels of gpv_tpu_torch/csrc: the mask
// value, warp reductions, 16- and 4-byte asynchronous copies, the bf16 row
// copy for any head dim, the bf16 tensor-core fragments (ldmatrix,
// mma.sync m16n8k16), and the cluster pieces of the wide-head route. Every
// kernel's name starts with `gpv_attn_`, so a profiler groups them by that
// prefix.
//
// Head dims above kMaxCols (the JAX package takes any) run on thread-block
// clusters: a cluster of n = ceil(Dh / C) CTAs owns one (batch, head, query
// block), and CTA r owns head dims [r C, r C + C) (the wrapper's plan picks
// C: the head dim split evenly, rounded up to 16, at most kMaxCols). Each
// CTA holds only its slices of Q, K and V and its columns of O, so its
// shared memory is a narrow block's at every Dh. Per key tile every CTA
// scores the keys over its slice, writes the partial scores to its own
// shared memory, and after a cluster barrier sums the n partials through
// distributed shared memory in rank order (`cluster_sum`), so every CTA
// holds the same fp32 S once and runs the same softmax; P.V then runs on
// its own V columns. Up to 8 CTAs is a portable cluster; 9 to 16 (Dh 1025
// to 2048) a non-portable one, which the H100 schedules.
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
// Head dims one CTA holds at most; wider heads are split over a cluster.
constexpr int kMaxCols = 128;
// CTAs a cluster at most (above 8 only with the non-portable attribute).
constexpr int kMaxCluster = 16;

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

// CTAs of a head's cluster at head dim Dh with slices of `cols` dims: 1 up
// to kMaxCols.
__host__ __device__ constexpr int cluster_size(int Dh, int cols) {
  return Dh > kMaxCols ? (Dh + cols - 1) / cols : 1;
}
// The plan's `cols` is valid: 0 up to kMaxCols, else a multiple of 16 in
// [16, kMaxCols] that needs at most kMaxCluster CTAs.
__host__ __device__ constexpr bool bad_cols(int Dh, int cols) {
  return Dh > kMaxCols ? (cols < 16 || cols > kMaxCols || cols % 16 != 0 ||
                          cluster_size(Dh, cols) > kMaxCluster)
                       : cols != 0;
}

// Split cluster barrier: every thread of every CTA arrives (release: its
// shared-memory writes before are seen by every CTA after the wait), and
// waits (acquire) for the phase. A CTA's partial scores are exchanged as:
// [wait for the last exchange's readers] write, arrive, wait, read the
// other CTAs', arrive; and one last wait before the CTA leaves.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// The address of this CTA's shared variable p in the CTA of rank r.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(r));
  return a;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// s = the sum over the cluster's n CTAs, in rank order, of the N floats
// that the same thread wrote in each CTA: V (4 or 1) at a time, group k at
// part + k * stride floats (this CTA's are s on entry). Every CTA gets the
// same fp32 sums. Call between the wait that follows every CTA's writes
// and the arrive that releases them.
template <int N, int V>
__device__ __forceinline__ void cluster_sum(float (&s)[N], const float* part,
                                            int stride, int n, int me) {
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int r = 0; r < n; ++r) {
    float got[N];
    if (r == me) {
#pragma unroll
      for (int i = 0; i < N; ++i) got[i] = s[i];
    } else {
      const uint32_t base = cluster_addr(part, r);
#pragma unroll
      for (int k = 0; k < N / V; ++k) {
        const uint32_t at = base + 4u * k * stride;
        if constexpr (V == 4) {
          const float4 x = ld_cluster4(at);
          got[4 * k] = x.x;
          got[4 * k + 1] = x.y;
          got[4 * k + 2] = x.z;
          got[4 * k + 3] = x.w;
        } else {
          got[k] = ld_cluster(at);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += got[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = acc[i];
}

// s = the cluster's sum of the N floats each thread wrote to `part` (float4
// group k at part + k * stride), in two steps: the CTA of rank k % n sums
// group k over the cluster in rank order and writes the total over its own
// partial (no other CTA reads that slot in this step), then every CTA
// reads each group's total from its owner. Each CTA reads 2 (n - 1) / n of
// the partials' size where cluster_sum reads n - 1 times it, and every CTA
// gets the same fp32 sums. Call after the wait that follows every CTA's
// writes of `part`; the caller arrives once it returns.
template <int N>
__device__ __forceinline__ void cluster_allreduce(float (&s)[N], float* part,
                                                  int stride, int n, int me) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    if (k % n != me) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < n; ++r) {
      const float4 x = r == me ? make_float4(s[4 * k], s[4 * k + 1],
                                             s[4 * k + 2], s[4 * k + 3])
                               : ld_cluster4(cluster_addr(part, r) +
                                             4u * k * stride);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(part + k * stride) = acc;
    s[4 * k] = acc.x;
    s[4 * k + 1] = acc.y;
    s[4 * k + 2] = acc.z;
    s[4 * k + 3] = acc.w;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int owner = k % n;
    if (owner == me) continue;
    const float4 x = ld_cluster4(cluster_addr(part, owner) + 4u * k * stride);
    s[4 * k] = x.x;
    s[4 * k + 1] = x.y;
    s[4 * k + 2] = x.z;
    s[4 * k + 3] = x.w;
  }
}

// K2 on clusters: blockIdx.z = half * B + b, the first half the direction
// over more keys (the longer loop of dependent tiles), so that the block
// scheduler starts those first and the short ones fill in behind them.
// Sets the batch b and whether the block takes the second direction (the
// one whose keys number tk2).
__device__ __forceinline__ void long_first(int tk1, int tk2, int& b,
                                           bool& second) {
  const int B = gridDim.z >> 1;
  const bool first = (int)blockIdx.z < B;
  b = first ? blockIdx.z : blockIdx.z - B;
  second = first == (tk2 > tk1);
}

// Launch `kernel` on `grid` as clusters of `cluster` CTAs (each grid
// dimension a multiple of the cluster's) on stream s; returns the launch's
// cudaError_t.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, dim3 cluster,
                           int threads, int smem, cudaStream_t s,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// A cluster kernel's dynamic shared memory limit, and clusters of up to
// kMaxCluster CTAs allowed.
template <typename K>
cudaError_t allow_cluster(K* kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace gpv_attn
