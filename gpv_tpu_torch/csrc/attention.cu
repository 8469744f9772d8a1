// Fused multi-head attention forward in fp32 for Hopper (sm_90a), plain C
// interface: the card's fp32 parity path of both Pallas TPU kernels of
// gpv_tpu/ops/attention.py (bf16 calls go to attention_tile.cu and
// attention_decode.cu):
//   gpv_attn_fp32    <- fused_attention   (cell body _attend_cell)
//   gpv_attn_fp32_bi <- fused_biattention (_make_biattn_kernel)
//
// What it computes, per (batch, head): S = (q * 1/sqrt(Dh)) . k^T in fp32,
// plus one fp32 mask term per score (-1e9 for an invalid key, -1e9 above
// the diagonal when causal, summed before it meets the score, as the TPU
// kernel's materialised mask; -inf for the key slots past Tk, which take
// no part), so a fully masked row gives V's mean; softmax with fp32
// statistics; P . V accumulated in fp32. Every product is an fp32 FMA on
// the CUDA cores: the route exists to hold the plain fp32 version to 1e-5,
// which TF32 would not. Layout (B, T, H, Dh), contiguous, 16-byte-aligned
// bases, any Dh >= 1 (a Dh that is not a multiple of 4 is copied element
// by element). Above Dh 128 both variants run on clusters (attention_
// common.cuh): n = ceil(Dh / C) CTAs own one (batch, head, query block),
// CTA r holds Q, K and V over its slice of C <= 128 head dims and O's
// columns of that slice, so a thread's O stays at 4 chunks of 4 and a
// CTA's shared memory is a Dh-128 block's plus its partial scores. Per key
// tile the CTAs exchange their partial scores through distributed shared
// memory and each sums them in rank order: S is computed once per row
// block, not once per column block, and K and V are read once. A cluster
// tile CTA owns 32 rows over 32-key tiles (P 40 floats a row), so that its
// shared memory stays under half an SM's; a cluster decode CTA of
// teacher-forced rows has 2 warps (the wrapper's plan; measured in
// PERF.md); K2's blocks over the direction with more keys are
// dispatched first (`long_first`).
//
// What bounds it on the card. With TF32 off the products run at the CUDA
// cores' 67 TFLOP/s, not the tensor cores' 495, so the line between bytes
// and operations moves: at the DETR encoder's 300 x 300 (Dh 32, B 20) the
// 1.84 GFLOP take 27.5 us against 7.3 us for the bytes, and every shape
// with Tq, Tk >= ~100 is bound by operations. One-row calls (the decode
// step: Tk x Dh multiply-adds on 8 Tk Dh bytes of K and V) stay bound by
// bytes. What limits this design is the shared memory feeding the FMAs:
// each thread reads 12 float4 per 128 FMAs in S and 8 per 64 in P.V at
// Dh 32, and one block of 4 warps already takes most of what an SM's
// shared memory delivers (measured in PERF.md). Two variants, chosen by
// the wrapper's `_plan`:
//
// tile (every K2 call, and K1 with Tq > 8 unless Tq <= 32 and Tk > 64): a
// block of 128 threads owns 64 query rows (32 when Tq <= 32, and for K2)
// of one (batch, head), so K and V are read ceil(Tq/64) times per (b, h),
// 5 at the DETR encoder.
// - Q is copied with cp.async and scaled once in shared memory. K and V
//   stream in 64-key tiles, double buffered with 16-byte cp.async: tile
//   t+1's copy flies while tile t is multiplied. Each tile's key-validity
//   bytes are read into a register one tile ahead.
// - S = Q.K^T is a register-blocked outer product: 8 lanes share a row
//   group and each thread owns 4 (2) rows x 8 keys of scores; per 4 dims
//   it reads its rows and keys as float4 from rows padded to an odd
//   number of 16-byte chunks (conflict-free). A tile of at most 32 keys
//   in range skips the upper half of its key columns.
// - Row max and sum are reduced among the 8 lanes of a row group
//   (shuffles); P goes to shared memory once, read back by the same warp.
// - O += P.V is a second register-blocked product: each thread owns its
//   rows x 4-dim chunks of O, in registers across the whole key loop.
//
// decode (Tq <= 8, the decode step and the beam's K rows; and Tq <= 32
// over Tk > 64, the teacher-forced cross-attention): one block per
// (batch, head, 8 query rows), 1-4 warps that split the keys a lane a
// key, with no 16-row slot. Each warp copies its keys' K and V rows with
// 16-byte cp.async (all of them issued at once: Tk <= 128 is one pass),
// scores them against q broadcast from shared memory, and the warps merge
// their (max, sum, acc) partials through shared memory (each in its own
// K rows, so that two blocks of Dh 96 fit an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <math.h>

#include "attention_common.cuh"

namespace gpv_attn {
namespace {

constexpr int kThreads = 128;     // tile: 4 warps
constexpr int kGroups = 16;       // tile: row groups of 8 lanes
// floats per row of P: the key tile plus 8, so that the rows of a warp's
// 4 row groups start 8 banks apart (conflict-free); 72 at 64 keys
__host__ __device__ constexpr int p_stride(int KT) { return KT + 8; }
constexpr int kDecodeRows = 8;    // decode: query rows a block at most
constexpr int kDecodeWarps = 4;
constexpr int kWarpKeys = 32;     // decode: keys a warp scores at once

// One attention problem: queries (B, Tq, H, Dh) over keys/values
// (B, Tk, H, Dh), optional key validity (B, Tk) and causal flag.
struct Problem {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* key_valid;  // null: every key valid
  float* out;
  int Tq, Tk, causal;
};

// floats in one padded shared-memory row of d values: an odd number of
// 16-byte chunks, so 8 rows read at one column are 8 bank groups
__host__ __device__ constexpr int row_floats(int d) {
  return (((d + 3) / 4) | 1) * 4;
}
__host__ __device__ constexpr int dims4(int d) { return (d + 3) / 4 * 4; }

constexpr int kKeyTile = 64;      // tile: keys a shared-memory tile
// tile on a cluster: 32-key tiles and 32 rows, so that a CTA's shared
// memory stays under half an SM's (two CTAs an SM) at slices of 128
constexpr int kClusterKeyTile = 32, kClusterRows = 32;

// Keys a shared-memory tile of a tile block in a cluster of n.
__host__ __device__ constexpr int tile_keys(int n) {
  return n > 1 ? kClusterKeyTile : kKeyTile;
}
// Shared memory of a tile block owning `rows` query rows over D head dims
// (Dh, or a cluster CTA's slice C): the key tile's mask, Q, K and V in two
// stages, P, and in a cluster of n > 1 its partial scores.
__host__ __device__ constexpr int tile_smem_bytes(int D, int rows, int n) {
  return 4 * (tile_keys(n) + rows * row_floats(D) +
              4 * tile_keys(n) * row_floats(D) +
              rows * p_stride(tile_keys(n)) +
              (n > 1 ? rows * tile_keys(n) : 0));
}
// Shared memory of a decode block: q (`rows` rows of D dims) and each
// warp's K and V rows; a warp's (max, sum, acc) per row go into its own K
// rows at the end; in a cluster of n > 1 each warp's partial scores of its
// 32 keys.
__host__ __device__ constexpr int decode_smem_bytes(int D, int rows,
                                                    int warps, int n) {
  return 4 * (rows * dims4(D) + 2 * warps * kWarpKeys * row_floats(D) +
              (n > 1 ? warps * rows * kWarpKeys : 0));
}

// Rows [r0, r0 + n) of `nsrc` tensors (row stride rs floats; rows past
// `limit` read as zeros) into shared rows of `stride` floats, ceil(Dh/4)*4
// floats each, zero past Dh (a column block's width, when `row_dh` gives
// the whole row's head dim): 16-byte copies when the head dim is a
// multiple of 4, else 4-byte ones. Threads `tid` of `count` share the
// copy; each steps through (row, column) by `count` with a carry instead
// of a division.
template <int NSRC>
__device__ __forceinline__ void copy_rows(float* const (&dst)[NSRC],
                                          const float* const (&src)[NSRC],
                                          int r0, int n, int limit, int Dh,
                                          size_t rs, int stride, int tid,
                                          int count, int row_dh = 0) {
  const bool vec = ((row_dh ? row_dh : Dh) & 3) == 0;
  const int width = vec ? Dh >> 2 : dims4(Dh);  // copies per row
  const int unit = vec ? 4 : 1;                 // floats per copy
  int j = tid / width, c = tid - j * width;
  const int dj = count / width, dc = count - dj * width;
  for (; j < n; j += dj, c += dc) {
    if (c >= width) {
      c -= width;
      ++j;
      if (j >= n) break;
    }
    const int d = c * unit;
    const bool ok = r0 + j < limit && d < Dh;
    const size_t off = ok ? (size_t)(r0 + j) * rs + d : 0;
#pragma unroll
    for (int x = 0; x < NSRC; ++x) {
      if (vec)
        cp_async16(dst[x] + j * stride + d, src[x] + off, ok ? 16 : 0);
      else
        cp_async4(dst[x] + j * stride + d, src[x] + off, ok ? 4 : 0);
    }
  }
}

// The additive mask term of key `key` from its validity byte (`vb`, read
// earlier so that its latency hides under other work): -inf past Tk,
// -1e9 for an invalid key, else 0.
__device__ __forceinline__ float key_term(int key, int Tk, int vb) {
  return key >= Tk ? -INFINITY : (vb ? 0.f : kNeg);
}

// ----------------------------------------------------------------- tile

// s[r][j] += Q row (g + 16r) . K row (kg + 8j), j < JN (of JK slots), over
// nch 4-dim chunks: per chunk R + JN float4 loads for 4 R JN FMAs.
template <int R, int JK, int JN>
__device__ __forceinline__ void scores(float (&s)[R][JK], const float* q_s,
                                       const float* ks, int g, int kg, int RF,
                                       int nch) {
#pragma unroll 2
  for (int c = 0; c < nch; ++c) {
    float4 qv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      qv[r] =
          *reinterpret_cast<const float4*>(q_s + (g + 16 * r) * RF + c * 4);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(ks + (kg + 8 * j) * RF + c * 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
        s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
        s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
        s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
      }
    }
  }
}

// One block: rows [q0, q0 + 16R) of (batch b, head h). Thread t belongs to
// row group g = t / 8 (rows g + 16r, r < R) and owns keys kg + 8j
// (j < KT / 8) of each tile in S, and 4-dim chunks kg + 8i (i < DPT) of its
// rows of O, kg = t % 8. CLUSTER (Dh > 128): this CTA of a cluster of
// ceil(Dh / W) holds head dims [c0, c0 + W) of Q, K, V and O, and S is the
// cluster's sum of the CTAs' partial scores; else all of Dh (c0 0, W
// unused, so these instantiations compile as they did before wide heads).
template <int R, int DPT, int KT, bool CLUSTER>
__device__ void tile_rows(const Problem& p, int H, int Dh, float scale,
                          int b, int h, int q0, int c0, int W, float* smem) {
  constexpr int BQ = kGroups * R, JK = KT / 8, PS = p_stride(KT);
  // CLUSTER: this CTA's slice [c0, c0 + wv) of the head dims; the narrow
  // instantiations keep the expressions they had before the clusters
  const int RF = row_floats(CLUSTER ? W : Dh);
  const int wv = CLUSTER ? min(W, Dh - c0) : Dh;
  const int nch = CLUSTER ? (wv + 3) >> 2 : (Dh + 3) >> 2;
  const int RV = RF, nco = nch;
  const bool vec = (Dh & 3) == 0;
  float* mask_s = smem;                    // [KT]
  float* q_s = mask_s + KT;                // [BQ][RF]
  float* kv_s = q_s + BQ * RF;             // [2 stages][K: KT][RF, V: KT][RV]
  float* p_s = kv_s + 2 * KT * (RF + RV);  // [BQ][PS]
  float* part = p_s + BQ * PS;  // CLUSTER: [R JK / 4][kThreads][4]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = (tid >> 5) * 4 + (lane >> 3), kg = lane & 7;
  const size_t rs = (size_t)H * Dh;  // floats between two rows of (b, h)
  const int cs = CLUSTER ? c0 : 0;   // the slice's first column
  const float* qg = p.q + ((size_t)b * p.Tq * H + h) * Dh + cs;
  const float* kgl = p.k + ((size_t)b * p.Tk * H + h) * Dh + cs;
  const float* vgl = p.v + ((size_t)b * p.Tk * H + h) * Dh + cs;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;
  const int ntiles = (p.Tk + KT - 1) / KT;

  // the key tile's copies, and its validity bytes read into a register
  // (stored at the next iteration's top, after this tile's arithmetic)
  auto issue = [&](int t) {
    float* ks = kv_s + (t & 1) * KT * (RF + RV);
    if constexpr (CLUSTER)
      copy_rows<2>({ks, ks + KT * RF}, {kgl, vgl}, t * KT, KT, p.Tk, wv, rs,
                   RF, tid, kThreads, Dh);
    else
      copy_rows<2>({ks, ks + KT * RF}, {kgl, vgl}, t * KT, KT, p.Tk, Dh, rs,
                   RF, tid, kThreads);
    const int key = t * KT + tid;
    return tid < KT && key < p.Tk && valid ? (int)valid[key] : 1;
  };
  // Q raw (scaled in place once it lands) and key tile 0: one group
  if constexpr (CLUSTER)
    copy_rows<1>({q_s}, {qg}, q0, BQ, p.Tq, wv, rs, RF, tid, kThreads, Dh);
  else
    copy_rows<1>({q_s}, {qg}, q0, BQ, p.Tq, Dh, rs, RF, tid, kThreads);
  int vb = issue(0);
  cp_async_commit();

  float m[R], l[R], o[R][DPT][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      o[r][i][0] = o[r][i][1] = o[r][i][2] = o[r][i][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // every thread is done with tile t - 1 (stage, mask, P)
    if (tid < KT) mask_s[tid] = key_term(t * KT + tid, p.Tk, vb);
    if (t + 1 < ntiles) {
      vb = issue(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed for every thread
    if (t == 0) {     // Q scaled in fp32 as the TPU kernel does
      for (int i = tid; i < BQ * RF; i += kThreads) q_s[i] *= scale;
      __syncthreads();
    }

    const int k0 = t * KT;
    const float* ks = kv_s + (t & 1) * KT * (RF + RV);
    const float* vs = ks + KT * RF;
    const float* mk = mask_s;
    const int nk = min(KT, p.Tk - k0);

    // S = Q.K^T: R rows x JK keys a thread, 4 dims at a time; a tile of at
    // most KT / 2 keys in range skips the upper half of its key columns
    // (their slots stay 0 and take -inf from the mask)
    float s[R][JK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[r][j] = 0.f;
    if (nk > KT / 2)
      scores<R, JK, JK>(s, q_s, ks, g, kg, RF, nch);
    else
      scores<R, JK, JK / 2>(s, q_s, ks, g, kg, RF, nch);
    if constexpr (CLUSTER) {  // the slice's partial scores -> the sum over
      // the cluster, the same in every CTA
      float(&flat)[R * JK] = *reinterpret_cast<float(*)[R * JK]>(&s[0][0]);
      float* slot = part + tid * 4;
      if (t > 0) cluster_wait();  // every CTA has read the last tile's
#pragma unroll
      for (int i = 0; i < R * JK; i += 4)
        *reinterpret_cast<float4*>(slot + i * kThreads) =
            make_float4(flat[i], flat[i + 1], flat[i + 2], flat[i + 3]);
      cluster_arrive();
      cluster_wait();
      cluster_sum<R * JK, 4>(flat, slot, 4 * kThreads, (Dh + W - 1) / W,
                             cluster_rank());
      cluster_arrive();
    }

    // online softmax: the 8 lanes of a row group hold its KT scores
    float mk8[JK];
#pragma unroll
    for (int j = 0; j < JK; ++j) mk8[j] = mk[kg + 8 * j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + g + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        float add = mk8[j];  // key validity + causal, one fp32 sum
        if (p.causal && k0 + kg + 8 * j > row) add += kNeg;
        s[r][j] += add;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 is in range
      const float alpha = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      float sum = 0.f;
      float* prow = p_s + (g + 16 * r) * PS + kg;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const float e = ex2((s[r][j] - m_new) * kLog2e);
        sum += e;
        prow[8 * j] = e;
      }
      l[r] = l[r] * alpha + sum;  // this thread's share; summed at the end
#pragma unroll
      for (int i = 0; i < DPT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][i][e] *= alpha;
    }

    __syncwarp();  // P's rows of this warp are written by this warp only

    // O += P.V over the keys in range (P is 0 and V zero past Tk)
    const int nk4 = (nk + 3) & ~3;
#pragma unroll 2
    for (int j = 0; j < nk4; j += 4) {
      float4 pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        pv[r] = *reinterpret_cast<const float4*>(p_s + (g + 16 * r) * PS +
                                                 j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int c = kg + 8 * i;
          if (c < nco) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vs + (j + jj) * RV + c * 4);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float pj = jj == 0   ? pv[r].x
                               : jj == 1 ? pv[r].y
                               : jj == 2 ? pv[r].z
                                         : pv[r].w;
              o[r][i][0] = fmaf(pj, vv.x, o[r][i][0]);
              o[r][i][1] = fmaf(pj, vv.y, o[r][i][1]);
              o[r][i][2] = fmaf(pj, vv.z, o[r][i][2]);
              o[r][i][3] = fmaf(pj, vv.w, o[r][i][3]);
            }
          }
        }
      }
    }
  }

  // no CTA of a cluster leaves while another may read its partial scores
  if constexpr (CLUSTER) cluster_wait();
  float* og = p.out + ((size_t)b * p.Tq * H + h) * Dh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(kFull, den, 1);
    den += __shfl_xor_sync(kFull, den, 2);
    den += __shfl_xor_sync(kFull, den, 4);
    const int t = q0 + g + 16 * r;
    if (t >= p.Tq) continue;
    float* orow = og + (size_t)t * rs + cs;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = kg + 8 * i;
      if (c >= nco) continue;
      const float4 x = make_float4(o[r][i][0] / den, o[r][i][1] / den,
                                   o[r][i][2] / den, o[r][i][3] / den);
      if (vec) {
        *reinterpret_cast<float4*>(orow + c * 4) = x;
      } else {
        const int d = c * 4;
        orow[d] = x.x;
        if (d + 1 < wv) orow[d + 1] = x.y;
        if (d + 2 < wv) orow[d + 2] = x.z;
        if (d + 3 < wv) orow[d + 3] = x.w;
      }
    }
  }
}

// blockIdx.y = h * n + c: the head, and in a cluster (of n CTAs along y)
// the CTA's slice c of W head dims.
template <int R, int DPT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
    gpv_attn_fp32_tile_kernel(Problem p, int H, int Dh, float scale, int W) {
  extern __shared__ __align__(16) float smem_f[];
  const int n = CLUSTER ? (Dh + W - 1) / W : 1;
  const int h = blockIdx.y / n, c = blockIdx.y - h * n;
  tile_rows<R, DPT, CLUSTER ? kClusterKeyTile : kKeyTile, CLUSTER>(
      p, H, Dh, scale, blockIdx.z, h, blockIdx.x * kGroups * R, c * W, W,
      smem_f);
}

// Both co-attention directions in one launch: blockIdx.z = 2 * b + dir; on
// a cluster blockIdx.z = half * B + b (`long_first`).
template <int R, int DPT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
    gpv_attn_fp32_bi_kernel(Problem p1, Problem p2, int H, int Dh,
                            float scale, int W) {
  extern __shared__ __align__(16) float smem_f[];
  int b = blockIdx.z >> 1;
  bool second = blockIdx.z & 1;
  if constexpr (CLUSTER) long_first(p1.Tk, p2.Tk, b, second);
  const Problem p = (CLUSTER ? second : (blockIdx.z & 1)) ? p2 : p1;
  const int q0 = blockIdx.x * kGroups * R;
  // whole block (a cluster shares q0): before any barrier
  if (q0 >= p.Tq) return;
  const int n = CLUSTER ? (Dh + W - 1) / W : 1;
  const int h = blockIdx.y / n, c = blockIdx.y - h * n;
  tile_rows<R, DPT, CLUSTER ? kClusterKeyTile : kKeyTile, CLUSTER>(
      p, H, Dh, scale, CLUSTER ? b : blockIdx.z >> 1, h, q0, c * W, W,
      smem_f);
}

// --------------------------------------------------------------- decode

// One block per (batch, head, ROWS query rows from q0 = ROWS * blockIdx.z),
// `blockDim.x / 32` warps. Warp w scores keys [32w, 32w + 32), then
// [32(w + W), ...) while keys remain, a lane a key; lane owns dims
// lane + 32i of P.V.
template <int ROWS>
__global__ void __launch_bounds__(kDecodeWarps * 32)
    gpv_attn_fp32_decode_kernel(Problem p, int H, int Dh, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int RF = row_floats(Dh), D4 = dims4(Dh), nch = D4 >> 2;
  float* q_s = smem_f;                                   // [ROWS][D4]
  float* kv0 = q_s + ROWS * D4;  // warp w's K rows, then V rows
  float* k_s = kv0 + warp * 2 * kWarpKeys * RF;
  float* v_s = k_s + kWarpKeys * RF;

  const size_t rs = (size_t)H * Dh;
  const float* qg = p.q + ((size_t)b * p.Tq * H + h) * Dh;
  const float* kgl = p.k + ((size_t)b * p.Tk * H + h) * Dh;
  const float* vgl = p.v + ((size_t)b * p.Tk * H + h) * Dh;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;

  // q raw (one group for the block), then this warp's first K and V rows
  copy_rows<1>({q_s}, {qg}, q0, ROWS, p.Tq, Dh, rs, D4, threadIdx.x,
               blockDim.x);
  cp_async_commit();
  const int first = warp * kWarpKeys;
  if (first < p.Tk)
    copy_rows<2>({k_s, v_s}, {kgl, vgl}, first,
                 min(kWarpKeys, p.Tk - first), p.Tk, Dh, rs, RF, lane, 32);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // q landed; scaled in fp32 as the TPU kernel does
  for (int i = threadIdx.x; i < ROWS * D4; i += blockDim.x) q_s[i] *= scale;
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = first; k0 < p.Tk; k0 += nw * kWarpKeys) {
    const int nk = min(kWarpKeys, p.Tk - k0);
    const int key = k0 + lane;
    const bool live = lane < nk;
    // key validity, read while the rows land
    const float kv = live && valid && !valid[key] ? kNeg : 0.f;
    cp_async_wait<0>();
    __syncwarp();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    if (live) {  // four partial sums a row, added at the end
      const float* kr = k_s + lane * RF;
      float dot[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        dot[r][0] = dot[r][1] = dot[r][2] = dot[r][3] = 0.f;
#pragma unroll 4
      for (int c = 0; c < nch; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + c * 4);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qx =
              *reinterpret_cast<const float4*>(q_s + r * D4 + c * 4);
          dot[r][0] = fmaf(qx.x, kx.x, dot[r][0]);
          dot[r][1] = fmaf(qx.y, kx.y, dot[r][1]);
          dot[r][2] = fmaf(qx.z, kx.z, dot[r][2]);
          dot[r][3] = fmaf(qx.w, kx.w, dot[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        s[r] = (dot[r][0] + dot[r][1]) + (dot[r][2] + dot[r][3]);
    }
    float e[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float add = kv;  // key validity + causal, one fp32 sum
      if (p.causal && key > q0 + r) add += kNeg;
      const float sc = live ? s[r] + add : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = ex2((m[r] - m_new) * kLog2e);
      e[r] = live ? ex2((sc - m_new) * kLog2e) : 0.f;
      l[r] = l[r] * alpha + e[r];  // this lane's share
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(kFull, e[r], j);
      const float* vr = v_s + j * RF + lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (32 * i >= Dh) break;  // the same for the whole warp
        const float vx = lane + 32 * i < Dh ? vr[32 * i] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][i] = fmaf(pj[r], vx, acc[r][i]);
      }
    }
    __syncwarp();  // every lane is done with the rows before the next copy
    const int next = k0 + nw * kWarpKeys;
    if (next < p.Tk) {
      copy_rows<2>({k_s, v_s}, {kgl, vgl}, next,
                   min(kWarpKeys, p.Tk - next), p.Tk, Dh, rs, RF, lane, 32);
      cp_async_commit();
    }
  }

  // each warp's (max, sum, acc) per row into its own K rows (32 RF floats
  // >= ROWS (D4 + 2)), then one merge over the warps
  __syncwarp();  // every lane is done with this warp's rows
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lw = warp_sum(l[r]);
    float* mine = k_s + r * (D4 + 2);
    if (lane == 0) {
      mine[0] = m[r];
      mine[1] = lw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < Dh) mine[2 + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  const int rows = min(p.Tq - q0, ROWS);
  for (int i = threadIdx.x; i < rows * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w)
      M = fmaxf(M, kv0[w * 2 * kWarpKeys * RF + r * (D4 + 2)]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* pw = kv0 + w * 2 * kWarpKeys * RF + r * (D4 + 2);
      const float f = ex2((pw[0] - M) * kLog2e);
      L = fmaf(f, pw[1], L);
      O = fmaf(f, pw[2 + d], O);
    }
    p.out[(((size_t)b * p.Tq + q0 + r) * H + h) * Dh + d] = O / L;
  }
}

// The decode variant above Dh 128, on a cluster of n CTAs (along x) per
// (batch, head, ROWS query rows): blockIdx.x = h * n + c, and CTA c holds
// q, K and V over head dims [c0, c0 + W), c0 = c W. Each chunk of 32 keys a
// warp scores is summed over the cluster (cluster_sum) before the softmax,
// so every warp walks the same number of chunks (a chunk past Tk has no
// live key); then as gpv_attn_fp32_decode_kernel on the CTA's V columns.
template <int ROWS>
__global__ void __launch_bounds__(kDecodeWarps * 32)
    gpv_attn_fp32_decode_cluster_kernel(Problem p, int H, int Dh,
                                        float scale, int W) {
  extern __shared__ __align__(16) float smem_f[];
  const int n = (Dh + W - 1) / W;
  const int h = blockIdx.x / n, b = blockIdx.y, q0 = blockIdx.z * ROWS;
  const int c0 = (blockIdx.x - h * n) * W;
  const int wv = min(W, Dh - c0);  // this CTA's head dims
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, me = cluster_rank();
  const int RF = row_floats(W), D4 = dims4(W), nch = (wv + 3) >> 2;
  const int PW = dims4(wv) + 2;
  float* q_s = smem_f;                                  // [ROWS][D4]
  float* part = q_s + ROWS * D4;  // [ROWS][nw 32]: partial scores
  float* kv0 = part + nw * ROWS * kWarpKeys;  // warp w's K, V rows
  float* k_s = kv0 + warp * 2 * kWarpKeys * RF;
  float* v_s = k_s + kWarpKeys * RF;

  const size_t rs = (size_t)H * Dh;
  const float* qg = p.q + ((size_t)b * p.Tq * H + h) * Dh + c0;
  const float* kgl = p.k + ((size_t)b * p.Tk * H + h) * Dh + c0;
  const float* vgl = p.v + ((size_t)b * p.Tk * H + h) * Dh + c0;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;

  auto copy_kv = [&](int k0) {  // this warp's K and V rows over the slice
    copy_rows<2>({k_s, v_s}, {kgl, vgl}, k0, min(kWarpKeys, p.Tk - k0),
                 p.Tk, wv, rs, RF, lane, 32, Dh);
  };
  // q raw (one group for the block), then this warp's first K and V rows
  copy_rows<1>({q_s}, {qg}, q0, ROWS, p.Tq, wv, rs, D4, threadIdx.x,
               blockDim.x, Dh);
  cp_async_commit();
  const int first = warp * kWarpKeys;
  if (first < p.Tk) copy_kv(first);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // q landed; scaled in fp32 as the TPU kernel does
  for (int i = threadIdx.x; i < ROWS * D4; i += blockDim.x) q_s[i] *= scale;
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  const int step = nw * kWarpKeys, chunks = (p.Tk + step - 1) / step;
  for (int it = 0; it < chunks; ++it) {
    const int k0 = first + it * step;
    const int nk = max(0, min(kWarpKeys, p.Tk - k0));
    const int key = k0 + lane;
    const bool live = lane < nk;
    // key validity, read while the rows land
    const float kv = live && valid && !valid[key] ? kNeg : 0.f;
    cp_async_wait<0>();
    __syncwarp();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    if (live) {  // four partial sums a row, added at the end
      const float* kr = k_s + lane * RF;
      float dot[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        dot[r][0] = dot[r][1] = dot[r][2] = dot[r][3] = 0.f;
#pragma unroll 4
      for (int c = 0; c < nch; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + c * 4);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qx =
              *reinterpret_cast<const float4*>(q_s + r * D4 + c * 4);
          dot[r][0] = fmaf(qx.x, kx.x, dot[r][0]);
          dot[r][1] = fmaf(qx.y, kx.y, dot[r][1]);
          dot[r][2] = fmaf(qx.z, kx.z, dot[r][2]);
          dot[r][3] = fmaf(qx.w, kx.w, dot[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        s[r] = (dot[r][0] + dot[r][1]) + (dot[r][2] + dot[r][3]);
    }
    // the slice's partial scores -> the cluster's sums, the same everywhere
    float* slot = part + warp * kWarpKeys + lane;
    if (it > 0) cluster_wait();  // every CTA has read the last chunk's
#pragma unroll
    for (int r = 0; r < ROWS; ++r) slot[r * nw * kWarpKeys] = s[r];
    cluster_arrive();
    cluster_wait();
    cluster_sum<ROWS, 1>(s, slot, nw * kWarpKeys, n, me);
    cluster_arrive();

    float e[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float add = kv;  // key validity + causal, one fp32 sum
      if (p.causal && key > q0 + r) add += kNeg;
      const float sc = live ? s[r] + add : -INFINITY;
      // finite: chunk 0 of every warp has a key (warps <= ceil(Tk / 32))
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = ex2((m[r] - m_new) * kLog2e);
      e[r] = live ? ex2((sc - m_new) * kLog2e) : 0.f;
      l[r] = l[r] * alpha + e[r];  // this lane's share
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(kFull, e[r], j);
      const float* vr = v_s + j * RF + lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (32 * i >= wv) break;  // the same for the whole warp
        const float vx = lane + 32 * i < wv ? vr[32 * i] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][i] = fmaf(pj[r], vx, acc[r][i]);
      }
    }
    __syncwarp();  // every lane is done with the rows before the next copy
    if (k0 + step < p.Tk) {
      copy_kv(k0 + step);
      cp_async_commit();
    }
  }
  // no CTA of the cluster leaves while another may read its partials
  cluster_wait();

  // each warp's (max, sum, acc) per row into its own K rows (32 RF floats
  // >= ROWS PW), then one merge over the warps
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lw = warp_sum(l[r]);
    float* mine = k_s + r * PW;
    if (lane == 0) {
      mine[0] = m[r];
      mine[1] = lw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < wv) mine[2 + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  const int WS = 2 * kWarpKeys * RF;  // floats of a warp's rows
  const int rows = min(p.Tq - q0, ROWS);
  for (int i = threadIdx.x; i < rows * wv; i += blockDim.x) {
    const int r = i / wv, d = i - r * wv;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, kv0[w * WS + r * PW]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* pw = kv0 + w * WS + r * PW;
      const float f = ex2((pw[0] - M) * kLog2e);
      L = fmaf(f, pw[1], L);
      O = fmaf(f, pw[2 + d], O);
    }
    p.out[(((size_t)b * p.Tq + q0 + r) * H + h) * Dh + c0 + d] = O / L;
  }
}

// ------------------------------------------------------------- launches

float head_scale(int Dh) { return (float)(1.0 / sqrt((double)Dh)); }

// 4-dim chunks a thread owns in O: O's columns a block <= 32 * DPT
int chunks_per_thread(int W) { return (W + 31) / 32; }

// The tile (BI false) or K2 (BI true) kernel of R row slots a thread, DPT
// chunks of O a thread, on a cluster or not.
template <bool BI, int R, int DPT, bool CLUSTER>
auto tile_kernel() {
  if constexpr (BI)
    return gpv_attn_fp32_bi_kernel<R, DPT, CLUSTER>;
  else
    return gpv_attn_fp32_tile_kernel<R, DPT, CLUSTER>;
}

// f(kernel) for R row slots at head dim Dh: up to Dh 128 the instantiation
// of Dh's chunks a thread; wider heads the cluster one (R 2) of a slice of
// W dims (3 or 4 chunks a thread).
template <bool BI, int R, typename F>
cudaError_t with_tile(int Dh, int W, F f) {
  if (Dh <= kMaxCols) {
    switch (chunks_per_thread(Dh)) {
      case 1: return f(tile_kernel<BI, R, 1, false>());
      case 2: return f(tile_kernel<BI, R, 2, false>());
      case 3: return f(tile_kernel<BI, R, 3, false>());
      default: return f(tile_kernel<BI, R, 4, false>());
    }
  }
  if constexpr (R * kGroups == kClusterRows) {
    if (chunks_per_thread(W) <= 3) return f(tile_kernel<BI, R, 3, true>());
    return f(tile_kernel<BI, R, 4, true>());
  }
  return cudaErrorInvalidValue;
}

// f(kernel) for `rows` rows a block (64 or 32; K2: 32).
template <bool BI, typename F>
cudaError_t with_tile_shape(int rows, int Dh, int W, F f) {
  if constexpr (!BI) {
    if (rows == 64) return with_tile<false, 4>(Dh, W, f);
  }
  if (rows == 32) return with_tile<BI, 2>(Dh, W, f);
  return cudaErrorInvalidValue;
}

// Launch a tile kernel on `grid` (y: H * n), as clusters of n along y
// above Dh 128.
template <typename K, typename... Args>
cudaError_t launch_tile(K* kernel, dim3 grid, int n, int smem, cudaStream_t s,
                        Args... args) {
  if (n == 1) {
    kernel<<<grid, kThreads, smem, s>>>(args...);
    return cudaGetLastError();
  }
  return launch_cluster(kernel, grid, dim3(1, n, 1), kThreads, smem, s,
                        args...);
}

template <int ROWS>
cudaError_t launch_decode(const Problem& p, int B, int H, int Dh, int W,
                          int warps, int smem, cudaStream_t s) {
  const int n = cluster_size(Dh, W);
  const dim3 grid(H * n, B, (p.Tq + ROWS - 1) / ROWS);
  if (n > 1)
    return launch_cluster(gpv_attn_fp32_decode_cluster_kernel<ROWS>, grid,
                          dim3(n, 1, 1), warps * 32, smem, s, p, H, Dh,
                          head_scale(Dh), W);
  gpv_attn_fp32_decode_kernel<ROWS><<<grid, warps * 32, smem, s>>>(
      p, H, Dh, head_scale(Dh));
  return cudaGetLastError();
}

template <typename F>
cudaError_t set_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_dims(int B, int Tq, int Tk, int H, int Dh, int cols,
              int smem_bytes) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Dh <= 0 ||
         bad_cols(Dh, cols) || smem_bytes > kMaxSmem;
}

// A tile launch the plan may give: 64-key tiles (a cluster: 32 keys and
// 32 rows), and enough shared memory for its block (W: the head dims a
// block holds).
bool bad_tile(int Dh, int W, int rows, int key_tile, int smem_bytes) {
  const int n = cluster_size(Dh, W);
  return key_tile != tile_keys(n) || (n > 1 && rows != kClusterRows) ||
         smem_bytes < tile_smem_bytes(W, rows, n);
}

}  // namespace
}  // namespace gpv_attn

using namespace gpv_attn;

// Once per process, after loading: allow every instantiation the dynamic
// shared memory of its largest block (Dh 128, and a cluster CTA's at a
// slice of 128), and the cluster ones clusters of up to 16 CTAs. Returns a
// cudaError_t.
extern "C" int gpv_attn_fp32_init() {
  cudaError_t e = cudaSuccess;
  for (int rows = 32; rows <= 64; rows += 32) {
    const int narrow = tile_smem_bytes(kMaxCols, rows, 1);
    auto set = [&](int bytes) {
      return [bytes](auto kernel) { return set_smem(kernel, bytes); };
    };
    for (int W = 32; W <= kMaxCols; W += 32) {  // head dims up to 128
      if (e == cudaSuccess)
        e = with_tile_shape<false>(rows, W, W, set(narrow));
      if (e == cudaSuccess && rows == 32)
        e = with_tile_shape<true>(rows, W, W, set(narrow));
    }
  }
  const int wide = tile_smem_bytes(kMaxCols, kClusterRows, 2);
  auto allow = [&](auto kernel) { return allow_cluster(kernel, wide); };
  for (int W = 96; W <= kMaxCols; W += 32) {  // clusters: 3, 4 chunks
    if (e == cudaSuccess)
      e = with_tile_shape<false>(kClusterRows, 2 * kMaxCols, W, allow);
    if (e == cudaSuccess)
      e = with_tile_shape<true>(kClusterRows, 2 * kMaxCols, W, allow);
  }
  const int dec = decode_smem_bytes(kMaxCols, kDecodeRows, kDecodeWarps, 1);
  const int dec_cl =
      decode_smem_bytes(kMaxCols, kDecodeRows, kDecodeWarps, 2);
#define GPV_SET(ROWS)                                                      \
  if (e == cudaSuccess)                                                    \
    e = set_smem(gpv_attn_fp32_decode_kernel<ROWS>, dec);                  \
  if (e == cudaSuccess)                                                    \
    e = allow_cluster(gpv_attn_fp32_decode_cluster_kernel<ROWS>, dec_cl);
  GPV_SET(1)
  GPV_SET(2)
  GPV_SET(4)
  GPV_SET(8)
#undef GPV_SET
  return e;
}

// K1: q/out (B, Tq, H, Dh), k/v (B, Tk, H, Dh), as the wrapper's plan
// gives it: a block owns `rows` query rows, 1, 2, 4 or 8 for the decode
// variant with `warps` warps, 32 or 64 for the tile variant (4 warps) with
// `key_tile` (64) keys a tile; above Dh 128 a cluster of ceil(Dh / cols)
// CTAs of `cols` head dims each; `smem_bytes` at least what that block
// needs. Returns a cudaError_t.
extern "C" int gpv_attn_fp32(const void* q, const void* k, const void* v,
                             const unsigned char* key_valid, void* out, int B,
                             int Tq, int Tk, int H, int Dh, int causal,
                             int rows, int warps, int key_tile, int cols,
                             int smem_bytes, void* stream) {
  if (bad_dims(B, Tq, Tk, H, Dh, cols, smem_bytes))
    return cudaErrorInvalidValue;
  const int W = Dh > kMaxCols ? cols : Dh;  // head dims a block holds
  const int n = cluster_size(Dh, cols);
  const Problem p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), key_valid,
                  static_cast<float*>(out), Tq, Tk, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= kDecodeRows) {
    if (rows < 1 || (rows & (rows - 1)) || warps < 1 ||
        warps > kDecodeWarps || key_tile != kWarpKeys ||
        smem_bytes < decode_smem_bytes(W, rows, warps, n))
      return cudaErrorInvalidValue;
    switch (rows) {
      case 1: return launch_decode<1>(p, B, H, Dh, W, warps, smem_bytes, s);
      case 2: return launch_decode<2>(p, B, H, Dh, W, warps, smem_bytes, s);
      case 4: return launch_decode<4>(p, B, H, Dh, W, warps, smem_bytes, s);
      default: return launch_decode<8>(p, B, H, Dh, W, warps, smem_bytes, s);
    }
  }
  if (warps != kThreads / 32 || bad_tile(Dh, W, rows, key_tile, smem_bytes))
    return cudaErrorInvalidValue;
  const dim3 grid((Tq + rows - 1) / rows, H * n, B);
  const float sc = head_scale(Dh);
  return with_tile_shape<false>(rows, Dh, W, [&](auto kernel) {
    return launch_tile(kernel, grid, n, smem_bytes, s, p, H, Dh, sc, W);
  });
}

// K2, both directions on the tile variant (`rows` 32, 4 warps):
// ctx1 = softmax(q2 k1^T + m1) v1 -> (B, T2, H, Dh)  (valid1: (B, T1))
// ctx2 = softmax(q1 k2^T + m2) v2 -> (B, T1, H, Dh)  (valid2: (B, T2))
extern "C" int gpv_attn_fp32_bi(const void* q1, const void* k1,
                                const void* v1, const void* q2,
                                const void* k2, const void* v2,
                                const unsigned char* valid1,
                                const unsigned char* valid2, void* ctx1,
                                void* ctx2, int B, int T1, int T2, int H,
                                int Dh, int rows, int warps, int key_tile,
                                int cols, int smem_bytes, void* stream) {
  const int W = Dh > kMaxCols ? cols : Dh;
  if (bad_dims(B, T1, T2, H, Dh, cols, smem_bytes) || rows != 32 ||
      warps != kThreads / 32 || bad_tile(Dh, W, rows, key_tile, smem_bytes))
    return cudaErrorInvalidValue;
  using F = const float*;
  const Problem p1{static_cast<F>(q2), static_cast<F>(k1), static_cast<F>(v1),
                   valid1, static_cast<float*>(ctx1), T2, T1, 0};
  const Problem p2{static_cast<F>(q1), static_cast<F>(k2), static_cast<F>(v2),
                   valid2, static_cast<float*>(ctx2), T1, T2, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tq = T1 > T2 ? T1 : T2;
  const int n = cluster_size(Dh, cols);
  const dim3 grid((tq + rows - 1) / rows, H * n, 2 * B);
  const float sc = head_scale(Dh);
  return with_tile_shape<true>(rows, Dh, W, [&](auto kernel) {
    return launch_tile(kernel, grid, n, smem_bytes, s, p1, p2, H, Dh, sc, W);
  });
}
