// Fused multi-head attention on the tensor cores, bf16, for Hopper (sm_90a),
// plain C interface. The bf16 path of both Pallas kernels of
// gpv_tpu/ops/attention.py wherever a call has two or more query rows:
//   gpv_attn_tile     <- fused_attention   (cell _attend_cell): DETR encoder
//                        300x300 and decoder 100x100 / 100x300 (8 heads of
//                        32), BERT 20x20 (12 of 64), teacher-forced 20x20
//   gpv_attn_tile_bi  <- fused_biattention (_make_biattn_kernel): both
//                        co-attention directions, 100x20 and 20x100 (16 of
//                        48), in one launch
// One-row calls (the decode step) go to attention_decode.cu; fp32 calls to
// attention.cu.
//
// What it computes, per (batch, head): S = q . k^T in fp32, times 1/sqrt(Dh)
// in fp32, plus one fp32 mask term (-1e9 for an invalid key, -1e9 above the
// diagonal when causal, summed as `attention_mask` builds it; -inf for the
// key slots past Tk, which take no part); softmax with fp32 statistics; P
// rounded to bf16; P . V accumulated in fp32; the output in bf16. Scores,
// mask and maxima are kept times log2(e) (scale log2(e)/sqrt(Dh), mask
// -1e9 log2(e)), so each exponential is one ex2. Layout
// (B, T, H, Dh), contiguous, every pointer 16-byte aligned, any Dh >= 1.
// Rows are copied 16 bytes at a time when Dh is a multiple of 8, 4 bytes
// when it is even, else one value at a time; the padding up to the
// product's depth is zero-filled, so S and O are unchanged by it.
//
// Head dims up to 128 that are multiples of 8 instantiate the product's
// depth D (Dh rounded up to 16) and keep Q's fragments in registers; each
// warp's O (16 rows x D) lives in fp32 registers. Every other head dim
// takes the `wide` instantiation (D = 128, copies in bf16_unit's units,
// Q's fragments read by ldmatrix at each step). Above 128 a warp's O would
// spill, so that instantiation runs on a cluster (attention_common.cuh):
// the grid's y runs over (head, slice), a cluster of n CTAs along y owns a
// (batch, head, query block), and each CTA holds Q, K and V over its
// slice of at most 128 head dims. Each key tile's partial scores are
// summed over the cluster through distributed shared memory, so S is
// computed once per row block and K and V are read once.
//
// What bounds it on the card: bytes. The DETR-encoder shape does 1.84 GFLOP
// on 12.3 MB, about 150 operations per byte against the H100's ~295 for bf16
// at the dense tensor-core peak, and every other shape fewer. So the design
// keeps scores out of device memory and moves each input once per block:
// - One warp owns 16 query rows of one (batch, head); a block holds 1-4
//   warps (the wrapper picks min(4, ceil(Tq/16))). Padding rows are
//   computed and never stored. A warp whose rows all lie past Tq skips the
//   products (it still helps load), which is how K2's 20-row direction runs
//   in a block sized for the 100-row one.
// - S = Q.K^T and O += P.V run as mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), operands from shared memory by ldmatrix (V with .trans).
//   S's accumulator layout is P's A-fragment layout, so P goes from the
//   softmax to the second product in registers (FlashAttention-2). wgmma
//   would need 64-row warpgroup tiles and TMA descriptors; at these shapes
//   mma.sync already gives far more operations per second than the bytes
//   allow (~150 per byte even at the encoder shape), so it suffices.
// - K and V stream through dynamic shared memory in 64-key tiles, double
//   buffered with 16-byte cp.async.cg copies: tile t+1 lands while tile t
//   is multiplied. Rows are padded to an odd number of 16-byte chunks
//   (row_chunks) so ldmatrix is free of bank conflicts.
// - Streaming, not whole rows: holding a (b, h)'s whole K/V would take
//   256 KB at Tk 512, Dh 128, beyond the 227 KB a block may have, and the
//   small fixed tile keeps several blocks on an SM. The price is that P is
//   rounded before it is normalised (against the running max, with the
//   rounded values summed into the row sum), where the Pallas cell rounds
//   the normalised p. The two differ by bf16 rounding, inside the bf16
//   tolerance the kernel is held to.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <math.h>

#include <type_traits>

#include "attention_common.cuh"

namespace gpv_attn {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 4;  // 16 query rows each

struct Attn {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const unsigned char* key_valid;  // (B, Tk) or null: every key valid
  bf16* out;
  int Tq, Tk, causal;
};

constexpr int kKeyTile = 64;  // keys a shared-memory tile
// clusters of at least this many CTAs exchange their partial scores by
// cluster_allreduce, smaller ones by cluster_sum: on the H100 the two-step
// exchange was 0.64x at 8 CTAs, 0.86x at 6, 0.94x at 5, 0.98-1.00x at 4,
// and 1.13x at 3 (PERF.md)
constexpr int kAllreduceCtas = 4;

// Dynamic shared memory of a block of `warps` warps holding W head dims
// (Dh padded to 16, or a cluster CTA's slice): the key mask, the block's Q
// rows, K and V in two stages, and in a cluster of n > 1 each thread's
// partial scores of a tile (two CTAs an SM at slices of 128 and 4 warps).
__host__ __device__ constexpr int tile_smem_bytes(int W, int warps, int n) {
  return 2 * kKeyTile * 4 + 16 * warps * row_chunks(W) * 16 +
         2 * kKeyTile * 2 * row_chunks(W) * 16 +
         (n > 1 ? warps * 32 * kKeyTile / 2 * 4 : 0);
}

// Rows [q0, q0 + blockDim.x / 2) of (batch b, head h). Narrow (WIDE false;
// Dh <= 128, a multiple of 8): D is Dh rounded up to a multiple of 16, the
// depth of both products and O's width; c0 = 0, W = D, 16-byte copies (the
// code of these instantiations is what it was before other head dims).
// WIDE (any other Dh): D = 128 is O's largest width; the block holds head
// dims [c0, c0 + W) of Q, K, V and O (all of a head up to Dh 128, W its Dh
// padded to 16; above, one CTA's slice of a cluster of n: CLUSTER), S's
// depth Dp is the held dims rounded up to 16, rows are copied in the units
// bf16_unit gives, and on a cluster S is the cluster's sum of the CTAs'
// partial scores. KT keys a shared-memory tile.
template <int D, int KT, bool WIDE, bool CLUSTER>
__device__ __forceinline__ void tile_rows(const Attn& p, int H, int Dh,
                                          float scale2, int b, int h, int q0,
                                          int c0, int W, int n,
                                          unsigned char* smem) {
  constexpr int NO = D / 8;   // 8-wide column tiles of O (WIDE: at most)
  constexpr int NJ = KT / 8;  // 8-key column tiles of S
  constexpr int NK = KT / 16; // 16-key steps of P.V
  const int wv = WIDE ? min(W, Dh - c0) : D;         // this block's dims
  const int Dp = WIDE ? (wv + 15) / 16 * 16 : D;     // S's depth
  const int ROW = row_chunks(WIDE ? W : D) * 8;      // bf16 per Q, K, V row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, rows = nthreads / 2;
  float* mask_s = reinterpret_cast<float*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + 2 * KT * 4);
  bf16* k_s = q_s + rows * ROW;
  bf16* v_s = k_s + 2 * KT * ROW;
  // n > 1: the partial scores, [NJ][nthreads][4] floats
  float* part = reinterpret_cast<float*>(v_s + 2 * KT * ROW);

  const int unit = bf16_unit(Dh);
  const size_t rs = (size_t)H * Dh;  // elements between two rows of (b, h)
  const bf16* qg = p.q + ((size_t)b * p.Tq * H + h) * Dh;
  const bf16* kg = p.k + ((size_t)b * p.Tk * H + h) * Dh;
  const bf16* vg = p.v + ((size_t)b * p.Tk * H + h) * Dh;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;

  constexpr int CH = D / 8;  // narrow: 16-byte chunks copied per row
  const int dc = Dh >> 3;    // narrow: chunks that hold data
  if constexpr (WIDE) {
    copy_bf16_rows<1>(unit, {q_s}, {qg}, q0, rows, p.Tq, c0, W, Dh - c0, rs,
                      ROW, tid, nthreads);
  } else {
    for (int i = tid; i < rows * CH; i += nthreads) {
      const int r = i / CH, c = i - r * CH, t = q0 + r;
      const bool ok = t < p.Tq && c < dc;
      cp_async16(q_s + r * ROW + c * 8, ok ? qg + t * rs + c * 8 : qg,
                 ok ? 16 : 0);
    }
  }
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * KT;
    bf16* ks = k_s + stage * KT * ROW;
    bf16* vs = v_s + stage * KT * ROW;
    if constexpr (WIDE) {
      copy_bf16_rows<2>(unit, {ks, vs}, {kg, vg}, k0, KT, p.Tk, c0, W,
                        Dh - c0, rs, ROW, tid, nthreads);
    } else {
      for (int i = tid; i < KT * CH; i += nthreads) {
        const int r = i / CH, c = i - r * CH, key = k0 + r;
        const bool ok = key < p.Tk && c < dc;
        const size_t off = ok ? key * rs + c * 8 : 0;
        cp_async16(ks + r * ROW + c * 8, kg + off, ok ? 16 : 0);
        cp_async16(vs + r * ROW + c * 8, vg + off, ok ? 16 : 0);
      }
    }
    for (int i = tid; i < KT; i += nthreads) {
      const int key = k0 + i;
      mask_s[stage * KT + i] =
          key >= p.Tk ? -INFINITY : (valid && !valid[key]) ? kNeg2 : 0.f;
    }
  };

  const int n_tiles = (p.Tk + KT - 1) / KT;
  load_tile(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  const int row_base = q0 + warp * 16;
  const bool active = row_base < p.Tq;  // warp-uniform
  const int r_lo = row_base + (lane >> 2), r_hi = r_lo + 8;
  uint32_t qf[WIDE ? 1 : D / 16][4];  // narrow: Q's fragments, kept
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* ks = k_s + stage * KT * ROW;
      const bf16* vs = v_s + stage * KT * ROW;
      const float* mk = mask_s + stage * KT;
      const int k0 = tile * KT;

      // S = Q.K^T: NJ column tiles of 8 keys; 16-key groups past Tk skipped
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (!WIDE) {
        constexpr int KS = D / 16;  // k-steps of Q.K^T
        if (tile == 0) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * ROW +
                                    kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < NK; ++np) {
          if (k0 + np * 16 >= p.Tk) break;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t bk[4];
            ldmatrix_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     ROW +
                                kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          }
        }
      } else {  // Q's fragment of each k-step read again from shared memory
        for (int kk = 0; kk < Dp / 16; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, q_s + (warp * 16 + (lane & 15)) * ROW + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NK; ++np) {
            if (k0 + np * 16 >= p.Tk) break;
            uint32_t bk[4];
            ldmatrix_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     ROW +
                                kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          }
        }
        if constexpr (CLUSTER) {  // the slice's partial scores -> the sum
          // over the cluster, the same in every CTA
          float(&flat)[NJ * 4] =
              *reinterpret_cast<float(*)[NJ * 4]>(&s[0][0]);
          float* slot = part + tid * 4;
          if (tile > 0) cluster_wait();  // every CTA read the last tile's
#pragma unroll
          for (int i = 0; i < NJ * 4; i += 4)
            *reinterpret_cast<float4*>(slot + i * nthreads) =
                make_float4(flat[i], flat[i + 1], flat[i + 2], flat[i + 3]);
          cluster_arrive();
          cluster_wait();
          if (n >= kAllreduceCtas)
            cluster_allreduce<NJ * 4>(flat, slot, 4 * nthreads, n,
                                      cluster_rank());
          else
            cluster_sum<NJ * 4, 4>(flat, slot, 4 * nthreads, n,
                                   cluster_rank());
          cluster_arrive();
        }
      }

      // scale and mask in fp32, in the log2 domain (scale2 = log2(e) /
      // sqrt(Dh)); row maxima over the quad that shares a row
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 mv =
            *reinterpret_cast<const float2*>(mk + j * 8 + (lane & 3) * 2);
        s[j][0] = s[j][0] * scale2 + mv.x;
        s[j][1] = s[j][1] * scale2 + mv.y;
        s[j][2] = s[j][2] * scale2 + mv.x;
        s[j][3] = s[j][3] * scale2 + mv.y;
      }
      if (p.causal && k0 + KT - 1 > row_base) {  // a diagonal tile
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + (lane & 3) * 2 + (e & 1) > ((e & 2) ? r_hi : r_lo))
              s[j][e] += kNeg2;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, o_));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, o_));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;

      // P in bf16, laid out as the A fragments of P.V; the rounded values
      // are what the row sum adds up
      uint32_t pa[NK][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t p_lo =
            pack_bf16(ex2(s[j][0] - m_lo), ex2(s[j][1] - m_lo));
        const uint32_t p_hi =
            pack_bf16(ex2(s[j][2] - m_hi), ex2(s[j][3] - m_hi));
        sum_lo += sum_bf16x2(p_lo);
        sum_hi += sum_bf16x2(p_hi);
        pa[j >> 1][(j & 1) * 2] = p_lo;
        pa[j >> 1][(j & 1) * 2 + 1] = p_hi;
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= a_lo;
        o[n][1] *= a_lo;
        o[n][2] *= a_hi;
        o[n][3] *= a_hi;
      }

      // O += P.V, V^T fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (k0 + kk * 16 >= p.Tk) break;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          if (WIDE && np * 16 >= Dp) break;
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                      np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
        }
      }
    } else if (CLUSTER) {  // a warp past Tq still takes part
      if (tile > 0) cluster_wait();
      cluster_arrive();
      cluster_wait();
      if (n >= kAllreduceCtas) {
        cluster_arrive();
        cluster_wait();
      }
      cluster_arrive();
    }
    __syncthreads();  // the next iteration refills this stage
  }
  // no CTA of a cluster leaves while another may read its partial scores
  if (CLUSTER) cluster_wait();

  if (!active) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, o_);
    l_hi += __shfl_xor_sync(kFull, l_hi, o_);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  if constexpr (!WIDE) {
    bf16* out_lo = p.out + ((size_t)(b * p.Tq + r_lo) * H + h) * Dh;
    bf16* out_hi = p.out + ((size_t)(b * p.Tq + r_hi) * H + h) * Dh;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d >= Dh) break;
      if (r_lo < p.Tq)
        *reinterpret_cast<uint32_t*>(out_lo + d) =
            pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
      if (r_hi < p.Tq)
        *reinterpret_cast<uint32_t*>(out_hi + d) =
            pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
    }
    return;
  }
  const bool even = (Dh & 1) == 0;
  bf16* out_lo = p.out + ((size_t)(b * p.Tq + r_lo) * H + h) * Dh + c0;
  bf16* out_hi = p.out + ((size_t)(b * p.Tq + r_hi) * H + h) * Dh + c0;
#pragma unroll
  for (int t = 0; t < NO; ++t) {
    const int d = t * 8 + (lane & 3) * 2;
    if (d >= wv) break;
    if (r_lo < p.Tq)
      store_bf16_pair(out_lo + d, o[t][0] * inv_lo, o[t][1] * inv_lo, even,
                      d + 1 < wv);
    if (r_hi < p.Tq)
      store_bf16_pair(out_hi + d, o[t][2] * inv_hi, o[t][3] * inv_hi, even,
                      d + 1 < wv);
  }
}

// blockIdx.y = h * n + c: the head, and in a cluster (of n CTAs along y,
// above Dh 128) the CTA's slice c of W head dims; W: the dims a block
// holds (WIDE), else D.
template <int D, int KT, bool WIDE, bool CLUSTER>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_tile_kernel(Attn p, int H, int Dh, float scale2, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = CLUSTER ? (Dh + W - 1) / W : 1;
  const int h = blockIdx.y / nc, c = blockIdx.y - h * nc;
  tile_rows<D, KT, WIDE, CLUSTER>(p, H, Dh, scale2, blockIdx.z, h,
                         blockIdx.x * (blockDim.x / 2), c * W, W, nc, smem);
}

// Both co-attention directions in one launch: blockIdx.z = 2 * b + dir; on
// a cluster blockIdx.z = half * B + b (`long_first`).
template <int D, int KT, bool WIDE, bool CLUSTER>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_tile_bi_kernel(Attn p1, Attn p2, int H, int Dh, float scale2,
                            int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = CLUSTER ? (Dh + W - 1) / W : 1;
  int b = blockIdx.z >> 1;
  bool second = blockIdx.z & 1;
  if constexpr (CLUSTER) long_first(p1.Tk, p2.Tk, b, second);
  const Attn p = second ? p2 : p1;
  const int q0 = blockIdx.x * (blockDim.x / 2);
  // whole block (a cluster shares q0): before any barrier
  if (q0 >= p.Tq) return;
  const int h = blockIdx.y / nc, c = blockIdx.y - h * nc;
  tile_rows<D, KT, WIDE, CLUSTER>(p, H, Dh, scale2, b, h, q0, c * W, W, nc,
                                  smem);
}

// One instantiation: O's (largest) width D, KT keys a tile, wide or not,
// on a cluster or not.
template <int D, int KT, bool WIDE, bool CLUSTER = false>
struct Inst {
  static constexpr int d = D, kt = KT;
  static constexpr bool wide = WIDE, cluster = CLUSTER;
};

int padded_dim(int Dh) { return (Dh + 15) / 16 * 16; }

// f(Inst<...>{}) for the instantiation that takes head dim Dh (the wide
// ones: above Dh 128 on a cluster, and a Dh that is not a multiple of 8),
// with 64-key tiles; cudaErrorInvalidValue for another key tile.
template <typename F>
cudaError_t with_inst(int Dh, int key_tile, F f) {
  if (key_tile != kKeyTile) return cudaErrorInvalidValue;
  if (Dh > kMaxCols) return f(Inst<kMaxCols, kKeyTile, true, true>{});
  if (Dh % 8) return f(Inst<kMaxCols, kKeyTile, true>{});
  switch (padded_dim(Dh)) {
    case 16: return f(Inst<16, 64, false>{});
    case 32: return f(Inst<32, 64, false>{});
    case 48: return f(Inst<48, 64, false>{});
    case 64: return f(Inst<64, 64, false>{});
    case 80: return f(Inst<80, 64, false>{});
    case 96: return f(Inst<96, 64, false>{});
    case 112: return f(Inst<112, 64, false>{});
    default: return f(Inst<128, 64, false>{});
  }
}

// log2(e) / sqrt(Dh): the softmax scale in the log2 domain
float head_scale2(int Dh) {
  return (float)(1.4426950408889634 / sqrt((double)Dh));
}

// The head dims a block holds: the plan's `cols` above 128, else Dh
// padded to 16.
int out_cols(int Dh, int cols) {
  return Dh > kMaxCols ? cols : padded_dim(Dh);
}

bool bad_shape(int B, int T1, int T2, int H, int Dh, int warps, int key_tile,
               int cols, int smem_bytes) {
  return B <= 0 || T1 <= 0 || T2 <= 0 || H <= 0 || Dh <= 0 || warps < 1 ||
         warps > kMaxWarps || key_tile != kKeyTile || bad_cols(Dh, cols) ||
         smem_bytes > kMaxSmem ||
         smem_bytes < tile_smem_bytes(out_cols(Dh, cols), warps,
                                      cluster_size(Dh, cols));
}

// Launch one tile kernel on `grid` (y: H * n), as clusters of n CTAs along
// y above Dh 128.
template <typename K, typename... Args>
cudaError_t launch(K* kernel, dim3 grid, int n, int warps, int smem,
                   cudaStream_t s, Args... args) {
  if (n == 1) {
    kernel<<<grid, warps * 32, smem, s>>>(args...);
    return cudaGetLastError();
  }
  return launch_cluster(kernel, grid, dim3(1, n, 1), warps * 32, smem, s,
                        args...);
}

}  // namespace
}  // namespace gpv_attn

using namespace gpv_attn;

// Once per process, after loading: allow every instantiation the dynamic
// shared memory of its largest block (the narrow ones at their D, the
// wide one of Dh <= 128 at D 128, the cluster one a cluster CTA's at a
// slice of 128 and clusters of up to 16 CTAs). Returns a cudaError_t.
extern "C" int gpv_attn_tile_init() {
  // Dh 16-128: the narrow ones; 12: the wide one; 144: the cluster one
  for (int Dh : {16, 32, 48, 64, 80, 96, 112, 128, 12, kMaxCols + 16}) {
    const cudaError_t err = with_inst(Dh, kKeyTile, [](auto c) {
      using C = decltype(c);
      auto tile = gpv_attn_tile_kernel<C::d, C::kt, C::wide, C::cluster>;
      auto bi = gpv_attn_tile_bi_kernel<C::d, C::kt, C::wide, C::cluster>;
      if constexpr (C::cluster) {
        constexpr int bytes = tile_smem_bytes(kMaxCols, kMaxWarps, 2);
        cudaError_t e = allow_cluster(tile, bytes);
        if (e == cudaSuccess) e = allow_cluster(bi, bytes);
        return e;
      } else {
        constexpr int bytes = tile_smem_bytes(C::d, kMaxWarps, 1);
        cudaError_t e = cudaFuncSetAttribute(
            tile, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(
              bi, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return e;
      }
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K1, Tq >= 1 rows per (b, h); `warps`, `key_tile` (64), `cols` (above Dh
// 128: a cluster of ceil(Dh / cols) CTAs of `cols` head dims) and
// `smem_bytes` as the wrapper's plan gives them (smem_bytes at least
// tile_smem_bytes).
extern "C" int gpv_attn_tile(const void* q, const void* k, const void* v,
                             const unsigned char* key_valid, void* out, int B,
                             int Tq, int Tk, int H, int Dh, int causal,
                             int warps, int key_tile, int cols,
                             int smem_bytes, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Dh, warps, key_tile, cols, smem_bytes))
    return cudaErrorInvalidValue;
  const Attn p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), key_valid,
               static_cast<bf16*>(out), Tq, Tk, causal};
  const int W = out_cols(Dh, cols), n = cluster_size(Dh, cols);
  const dim3 grid((Tq + 16 * warps - 1) / (16 * warps), H * n, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale2 = head_scale2(Dh);
  return with_inst(Dh, key_tile, [&](auto c) {
    using C = decltype(c);
    return launch(gpv_attn_tile_kernel<C::d, C::kt, C::wide, C::cluster>,
                  grid, n, warps, smem_bytes, s, p, H, Dh, scale2, W);
  });
}

// K2: ctx1 = softmax(q2 k1^T + m1) v1 -> (B, T2, H, Dh)  (valid1: (B, T1))
//     ctx2 = softmax(q1 k2^T + m2) v2 -> (B, T1, H, Dh)  (valid2: (B, T2))
extern "C" int gpv_attn_tile_bi(const void* q1, const void* k1,
                                const void* v1, const void* q2,
                                const void* k2, const void* v2,
                                const unsigned char* valid1,
                                const unsigned char* valid2, void* ctx1,
                                void* ctx2, int B, int T1, int T2, int H,
                                int Dh, int warps, int key_tile, int cols,
                                int smem_bytes, void* stream) {
  if (bad_shape(B, T1, T2, H, Dh, warps, key_tile, cols, smem_bytes))
    return cudaErrorInvalidValue;
  const Attn p1{static_cast<const bf16*>(q2), static_cast<const bf16*>(k1),
                static_cast<const bf16*>(v1), valid1,
                static_cast<bf16*>(ctx1), T2, T1, 0};
  const Attn p2{static_cast<const bf16*>(q1), static_cast<const bf16*>(k2),
                static_cast<const bf16*>(v2), valid2,
                static_cast<bf16*>(ctx2), T1, T2, 0};
  const int tq = T1 > T2 ? T1 : T2;
  const int W = out_cols(Dh, cols), n = cluster_size(Dh, cols);
  const dim3 grid((tq + 16 * warps - 1) / (16 * warps), H * n, 2 * B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale2 = head_scale2(Dh);
  return with_inst(Dh, key_tile, [&](auto c) {
    using C = decltype(c);
    return launch(gpv_attn_tile_bi_kernel<C::d, C::kt, C::wide, C::cluster>,
                  grid, n, warps, smem_bytes, s, p1, p2, H, Dh, scale2, W);
  });
}
