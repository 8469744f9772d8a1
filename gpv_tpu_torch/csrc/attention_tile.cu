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
// (B, T, H, Dh), contiguous, every pointer 16-byte aligned, Dh a multiple
// of 8 and at most 128.
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
constexpr int kKeyTile = 64;  // keys per shared-memory tile
constexpr int kMaxWarps = 4;  // 16 query rows each

struct Attn {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const unsigned char* key_valid;  // (B, Tk) or null: every key valid
  bf16* out;
  int Tq, Tk, causal;
};

// Dynamic shared memory of a block of `warps` warps at padded head dim D:
// the key mask and K and V in two stages, and the block's Q rows.
constexpr int tile_smem_bytes(int D, int warps) {
  return 2 * kKeyTile * 4 + 16 * warps * row_chunks(D) * 16 +
         2 * 2 * kKeyTile * row_chunks(D) * 16;
}

// Rows [q0, q0 + blockDim.x / 2) of (batch b, head h). D: Dh rounded up to
// a multiple of 16 (the product's depth); the pad is zero-filled.
template <int D>
__device__ __forceinline__ void tile_rows(const Attn& p, int H, int Dh,
                                          float scale2, int b, int h, int q0,
                                          unsigned char* smem) {
  constexpr int ROW = row_chunks(D) * 8;  // bf16 per shared-memory row
  constexpr int CH = D / 8;               // 16-byte chunks copied per row
  constexpr int KS = D / 16;              // k-steps of Q.K^T
  constexpr int NO = D / 8;               // 8-wide column tiles of O
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, rows = nthreads / 2;
  float* mask_s = reinterpret_cast<float*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + 2 * kKeyTile * 4);
  bf16* k_s = q_s + rows * ROW;
  bf16* v_s = k_s + 2 * kKeyTile * ROW;

  const int dc = Dh >> 3;  // chunks that hold data
  const size_t rs = (size_t)H * Dh;  // elements between two rows of (b, h)
  const bf16* qg = p.q + ((size_t)b * p.Tq * H + h) * Dh;
  const bf16* kg = p.k + ((size_t)b * p.Tk * H + h) * Dh;
  const bf16* vg = p.v + ((size_t)b * p.Tk * H + h) * Dh;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;

  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, c = i - r * CH, t = q0 + r;
    const bool ok = t < p.Tq && c < dc;
    cp_async16(q_s + r * ROW + c * 8, ok ? qg + t * rs + c * 8 : qg,
               ok ? 16 : 0);
  }
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kKeyTile;
    bf16* ks = k_s + stage * kKeyTile * ROW;
    bf16* vs = v_s + stage * kKeyTile * ROW;
    for (int i = tid; i < kKeyTile * CH; i += nthreads) {
      const int r = i / CH, c = i - r * CH, key = k0 + r;
      const bool ok = key < p.Tk && c < dc;
      const size_t off = ok ? key * rs + c * 8 : 0;
      cp_async16(ks + r * ROW + c * 8, kg + off, ok ? 16 : 0);
      cp_async16(vs + r * ROW + c * 8, vg + off, ok ? 16 : 0);
    }
    for (int i = tid; i < kKeyTile; i += nthreads) {
      const int key = k0 + i;
      mask_s[stage * kKeyTile + i] =
          key >= p.Tk ? -INFINITY : (valid && !valid[key]) ? kNeg2 : 0.f;
    }
  };

  const int n_tiles = (p.Tk + kKeyTile - 1) / kKeyTile;
  load_tile(0, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  const int row_base = q0 + warp * 16;
  const bool active = row_base < p.Tq;  // warp-uniform
  const int r_lo = row_base + (lane >> 2), r_hi = r_lo + 8;
  uint32_t qf[KS][4];
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
      if (tile == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * ROW +
                                  kk * 16 + (lane >> 4) * 8);
      }
      const bf16* ks = k_s + stage * kKeyTile * ROW;
      const bf16* vs = v_s + stage * kKeyTile * ROW;
      const float* mk = mask_s + stage * kKeyTile;
      const int k0 = tile * kKeyTile;

      // S = Q.K^T: 8 column tiles of 8 keys; 16-key groups past Tk skipped
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (k0 + np * 16 >= p.Tk) break;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ROW +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // scale and mask in fp32, in the log2 domain (scale2 = log2(e) /
      // sqrt(Dh)); row maxima over the quad that shares a row
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mv =
            *reinterpret_cast<const float2*>(mk + j * 8 + (lane & 3) * 2);
        s[j][0] = s[j][0] * scale2 + mv.x;
        s[j][1] = s[j][1] * scale2 + mv.y;
        s[j][2] = s[j][2] * scale2 + mv.x;
        s[j][3] = s[j][3] * scale2 + mv.y;
      }
      if (p.causal && k0 + kKeyTile - 1 > row_base) {  // a diagonal tile
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + (lane & 3) * 2 + (e & 1) > ((e & 2) ? r_hi : r_lo))
              s[j][e] += kNeg2;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
      uint32_t pa[4][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + kk * 16 >= p.Tk) break;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                      np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  if (!active) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, o_);
    l_hi += __shfl_xor_sync(kFull, l_hi, o_);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
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
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_tile_kernel(Attn p, int H, int Dh, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile_rows<D>(p, H, Dh, scale2, blockIdx.z, blockIdx.y,
               blockIdx.x * (blockDim.x / 2), smem);
}

// Both co-attention directions in one launch: blockIdx.z = 2 * b + dir.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_tile_bi_kernel(Attn p1, Attn p2, int H, int Dh, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Attn p = (blockIdx.z & 1) ? p2 : p1;
  const int q0 = blockIdx.x * (blockDim.x / 2);
  if (q0 >= p.Tq) return;  // whole block: before any barrier
  tile_rows<D>(p, H, Dh, scale2, blockIdx.z >> 1, blockIdx.y, q0, smem);
}

// f(std::integral_constant<int, D>) for the padded head dim D.
template <typename F>
cudaError_t with_dim(int D, F f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

int padded_dim(int Dh) { return (Dh + 15) / 16 * 16; }
// log2(e) / sqrt(Dh): the softmax scale in the log2 domain
float head_scale2(int Dh) {
  return (float)(1.4426950408889634 / sqrt((double)Dh));
}

bool bad_shape(int B, int T1, int T2, int H, int Dh, int warps,
               int smem_bytes) {
  return B <= 0 || T1 <= 0 || T2 <= 0 || H <= 0 || Dh <= 0 || Dh > 128 ||
         Dh % 8 || warps < 1 || warps > kMaxWarps ||
         smem_bytes < tile_smem_bytes(padded_dim(Dh), warps);
}

}  // namespace
}  // namespace gpv_attn

using namespace gpv_attn;

// Once per process, after loading: allow every instantiation the dynamic
// shared memory of its largest block. Returns a cudaError_t.
extern "C" int gpv_attn_tile_init() {
  for (int D = 16; D <= 128; D += 16) {
    const cudaError_t err = with_dim(D, [](auto d) {
      constexpr int kD = decltype(d)::value;
      constexpr int bytes = tile_smem_bytes(kD, kMaxWarps);
      cudaError_t e = cudaFuncSetAttribute(
          gpv_attn_tile_kernel<kD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gpv_attn_tile_bi_kernel<kD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      return e;
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K1, Tq >= 1 rows per (b, h); `warps` and `smem_bytes` as the wrapper's
// plan gives them (smem_bytes at least tile_smem_bytes).
extern "C" int gpv_attn_tile(const void* q, const void* k, const void* v,
                             const unsigned char* key_valid, void* out, int B,
                             int Tq, int Tk, int H, int Dh, int causal,
                             int warps, int smem_bytes, void* stream) {
  if (bad_shape(B, Tq, Tk, H, Dh, warps, smem_bytes))
    return cudaErrorInvalidValue;
  const Attn p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), key_valid,
               static_cast<bf16*>(out), Tq, Tk, causal};
  const dim3 grid((Tq + 16 * warps - 1) / (16 * warps), H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale2 = head_scale2(Dh);
  return with_dim(padded_dim(Dh), [&](auto d) {
    gpv_attn_tile_kernel<decltype(d)::value>
        <<<grid, warps * 32, smem_bytes, s>>>(p, H, Dh, scale2);
    return cudaGetLastError();
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
                                int Dh, int warps, int smem_bytes,
                                void* stream) {
  if (bad_shape(B, T1, T2, H, Dh, warps, smem_bytes))
    return cudaErrorInvalidValue;
  const Attn p1{static_cast<const bf16*>(q2), static_cast<const bf16*>(k1),
                static_cast<const bf16*>(v1), valid1,
                static_cast<bf16*>(ctx1), T2, T1, 0};
  const Attn p2{static_cast<const bf16*>(q1), static_cast<const bf16*>(k2),
                static_cast<const bf16*>(v2), valid2,
                static_cast<bf16*>(ctx2), T1, T2, 0};
  const int tq = T1 > T2 ? T1 : T2;
  const dim3 grid((tq + 16 * warps - 1) / (16 * warps), H, 2 * B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale2 = head_scale2(Dh);
  return with_dim(padded_dim(Dh), [&](auto d) {
    gpv_attn_tile_bi_kernel<decltype(d)::value>
        <<<grid, warps * 32, smem_bytes, s>>>(p1, p2, H, Dh, scale2);
    return cudaGetLastError();
  });
}
