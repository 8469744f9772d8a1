// One-row fused attention, bf16, for Hopper (sm_90a), plain C interface.
// The bf16 path of the Pallas kernel fused_attention (gpv_tpu/ops/
// attention.py, cell _attend_cell) when a call has one query row: the text
// decoder's step, over its 20-slot self-attention cache and over the
// 120-slot decode memory (8 heads of 96), 6 calls a step, 114 of the 144
// attention calls of a 19-step predict. Calls with more rows go to
// attention_tile.cu; fp32 calls to attention.cu.
//
// What it computes, per (batch, head): s_j = (q . k_j) / sqrt(Dh) in fp32,
// plus -1e9 for an invalid key (and -1e9 for j > 0 when causal: the one
// row is row 0), softmax with fp32 statistics, P rounded to bf16 and summed
// as rounded, P . V accumulated in fp32, the output in bf16. Scores and
// maxima are kept times log2(e), as in attention_tile.cu.
//
// What bounds it on the card: bytes. One row against Tk keys is a matrix-
// vector product per (b, h): Tk * Dh multiply-adds on 4 * Tk * Dh bytes of
// K and V, far too few operations for the tensor cores to matter. The
// bound at the decode step's shapes is reading K and V once (1.29 MB over
// the cache, 7.37 MB over the memory at B=20).
//
// Design: one block per (b, h), 1-4 warps (min(4, ceil(Tk/32))), and no
// query row that does not exist is computed.
// - The warps split the keys: warp w takes keys [32w, 32w + 32), then
//   [32(w + W), ...) while keys remain. Its lanes copy the K and V rows of
//   those keys into the warp's own shared memory with coalesced 16-byte
//   cp.async copies, so a warp waits for its own copies alone. The first
//   copies are issued before q is read, and the key-validity bytes are
//   read while the rows land: the kernel is a few dependent trips to
//   device memory long, and these overlap two of them.
// - Each lane scores one key in fp32 against q (held in shared memory as
//   fp32, read by broadcast); the warp takes max and sum with shuffles.
// - P.V: each lane owns two adjacent dims (one or two such pairs), read as
//   __nv_bfloat162, and runs over its warp's keys.
// - The warps' (max, sum, acc) are combined once through shared memory and
//   warp 0 writes the output row in bf16.
//
// Any Dh >= 1: rows are copied 16 bytes at a time when Dh is a multiple of
// 8, 4 bytes when it is even, else one value at a time, and zero-filled to
// a multiple of 8. Above Dh 128 a block computes at most 128 output
// columns: the grid's x runs over (head, column block), each block scores
// the keys over the whole Dh (q and the K rows whole in shared memory) and
// keeps only its columns of V, so a lane's pairs stay at most two. K rows
// of 32 keys a warp at Dh 768 take 50 KB, so the wrapper's plan cuts the
// warps until the block fits 227 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <math.h>

#include "attention_common.cuh"

namespace gpv_attn {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 4;
constexpr int kWarpKeys = 32;  // keys a warp scores at once: one per lane

struct Decode {
  const bf16* q;  // (B, 1, H, Dh)
  const bf16* k;  // (B, Tk, H, Dh)
  const bf16* v;
  const unsigned char* key_valid;  // (B, Tk) or null: every key valid
  bf16* out;                       // (B, 1, H, Dh)
  int Tk, H, Dh, causal;
  float scale2;  // log2(e) / sqrt(Dh)
  int W;         // output columns a block (block_cols)
};

// q as fp32 (Dh rounded up to 8, room for 128 at least), each warp's
// (max, sum, acc[W]) and each warp's K rows (Dh wide) and V rows (W wide).
__host__ __device__ constexpr int q_floats(int Dh) {
  return ceil8(Dh) > 128 ? ceil8(Dh) : 128;
}
__host__ __device__ constexpr int part_bytes(int W, int warps) {
  return (warps * (ceil8(W) + 2) * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int decode_smem_bytes(int Dh, int W,
                                                    int warps) {
  return q_floats(Dh) * 4 + part_bytes(W, warps) +
         warps * kWarpKeys * (row_chunks(Dh) + row_chunks(W)) * 16;
}

// DP: bf16 pairs a lane owns in P.V (W <= 64 * DP). GEN: any Dh (column
// blocks above 128, copies in bf16_unit's units); else Dh <= 128 and a
// multiple of 8, whose code is what it was before other head dims.
template <int DP, bool GEN>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_decode_kernel(Decode p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = GEN ? (p.Dh + p.W - 1) / p.W : 1;  // column blocks a head
  const int h = blockIdx.x / nc, b = blockIdx.y;
  const int c0 = GEN ? (blockIdx.x - h * nc) * p.W : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int Dh = p.Dh, D8 = GEN ? ceil8(Dh) : Dh, dc = D8 >> 3;
  const int ROW = (GEN ? row_chunks(Dh) : (Dh / 8) | 1) * 8;
  const int VROW = GEN ? row_chunks(p.W) * 8 : ROW;
  const int PW = GEN ? ceil8(p.W) + 2 : Dh + 2;  // floats of a warp's partials
  const int wv = GEN ? min(p.W, Dh - c0) : Dh;   // this block's columns
  const int unit = bf16_unit(Dh);
  const int qf = GEN ? q_floats(Dh) : 128;
  float* q_s = reinterpret_cast<float*>(smem);
  float* part = q_s + qf;
  bf16* k_s = reinterpret_cast<bf16*>(
                  smem + qf * 4 +
                  (GEN ? part_bytes(p.W, nw) : (nw * PW * 4 + 15) / 16 * 16)) +
              warp * kWarpKeys * (ROW + VROW);
  bf16* v_s = k_s + kWarpKeys * ROW;

  const size_t rs = (size_t)p.H * Dh;  // elements between two keys of (b, h)
  const bf16* kg = p.k + ((size_t)b * p.Tk * p.H + h) * Dh;
  const bf16* vg = p.v + ((size_t)b * p.Tk * p.H + h) * Dh;
  const unsigned char* valid =
      p.key_valid ? p.key_valid + (size_t)b * p.Tk : nullptr;
  const bf16* qg = p.q + ((size_t)b * p.H + h) * Dh;

  // this warp's next rows of K (whole) and V (this block's columns)
  auto copy_rows = [&](int k0) {
    const int nk = min(kWarpKeys, p.Tk - k0);
    if constexpr (!GEN) {
      for (int i = lane; i < nk * dc; i += 32) {
        const int r = i / dc, c = i - r * dc;
        const size_t off = (size_t)(k0 + r) * rs + c * 8;
        cp_async16(k_s + r * ROW + c * 8, kg + off, 16);
        cp_async16(v_s + r * ROW + c * 8, vg + off, 16);
      }
    } else if (nc == 1) {
      copy_bf16_rows<2>(unit, {k_s, v_s}, {kg, vg}, k0, nk, p.Tk, 0, D8, Dh,
                        rs, ROW, lane, 32);
    } else {
      copy_bf16_rows<1>(unit, {k_s}, {kg}, k0, nk, p.Tk, 0, D8, Dh, rs, ROW,
                        lane, 32);
      copy_bf16_rows<1>(unit, {v_s}, {vg}, k0, nk, p.Tk, c0, ceil8(p.W),
                        Dh - c0, rs, VROW, lane, 32);
    }
    cp_async_commit();
  };
  const int first = warp * kWarpKeys;
  if (first < p.Tk) copy_rows(first);  // lands while q is read
  for (int d = threadIdx.x; d < D8; d += blockDim.x)
    q_s[d] = !GEN || d < Dh ? __bfloat162float(qg[d]) : 0.f;
  __syncthreads();

  float m = -INFINITY, l = 0.f, acc[DP][2];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int k0 = first; k0 < p.Tk; k0 += nw * kWarpKeys) {
    const int nk = min(kWarpKeys, p.Tk - k0);
    const int key = k0 + lane;
    float mv = 0.f;  // causal + key validity, one fp32 sum, read meanwhile
    if (lane < nk && valid && !valid[key]) mv += kNeg2;
    if (p.causal && key > 0) mv += kNeg2;
    cp_async_wait<0>();
    __syncwarp();

    float s = -INFINITY;  // lanes past the last key take no part
    if (lane < nk) {
      const bf16* kr = k_s + lane * ROW;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, summed at the end
#pragma unroll 4
      for (int c = 0; c < dc; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 8);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 qa = *reinterpret_cast<const float4*>(q_s + c * 8);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + c * 8 + 4);
        float2 f = __bfloat1622float2(k2[0]);
        dot[0] = fmaf(qa.x, f.x, dot[0]);
        dot[1] = fmaf(qa.y, f.y, dot[1]);
        f = __bfloat1622float2(k2[1]);
        dot[2] = fmaf(qa.z, f.x, dot[2]);
        dot[3] = fmaf(qa.w, f.y, dot[3]);
        f = __bfloat1622float2(k2[2]);
        dot[0] = fmaf(qb.x, f.x, dot[0]);
        dot[1] = fmaf(qb.y, f.y, dot[1]);
        f = __bfloat1622float2(k2[3]);
        dot[2] = fmaf(qb.z, f.x, dot[2]);
        dot[3] = fmaf(qb.w, f.y, dot[3]);
      }
      s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * p.scale2 + mv;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = ex2(m - m_new);
    // P in bf16 before P.V; the rounded values are what the sum adds up
    const float e =
        lane < nk ? __bfloat162float(__float2bfloat16(ex2(s - m_new))) : 0.f;
    l = l * alpha + warp_sum(e);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
    }
#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(kFull, e, j);
      const bf16* vr = v_s + j * VROW;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        const int d = 2 * lane + 64 * i;
        if (d < wv) {  // an odd wv's last pair reads a zero-filled pad
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vr + d));
          acc[i][0] = fmaf(pj, f.x, acc[i][0]);
          acc[i][1] = fmaf(pj, f.y, acc[i][1]);
        }
      }
    }
    __syncwarp();  // every lane is done with the rows before the next copy
    if (k0 + nw * kWarpKeys < p.Tk) copy_rows(k0 + nw * kWarpKeys);
  }

  float* mine = part + warp * PW;
  if (lane == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const int d = 2 * lane + 64 * i;
    if (d < wv) {
      mine[2 + d] = acc[i][0];
      mine[3 + d] = acc[i][1];
    }
  }
  __syncthreads();
  if (warp != 0) return;

  float M = -INFINITY;
  for (int w = 0; w < nw; ++w) M = fmaxf(M, part[w * PW]);
  float L = 0.f, o[DP][2];
#pragma unroll
  for (int i = 0; i < DP; ++i) o[i][0] = o[i][1] = 0.f;
  for (int w = 0; w < nw; ++w) {
    const float* pw = part + w * PW;
    const float f = ex2(pw[0] - M);  // a warp without keys: 0
    L += f * pw[1];
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int d = 2 * lane + 64 * i;
      if (d < wv) {
        o[i][0] = fmaf(f, pw[2 + d], o[i][0]);
        o[i][1] = fmaf(f, pw[3 + d], o[i][1]);
      }
    }
  }
  bf16* og = p.out + ((size_t)b * p.H + h) * Dh + c0;
  const float inv = 1.f / L;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    const int d = 2 * lane + 64 * i;
    if (d < wv) {
      if constexpr (GEN)
        store_bf16_pair(og + d, o[i][0] * inv, o[i][1] * inv, (Dh & 1) == 0,
                        d + 1 < wv);
      else
        *reinterpret_cast<uint32_t*>(og + d) =
            pack_bf16(o[i][0] * inv, o[i][1] * inv);
    }
  }
}

}  // namespace
}  // namespace gpv_attn

using namespace gpv_attn;

// Once per process, after loading: allow each instantiation the dynamic
// shared memory of its largest block (Dh 128 for those of head dims up to
// 128 that are multiples of 8, all a block may have for the others).
// Returns a cudaError_t.
extern "C" int gpv_attn_decode_init() {
  const int narrow = decode_smem_bytes(128, 128, kMaxWarps);
  cudaError_t e = cudaSuccess;
#define GPV_SET(DP, GEN, bytes)                                        \
  if (e == cudaSuccess)                                                \
    e = cudaFuncSetAttribute(gpv_attn_decode_kernel<DP, GEN>,          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             bytes);
  GPV_SET(1, false, narrow)
  GPV_SET(2, false, narrow)
  GPV_SET(1, true, kMaxSmem)
  GPV_SET(2, true, kMaxSmem)
#undef GPV_SET
  return e;
}

// K1 with Tq = 1: q/out (B, 1, H, Dh), k/v (B, Tk, H, Dh); `warps`, `cols`
// and `smem_bytes` as the wrapper's plan gives them.
extern "C" int gpv_attn_decode(const void* q, const void* k, const void* v,
                               const unsigned char* key_valid, void* out,
                               int B, int Tk, int H, int Dh, int causal,
                               int warps, int cols, int smem_bytes,
                               void* stream) {
  if (B <= 0 || Tk <= 0 || H <= 0 || Dh <= 0 || bad_cols(Dh, cols) ||
      warps < 1 || warps > kMaxWarps || smem_bytes > kMaxSmem ||
      smem_bytes < decode_smem_bytes(Dh, block_cols(Dh, cols), warps))
    return cudaErrorInvalidValue;
  const int W = block_cols(Dh, cols);
  const Decode p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), key_valid,
                 static_cast<bf16*>(out), Tk, H, Dh, causal,
                 (float)(1.4426950408889634 / sqrt((double)Dh)), W};
  const dim3 grid(H * col_blocks(Dh, cols), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gen = Dh > kMaxCols || Dh % 8;
  if (W <= 64 && !gen)
    gpv_attn_decode_kernel<1, false><<<grid, warps * 32, smem_bytes, s>>>(p);
  else if (!gen)
    gpv_attn_decode_kernel<2, false><<<grid, warps * 32, smem_bytes, s>>>(p);
  else if (W <= 64)
    gpv_attn_decode_kernel<1, true><<<grid, warps * 32, smem_bytes, s>>>(p);
  else
    gpv_attn_decode_kernel<2, true><<<grid, warps * 32, smem_bytes, s>>>(p);
  return cudaGetLastError();
}
