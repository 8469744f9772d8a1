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
// a multiple of 8. Above Dh 128 the kernel runs on a cluster
// (attention_common.cuh): the grid's x runs over (head, slice), a cluster
// of n CTAs along x owns one (batch, head), and each CTA holds q, K and V
// over its slice of at most 128 head dims, so a lane's pairs stay at most
// two and a CTA's shared memory is a Dh-128 block's. Every warp's chunk of
// 32 partial scores is summed over the cluster through distributed shared
// memory before its softmax, so the warps walk the same number of chunks
// in every CTA (a chunk past Tk has no live key).
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
  int W;         // head dims a block holds: Dh, or a cluster CTA's slice
};

// q as fp32 (W rounded up to 8, room for 128 at least), each warp's
// (max, sum, acc[W]), in a cluster of n > 1 each warp's 32 partial
// scores, and each warp's K and V rows (W wide).
__host__ __device__ constexpr int q_floats(int W) {
  return ceil8(W) > 128 ? ceil8(W) : 128;
}
__host__ __device__ constexpr int part_bytes(int W, int warps) {
  return (warps * (ceil8(W) + 2) * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int cluster_part_bytes(int warps, int n) {
  return n > 1 ? warps * kWarpKeys * 4 : 0;
}
__host__ __device__ constexpr int decode_smem_bytes(int W, int warps,
                                                    int n) {
  return q_floats(W) * 4 + part_bytes(W, warps) +
         cluster_part_bytes(warps, n) +
         warps * kWarpKeys * 2 * row_chunks(W) * 16;
}

// DP: bf16 pairs a lane owns in P.V (W <= 64 * DP). GEN: any Dh (copies
// in bf16_unit's units; CLUSTER: above 128, a cluster of n CTAs); else Dh
// <= 128 and a multiple of 8, whose code is what it was before other head
// dims.
template <int DP, bool GEN, bool CLUSTER = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
    gpv_attn_decode_kernel(Decode p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = CLUSTER ? (p.Dh + p.W - 1) / p.W : 1;  // CTAs a head
  const int h = blockIdx.x / nc, b = blockIdx.y;
  const int c0 = CLUSTER ? (blockIdx.x - h * nc) * p.W : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int Dh = p.Dh;
  const int wv = GEN ? min(p.W, Dh - c0) : Dh;   // this block's head dims
  const int D8 = GEN ? ceil8(wv) : Dh, dc = D8 >> 3;
  const int ROW = (GEN ? row_chunks(p.W) : (Dh / 8) | 1) * 8;
  const int PW = GEN ? ceil8(p.W) + 2 : Dh + 2;  // floats of a warp's partials
  const int unit = bf16_unit(Dh);
  const int qf = GEN ? q_floats(p.W) : 128;
  float* q_s = reinterpret_cast<float*>(smem);
  float* part = q_s + qf;
  const int pb = GEN ? part_bytes(p.W, nw) : (nw * PW * 4 + 15) / 16 * 16;
  float* cpart = reinterpret_cast<float*>(smem + qf * 4 + pb);  // CLUSTER
  bf16* k_s = reinterpret_cast<bf16*>(
                  smem + qf * 4 + pb +
                  (CLUSTER ? cluster_part_bytes(nw, nc) : 0)) +
              warp * kWarpKeys * (ROW + ROW);
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
    } else {
      copy_bf16_rows<2>(unit, {k_s, v_s}, {kg, vg}, k0, nk, p.Tk, c0,
                        ceil8(p.W), Dh - c0, rs, ROW, lane, 32);
    }
    cp_async_commit();
  };
  const int first = warp * kWarpKeys;
  if (first < p.Tk) copy_rows(first);  // lands while q is read
  for (int d = threadIdx.x; d < D8; d += blockDim.x)
    q_s[d] = !GEN || d < wv ? __bfloat162float(qg[c0 + d]) : 0.f;
  __syncthreads();

  float m = -INFINITY, l = 0.f, acc[DP][2];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i][0] = acc[i][1] = 0.f;

  // a cluster's warps walk ceil(Tk / step) chunks each (nk <= 0 past Tk)
  const int step = nw * kWarpKeys;
  const int end = CLUSTER ? first + (p.Tk + step - 1) / step * step : p.Tk;
  for (int k0 = first; k0 < end; k0 += nw * kWarpKeys) {
    const int nk = min(kWarpKeys, p.Tk - k0);
    const int key = k0 + lane;
    float mv = 0.f;  // causal + key validity, one fp32 sum, read meanwhile
    if (lane < nk && valid && !valid[key]) mv += kNeg2;
    if (p.causal && key > 0) mv += kNeg2;
    cp_async_wait<0>();
    __syncwarp();

    float s = -INFINITY;  // lanes past the last key take no part
    float dsum = 0.f;     // CLUSTER: this slice's partial score
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
      if constexpr (CLUSTER)
        dsum = (dot[0] + dot[1]) + (dot[2] + dot[3]);
      else
        s = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * p.scale2 + mv;
    }
    if constexpr (CLUSTER) {  // the slice's partial -> the cluster's sum
      float one[1] = {dsum};
      float* slot = cpart + warp * kWarpKeys + lane;
      if (k0 != first) cluster_wait();  // every CTA read the last chunk's
      *slot = dsum;
      cluster_arrive();
      cluster_wait();
      cluster_sum<1, 1>(one, slot, 0, nc, cluster_rank());
      cluster_arrive();
      if (lane < nk) s = one[0] * p.scale2 + mv;
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
      const bf16* vr = v_s + j * ROW;
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
  // no CTA of a cluster leaves while another may read its partials
  if constexpr (CLUSTER) cluster_wait();

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
// 128, a cluster CTA's at a slice of 128 for the cluster one, which may
// also form clusters of up to 16 CTAs). Returns a cudaError_t.
extern "C" int gpv_attn_decode_init() {
  const int narrow = decode_smem_bytes(128, kMaxWarps, 1);
  const int wide = decode_smem_bytes(128, kMaxWarps, 2);
  cudaError_t e = cudaSuccess;
#define GPV_SET(DP, GEN, bytes)                                        \
  if (e == cudaSuccess)                                                \
    e = cudaFuncSetAttribute(gpv_attn_decode_kernel<DP, GEN>,          \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             bytes);
  GPV_SET(1, false, narrow)
  GPV_SET(2, false, narrow)
  GPV_SET(1, true, narrow)
  GPV_SET(2, true, narrow)
#undef GPV_SET
  if (e == cudaSuccess)
    e = allow_cluster(gpv_attn_decode_kernel<2, true, true>, wide);
  return e;
}

// K1 with Tq = 1: q/out (B, 1, H, Dh), k/v (B, Tk, H, Dh); `warps`, `cols`
// and `smem_bytes` as the wrapper's plan gives them.
extern "C" int gpv_attn_decode(const void* q, const void* k, const void* v,
                               const unsigned char* key_valid, void* out,
                               int B, int Tk, int H, int Dh, int causal,
                               int warps, int cols, int smem_bytes,
                               void* stream) {
  const int W = Dh > kMaxCols ? cols : Dh;  // head dims a block holds
  const int n = cluster_size(Dh, cols);
  if (B <= 0 || Tk <= 0 || H <= 0 || Dh <= 0 || bad_cols(Dh, cols) ||
      warps < 1 || warps > kMaxWarps || smem_bytes > kMaxSmem ||
      smem_bytes < decode_smem_bytes(W, warps, n))
    return cudaErrorInvalidValue;
  const Decode p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), key_valid,
                 static_cast<bf16*>(out), Tk, H, Dh, causal,
                 (float)(1.4426950408889634 / sqrt((double)Dh)), W};
  const dim3 grid(H * n, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gen = Dh > kMaxCols || Dh % 8;
  if (n > 1)  // a cluster of n CTAs along x a head; W > 64 above Dh 128
    return launch_cluster(gpv_attn_decode_kernel<2, true, true>, grid,
                          dim3(n, 1, 1), warps * 32, smem_bytes, s, p);
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
