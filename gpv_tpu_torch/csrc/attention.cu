// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of gpv_tpu/ops/attention.py:
//   gpv_fused_attention   <- fused_attention   (cell body _attend_cell)
//   gpv_fused_biattention <- fused_biattention (_make_biattn_kernel)
//
// What it computes, per (batch, head): S = (q * 1/sqrt(Dh)) . k^T in fp32,
// plus -1e9 on invalid keys and -1e9 above the diagonal when causal (added
// as one fp32 mask, like the TPU kernel's materialised mask); softmax with
// fp32 statistics; P rounded to V's type; P . V accumulated in fp32; the
// output in the input type. Layout (B, T, H, Dh), contiguous.
//
// What bounds it on the card: at the main path's shapes (Tk <= 300,
// Dh <= 96) each output row reads O(Tk * Dh) bytes of K/V and does
// O(Tk * Dh) multiply-adds, so the unfused version is bound by moving the
// (B, H, Tq, Tk) score matrix through device memory. This design never
// writes scores out: one block owns 16 query rows of one (batch, head),
// streams K/V through shared memory in tiles of 32 keys and keeps an
// online (running-max) softmax in registers, so device memory sees q and
// out once, and k and v once per 16-row query block (mostly from L2). The products run on the CUDA cores in fp32;
// moving them to the tensor cores (wgmma) is later work. At the decode
// step (Tq = 1) a block has one real row of its 16, so that shape is bound
// by one warp's latency over the key tiles; splitting the keys across the
// block's warps is later work too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kRows = 4;                   // query rows per warp
constexpr int kBlockQ = kWarps * kRows;    // query rows per block
constexpr int kBlockK = 32;                // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e9f;              // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One attention problem: queries (B, Tq, H, Dh) over keys/values
// (B, Tk, H, Dh), optional key validity (B, Tk) and causal flag.
struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* key_valid;  // null: every key valid
  void* out;
  int Tq, Tk, H, Dh, causal;
  float scale;
};

// One block: kBlockQ query rows [q0, q0 + kBlockQ) of (batch b, head h).
// MAXD = 32 * DPL is the head-dim capacity; lane owns output dims
// lane, lane + 32, ... (< Dh), so Dh need not be a power of two.
template <typename T, int DPL>
__device__ void attend_rows(const Problem& p, int b, int h, int q0) {
  constexpr int MAXD = 32 * DPL;
  constexpr int KST = MAXD + 1;  // odd row stride: lane j reads row j
  __shared__ __align__(16) float q_s[kBlockQ * MAXD];
  __shared__ float k_s[kBlockK * KST];
  __shared__ float v_s[kBlockK * MAXD];

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dh = p.Dh, H = p.H;
  const int dh4 = (Dh + 3) & ~3;  // zero-padded to a multiple of 4 (<= MAXD)

  // queries of this block, pre-scaled in fp32 as the TPU kernel does
  for (int i = tid; i < kBlockQ * MAXD; i += kThreads) {
    const int r = i / MAXD, d = i - r * MAXD, t = q0 + r;
    float x = 0.f;
    if (t < p.Tq && d < Dh)
      x = to_float(q[((size_t)(b * p.Tq + t) * H + h) * Dh + d]) * p.scale;
    q_s[i] = x;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int row0 = q0 + warp * kRows;

  for (int k0 = 0; k0 < p.Tk; k0 += kBlockK) {
    __syncthreads();  // previous tile fully read (and q_s written)
    for (int i = tid; i < kBlockK * MAXD; i += kThreads) {
      const int j = i / MAXD, d = i - j * MAXD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < p.Tk && d < Dh) {
        const size_t off = ((size_t)(b * p.Tk + key) * H + h) * Dh + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      k_s[j * KST + d] = kx;
      v_s[j * MAXD + d] = vx;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool in_range = key < p.Tk;
    const int nk = min(kBlockK, p.Tk - k0);
    const bool key_ok =
        !in_range || p.key_valid == nullptr || p.key_valid[b * p.Tk + key];

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KST;
    const float* qrow = q_s + warp * kRows * MAXD;
    for (int d = 0; d < dh4; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * MAXD + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = row0 + r;
      float sc = -INFINITY;  // keys past Tk take no part
      if (in_range) {
        float mask = 0.f;  // causal + key validity, one fp32 sum
        if (p.causal && key > t) mask += kNeg;
        if (!key_ok) mask += kNeg;
        sc = s[r] + mask;
      }
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      float e = in_range ? expf(sc - m_new) : 0.f;
      e = to_float(from_float<T>(e));  // P in V's type before P.V
      l[r] = l[r] * alpha + e;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      pr[r] = e;
    }

    for (int j = 0; j < nk; ++j) {
      const float* vrow = v_s + j * MAXD + lane;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = vrow[32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, pr[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = warp_sum(l[r]);
    const int t = row0 + r;
    if (t >= p.Tq) continue;
    T* orow = out + ((size_t)(b * p.Tq + t) * H + h) * Dh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) orow[d] = from_float<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(Problem p) {
  attend_rows<T, DPL>(p, blockIdx.z, blockIdx.y, blockIdx.x * kBlockQ);
}

// Both co-attention directions in one launch: blockIdx.z = 2 * b + dir.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    biattention_kernel(Problem p1, Problem p2) {
  const Problem p = (blockIdx.z & 1) ? p2 : p1;
  const int q0 = blockIdx.x * kBlockQ;
  if (q0 >= p.Tq) return;  // whole block: before any barrier
  attend_rows<T, DPL>(p, blockIdx.z >> 1, blockIdx.y, q0);
}

int dims_per_lane(int Dh) { return (Dh + 31) / 32; }

template <typename T>
cudaError_t launch_attention(const Problem& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Tq + kBlockQ - 1) / kBlockQ, p.H, B);
  const dim3 block(kThreads);
  switch (dims_per_lane(p.Dh)) {
    case 1: attention_kernel<T, 1><<<grid, block, 0, stream>>>(p); break;
    case 2: attention_kernel<T, 2><<<grid, block, 0, stream>>>(p); break;
    case 3: attention_kernel<T, 3><<<grid, block, 0, stream>>>(p); break;
    case 4: attention_kernel<T, 4><<<grid, block, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_biattention(const Problem& p1, const Problem& p2, int B,
                               cudaStream_t stream) {
  const int tq = p1.Tq > p2.Tq ? p1.Tq : p2.Tq;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, p1.H, 2 * B);
  const dim3 block(kThreads);
  switch (dims_per_lane(p1.Dh)) {
    case 1: biattention_kernel<T, 1><<<grid, block, 0, stream>>>(p1, p2); break;
    case 2: biattention_kernel<T, 2><<<grid, block, 0, stream>>>(p1, p2); break;
    case 3: biattention_kernel<T, 3><<<grid, block, 0, stream>>>(p1, p2); break;
    case 4: biattention_kernel<T, 4><<<grid, block, 0, stream>>>(p1, p2); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

float head_scale(int Dh) { return (float)(1.0 / sqrt((double)Dh)); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int gpv_fused_attention(const void* q, const void* k,
                                   const void* v,
                                   const unsigned char* key_valid, void* out,
                                   int B, int Tq, int Tk, int H, int Dh,
                                   int causal, int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Dh <= 0)
    return cudaErrorInvalidValue;
  const Problem p{q, k, v, key_valid, out, Tq, Tk, H, Dh, causal,
                  head_scale(Dh)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_attention<float>(p, B, s);
  if (dtype == 1) return launch_attention<__nv_bfloat16>(p, B, s);
  return cudaErrorInvalidValue;
}

// ctx1 = softmax(q2 k1^T + m1) v1 -> (B, T2, H, Dh)  (valid1: (B, T1))
// ctx2 = softmax(q1 k2^T + m2) v2 -> (B, T1, H, Dh)  (valid2: (B, T2))
extern "C" int gpv_fused_biattention(
    const void* q1, const void* k1, const void* v1, const void* q2,
    const void* k2, const void* v2, const unsigned char* valid1,
    const unsigned char* valid2, void* ctx1, void* ctx2, int B, int T1,
    int T2, int H, int Dh, int dtype, void* stream) {
  if (B <= 0 || T1 <= 0 || T2 <= 0 || H <= 0 || Dh <= 0)
    return cudaErrorInvalidValue;
  const float scale = head_scale(Dh);
  const Problem p1{q2, k1, v1, valid1, ctx1, T2, T1, H, Dh, 0, scale};
  const Problem p2{q1, k2, v2, valid2, ctx2, T1, T2, H, Dh, 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_biattention<float>(p1, p2, B, s);
  if (dtype == 1) return launch_biattention<__nv_bfloat16>(p1, p2, B, s);
  return cudaErrorInvalidValue;
}
