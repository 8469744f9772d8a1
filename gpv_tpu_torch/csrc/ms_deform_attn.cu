// Multi-scale deformable attention's sampling, forward only (Zhu et al.,
// "Deformable DETR", ICLR 2021, MSDeformAttn): the kernel behind
// gpv_tpu_torch/ops/ms_deform_attn.py.
//
//   out[b, q, h, :] = sum_{l, p} A[b, q, h, l, p]
//                     * bilinear(value[b, level l, h, :], loc[b, q, h, l, p])
//   A   = softmax over the L*P logits of (b, q, h)
//   loc = ref[b, q, l] + off[b, q, h, l, p] / (W_l, H_l)
//
// A sample sits at pixel (loc.x * W_l - 0.5, loc.y * H_l - 0.5) of level
// l's map and a corner outside the map reads 0 (grid_sample, zero
// padding, align_corners=False). Level l's rows of the value start at
// sum_{k<l} H_k W_k, row-major.
//
// One warp per (b, q, h), 8 warps a block: at 8 heads, one query's heads,
// whose corner reads fall in the same value rows (L1 serves them). Lane
// j < L*P owns sample j: its softmax weight (max and sum over the warp by
// shuffles), its location and its four corners (value row and bilinear
// weight, the attention weight folded in, weight 0 outside the map). The
// warp then walks the samples: lane c accumulates channel c of the head
// from the four corner rows, so the warp's read of a corner is one
// contiguous run of the head's 32 elements. Locations, softmax and sums
// are fp32 on both routes; the output is written in the value's dtype.
//
// It takes Deformable DETR's heads: Dh = 32 (256 wide, 8 heads), at most
// kMaxLevels levels and 32 samples (L * P) a head; the entry refuses
// anything else with cudaErrorInvalidValue.
//
// Interface (plain C, loaded with ctypes): gpv_msdeform(value, ref, off,
// logits, out, B, S, Q, H, Dh, L, P, shapes, bf16, stream) with value
// (B, S, H, Dh), ref (B, Q, L, 2) fp32, off (B, Q, H, L, P, 2), logits
// (B, Q, H, L*P), out (B, Q, H, Dh), all contiguous; `shapes` a host
// array of the L (H_l, W_l); value, off, logits and out bf16 when `bf16`,
// else fp32. Returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kDh = 32;        // a lane a channel
constexpr int kThreads = 256;  // 8 warps
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void sample_head(
    const T* __restrict__ value, const float* __restrict__ ref,
    const T* __restrict__ off, const T* __restrict__ logits,
    T* __restrict__ out, int S, int Q, int H, int L, int P, long long warps,
    const Levels& lv) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= warps) return;  // whole warps: the block is a multiple of 32
  const int h = (int)(warp % H);
  const long long bq = warp / H;
  const long long b = bq / Q;
  const int LP = L * P;

  // sample `lane`: its share of the softmax
  float logit = -INFINITY;
  if (lane < LP) logit = load(logits + warp * LP + lane);
  float m = logit;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float e = lane < LP ? expf(logit - m) : 0.f;
  float sum = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  const float a = e / sum;

  // its four corners: value row (-1 outside the map) and weight
  int row[4] = {-1, -1, -1, -1};
  float wt[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < LP) {
    const int l = lane / P;
    const int Hl = lv.h[l], Wl = lv.w[l];
    const float* r = ref + (bq * L + l) * 2;
    const T* o = off + (warp * LP + lane) * 2;
    const float x = (r[0] + load(o) / (float)Wl) * (float)Wl - 0.5f;
    const float y = (r[1] + load(o + 1) / (float)Hl) * (float)Hl - 0.5f;
    if (x > -1.f && y > -1.f && x < (float)Wl && y < (float)Hl) {
      const float fx = floorf(x), fy = floorf(y);
      const int x0 = (int)fx, y0 = (int)fy;
      const float dx = x - fx, dy = y - fy;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cx = x0 + (k & 1), cy = y0 + (k >> 1);
        if (cx >= 0 && cx < Wl && cy >= 0 && cy < Hl) {
          row[k] = lv.start[l] + cy * Wl + cx;
          wt[k] = a * ((k & 1) ? dx : 1.f - dx) * ((k >> 1) ? dy : 1.f - dy);
        }
      }
    }
  }

  // the warp walks the samples, each lane its channel
  float acc = 0.f;
  const long long stride = (long long)H * kDh;  // one value row
  const T* vb = value + b * S * stride + (long long)h * kDh + lane;
#pragma unroll 2
  for (int j = 0; j < LP; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = __shfl_sync(kFull, row[k], j);
      const float w = __shfl_sync(kFull, wt[k], j);
      if (r >= 0) acc = fmaf(w, load(vb + r * stride), acc);  // warp-uniform
    }
  }
  store(out + warp * kDh + lane, acc);
}

__global__ void __launch_bounds__(kThreads) gpv_msdeform_bf16_kernel(
    const __nv_bfloat16* __restrict__ value, const float* __restrict__ ref,
    const __nv_bfloat16* __restrict__ off,
    const __nv_bfloat16* __restrict__ logits, __nv_bfloat16* __restrict__ out,
    int S, int Q, int H, int L, int P, long long warps, Levels lv) {
  sample_head<__nv_bfloat16>(value, ref, off, logits, out, S, Q, H, L, P,
                             warps, lv);
}

__global__ void __launch_bounds__(kThreads) gpv_msdeform_fp32_kernel(
    const float* __restrict__ value, const float* __restrict__ ref,
    const float* __restrict__ off, const float* __restrict__ logits,
    float* __restrict__ out, int S, int Q, int H, int L, int P,
    long long warps, Levels lv) {
  sample_head<float>(value, ref, off, logits, out, S, Q, H, L, P, warps, lv);
}

}  // namespace

extern "C" int gpv_msdeform(const void* value, const float* ref,
                            const void* off, const void* logits, void* out,
                            int B, int S, int Q, int H, int Dh, int L, int P,
                            const int* shapes, int bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > 32 || Dh != kDh || H < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = (int)start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * Q * H;
  if (warps == 0) return 0;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    gpv_msdeform_bf16_kernel<<<(int)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), ref,
        static_cast<const __nv_bfloat16*>(off),
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<__nv_bfloat16*>(out), S, Q, H, L, P, warps, lv);
  } else {
    gpv_msdeform_fp32_kernel<<<(int)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(value), ref,
        static_cast<const float*>(off), static_cast<const float*>(logits),
        static_cast<float*>(out), S, Q, H, L, P, warps, lv);
  }
  return (int)cudaGetLastError();
}
