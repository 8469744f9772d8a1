// Multi-scale deformable attention's sampling, forward only (Zhu et al.,
// "Deformable DETR", ICLR 2021, MSDeformAttn): the kernel behind
// gpv_tpu_torch/ops/ms_deform_attn.py. The JAX package has no such kernel.
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
// What bounds it on the H100: not device memory (each input byte read
// once and the output written once take 0.55 ms over a B=20 predict's 12
// layers at 3.35 TB/s) but instructions. Every (query, head) reads L*P*4
// corners of the head's Dh = 32 channels, each a 64-byte (bf16) or
// 128-byte (fp32) run at a place the data chooses (an encoder layer at
// B=20 asks L1 and L2 for 4 GB of such runs), and an encoder layer's 16
// million samples each need a softmax weight, a location and four
// corners. Measured on the card, the samples' arithmetic and the
// unpacking and multiply-adds of the gathered values take more of the
// time than the reads: with every gather an L1 hit the kernel is no
// faster. So the design does each piece of that work once, on all of
// the block's threads, and keeps many reads in flight:
//
// - One block a tile of `tile` consecutive queries of one image, with all
//   H heads; the grid runs image by image, so the blocks resident
//   together sample one image's value (3.3 MB a layer in bf16, held in
//   L2).
// - Phase 1 computes each (query, head, sample) once. A lane takes one
//   (query, head, level): the softmax over the head's L*P logits (its own
//   P, then shuffles across the G >= L lanes of the head), then each of
//   its P samples' location and corners, as offsets of value rows in
//   16-byte units (-1 outside the map) and bilinear weights with the
//   attention weight folded in. They go to shared memory, 32 bytes a
//   sample, [sample][head][query] with a spare slot a (sample, head), so
//   that neither the writes nor the gathers' reads collide in a bank.
// - Phase 2: a thread gathers 16 bytes of a head (8 bf16 or 4 fp32
//   channels; 4 or 8 threads a head), lanes ordered channel chunk, query,
//   head: a warp takes one head of 8 (bf16) or 4 (fp32) neighbouring
//   queries, whose samples at the coarser levels fall on the same pixels,
//   so one load instruction touches fewer cache lines. kBatch samples'
//   four corners load as independent 16-byte reads, all in flight before
//   their multiply-adds, one fp32 accumulator a channel, and each thread
//   stores its 16 bytes of the output.
//
// Locations, the softmax and the sums are fp32 on both routes, each
// channel summed over samples and corners in order; the output is written
// in the value's dtype. The tile, the block's threads and its shared
// memory come from the wrapper's `_plan`; the entry refuses a launch given
// less shared memory than the tile needs.
//
// It takes Deformable DETR's heads: Dh = 32 (256 wide, 8 heads), at most
// kMaxLevels levels and kMaxSamples samples (L * P) a head; the entry
// refuses anything else with cudaErrorInvalidValue.
//
// Interface (plain C, loaded with ctypes): gpv_msdeform_init() once at
// load (the kernels' shared-memory limit), then gpv_msdeform(value, ref,
// off, logits, out, B, S, Q, H, Dh, L, P, shapes, bf16, tile, threads,
// smem, stream) with value (B, S, H, Dh) and out (B, Q, H, Dh) on 16-byte
// boundaries, ref (B, Q, L, 2) fp32, off (B, Q, H, L, P, 2) on a boundary
// of two of its values, logits (B, Q, H, L*P), all contiguous; `shapes` a
// host array of the L (H_l, W_l); value, off, logits and out bf16 when
// `bf16`, else fp32. Returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 32;    // L * P a head
constexpr int kDh = 32;
constexpr int kMaxThreads = 256;   // a block's, at most
constexpr int kSlotBytes = 32;     // a sample's 4 value rows and 4 weights
constexpr int kMaxSmem = 232448;   // an H100 block's shared memory
constexpr int kBatch = 2;          // samples a thread gathers at once
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// a[l] by selects: a parameter indexed at run time would go to local memory
__device__ __forceinline__ int pick(const int (&a)[kMaxLevels], int l) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k) v = l == k ? a[k] : v;
  return v;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// two neighbouring values, 4-byte (bf16) or 8-byte (fp32) aligned
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes of a head's channels: kN values, widened to fp32 to be summed
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void add(float* acc, float w, uint4 v) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  // channel 2i is the low half of word i: a bf16 is an fp32's top 16 bits
  static __device__ __forceinline__ void add2(float* acc, float w,
                                              unsigned x) {
    acc[0] = fmaf(w, __uint_as_float(x << 16), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(x & 0xffff0000u), acc[1]);
  }
  static __device__ __forceinline__ void add(float* acc, float w, uint4 v) {
    add2(acc, w, v.x);
    add2(acc + 2, w, v.y);
    add2(acc + 4, w, v.z);
    add2(acc + 6, w, v.w);
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                      pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
  }
};

template <typename T>
__device__ __forceinline__ void sample_tile(
    const T* __restrict__ value, const float* __restrict__ ref,
    const T* __restrict__ off, const T* __restrict__ logits,
    T* __restrict__ out, int S, int Q, int H, int L, int P, int tile,
    const Levels& lv) {
  extern __shared__ int4 slots[];
  const int LP = L * P;
  const int per = H * (tile + 1);  // slots a sample: [H][tile + 1]
  const int n = LP * per;          // one spare slot a (sample, head)
  int4* rows = slots;
  float4* wts = reinterpret_cast<float4*>(slots + n);
  const int rowChunks = H * kDh * (int)sizeof(T) / 16;  // a value row's
  const int tiles = (Q + tile - 1) / tile;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * tile;
  const int nq = min(tile, Q - q0);
  const long long first = ((long long)b * Q + q0) * H;  // (b, q0, head 0)

  // 1. a lane a (query, head, level), G lanes (G >= L) a (query, head):
  //    the softmax over the group's L*P logits (each lane's P, then
  //    shuffles across the group), then each of the lane's P samples'
  //    location and corners into its slot
  int G = 1;
  while (G < L) G <<= 1;
  const int l = threadIdx.x & (G - 1);
  for (int base = 0; base < nq * H * G; base += blockDim.x) {  // uniform
    const int qh = (base + threadIdx.x) / G;
    const bool live = qh < nq * H && l < L;
    const int q = qh / H, h = qh - q * H;
    const long long g = first + qh;
    const T* lg = logits + g * LP + l * P;
    float m = -INFINITY;
    if (live)
      for (int p = 0; p < P; ++p) m = fmaxf(m, load(lg + p));
    for (int o = G >> 1; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.f;
    if (live)
      for (int p = 0; p < P; ++p) sum += expf(load(lg + p) - m);
    for (int o = G >> 1; o > 0; o >>= 1)
      sum += __shfl_xor_sync(kFull, sum, o);
    if (!live) continue;
    const int Hl = pick(lv.h, l), Wl = pick(lv.w, l);
    const int start = pick(lv.start, l);
    const float* r = ref + (((long long)b * Q + q0 + q) * L + l) * 2;
    const float rx = r[0], ry = r[1];
    const T* o = off + (g * LP + l * P) * 2;
    for (int p = 0; p < P; ++p) {
      const float a = expf(load(lg + p) - m) / sum;
      const float2 d = load2(o + 2 * p);
      const float x = (rx + d.x / (float)Wl) * (float)Wl - 0.5f;
      const float y = (ry + d.y / (float)Hl) * (float)Hl - 0.5f;
      int4 rw = make_int4(-1, -1, -1, -1);
      float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
      if (x > -1.f && y > -1.f && x < (float)Wl && y < (float)Hl) {
        const float fx = floorf(x), fy = floorf(y);
        const int x0 = (int)fx, y0 = (int)fy;
        const float dx = x - fx, dy = y - fy;
        const int at = (start + y0 * Wl + x0) * rowChunks;
        const bool left = x0 >= 0, right = x0 + 1 < Wl;
        const bool top = y0 >= 0, bottom = y0 + 1 < Hl;
        if (top && left) rw.x = at, wt.x = a * (1.f - dx) * (1.f - dy);
        if (top && right) rw.y = at + rowChunks, wt.y = a * dx * (1.f - dy);
        if (bottom && left)
          rw.z = at + Wl * rowChunks, wt.z = a * (1.f - dx) * dy;
        if (bottom && right)
          rw.w = at + (Wl + 1) * rowChunks, wt.w = a * dx * dy;
      }
      const int s = (l * P + p) * per + h * (tile + 1) + q;
      rows[s] = rw;
      wts[s] = wt;
    }
  }
  __syncthreads();

  // 2. a thread gathers 16 bytes of one (query, head)
  constexpr int kN = Chunk<T>::kN;     // channels a chunk
  constexpr int kChunks = kDh / kN;    // chunks a head
  const long long stride = (long long)H * kDh;  // one value row
  const T* vb = value + (long long)b * S * stride;
  for (int i = threadIdx.x; i < tile * H * kChunks; i += blockDim.x) {
    const int qc = i / kChunks, c = i - qc * kChunks;
    const int h = qc / tile, q = qc - h * tile;
    if (q >= nq) continue;
    const int at = h * (tile + 1) + q;  // sample j's slot: at + j * per
    const uint4* vh = reinterpret_cast<const uint4*>(vb + h * kDh + c * kN);
    float acc[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < LP; j0 += kBatch) {
      uint4 v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        int4 r = make_int4(-1, -1, -1, -1);
        if (j0 + u < LP) r = rows[at + (j0 + u) * per];
        const int rk[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = rk[k] >= 0 ? __ldg(vh + rk[k])
                               : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= LP) break;
        const float4 w = wts[at + (j0 + u) * per];
        Chunk<T>::add(acc, w.x, v[u][0]);
        Chunk<T>::add(acc, w.y, v[u][1]);
        Chunk<T>::add(acc, w.z, v[u][2]);
        Chunk<T>::add(acc, w.w, v[u][3]);
      }
    }
    reinterpret_cast<uint4*>(out + (first + q * H + h) * kDh)[c] =
        Chunk<T>::pack(acc);
  }
}

__global__ void __launch_bounds__(kMaxThreads) gpv_msdeform_bf16_kernel(
    const __nv_bfloat16* __restrict__ value, const float* __restrict__ ref,
    const __nv_bfloat16* __restrict__ off,
    const __nv_bfloat16* __restrict__ logits, __nv_bfloat16* __restrict__ out,
    int S, int Q, int H, int L, int P, int tile, Levels lv) {
  sample_tile<__nv_bfloat16>(value, ref, off, logits, out, S, Q, H, L, P,
                             tile, lv);
}

__global__ void __launch_bounds__(kMaxThreads) gpv_msdeform_fp32_kernel(
    const float* __restrict__ value, const float* __restrict__ ref,
    const float* __restrict__ off, const float* __restrict__ logits,
    float* __restrict__ out, int S, int Q, int H, int L, int P, int tile,
    Levels lv) {
  sample_tile<float>(value, ref, off, logits, out, S, Q, H, L, P, tile, lv);
}

}  // namespace

extern "C" int gpv_msdeform_init() {
  cudaError_t err = cudaFuncSetAttribute(
      gpv_msdeform_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      gpv_msdeform_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
}

extern "C" int gpv_msdeform(const void* value, const float* ref,
                            const void* off, const void* logits, void* out,
                            int B, int S, int Q, int H, int Dh, int L, int P,
                            const int* shapes, int bf16, int tile,
                            int threads, int smem, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > kMaxSamples || Dh != kDh ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  if (tile < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      smem > kMaxSmem ||
      (long long)smem < (long long)L * P * H * (tile + 1) * kSlotBytes ||
      (long long)S * H * kDh * (bf16 ? 2 : 4) / 16 > INT_MAX ||
      reinterpret_cast<uintptr_t>(value) % 16 ||
      reinterpret_cast<uintptr_t>(off) % (bf16 ? 4 : 8) ||
      reinterpret_cast<uintptr_t>(out) % 16)
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
  const long long blocks = (long long)B * ((Q + tile - 1) / tile);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    gpv_msdeform_bf16_kernel<<<(int)blocks, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(value), ref,
        static_cast<const __nv_bfloat16*>(off),
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<__nv_bfloat16*>(out), S, Q, H, L, P, tile, lv);
  } else {
    gpv_msdeform_fp32_kernel<<<(int)blocks, threads, smem, s>>>(
        static_cast<const float*>(value), ref,
        static_cast<const float*>(off), static_cast<const float*>(logits),
        static_cast<float*>(out), S, Q, H, L, P, tile, lv);
  }
  return (int)cudaGetLastError();
}
