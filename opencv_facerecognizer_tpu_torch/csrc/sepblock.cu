// One fused depthwise-separable embedder block, one CTA per sample:
//   dw3x3 (stride 1, or stride 2 with SAME padding (0, 1) on even inputs)
//   -> GroupNorm (f32 stats, E[x^2] - E[x]^2, eps inside the rsqrt) -> ReLU
//   -> pw1x1 (bf16 x bf16 -> f32) -> GroupNorm -> (+ residual) -> ReLU.
//
// Replaces: opencv_facerecognizer_tpu/ops/pallas_sepblock.py
//   fused_sep_block (kernel body _sepblock_kernel).
//
// Rounding points (held to the Pallas kernel): the depthwise operands are
// rounded to bf16 and accumulated in f32; the activation stays f32 between
// the fused stages; the pointwise operands are rounded to bf16 and
// accumulated in f32; the residual is the input itself; the output is
// rounded to the input's type (bf16 when serving, or f32) once, at the end.
//
// What bounds it on the H100: per sample the block moves its bf16 input and
// output once (a few tens of KiB) and does at most ~2 MFLOP, so at the
// serving batch of 512 samples it is a short, memory-light kernel whose
// cost is latency: the unfused form pays one device-memory round trip of
// the activation per op (conv, norm, relu, conv, norm, add, relu). The
// design keeps the whole sample in shared memory: GroupNorm reduces over
// each sample's (H, W, C/G), so the sample is the natural unit, and 512
// samples give 512 CTAs for 132 SMs. Shared memory holds the bf16 input,
// the f32 depthwise output, the bf16 pointwise operand, the f32 pointwise
// output and the bf16 pointwise weights: at most ~212 KiB for the six
// serving shapes, under the 227 KiB a CTA may use, so no split at the first
// GroupNorm is needed. The pointwise product runs on the tensor cores
// (wmma 16x16x16, bf16 in, f32 accumulation), 16x16 output tiles spread
// over the warps; the depthwise conv and the norms run on CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;
constexpr int PAD_BF16 = 8;  // row padding of the bf16 operands (bank spread)
constexpr int PAD_F32 = 4;   // row padding of the f32 pointwise output

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

struct Layout {
  size_t x, dw, h1, pw, wpw, wdw, gn, red, total;
};

// One shared-memory layout, used by the kernel and by the host checks.
__host__ __device__ inline Layout layout(int h, int w, int c, int f,
                                         int stride, int groups) {
  const int p = (h / stride) * (w / stride);
  Layout l;
  l.x = 0;
  l.dw = align128(l.x + (size_t)h * w * c * 2);
  l.h1 = align128(l.dw + (size_t)p * c * 4);
  l.pw = align128(l.h1 + (size_t)p * (c + PAD_BF16) * 2);
  l.wpw = align128(l.pw + (size_t)p * (f + PAD_F32) * 4);
  l.wdw = align128(l.wpw + (size_t)c * (f + PAD_BF16) * 2);
  l.gn = align128(l.wdw + (size_t)9 * c * 4);
  l.red = align128(l.gn + (size_t)2 * groups * 4);
  l.total = align128(l.red + (size_t)2 * NWARPS * 4);
  return l;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// GroupNorm statistics of buf [p, cn] (row stride ld, channel fastest) per
// group: mean and rsqrt(var + eps) into stats[2 * gi], stats[2 * gi + 1].
// All threads call.
__device__ void group_stats(const float* buf, int p, int cn, int ld,
                            int groups, float eps, float* stats, float* red) {
  const int cg = cn / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int gi = 0; gi < groups; ++gi) {
    float s = 0.f, ss = 0.f;
    for (int e = threadIdx.x; e < p * cg; e += THREADS) {
      const int pix = e / cg, ch = gi * cg + (e - pix * cg);
      const float v = buf[pix * ld + ch];
      s += v;
      ss += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) { red[2 * warp] = s; red[2 * warp + 1] = ss; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ts = 0.f, tss = 0.f;
      for (int wi = 0; wi < NWARPS; ++wi) { ts += red[2 * wi]; tss += red[2 * wi + 1]; }
      const float cnt = (float)(p * cg);
      const float mean = ts / cnt;
      const float var = fmaxf(tss / cnt - mean * mean, 0.f);
      stats[2 * gi] = mean;
      stats[2 * gi + 1] = rsqrtf(var + eps);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// T is the activation type of x and out: bf16 (serving) or f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sepblock_kernel(const T* __restrict__ x,               // [B, H, W, C]
                const float* __restrict__ w_dw,        // [9, C] f32
                const float* __restrict__ g1s, const float* __restrict__ g1b,
                const __nv_bfloat16* __restrict__ w_pw, // [C, F] bf16
                const float* __restrict__ g2s, const float* __restrict__ g2b,
                T* __restrict__ out,                   // [B, OH, OW, F]
                int h, int w, int c, int f, int stride, int groups, float eps,
                int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(h, w, c, f, stride, groups);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + l.x);
  float* dws = reinterpret_cast<float*>(smem + l.dw);
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem + l.h1);
  float* pws = reinterpret_cast<float*>(smem + l.pw);
  __nv_bfloat16* wpws = reinterpret_cast<__nv_bfloat16*>(smem + l.wpw);
  float* wdws = reinterpret_cast<float*>(smem + l.wdw);
  float* stats = reinterpret_cast<float*>(smem + l.gn);
  float* red = reinterpret_cast<float*>(smem + l.red);

  const int tid = threadIdx.x;
  const int oh = h / stride, ow = w / stride, p = oh * ow;
  const int ldh = c + PAD_BF16, ldw = f + PAD_BF16, ldp = f + PAD_F32;
  const size_t b = blockIdx.x;

  // 1. Stage the sample (rounded to bf16: the depthwise operand), the
  // pointwise weights and the depthwise taps.
  const T* xb = x + b * h * w * c;
  {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint4* src = reinterpret_cast<const uint4*>(xb);
      uint4* dst = reinterpret_cast<uint4*>(xs);
      for (int e = tid; e < h * w * c / 8; e += THREADS) dst[e] = src[e];
    } else {
      const float4* src = reinterpret_cast<const float4*>(xb);
      for (int e = tid; e < h * w * c / 4; e += THREADS) {
        const float4 v = src[e];
        xs[4 * e] = __float2bfloat16(v.x);
        xs[4 * e + 1] = __float2bfloat16(v.y);
        xs[4 * e + 2] = __float2bfloat16(v.z);
        xs[4 * e + 3] = __float2bfloat16(v.w);
      }
    }
    const int f8 = f / 8;  // 16-byte chunks per weight row
    const uint4* wsrc = reinterpret_cast<const uint4*>(w_pw);
    for (int e = tid; e < c * f8; e += THREADS) {
      const int r = e / f8, k = e - r * f8;
      *reinterpret_cast<uint4*>(wpws + r * ldw + k * 8) = wsrc[e];
    }
    for (int e = tid; e < 9 * c; e += THREADS) wdws[e] = bf16_round(w_dw[e]);
  }
  __syncthreads();

  // 2. Depthwise 3x3, f32 accumulation over bf16 operands.
  const int pad_lo = stride == 1 ? 1 : 0;
  for (int e = tid; e < p * c; e += THREADS) {
    const int pix = e / c, ch = e - pix * c;
    const int i = pix / ow, j = pix - i * ow;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = i * stride + dy - pad_lo;
      if (yy < 0 || yy >= h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = j * stride + dx - pad_lo;
        if (xx < 0 || xx >= w) continue;
        acc += __bfloat162float(xs[(yy * w + xx) * c + ch]) *
               wdws[(dy * 3 + dx) * c + ch];
      }
    }
    dws[e] = acc;
  }
  __syncthreads();

  // 3. GroupNorm -> ReLU, rounded to bf16: the pointwise operand.
  group_stats(dws, p, c, c, groups, eps, stats, red);
  {
    const int cg = c / groups;
    for (int e = tid; e < p * c; e += THREADS) {
      const int pix = e / c, ch = e - pix * c, gi = ch / cg;
      const float y = (dws[e] - stats[2 * gi]) * stats[2 * gi + 1];
      h1s[pix * ldh + ch] = __float2bfloat16(fmaxf(y * g1s[ch] + g1b[ch], 0.f));
    }
  }
  __syncthreads();

  // 4. Pointwise 1x1 on the tensor cores: pws[p, f] = h1[p, :] . w_pw[:, f].
  {
    const int warp = tid >> 5;
    const int ftiles = f / 16;
    for (int t = warp; t < (p / 16) * ftiles; t += NWARPS) {
      const int p0 = (t / ftiles) * 16, f0 = (t % ftiles) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < c; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bw;
        wmma::load_matrix_sync(a, h1s + p0 * ldh + k, ldh);
        wmma::load_matrix_sync(bw, wpws + k * ldw + f0, ldw);
        wmma::mma_sync(acc, a, bw, acc);
      }
      wmma::store_matrix_sync(pws + p0 * ldp + f0, acc, ldp, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // 5. GroupNorm -> (+ residual) -> ReLU -> bf16 out.
  group_stats(pws, p, f, ldp, groups, eps, stats, red);
  {
    const int fg = f / groups;
    T* ob = out + b * p * f;
    for (int e = tid; e < p * f; e += THREADS) {
      const int pix = e / f, ch = e - pix * f, gi = ch / fg;
      float y = (pws[pix * ldp + ch] - stats[2 * gi]) * stats[2 * gi + 1];
      y = y * g2s[ch] + g2b[ch];
      if (residual) y += to_f32(xb[e]);  // the input itself, unrounded
      store(ob + e, fmaxf(y, 0.f));
    }
  }
}

}  // namespace

extern "C" {

long long sepblock_smem_bytes(int h, int w, int c, int f, int stride,
                              int groups) {
  return (long long)layout(h, w, c, f, stride, groups).total;
}

// x [b, h, w, c] bf16 (x_is_bf16 = 1) or f32; w_dw [9, c] f32 (tap-major);
// w_pw [c, f] bf16; GroupNorm scales/biases f32; out [b, h/stride,
// w/stride, f] in x's type. Returns the CUDA error code of the launch
// (0 = success).
int sepblock_forward(const void* x, int x_is_bf16, const void* w_dw,
                     const void* g1s, const void* g1b, const void* w_pw,
                     const void* g2s, const void* g2b, void* out, int b, int h,
                     int w, int c, int f, int stride, int groups, float eps,
                     int residual, void* stream) {
  const Layout l = layout(h, w, c, f, stride, groups);
  const int p = (h / stride) * (w / stride);
  if (l.total > (size_t)MAX_SMEM || c % 16 || f % 16 || p % 16 ||
      c % groups || f % groups || (stride != 1 && stride != 2) ||
      h % stride || w % stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wdw = static_cast<const float*>(w_dw);
  const float* s1 = static_cast<const float*>(g1s);
  const float* b1 = static_cast<const float*>(g1b);
  const __nv_bfloat16* wpw = static_cast<const __nv_bfloat16*>(w_pw);
  const float* s2 = static_cast<const float*>(g2s);
  const float* b2 = static_cast<const float*>(g2b);
  cudaError_t err;
  if (x_is_bf16) {
    err = cudaFuncSetAttribute(sepblock_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)l.total);
    if (err != cudaSuccess) return (int)err;
    sepblock_kernel<__nv_bfloat16><<<b, THREADS, l.total, s>>>(
        static_cast<const __nv_bfloat16*>(x), wdw, s1, b1, wpw, s2, b2,
        static_cast<__nv_bfloat16*>(out), h, w, c, f, stride, groups, eps,
        residual);
  } else {
    err = cudaFuncSetAttribute(sepblock_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)l.total);
    if (err != cudaSuccess) return (int)err;
    sepblock_kernel<float><<<b, THREADS, l.total, s>>>(
        static_cast<const float*>(x), wdw, s1, b1, wpw, s2, b2,
        static_cast<float*>(out), h, w, c, f, stride, groups, eps, residual);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
