// One fused depthwise-separable embedder block:
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
// output once (8-96 KiB at the six serving shapes) and does at most a few
// MFLOP, so at the serving batch of 512 samples the bound is bytes (~140
// MiB over the six blocks, 0.044 ms). GroupNorm reduces over each sample's
// (H, W, C/G), so the sample is the unit of work, and what costs time is
// the instructions and barriers between a sample's stages. The design:
//   - persistent CTAs: each stages the block's weights once (rounded to
//     bf16, from the modules' own layouts), then streams samples; the next
//     sample's input arrives by cp.async into a second buffer while the
//     current one computes, where two buffers fit without costing a CTA
//     per SM;
//   - three instantiations by sample size: 256 threads (two CTAs per SM)
//     when a thread's share is at most 8 pixels and a warp's 8 tiles; 512
//     threads (one CTA per SM) for the large early blocks, which halves
//     each thread's share so the depthwise outputs and the accumulators
//     fit 128 registers; 256 threads with 255 registers beyond that;
//   - the input buffers carry a zero halo, so the depthwise taps need no
//     bounds checks: each thread owns a channel pair (its taps from shared
//     memory) and a strided set of pixels, keeps its outputs in registers,
//     and takes the first GroupNorm's sums from them (per-thread partials,
//     one exchange through shared memory, one warp per group); only the
//     bf16 pointwise operand goes to shared memory;
//   - the pointwise product runs on the tensor cores (mma.sync m16n8k16,
//     ldmatrix operands at addresses fixed per tile, f32 accumulators in
//     registers; one sample of p = 16 pixels fills an m16 product, so
//     samples are not stacked); the second GroupNorm's sums come from the
//     accumulators as per-(16-pixel strip, channel) partials, in a fixed
//     order, with no atomics;
//   - the epilogue adds the residual from the staged input, rounds once,
//     stages the bf16 output over the input buffer (16-byte chunks
//     XOR-swizzled by pixel within aligned groups of up to 8 that divide
//     the row, against bank conflicts), stores it with 16-byte writes and
//     zeroes the halo cells it covered.
// Shared memory holds no f32 activation: 80-195 KiB at the serving shapes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int MAX_SMEM = 232448;
constexpr int PAD = 8;  // bf16 row padding of the pointwise operands (banks)

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// The instantiations: threads per CTA, and the register budgets of a
// thread (depthwise pixels) and of a warp (pointwise m16n8 tiles). The
// first runs two CTAs per SM; the second gives large samples 16 warps.
constexpr int VARIANTS[3][3] = {{256, 8, 8}, {512, 16, 8}, {256, 64, 32}};

struct Layout {
  size_t xe;  // bf16 elements of one input buffer: (h + 2) x (w + 2) x c,
              // or the output stage p x f if larger
  size_t h1, wpw, wdw, g2, stats, red, part, total;
};

// One shared-memory layout, used by the kernel and by the host checks.
__host__ __device__ inline Layout layout(int h, int w, int c, int f,
                                         int stride, int groups, int nbuf,
                                         int threads) {
  const int p = (h / stride) * (w / stride);
  Layout l;
  const size_t halo = (size_t)(h + 2) * (w + 2) * c, stage = (size_t)p * f;
  l.xe = halo > stage ? halo : stage;
  l.h1 = align128((size_t)nbuf * l.xe * 2);
  l.wpw = align128(l.h1 + (size_t)p * (c + PAD) * 2);
  l.wdw = align128(l.wpw + (size_t)f * (c + PAD) * 2);
  l.g2 = align128(l.wdw + (size_t)9 * c * 4);
  l.stats = align128(l.g2 + (size_t)2 * f * 4);
  l.red = align128(l.stats + (size_t)4 * groups * 4);
  l.part = align128(l.red + (size_t)threads * 4 * 4);
  l.total = align128(l.part + (size_t)(p / 16) * f * 2 * 4);
  return l;
}

int variant(int p, int c, int f) {
  for (int v = 0; v < 3; ++v) {
    const int threads = VARIANTS[v][0], pixlanes = threads / (c / 2);
    if (pixlanes < 1) continue;
    const int pix = (p + pixlanes - 1) / pixlanes;
    const int tiles = ((p / 16) * (f / 8) + threads / 32 - 1) / (threads / 32);
    if (pix <= VARIANTS[v][1] && tiles <= VARIANTS[v][2]) return v;
  }
  return -1;
}

// x / d for a d fixed per launch and 0 <= x < 2^31, as a multiply-high
// and a shift (no division code inlined at every use).
struct Div {
  int d;
  uint32_t mul, sh;
  __device__ explicit Div(int d_) : d(d_), mul(0), sh(0) {
    if (d_ > 1) {
      uint32_t l = 0;
      while ((1u << l) < (uint32_t)d_) ++l;  // ceil(log2 d)
      mul = (uint32_t)(((1ull << (31 + l)) + d_ - 1) / d_);
      sh = l - 1;
    }
  }
  __device__ __forceinline__ int operator()(int x) const {
    return d > 1 ? (int)(__umulhi((uint32_t)x, mul) >> sh) : x;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage one sample into the interior of a haloed bf16 buffer: cp.async
// for bf16 input (waited for by the caller), a converting copy for f32.
template <typename T, int NTHR>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const T* src, int h,
                                      int w, int c) {
  constexpr int PER = std::is_same<T, __nv_bfloat16>::value ? 8 : 4;
  const Div row_chunks(w * c / PER);
  for (int e = threadIdx.x; e < h * w * c / PER; e += NTHR) {
    const int iy = row_chunks(e), k = e - iy * row_chunks.d;
    __nv_bfloat16* d = dst + ((size_t)(iy + 1) * (w + 2) + 1) * c + k * PER;
    if constexpr (PER == 8) {
      cp_async16(d, src + (size_t)e * 8);
    } else {
      const float4 v = reinterpret_cast<const float4*>(src)[e];
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(d) = u;
    }
  }
  cp_async_commit();
}

// T is the activation type of x and out: bf16 (serving) or f32. CTA i
// takes samples i, i + gridDim.x, i + 2 gridDim.x, ...
template <typename T, int NTHR, int MAXPIX, int MAXT>
__global__ void __launch_bounds__(NTHR, NTHR == 256 && MAXPIX <= 8 ? 2 : 1)
sepblock_kernel(const T* __restrict__ x,               // [B, H, W, C]
                const float* __restrict__ w_dw,        // [C, 3, 3] f32
                const float* __restrict__ g1s, const float* __restrict__ g1b,
                const float* __restrict__ w_pw,        // [F, C] f32
                const float* __restrict__ g2s, const float* __restrict__ g2b,
                T* __restrict__ out,                   // [B, OH, OW, F]
                int b, int h, int w, int c, int f, int stride, int groups,
                float eps, int residual, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NWARPS = NTHR / 32;
  const Layout l = layout(h, w, c, f, stride, groups, nbuf, NTHR);
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(smem);        // [nbuf][h+2][w+2][c]
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem + l.h1);  // [p][c + PAD]
  __nv_bfloat16* wpws = reinterpret_cast<__nv_bfloat16*>(smem + l.wpw);  // [f][c + PAD]
  float* wdws = reinterpret_cast<float*>(smem + l.wdw);    // [9][c], bf16-rounded
  float* g2 = reinterpret_cast<float*>(smem + l.g2);        // scale [f], bias [f]
  float* stats = reinterpret_cast<float*>(smem + l.stats);  // gn1 [2g], gn2 [2g]
  float* red = reinterpret_cast<float*>(smem + l.red);      // [NTHR][4]
  float* part = reinterpret_cast<float*>(smem + l.part);    // [p / 16][f][2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oh = h / stride, ow = w / stride, p = oh * ow;
  const int hwc = h * w * c;
  const int ldh = c + PAD;
  const Div cg(c / groups), fg(f / groups), div_ow(ow);

  // Depthwise ownership: channel pair cp, pixels pl, pl + pixlanes, ...
  const int cpairs = c / 2;
  const int pixlanes = NTHR / cpairs;
  const Div div_cp(cpairs);
  const int pl = div_cp(tid), cp = tid - pl * cpairs;
  const bool dw_on = pl < pixlanes;
  const int ch0 = 2 * cp;
  const int grp0 = cg(ch0), grp1 = cg(ch0 + 1);

  // Once per CTA: zero the halos (never written again), stage the block's
  // weights rounded to bf16 from the modules' layouts, and the second
  // norm's parameters.
  {
    uint4* z = reinterpret_cast<uint4*>(xbuf);
    for (size_t e = tid; e < (size_t)nbuf * l.xe / 8; e += NTHR) z[e] = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < 9 * c; e += NTHR) {
      const int ch = e / 9, t = e - ch * 9;
      wdws[t * c + ch] = bf16_round(w_dw[e]);
    }
    const int c4 = c / 4;
    const float4* src = reinterpret_cast<const float4*>(w_pw);
    for (int e = tid; e < f * c4; e += NTHR) {
      const int n = e / c4, k = e - n * c4;
      const float4 v = src[e];
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(wpws + n * ldh + 4 * k) = u;
    }
    for (int e = tid; e < f; e += NTHR) { g2[e] = g2s[e]; g2[f + e] = g2b[e]; }
  }
  __syncthreads();  // the halo zeros land before any staging

  const int step = gridDim.x;
  int s = blockIdx.x;
  if (s < b) stage<T, NTHR>(xbuf, x + (size_t)s * hwc, h, w, c);
  if (nbuf == 2 && s + step < b)
    stage<T, NTHR>(xbuf + l.xe, x + (size_t)(s + step) * hwc, h, w, c);

  // Haloed input (iy, ix) sits at ((iy + 1) (w + 2) + ix + 1) c; output
  // (oy, ox)'s top-left tap at halo row / column oy * stride + 1 - pad_lo.
  const int off0 = stride == 1 ? 0 : 1;
  const int rs = (w + 2) * cpairs;  // bf16x2 per halo row
  const int ystep = div_ow(pixlanes), xstep = pixlanes - ystep * ow;
  const int MT = p / 16, NT = f / 8, ntiles = MT * NT;
  const Div div_nt(NT);
  const int tpw = (ntiles + NWARPS - 1) / NWARPS;
  // this warp's tiles: [warp tpw, warp tpw + mytiles)
  const int mytiles = max(0, min(tpw, ntiles - warp * tpw));
  const int qd = lane & 3, gq = lane >> 2;

  for (int i = 0; s < b; ++i, s += step) {
    __nv_bfloat16* xs = xbuf + (nbuf == 2 ? (size_t)(i & 1) * l.xe : 0);
    if (nbuf == 2 && s + step < b) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    // 1. Depthwise 3x3 into registers, with the first norm's partial sums.
    float dv[MAXPIX][2];
    float sa = 0.f, ssa = 0.f, sb = 0.f, ssb = 0.f;
    {
      float2 wk[9];  // this thread's taps, live only through this loop
#pragma unroll
      for (int t = 0; t < 9; ++t) wk[t] = *reinterpret_cast<const float2*>(wdws + t * c + ch0);
      const __nv_bfloat162* xs2 = reinterpret_cast<const __nv_bfloat162*>(xs) + cp;
      int oy = div_ow(pl), ox = pl - oy * ow;
#pragma unroll
      for (int j = 0; j < MAXPIX; ++j) {
        float a0 = 0.f, a1 = 0.f;
        if (dw_on && pl + j * pixlanes < p) {
          const __nv_bfloat162* r0 =
              xs2 + ((oy * stride + off0) * (w + 2) + ox * stride + off0) * cpairs;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float2 v = __bfloat1622float2(r0[ky * rs + kx * cpairs]);
              a0 = fmaf(v.x, wk[ky * 3 + kx].x, a0);
              a1 = fmaf(v.y, wk[ky * 3 + kx].y, a1);
            }
          }
          sa += a0; ssa += a0 * a0;
          sb += a1; ssb += a1 * a1;
        }
        dv[j][0] = a0;
        dv[j][1] = a1;
        ox += xstep;
        oy += ystep;
        if (ox >= ow) { ox -= ow; ++oy; }
      }
    }
    *reinterpret_cast<float4*>(red + 4 * tid) = make_float4(sa, ssa, sb, ssb);
    __syncthreads();

    // 2. First norm's statistics: one warp per group.
    for (int gi = warp; gi < groups; gi += NWARPS) {
      float ts = 0.f, tss = 0.f;
      for (int t = lane; t < pixlanes * cpairs; t += 32) {
        const int c0 = 2 * (t - div_cp(t) * cpairs);
        const float4 r = *reinterpret_cast<const float4*>(red + 4 * t);
        if (cg(c0) == gi) { ts += r.x; tss += r.y; }
        if (cg(c0 + 1) == gi) { ts += r.z; tss += r.w; }
      }
      ts = warp_sum(ts);
      tss = warp_sum(tss);
      if (lane == 0) {
        const float cnt = (float)(p * cg.d);
        const float mean = ts / cnt;
        const float var = fmaxf(tss / cnt - mean * mean, 0.f);
        stats[2 * gi] = mean;
        stats[2 * gi + 1] = rsqrtf(var + eps);
      }
    }
    __syncthreads();

    // 3. Normalize -> ReLU -> bf16 pointwise operand.
    if (dw_on) {
      const float ma = stats[2 * grp0], ra = stats[2 * grp0 + 1];
      const float mb = stats[2 * grp1], rb = stats[2 * grp1 + 1];
      const float s1a = g1s[ch0], s1b = g1s[ch0 + 1];
      const float b1a = g1b[ch0], b1b = g1b[ch0 + 1];
#pragma unroll
      for (int j = 0; j < MAXPIX; ++j) {
        const int pix = pl + j * pixlanes;
        if (pix < p) {
          const float y0 = fmaxf((dv[j][0] - ma) * ra * s1a + b1a, 0.f);
          const float y1 = fmaxf((dv[j][1] - mb) * rb * s1b + b1b, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(h1s + pix * ldh + ch0) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    __syncthreads();

    // 4. Pointwise on the tensor cores: warp w owns tiles [w tpw, (w+1) tpw)
    // of the (p / 16) x (f / 8) grid, strip-major. acc[jt][2 hh + e] is
    // pixel strip * 16 + gq + 8 hh, channel nt * 8 + 2 qd + e.
    float acc[MAXT][4];
#pragma unroll
    for (int jt = 0; jt < MAXT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
    uint32_t a_addr[MAXT], b_addr[MAXT];  // each tile's operand rows, at k = 0
#pragma unroll
    for (int jt = 0; jt < MAXT; ++jt) {
      const int tt = warp * tpw + (jt < mytiles ? jt : 0);
      const int strip = div_nt(tt), nt = tt - strip * NT;
      a_addr[jt] = smem_u32(h1s + (strip * 16 + (lane & 15)) * ldh + (lane >> 4) * 8);
      b_addr[jt] = smem_u32(wpws + (nt * 8 + (lane & 7)) * ldh + ((lane >> 3) & 1) * 8);
    }
    for (int k0 = 0; k0 < c; k0 += 16) {
#pragma unroll
      for (int jt = 0; jt < MAXT; ++jt) {
        if (jt < mytiles) {
          uint32_t a[4], bw[2];
          ldmatrix_x4(a, a_addr[jt] + 2 * k0);
          ldmatrix_x2(bw, b_addr[jt] + 2 * k0);
          mma_bf16(acc[jt], a, bw);
        }
      }
    }
    // Second norm's sums: per (strip, channel) over the strip's 16 pixels
    // (a reduction over the 8 lanes sharing a column), then one warp per
    // group over its strips and channels. No atomics: the order is fixed.
#pragma unroll
    for (int jt = 0; jt < MAXT; ++jt) {
      const int tt = warp * tpw + jt;
      if (jt < mytiles) {
        const int strip = div_nt(tt), nt = tt - strip * NT;
        float s0 = acc[jt][0] + acc[jt][2], s1 = acc[jt][1] + acc[jt][3];
        float q0 = acc[jt][0] * acc[jt][0] + acc[jt][2] * acc[jt][2];
        float q1 = acc[jt][1] * acc[jt][1] + acc[jt][3] * acc[jt][3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          q0 += __shfl_xor_sync(0xffffffffu, q0, off);
          q1 += __shfl_xor_sync(0xffffffffu, q1, off);
        }
        if (gq == 0) {
          float4* dst = reinterpret_cast<float4*>(part + (strip * f + nt * 8 + 2 * qd) * 2);
          *dst = make_float4(s0, q0, s1, q1);
        }
      }
    }
    __syncthreads();
    float* gsum = stats + 2 * groups;
    for (int gi = warp; gi < groups; gi += NWARPS) {
      float ts = 0.f, tss = 0.f;
      for (int e = lane; e < MT * fg.d; e += 32) {
        const int strip = fg(e), n = gi * fg.d + e - strip * fg.d;
        const float2 v = *reinterpret_cast<const float2*>(part + (strip * f + n) * 2);
        ts += v.x;
        tss += v.y;
      }
      ts = warp_sum(ts);
      tss = warp_sum(tss);
      if (lane == 0) {
        const float cnt = (float)(p * fg.d);
        const float mean = ts / cnt;
        const float var = fmaxf(tss / cnt - mean * mean, 0.f);
        gsum[2 * gi] = mean;
        gsum[2 * gi + 1] = rsqrtf(var + eps);
      }
    }
    __syncthreads();

    // 5. Second norm -> (+ residual from the staged input) -> ReLU, in
    // the accumulators.
#pragma unroll
    for (int jt = 0; jt < MAXT; ++jt) {
      const int tt = warp * tpw + jt;
      if (jt < mytiles) {
        const int strip = div_nt(tt), nt = tt - strip * NT;
        const int n = nt * 8 + 2 * qd;
        const int gA = fg(n), gB = fg(n + 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pix = strip * 16 + gq + 8 * hh;
          float y0 = (acc[jt][2 * hh] - gsum[2 * gA]) * gsum[2 * gA + 1] * g2[n] + g2[f + n];
          float y1 = (acc[jt][2 * hh + 1] - gsum[2 * gB]) * gsum[2 * gB + 1] * g2[n + 1] +
                     g2[f + n + 1];
          if (residual) {  // stride 1, C == F: input pixel = output pixel
            if constexpr (std::is_same<T, __nv_bfloat16>::value) {
              const int oy = div_ow(pix), ox = pix - oy * ow;
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  xs + ((oy + 1) * (w + 2) + ox + 1) * c + n));
              y0 += r.x;
              y1 += r.y;
            } else {  // the unrounded f32 input
              const float2 r = *reinterpret_cast<const float2*>(
                  x + (size_t)s * hwc + pix * f + n);
              y0 += r.x;
              y1 += r.y;
            }
          }
          acc[jt][2 * hh] = fmaxf(y0, 0.f);
          acc[jt][2 * hh + 1] = fmaxf(y1, 0.f);
        }
      }
    }
    // 6. Out, rounded once. bf16: through the input buffer (free once the
    // residual reads are done), 16-byte chunks of a pixel row stored at
    // chunk ^ (pix % g), g the largest power of two <= 8 dividing the row's
    // chunks (so the XOR stays inside the row), to spread the fragment
    // writes over the banks; then copied out with 16-byte stores; the halo
    // cells it covered are zeroed again. f32: straight from registers.
    T* ob = out + (size_t)s * p * f;
    const int fchunks = f / 8, low = fchunks & -fchunks;  // the largest power of two dividing it
    const int swz = (low < 8 ? low : 8) - 1;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) __syncthreads();
#pragma unroll
    for (int jt = 0; jt < MAXT; ++jt) {
      const int tt = warp * tpw + jt;
      if (jt < mytiles) {
        const int strip = div_nt(tt), nt = tt - strip * NT;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pix = strip * 16 + gq + 8 * hh;
          if constexpr (std::is_same<T, __nv_bfloat16>::value)
            *reinterpret_cast<__nv_bfloat162*>(xs + pix * f + ((nt ^ (pix & swz)) * 8) + 2 * qd) =
                __floats2bfloat162_rn(acc[jt][2 * hh], acc[jt][2 * hh + 1]);
          else
            *reinterpret_cast<float2*>(ob + pix * f + nt * 8 + 2 * qd) =
                make_float2(acc[jt][2 * hh], acc[jt][2 * hh + 1]);
        }
      }
    }
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      __syncthreads();
      const Div div_fc(fchunks);
      const uint4* src = reinterpret_cast<const uint4*>(xs);
      uint4* dst = reinterpret_cast<uint4*>(ob);
      for (int e = tid; e < p * fchunks; e += NTHR) {
        const int pix = div_fc(e), ch = e - pix * fchunks;
        dst[e] = src[pix * fchunks + (ch ^ (pix & swz))];
      }
      __syncthreads();
      // halo cells: row 0 and row h + 1 (w + 2 each), then columns 0 and
      // w + 1 of rows 1 .. h
      const int cchunks = c / 8;
      const Div div_cc(cchunks);
      uint4* z = reinterpret_cast<uint4*>(xs);
      for (int e = tid; e < (2 * (w + 2) + 2 * h) * cchunks; e += NTHR) {
        const int cell = div_cc(e), k = e - cell * cchunks;
        int hy, hx;
        if (cell < 2 * (w + 2)) {
          hy = cell < w + 2 ? 0 : h + 1;
          hx = cell < w + 2 ? cell : cell - (w + 2);
        } else {
          hy = 1 + ((cell - 2 * (w + 2)) >> 1);
          hx = (cell & 1) ? w + 1 : 0;
        }
        if ((size_t)(hy * (w + 2) + hx) * c < (size_t)p * f)
          z[(hy * (w + 2) + hx) * cchunks + k] = make_uint4(0, 0, 0, 0);
      }
    }
    const int nxt = s + (nbuf == 2 ? 2 : 1) * step;
    if (nxt < b) {
      if constexpr (!std::is_same<T, __nv_bfloat16>::value)
        __syncthreads();  // every read of this buffer is done
      stage<T, NTHR>(xs, x + (size_t)nxt * hwc, h, w, c);
    }
  }
}

template <typename T, int NTHR, int MAXPIX, int MAXT>
int occupancy(size_t smem, int* ctas) {
  auto kern = sepblock_kernel<T, NTHR, MAXPIX, MAXT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, NTHR, smem);
}

template <typename T>
int occupancy_v(int v, size_t smem, int* ctas) {
  switch (v) {
    case 0: return occupancy<T, 256, 8, 8>(smem, ctas);
    case 1: return occupancy<T, 512, 16, 8>(smem, ctas);
    default: return occupancy<T, 256, 64, 32>(smem, ctas);
  }
}

bool shape_ok(int h, int w, int c, int f, int stride, int groups) {
  const int p = (h / stride) * (w / stride);
  return c % 16 == 0 && f % 16 == 0 && p % 16 == 0 && c % groups == 0 &&
         f % groups == 0 && (stride == 1 || stride == 2) && h % stride == 0 &&
         w % stride == 0 && variant(p, c, f) >= 0;
}

}  // namespace

extern "C" {

// Launch plan of one block shape: plan[0] input buffers (2: the next
// sample is prefetched), plan[1] CTAs per SM, plan[2] shared-memory
// bytes per CTA, plan[3] the variant (0-2), plan[4] threads per CTA.
// Returns a CUDA error code; cudaErrorInvalidValue if the kernel does not
// take the shape.
int sepblock_plan(int h, int w, int c, int f, int stride, int groups,
                  int x_is_bf16, int* plan) {
  if (!shape_ok(h, w, c, f, stride, groups)) return (int)cudaErrorInvalidValue;
  const int v = variant((h / stride) * (w / stride), c, f);
  const int threads = VARIANTS[v][0];
  const size_t one = layout(h, w, c, f, stride, groups, 1, threads).total;
  const size_t two = layout(h, w, c, f, stride, groups, 2, threads).total;
  if (one > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  int ctas1 = 0, ctas2 = 0, err;
  err = x_is_bf16 ? occupancy_v<__nv_bfloat16>(v, one, &ctas1)
                  : occupancy_v<float>(v, one, &ctas1);
  if (err != 0) return err;
  int nbuf = 1, ctas = ctas1;
  if (x_is_bf16 && two <= (size_t)MAX_SMEM) {
    err = occupancy_v<__nv_bfloat16>(v, two, &ctas2);
    if (err != 0) return err;
    if (ctas2 == ctas1) { nbuf = 2; ctas = ctas2; }
  }
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  plan[0] = nbuf;
  plan[1] = ctas;
  plan[2] = (int)(nbuf == 2 ? two : one);
  plan[3] = v;
  plan[4] = threads;
  return 0;
}

// x [b, h, w, c] bf16 (x_is_bf16 = 1) or f32; w_dw [c, 1, 3, 3] and w_pw
// [f, c, 1, 1] f32 (the modules' layouts); GroupNorm scales/biases f32;
// out [b, h/stride, w/stride, f] in x's type; grid persistent CTAs and
// nbuf from sepblock_plan. Returns the CUDA error code of the launch (0 =
// success).
int sepblock_forward(const void* x, int x_is_bf16, const void* w_dw,
                     const void* g1s, const void* g1b, const void* w_pw,
                     const void* g2s, const void* g2b, void* out, int b, int h,
                     int w, int c, int f, int stride, int groups, float eps,
                     int residual, int grid, int nbuf, void* stream) {
  if (!shape_ok(h, w, c, f, stride, groups) || grid < 1 || nbuf < 1 ||
      nbuf > 2 || (nbuf == 2 && !x_is_bf16))
    return (int)cudaErrorInvalidValue;
  const int v = variant((h / stride) * (w / stride), c, f);
  const Layout l = layout(h, w, c, f, stride, groups, nbuf, VARIANTS[v][0]);
  if (l.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wdw = static_cast<const float*>(w_dw);
  const float* s1 = static_cast<const float*>(g1s);
  const float* b1 = static_cast<const float*>(g1b);
  const float* wpw = static_cast<const float*>(w_pw);
  const float* s2 = static_cast<const float*>(g2s);
  const float* b2 = static_cast<const float*>(g2b);
#define LAUNCH(TT, NTHR, MP, MTL)                                              \
  {                                                                            \
    auto kern = sepblock_kernel<TT, NTHR, MP, MTL>;                            \
    cudaError_t err = cudaFuncSetAttribute(                                    \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.total);      \
    if (err != cudaSuccess) return (int)err;                                   \
    kern<<<grid, NTHR, l.total, s>>>(static_cast<const TT*>(x), wdw, s1, b1,   \
                                     wpw, s2, b2, static_cast<TT*>(out), b, h, \
                                     w, c, f, stride, groups, eps, residual,   \
                                     nbuf);                                    \
  }
  if (x_is_bf16) {
    if (v == 0) LAUNCH(__nv_bfloat16, 256, 8, 8)
    else if (v == 1) LAUNCH(__nv_bfloat16, 512, 16, 8)
    else LAUNCH(__nv_bfloat16, 256, 64, 32)
  } else {
    if (v == 0) LAUNCH(float, 256, 8, 8)
    else if (v == 1) LAUNCH(float, 512, 16, 8)
    else LAUNCH(float, 256, 64, 32)
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
