// Streaming gallery match: per query, the top-k of q . g^T over the valid
// gallery rows, without materializing the [Q, N] score matrix.
//
// Replaces: opencv_facerecognizer_tpu/ops/pallas_match.py
//   streaming_match_topk (kernel body _match_kernel).
//
// Semantics (held to the Pallas kernel):
//   - bf16 operands, f32 accumulation (the queries and an f32 gallery are
//     rounded to bf16 on load, as the Pallas kernel rounds its MXU inputs);
//   - invalid rows never surface;
//   - equal similarities break toward the LOWEST gallery index, across
//     tiles, threads and splits;
//   - empty slots (fewer than k valid rows) carry sim -1e30 and index -1,
//     the index derived from the value in the merge kernel.
//
// What bounds it on the H100: the serving shape is Q = 512 queries against
// N = 2^20 bf16 rows of D = 256. The gallery is 512 MiB (0.16 ms at
// 3.35 TB/s) and the product is 2*Q*N*D = 275 GFLOP (0.28 ms at 989 TFLOP/s
// bf16): the tensor cores bound it, and only wgmma reaches their rate. The
// small Q is the trap: a grid over Q alone gives 4 CTAs for 132 SMs.
//
// The bf16 path (match_wgmma_kernel; bf16 gallery, D a multiple of 64 up
// to 256):
//   - grid (Q tiles, N splits), one CTA per SM, one wave; the Q-tile index
//     varies fastest, so the CTAs that stream one gallery slice run
//     together and the repeat reads of each tile hit L2;
//   - warp-specialized: one producer warp keeps TMA loads of gallery
//     chunks ([128 rows x 64 dims], 128-byte swizzle) in flight through an
//     mbarrier ring, and writes each tile's valid flags as a 128-bit
//     ballot beside its first chunk;
//   - consumer warpgroups of 64 queries each hold their queries in shared
//     memory for the whole slice (loaded once, rounded to bf16, stored in
//     the swizzled layout wgmma reads) and run wgmma m64n128k16 with the
//     scores in registers. At k = 1 four warpgroups (256 queries, 6 ring
//     stages) share each gallery tile, so the gallery crosses L2 twice at
//     Q = 512, not four times; at k > 1 two warpgroups (8 stages) leave
//     registers for the lists;
//   - each chunk's products are one commit group, and its ring stage goes
//     back to the producer as soon as they are done;
//   - each thread folds its 2 rows x 32 columns of a tile into a running
//     top-K in registers (strictly better, lowest index on ties): at K = 1
//     by a compare and two selects per score; past K = 1 by a register
//     filter against the list's K-th entry that marks the few passing
//     scores, which are then inserted in a loop, so the K-deep insertion
//     is compiled once rather than per score (128 inlined copies of it
//     outgrew the instruction cache, and staging the scores through
//     shared memory made ptxas serialize the wgmma chain). The four
//     threads of a row merge by shuffles at the end, and one partial per
//     (query, split) goes out.
// The f32-gallery path (match_wmma_kernel, also any other D with D % 16
// == 0) keeps the first design: synchronous tile loads rounded to bf16,
// wmma 16x16x16 tiles, scores through shared memory.
//
// k: one pass keeps a running top-K in registers, K a power of two up to
// 16. For 16 < k <= 256 the host runs ceil(k / 16) passes of K = 16: pass
// r admits only rows strictly worse (in the value-then-index order) than
// the last row pass r - 1 kept, so its 16 are ranks 16r .. 16r + 15. The
// merge kernel writes each pass's columns and the bound of the next.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int IDX_NONE = 0x7fffffff;
constexpr int ROUND_K = 16;  // K of one pass; larger k takes several

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Insert (v, i) into a list sorted best-first; K is a compile-time
// constant, so the list stays in registers.
template <int K>
__device__ __forceinline__ void insert(float (&vals)[K], int (&idx)[K],
                                       float v, int i) {
  if (!better(v, i, vals[K - 1], idx[K - 1])) return;
  vals[K - 1] = v;
  idx[K - 1] = i;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (better(vals[j], idx[j], vals[j - 1], idx[j - 1])) {
      float tv = vals[j]; vals[j] = vals[j - 1]; vals[j - 1] = tv;
      int ti = idx[j]; idx[j] = idx[j - 1]; idx[j - 1] = ti;
    }
  }
}

// A row enters a pass only below the previous pass's last kept row.
__device__ __forceinline__ bool admit(bool bounded, float bv, int bi,
                                      float v, int i) {
  return !bounded || better(bv, bi, v, i);
}

// Merge the list of the lane `off` away (xor) into this lane's.
template <int K>
__device__ __forceinline__ void merge_lanes(float (&tv)[K], int (&ti)[K],
                                            int off) {
  float pv[K];
  int pi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    pv[j] = __shfl_xor_sync(0xffffffffu, tv[j], off);
    pi[j] = __shfl_xor_sync(0xffffffffu, ti[j], off);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) insert<K>(tv, ti, pv[j], pi[j]);
}

// ---------------------------------------------------------------------
// bf16 path: TMA + wgmma, warp-specialized.

constexpr int WN = 128;                 // gallery rows per tile
constexpr int CHUNK = 64;               // dims per TMA box (128 bytes)
constexpr int STAGE_BYTES = WN * CHUNK * 2;
constexpr int MAX_WGMMA_D = 256;

// Per K: consumer warpgroups (64 queries each), queries per CTA, ring
// stages, threads (the consumers and one producer warp). At K = 1 (the
// serving top-1) four warpgroups share each gallery tile, so the gallery
// crosses L2 half as often; larger K keeps two, whose lists need the
// registers.
template <int K>
struct Cfg {
  static constexpr int NWG = K == 1 ? 4 : 2;
  static constexpr int WQ = 64 * NWG;
  static constexpr int STAGES = K == 1 ? 6 : 8;
  static constexpr int THREADS = NWG * 128 + 32;
};

template <int K>
size_t wgmma_smem_bytes(int d) {
  return 1024                                        // alignment slack
         + (size_t)Cfg<K>::WQ * d * 2                // query tile
         + (size_t)Cfg<K>::STAGES * STAGE_BYTES      // gallery ring
         + (size_t)Cfg<K>::STAGES * 16               // valid ballots
         + (size_t)2 * Cfg<K>::STAGES * 8;           // full / empty barriers
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, atoms of 8 rows (1024 bytes, the stride between
// 8-row groups). A step of 16 dims inside the atom adds 32 bytes to the
// start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d[64x128] (+)= A[64x16] . B[128x16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Score t (column 8 (t / 2) + 2 qd + t % 2) of row half H of a thread's
// m64n128 accumulators, for a t known only at run time: a switch keeps
// the accumulators in registers.
template <int H>
__device__ __forceinline__ float pick(const float (&acc)[64], int t) {
  switch (t) {
    case 0: return acc[0 + 2 * H + 0];
    case 1: return acc[0 + 2 * H + 1];
    case 2: return acc[4 + 2 * H + 0];
    case 3: return acc[4 + 2 * H + 1];
    case 4: return acc[8 + 2 * H + 0];
    case 5: return acc[8 + 2 * H + 1];
    case 6: return acc[12 + 2 * H + 0];
    case 7: return acc[12 + 2 * H + 1];
    case 8: return acc[16 + 2 * H + 0];
    case 9: return acc[16 + 2 * H + 1];
    case 10: return acc[20 + 2 * H + 0];
    case 11: return acc[20 + 2 * H + 1];
    case 12: return acc[24 + 2 * H + 0];
    case 13: return acc[24 + 2 * H + 1];
    case 14: return acc[28 + 2 * H + 0];
    case 15: return acc[28 + 2 * H + 1];
    case 16: return acc[32 + 2 * H + 0];
    case 17: return acc[32 + 2 * H + 1];
    case 18: return acc[36 + 2 * H + 0];
    case 19: return acc[36 + 2 * H + 1];
    case 20: return acc[40 + 2 * H + 0];
    case 21: return acc[40 + 2 * H + 1];
    case 22: return acc[44 + 2 * H + 0];
    case 23: return acc[44 + 2 * H + 1];
    case 24: return acc[48 + 2 * H + 0];
    case 25: return acc[48 + 2 * H + 1];
    case 26: return acc[52 + 2 * H + 0];
    case 27: return acc[52 + 2 * H + 1];
    case 28: return acc[56 + 2 * H + 0];
    case 29: return acc[56 + 2 * H + 1];
    case 30: return acc[60 + 2 * H + 0];
    case 31: return acc[60 + 2 * H + 1];
    default: return 0.f;
  }
}

template <int K>
__global__ void __launch_bounds__(Cfg<K>::THREADS, 1)
match_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                   const float* __restrict__ q,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ bound_v,
                   const int* __restrict__ bound_i,
                   float* __restrict__ part_vals, int* __restrict__ part_idx,
                   int nq, int n, int d, int rows_per_split) {
  constexpr int NWG = Cfg<K>::NWG, WQ = Cfg<K>::WQ, STAGES = Cfg<K>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                                // [d/64][WQ][128 B]
  unsigned char* ring = qs + (size_t)WQ * d * 2;           // [STAGES][WN][128 B]
  uint32_t* vmask = reinterpret_cast<uint32_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(vmask + STAGES * 4);
  uint64_t* empty = full + STAGES;

  const int nchunks = d / CHUNK;
  const int q0 = blockIdx.x * WQ;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);
  const int ntiles = n_end > n_begin ? (n_end - n_begin + WN - 1) / WN : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // Producer warp: valid ballots by all lanes, TMA by lane 0. The valid
    // bytes of the next tile are loaded one tile ahead.
    uint8_t nxt[4];
    auto load_valid = [&](int tile) {
      const int r0 = n_begin + tile * WN + lane;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        nxt[w] = (r0 + 32 * w < n_end) ? valid[r0 + 32 * w] : 0;
    };
    if (ntiles > 0) load_valid(0);
    uint32_t u = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      uint32_t m[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) m[w] = __ballot_sync(0xffffffffu, nxt[w] != 0);
      if (tile + 1 < ntiles) load_valid(tile + 1);
      const int n0 = n_begin + tile * WN;
      for (int c = 0; c < nchunks; ++c, ++u) {
        const int s = u % STAGES;
        if (lane == 0) {
          mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
          if (c == 0) {
#pragma unroll
            for (int w = 0; w < 4; ++w) vmask[s * 4 + w] = m[w];
          }
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(ring + (size_t)s * STAGE_BYTES, &gmap, &full[s],
                      c * CHUNK, n0);
        }
      }
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroups.
  const int wg = warp >> 2;
  const int t = threadIdx.x & 127;
  {
    // This warpgroup's 64 queries, rounded to bf16, in the swizzled
    // K-major layout (row r, 16-byte unit u of a 128-byte row at unit
    // u ^ (r % 8)), as TMA would have stored them.
    const int units = d / 8;
    for (int e = t; e < 64 * units; e += 128) {
      const int r = wg * 64 + e / units, u = e % units;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (q0 + r < nq) {
        const float4* src =
            reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * d + u * 8);
        a = src[0];
        b = src[1];
      }
      __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(a.z, a.w);
      __nv_bfloat162 p2 = __floats2bfloat162_rn(b.x, b.y);
      __nv_bfloat162 p3 = __floats2bfloat162_rn(b.z, b.w);
      uint4 v;
      v.x = *reinterpret_cast<uint32_t*>(&p0);
      v.y = *reinterpret_cast<uint32_t*>(&p1);
      v.z = *reinterpret_cast<uint32_t*>(&p2);
      v.w = *reinterpret_cast<uint32_t*>(&p3);
      const int c = u >> 3, uu = u & 7;
      *reinterpret_cast<uint4*>(qs + (size_t)c * WQ * 128 + r * 128 +
                                ((uu ^ (r & 7)) << 4)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  // Accumulator layout of m64n128: d[4j + 2h + e] is row 16 (warp % 4) +
  // lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
  const int qd = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool bounded = bound_v != nullptr;
  float bv[2] = {NEG_INF, NEG_INF};
  int bi[2] = {IDX_NONE, IDX_NONE};
  if (bounded) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q0 + row0 + 8 * h < nq) {
        bv[h] = bound_v[q0 + row0 + 8 * h];
        bi[h] = bound_i[q0 + row0 + 8 * h];
      }
    }
  }
  float tv[2][K];
  int ti[2][K];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < K; ++j) { tv[h][j] = NEG_INF; ti[h][j] = IDX_NONE; }

  const unsigned char* qwg = qs + wg * 64 * 128;
  uint32_t u_full = 0, u_free = 0;  // chunks waited for / released

  // Issue one tile's products into acc (asynchronous); its valid ballot
  // into mw.
  auto issue = [&](float (&acc)[64], uint32_t (&mw)[4]) {
    wgmma_fence();
    for (int c = 0; c < nchunks; ++c, ++u_full) {
      const int s = u_full % STAGES;
      mbar_wait(&full[s], (u_full / STAGES) & 1);
      if (c == 0) {
#pragma unroll
        for (int w = 0; w < 4; ++w) mw[w] = vmask[s * 4 + w];
      }
      const uint64_t da = smem_desc(qwg + (size_t)c * WQ * 128);
      const uint64_t db = smem_desc(ring + (size_t)s * STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk)
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      wgmma_commit();
    }
  };
  // Wait for the tile's products chunk by chunk (one commit group each),
  // handing each chunk's stage back to the producer as soon as its
  // products are done.
  auto drain = [&]() {
    for (int c = 0; c < nchunks; ++c) {
      switch (nchunks - 1 - c) {
        case 3: wgmma_wait<3>(); break;
        case 2: wgmma_wait<2>(); break;
        case 1: wgmma_wait<1>(); break;
        default: wgmma_wait<0>(); break;
      }
      if (lane == 0) mbar_arrive(&empty[(u_free + c) % STAGES]);
    }
    u_free += nchunks;
  };

  // Fold a tile's columns, in increasing index order, into the running
  // lists. Bit (8 (j % 4) + 2 qd + e) of mw[j / 4] >> 0 is column 8j +
  // 2 qd + e's valid flag.
  auto fold = [&](const float (&acc)[64], uint32_t (&mw)[4], int n0) {
#pragma unroll
    for (int w = 0; w < 4; ++w) mw[w] >>= 2 * qd;
    if constexpr (K == 1) {
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (mw[j >> 2] >> (8 * (j & 3) + e)) & 1u;
          const int col = n0 + 8 * j + 2 * qd + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[4 * j + 2 * h + e];
            if (ok && admit(bounded, bv[h], bi[h], v, col) && better(v, col, tv[h][0], ti[h][0])) {
              tv[h][0] = v;
              ti[h][0] = col;
            }
          }
        }
      }
    } else {
      // Past K = 1: filter in registers against each list's K-th entry as
      // it stood before the tile, one bit per passing score, then insert
      // only those, in increasing column order (the insertion re-checks
      // against the updated list). The K-deep insertion is compiled once
      // per row half, not once per score.
      uint32_t pm[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (mw[j >> 2] >> (8 * (j & 3) + e)) & 1u;
          const int col = n0 + 8 * j + 2 * qd + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[4 * j + 2 * h + e];
            if (ok && admit(bounded, bv[h], bi[h], v, col) &&
                better(v, col, tv[h][K - 1], ti[h][K - 1]))
              pm[h] |= 1u << (2 * j + e);
          }
        }
      }
      for (uint32_t m = pm[0]; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        insert<K>(tv[0], ti[0], pick<0>(acc, t), n0 + 8 * (t >> 1) + 2 * qd + (t & 1));
      }
      for (uint32_t m = pm[1]; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        insert<K>(tv[1], ti[1], pick<1>(acc, t), n0 + 8 * (t >> 1) + 2 * qd + (t & 1));
      }
    }
  };

  {
    float acc[64];
    uint32_t mw[4];
    for (int tile = 0; tile < ntiles; ++tile) {
      issue(acc, mw);
      drain();
      fold(acc, mw, n_begin + tile * WN);
    }
  }

  // The four lanes of a row hold disjoint columns: merge them.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge_lanes<K>(tv[h], ti[h], 1);
    merge_lanes<K>(tv[h], ti[h], 2);
  }
  if (qd == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + row0 + 8 * h;
      if (qi < nq) {
        const size_t base = ((size_t)split * nq + qi) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          part_vals[base + j] = tv[h][j];
          part_idx[base + j] = ti[h][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// f32-gallery path (and any D % 16 == 0): wmma tiles, scores through
// shared memory.

constexpr int BQ = 128;         // queries per CTA
constexpr int BN = 64;          // gallery rows per streamed tile
constexpr int THREADS = 256;    // 8 warps
constexpr int PAD = 8;          // bf16 padding per shared-memory row
constexpr int SLD = BN + 4;     // leading dimension of the f32 score tile

// The gallery tile and the score tile share one region: the scores of a
// tile are stored only after every warp has read the tile.
__host__ __device__ inline size_t tile_bytes(int d) {
  const size_t g = (size_t)BN * (d + PAD) * sizeof(__nv_bfloat16);
  const size_t s = (size_t)BQ * SLD * sizeof(float);
  return ((g > s ? g : s) + 127) & ~size_t(127);
}

size_t wmma_smem_bytes(int d) {
  return (size_t)BQ * (d + PAD) * sizeof(__nv_bfloat16)  // query tile
         + tile_bytes(d)                                  // gallery / scores
         + BN;                                            // valid flags
}

template <typename GT, int K>
__global__ void __launch_bounds__(THREADS)
match_wmma_kernel(const float* __restrict__ q, const GT* __restrict__ g,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ bound_v,
                  const int* __restrict__ bound_i,
                  float* __restrict__ part_vals, int* __restrict__ part_idx,
                  int nq, int n, int d, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* tile = smem + (size_t)BQ * ld * sizeof(__nv_bfloat16);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(tile);
  float* ss = reinterpret_cast<float*>(tile);
  uint8_t* vs = tile + tile_bytes(d);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);

  // Query tile, rounded to bf16 (rows past nq are zeros, never written).
  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const float v = (q0 + r < nq) ? q[(size_t)(q0 + r) * d + c] : 0.f;
    qs[r * ld + c] = __float2bfloat16(v);
  }

  float tv[K];
  int ti[K];
#pragma unroll
  for (int j = 0; j < K; ++j) { tv[j] = NEG_INF; ti[j] = IDX_NONE; }

  const int row = tid >> 1;   // the query this thread ranks for
  const int half = tid & 1;   // which half of the tile's columns
  const int warp = tid >> 5;
  const int wq = warp >> 1;   // warp tile: queries [32 wq, 32 wq + 32)
  const int wg = warp & 1;    //   x gallery rows [32 wg, 32 wg + 32)
  const bool bounded = bound_v != nullptr;
  float bv = NEG_INF;
  int bi = IDX_NONE;
  if (bounded && q0 + row < nq) { bv = bound_v[q0 + row]; bi = bound_i[q0 + row]; }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (std::is_same<GT, __nv_bfloat16>::value) {
      const int chunks = d / 8;  // 16-byte chunks per row
      for (int e = tid; e < BN * chunks; e += THREADS) {
        const int r = e / chunks, c8 = e - r * chunks;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n0 + r < n_end)
          v = reinterpret_cast<const uint4*>(g + (size_t)(n0 + r) * d)[c8];
        *reinterpret_cast<uint4*>(gs + r * ld + c8 * 8) = v;
      }
    } else {
      const int chunks = d / 4;  // float4 per row
      for (int e = tid; e < BN * chunks; e += THREADS) {
        const int r = e / chunks, c4 = e - r * chunks;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + r < n_end)
          v = reinterpret_cast<const float4*>(g + (size_t)(n0 + r) * d)[c4];
        __nv_bfloat16* dst = gs + r * ld + c4 * 4;
        dst[0] = __float2bfloat16(v.x);
        dst[1] = __float2bfloat16(v.y);
        dst[2] = __float2bfloat16(v.z);
        dst[3] = __float2bfloat16(v.w);
      }
    }
    if (tid < BN) vs[tid] = (n0 + tid < n_end) ? valid[n0 + tid] : 0;
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], qs + (wq * 32 + i * 16) * ld + kk, ld);
        wmma::load_matrix_sync(bf[i], gs + (wg * 32 + i * 16) * ld + kk, ld);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // every warp has read the gallery tile: reuse it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ss + (wq * 32 + i * 16) * SLD + wg * 32 + j * 16,
                                acc[i][j], SLD, wmma::mem_row_major);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN / 2; ++j) {
      const int c = half + 2 * j;
      const float v = ss[row * SLD + c];
      const bool pass = vs[c] && admit(bounded, bv, bi, v, n0 + c) &&
                        better(v, n0 + c, tv[K - 1], ti[K - 1]);
      if (__any_sync(0xffffffffu, pass) && pass) insert<K>(tv, ti, v, n0 + c);
    }
  }

  merge_lanes<K>(tv, ti, 1);  // the two half-lists of a query
  if (half == 0 && q0 + row < nq) {
    const size_t base = ((size_t)split * nq + q0 + row) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_vals[base + j] = tv[j];
      part_idx[base + j] = ti[j];
    }
  }
}

// ---------------------------------------------------------------------
// Merge of the per-split partials of one pass into columns [col0, col0 +
// K) of the output; the pass's last kept row becomes the next pass's
// bound.

template <int K>
__global__ void match_merge_kernel(const float* __restrict__ part_vals,
                                   const int* __restrict__ part_idx,
                                   float* __restrict__ out_vals,
                                   int* __restrict__ out_idx,
                                   float* __restrict__ bound_v,
                                   int* __restrict__ bound_i,
                                   int nq, int splits, int k, int col0) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float tv[K];
  int ti[K];
#pragma unroll
  for (int j = 0; j < K; ++j) { tv[j] = NEG_INF; ti[j] = IDX_NONE; }
  for (int s = 0; s < splits; ++s) {
    const size_t base = ((size_t)s * nq + qi) * K;
#pragma unroll
    for (int j = 0; j < K; ++j)
      insert<K>(tv, ti, part_vals[base + j], part_idx[base + j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (col0 + j < k) {
      // Sentinel from the VALUE: a slot no valid row filled keeps -1e30.
      out_vals[(size_t)qi * k + col0 + j] = tv[j];
      out_idx[(size_t)qi * k + col0 + j] = tv[j] > NEG_INF * 0.5f ? ti[j] : -1;
    }
  }
  if (bound_v != nullptr) {
    bound_v[qi] = tv[K - 1];
    bound_i[qi] = ti[K - 1];
  }
}

// ---------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

struct Args {
  const float* q;
  const void* g;
  int g_is_bf16;
  const uint8_t* valid;
  float* part_vals;
  int* part_idx;
  float* out_vals;
  int* out_idx;
  float* bound_v;
  int* bound_i;
  int nq, n, d, k, kpad, splits, rows_per_split;
  cudaStream_t stream;
};

template <int K>
int launch_partial_wgmma(const Args& a, const CUtensorMap& map, bool bounded) {
  const size_t smem = wgmma_smem_bytes<K>(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      match_wgmma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + Cfg<K>::WQ - 1) / Cfg<K>::WQ, a.splits);
  match_wgmma_kernel<K><<<grid, Cfg<K>::THREADS, smem, a.stream>>>(
      map, a.q, a.valid, bounded ? a.bound_v : nullptr,
      bounded ? a.bound_i : nullptr, a.part_vals, a.part_idx, a.nq, a.n, a.d,
      a.rows_per_split);
  return (int)cudaGetLastError();
}

template <typename GT, int K>
int launch_partial_wmma(const Args& a, bool bounded) {
  const size_t smem = wmma_smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      match_wmma_kernel<GT, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + BQ - 1) / BQ, a.splits);
  match_wmma_kernel<GT, K><<<grid, THREADS, smem, a.stream>>>(
      a.q, static_cast<const GT*>(a.g), a.valid, bounded ? a.bound_v : nullptr,
      bounded ? a.bound_i : nullptr, a.part_vals, a.part_idx, a.nq, a.n, a.d,
      a.rows_per_split);
  return (int)cudaGetLastError();
}

template <int K>
int run_passes(const Args& a, const CUtensorMap* map) {
  const int passes = a.k > K ? (a.k + K - 1) / K : 1;
  for (int r = 0; r < passes; ++r) {
    const bool bounded = r > 0;
    int err;
    if (map != nullptr)
      err = launch_partial_wgmma<K>(a, *map, bounded);
    else if (a.g_is_bf16)
      err = launch_partial_wmma<__nv_bfloat16, K>(a, bounded);
    else
      err = launch_partial_wmma<float, K>(a, bounded);
    if (err != 0) return err;
    match_merge_kernel<K><<<(a.nq + 127) / 128, 128, 0, a.stream>>>(
        a.part_vals, a.part_idx, a.out_vals, a.out_idx,
        passes > 1 ? a.bound_v : nullptr, passes > 1 ? a.bound_i : nullptr,
        a.nq, a.splits, a.k, r * K);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Constants the Python wrapper checks its launch plan against.
int streaming_match_round_k() { return ROUND_K; }
int streaming_match_wgmma_block_q(int kpad) {
  return kpad == 1 ? Cfg<1>::WQ : Cfg<2>::WQ;
}
int streaming_match_wgmma_block_n() { return WN; }
int streaming_match_wgmma_max_d() { return MAX_WGMMA_D; }
int streaming_match_wmma_block_q() { return BQ; }
int streaming_match_wmma_block_n() { return BN; }
// Dynamic shared memory of one CTA of a pass (path 1: wgmma, 0: wmma).
long long streaming_match_smem_bytes(int d, int kpad, int path) {
  if (path == 0) return (long long)wmma_smem_bytes(d);
  return (long long)(kpad == 1 ? wgmma_smem_bytes<1>(d) : wgmma_smem_bytes<2>(d));
}

// q [nq, d] f32; g [n, d] bf16 (g_is_bf16 = 1) or f32; valid [n] uint8;
// part_vals/part_idx [splits, nq, kpad] scratch; bound_v/bound_i [nq]
// scratch (used when k > kpad); out [nq, k]. path 1: TMA + wgmma (bf16
// gallery, d % 64 == 0, d <= 256, 16-byte aligned q and g,
// rows_per_split % 128 == 0); path 0: wmma (d % 16 == 0,
// rows_per_split % 64 == 0). kpad is a power of two <= 16, and k <= kpad
// unless kpad == 16. Returns the CUDA error code of the launches (0 =
// success).
int streaming_match_topk(const void* q, const void* g, int g_is_bf16,
                         const void* valid, void* part_vals, void* part_idx,
                         void* out_vals, void* out_idx, void* bound_v,
                         void* bound_i, int nq, int n, int d, int k, int kpad,
                         int path, int splits, int rows_per_split,
                         void* stream) {
  if (d % 16 != 0 || k < 1 || (k > kpad && kpad != ROUND_K) || splits < 1 ||
      (k > kpad && (bound_v == nullptr || bound_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), g, g_is_bf16,
         static_cast<const uint8_t*>(valid), static_cast<float*>(part_vals),
         static_cast<int*>(part_idx), static_cast<float*>(out_vals),
         static_cast<int*>(out_idx), static_cast<float*>(bound_v),
         static_cast<int*>(bound_i), nq, n, d, k, kpad, splits,
         rows_per_split, reinterpret_cast<cudaStream_t>(stream)};
  CUtensorMap map;
  const CUtensorMap* mp = nullptr;
  if (path == 1) {
    if (!g_is_bf16 || d % CHUNK != 0 || d > MAX_WGMMA_D ||
        rows_per_split % WN != 0 || reinterpret_cast<uintptr_t>(g) % 16 ||
        reinterpret_cast<uintptr_t>(q) % 16)
      return (int)cudaErrorInvalidValue;
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
    const cuuint32_t box[2] = {CHUNK, WN};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(g),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    mp = &map;
  } else if (path != 0 || rows_per_split % BN != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (kpad) {
    case 1: return run_passes<1>(a, mp);
    case 2: return run_passes<2>(a, mp);
    case 4: return run_passes<4>(a, mp);
    case 8: return run_passes<8>(a, mp);
    case 16: return run_passes<16>(a, mp);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
