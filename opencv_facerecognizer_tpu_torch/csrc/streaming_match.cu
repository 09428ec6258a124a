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
//     tiles and across splits;
//   - empty slots (fewer than k valid rows) carry sim -1e30 and index -1,
//     the index derived from the value in the merge kernel.
//
// What bounds it on the H100: the serving shape is Q = 512 queries against
// N = 2^20 bf16 rows of D = 256. The gallery is 512 MiB (0.16 ms at
// 3.35 TB/s) and the product is 2*Q*N*D = 275 GFLOP (0.28 ms at 989 TFLOP/s
// bf16), so the tensor cores bound it, closely followed by memory. The
// small Q is the trap: a grid over Q alone gives 512/128 = 4 CTAs for 132
// SMs. The design:
//   - the grid is (Q tiles, N splits): each CTA keeps one 128-query tile in
//     shared memory and streams only its own slice of the gallery, so the
//     card gets hundreds of CTAs. The Q-tile index varies fastest, so the
//     CTAs that read the same gallery slice run together and the repeat
//     reads of that slice hit L2 (4 Q tiles: the gallery crosses L2 4x);
//   - each 128x64 score tile is a bf16 tensor-core product (wmma 16x16x16,
//     f32 accumulation), a 32x32 warp tile per warp; the scores are stored
//     over the gallery tile they came from, which keeps the CTA at ~100 KiB
//     of shared memory, two CTAs per SM;
//   - each thread keeps a running top-K (registers, sorted, lowest index
//     first on ties) over half of the tile's columns for one query; the two
//     half-lists of a query are merged with one warp shuffle and written as
//     one per-split partial;
//   - a second small kernel merges the per-split partials per query with
//     the same order and derives the -1 sentinel from the value.
// Plain synchronous tile loads, no TMA, no wgmma, no pipelining: at the
// serving shape it runs several times above its bound (PERF.md); a later
// change makes it fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 128;         // queries per CTA
constexpr int BN = 64;          // gallery rows per streamed tile
constexpr int THREADS = 256;    // 8 warps
constexpr int PAD = 8;          // bf16 padding per shared-memory row
constexpr int SLD = BN + 4;     // leading dimension of the f32 score tile
constexpr float NEG_INF = -1e30f;
constexpr int IDX_NONE = 0x7fffffff;

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

// The gallery tile and the score tile share one region: the scores of a
// tile are stored only after every warp has read the tile.
__host__ __device__ inline size_t tile_bytes(int d) {
  const size_t g = (size_t)BN * (d + PAD) * sizeof(__nv_bfloat16);
  const size_t s = (size_t)BQ * SLD * sizeof(float);
  return ((g > s ? g : s) + 127) & ~size_t(127);
}

size_t partial_smem_bytes(int d) {
  return (size_t)BQ * (d + PAD) * sizeof(__nv_bfloat16)  // query tile
         + tile_bytes(d)                                  // gallery / scores
         + BN;                                            // valid flags
}

template <typename GT, int K>
__global__ void __launch_bounds__(THREADS)
match_partial_kernel(const float* __restrict__ q, const GT* __restrict__ g,
                     const uint8_t* __restrict__ valid,
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
      if (vs[c]) insert<K>(tv, ti, ss[row * SLD + c], n0 + c);
    }
  }

  // Merge the two half-lists of each query (adjacent lanes).
  {
    float pv[K];
    int pi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pv[j] = __shfl_xor_sync(0xffffffffu, tv[j], 1);
      pi[j] = __shfl_xor_sync(0xffffffffu, ti[j], 1);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) insert<K>(tv, ti, pv[j], pi[j]);
  }
  if (half == 0 && q0 + row < nq) {
    const size_t base = ((size_t)split * nq + q0 + row) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_vals[base + j] = tv[j];
      part_idx[base + j] = ti[j];
    }
  }
}

template <int K>
__global__ void match_merge_kernel(const float* __restrict__ part_vals,
                                   const int* __restrict__ part_idx,
                                   float* __restrict__ out_vals,
                                   int* __restrict__ out_idx,
                                   int nq, int splits, int k) {
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
    if (j < k) {
      // Sentinel from the VALUE: a slot no valid row filled keeps -1e30.
      out_vals[(size_t)qi * k + j] = tv[j];
      out_idx[(size_t)qi * k + j] = tv[j] > NEG_INF * 0.5f ? ti[j] : -1;
    }
  }
}

template <typename GT, int K>
int launch(const float* q, const GT* g, const uint8_t* valid,
           float* part_vals, int* part_idx, float* out_vals, int* out_idx,
           int nq, int n, int d, int k, int splits, int rows_per_split,
           cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      match_partial_kernel<GT, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  match_partial_kernel<GT, K><<<grid, THREADS, smem, stream>>>(
      q, g, valid, part_vals, part_idx, nq, n, d, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  match_merge_kernel<K><<<(nq + 127) / 128, 128, 0, stream>>>(
      part_vals, part_idx, out_vals, out_idx, nq, splits, k);
  return (int)cudaGetLastError();
}

template <typename GT>
int dispatch_k(const float* q, const GT* g, const uint8_t* valid,
               float* part_vals, int* part_idx, float* out_vals, int* out_idx,
               int nq, int n, int d, int k, int kpad, int splits,
               int rows_per_split, cudaStream_t stream) {
  switch (kpad) {
#define CASE(KK)                                                          \
  case KK:                                                                \
    return launch<GT, KK>(q, g, valid, part_vals, part_idx, out_vals,     \
                          out_idx, nq, n, d, k, splits, rows_per_split,   \
                          stream);
    CASE(1) CASE(2) CASE(4) CASE(8) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Constants the Python wrapper sizes its launch and scratch with.
int streaming_match_block_q() { return BQ; }
int streaming_match_block_n() { return BN; }
long long streaming_match_smem_bytes(int d) {
  return (long long)partial_smem_bytes(d);
}

// q [nq, d] f32; g [n, d] bf16 (g_is_bf16 = 1) or f32; valid [n] uint8;
// part_vals/part_idx [splits, nq, kpad] scratch; out [nq, k].
// Returns the CUDA error code of the launches (0 = success).
int streaming_match_topk(const void* q, const void* g, int g_is_bf16,
                         const void* valid, void* part_vals, void* part_idx,
                         void* out_vals, void* out_idx, int nq, int n, int d,
                         int k, int kpad, int splits, int rows_per_split,
                         void* stream) {
  if (d % 16 != 0 || k < 1 || k > kpad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* pv = static_cast<float*>(part_vals);
  int* pi = static_cast<int*>(part_idx);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_idx);
  if (g_is_bf16)
    return dispatch_k<__nv_bfloat16>(
        qf, static_cast<const __nv_bfloat16*>(g), v, pv, pi, ov, oi, nq, n, d,
        k, kpad, splits, rows_per_split, s);
  return dispatch_k<float>(qf, static_cast<const float*>(g), v, pv, pi, ov,
                           oi, nq, n, d, k, kpad, splits, rows_per_split, s);
}

}  // extern "C"
