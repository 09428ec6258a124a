// Greedy non-maximum suppression keep-mask, one image per CTA.
//
// Replaces: no Pallas kernel. The reference runs the greedy loop as a
//   lax.fori_loop inside its jitted step
//   (opencv_facerecognizer_tpu/ops/nms.py nms_mask); eager PyTorch ran it
//   as a Python loop of K steps, about six launches each.
//
// Semantics (held to ops/nms.py nms_mask_plain, the reference's loop):
//   - the candidates arrive in stable descending score order (the sort
//     stays in PyTorch, torch.sort(stable=True), the reference's tie
//     order), with ``order`` the permutation that sorted them;
//   - candidate i is kept iff its score > score_thr and no kept j < i has
//     IoU(i, j) > iou_thr;
//   - the keep flags go back to candidate order: keep[order[i]].
//   The IoU is pairwise_iou's f32 arithmetic operation by operation:
//   inter = max(y1 - y0, 0) * max(x1 - x0, 0), union = (area_i + area_j)
//   - inter, iou = inter / max(union, 1e-12), each op rounded to nearest
//   (__f*_rn intrinsics: no FMA contraction, IEEE division), so a box at
//   the threshold falls the same way as in PyTorch on either device.
//
// What bounds it on the H100: nothing the memory or the ALUs see. At the
// serving shape (B = 32 images, K = 64 candidates) the inputs are 58 KiB
// and the IoUs 32 * 2016 pairs: microseconds of launch and a K-step
// dependent chain are the cost. The design keeps that chain short:
//   - the boxes and their areas go to shared memory once;
//   - every warp computes IoU rows 32 columns at a time and packs the
//     "earlier and overlapping" flags of row i with one __ballot_sync into
//     a K x ceil(K/32) bit matrix in shared memory (128 KiB at K = 1024);
//     the candidate flags are packed the same way;
//   - one warp scans: lane w holds keep word w (K <= 1024, so 32 words
//     fit a warp); step i is one shared load per lane and one
//     __any_sync over (keep & suppress[i]), so the dependent chain is
//     K shuffle-latency steps with no block barrier inside it;
//   - all threads scatter the flags back to candidate order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 1024;  // the scan keeps one keep word per lane
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int words_of(int k) { return (k + 31) / 32; }

__host__ inline size_t smem_bytes(int k) {
  const int w = words_of(k);
  return (size_t)k * sizeof(float4)             // boxes
         + (size_t)k * sizeof(float)             // areas
         + (size_t)k * w * sizeof(uint32_t)      // suppress bits
         + 2 * (size_t)w * sizeof(uint32_t);     // candidate and keep words
}

__device__ inline float box_area(float4 b) {
  const float h = fmaxf(__fsub_rn(b.z, b.x), 0.0f);
  const float w = fmaxf(__fsub_rn(b.w, b.y), 0.0f);
  return __fmul_rn(h, w);
}

__device__ inline float iou(float4 a, float4 b, float area_a, float area_b) {
  const float y0 = fmaxf(a.x, b.x);
  const float x0 = fmaxf(a.y, b.y);
  const float y1 = fminf(a.z, b.z);
  const float x1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(y1, y0), 0.0f),
                                fmaxf(__fsub_rn(x1, x0), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const int64_t* __restrict__ order, uint8_t* __restrict__ keep,
                int k, float iou_thr, float score_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = words_of(k);
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  uint32_t* sup = reinterpret_cast<uint32_t*>(sarea + k);
  uint32_t* cand = sup + (size_t)k * w;
  uint32_t* kept = cand + w;

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* b = boxes + (size_t)img * k * 4;
  const float* s = scores + (size_t)img * k;

  for (int i = tid; i < k; i += THREADS) {
    const float4 v = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    sbox[i] = v;
    sarea[i] = box_area(v);
  }
  __syncthreads();

  // Row i, word c: bit l set iff j = 32c + l < i and IoU(i, j) > iou_thr.
  for (int p = warp; p < k * w; p += THREADS / 32) {
    const int i = p / w;
    const int c = p - i * w;
    const int j = 32 * c + lane;
    bool hit = false;
    if (j < i) hit = iou(sbox[i], sbox[j], sarea[i], sarea[j]) > iou_thr;
    const uint32_t bits = __ballot_sync(FULL, hit);
    if (lane == 0) sup[p] = bits;
  }
  for (int c = warp; c < w; c += THREADS / 32) {
    const int j = 32 * c + lane;
    const uint32_t bits = __ballot_sync(FULL, j < k && s[j] > score_thr);
    if (lane == 0) cand[c] = bits;
  }
  __syncthreads();

  if (warp == 0) {
    const uint32_t my_cand = lane < w ? cand[lane] : 0u;
    uint32_t my_keep = 0u;
    for (int i = 0; i < k; ++i) {
      const uint32_t row = lane < w ? sup[(size_t)i * w + lane] : 0u;
      const bool overlapped = __any_sync(FULL, (my_keep & row) != 0u);
      if (lane == (i >> 5) && !overlapped && ((my_cand >> (i & 31)) & 1u))
        my_keep |= 1u << (i & 31);
    }
    if (lane < w) kept[lane] = my_keep;
  }
  __syncthreads();

  const int64_t* o = order + (size_t)img * k;
  uint8_t* out = keep + (size_t)img * k;
  for (int i = tid; i < k; i += THREADS) {
    const int64_t dst = o[i];
    if (dst >= 0 && dst < k) out[dst] = (uint8_t)((kept[i >> 5] >> (i & 31)) & 1u);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA at K candidates; 0 when K is out of
// range (1 .. 1024).
size_t nms_smem_bytes(int k) {
  return (k < 1 || k > MAX_K) ? 0 : smem_bytes(k);
}

// keep[b, order[b, i]] = greedy-NMS flag of sorted candidate i, for b in
// [0, batch). boxes [batch, k, 4] f32 and scores [batch, k] f32 in stable
// descending score order, order [batch, k] int64, keep [batch, k] uint8.
// Returns a CUDA error code (cudaErrorInvalidValue for k outside 1..1024).
int nms_keep(const float* boxes, const float* scores, const int64_t* order,
             uint8_t* keep, int batch, int k, float iou_thr, float score_thr,
             cudaStream_t stream) {
  if (k < 1 || k > MAX_K || batch < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<batch, THREADS, smem, stream>>>(boxes, scores, order, keep, k,
                                                    iou_thr, score_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
