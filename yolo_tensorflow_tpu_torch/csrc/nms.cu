// Greedy non-maximum suppression over ranked candidates, for Hopper (sm_90a).
//
// Replaces the greedy step of yolo_tensorflow_tpu/post/nms.py: _greedy_keep
// (:103), a lax.while_loop fixpoint over the K x K IoU matrix, and the final
// lax.top_k of _nms_single (:126). On the TPU that is XLA, not a Pallas
// kernel; PyTorch has no loop that stays on the device, so without this
// kernel every fixpoint round is a host sync. Per image, with the K
// candidates in rank order (descending score, as top-k left them):
//   keep[i] = score[i] > conf and no kept j < i overlaps i,
//   overlap(j, i) = (class_aware and label[j] != label[i] ? 0 : iou) > thr,
// the sequential greedy that the fixpoint converges to (tests/test_nms.py
// holds the fixpoint to a sequential oracle). The output is the first D kept
// candidates in rank order, then zeros and valid = false: what
// lax.top_k(where(keep, score, -1), D) selects, since kept scores lie above
// -1 in rank order and top_k breaks ties toward the lower index.
//
// Exactness: iou > thr decides as the plain version's does only if the IoU
// rounds the same, so it is written with round-to-nearest intrinsics in
// iou_matrix's order (area = max(x1-x0,0) * max(y1-y0,0), union = (area_i +
// area_j) - inter, inter / max(union, 1e-9)): nvcc would otherwise contract
// a product and a sum into one fma. min, max and the clamps keep a NaN, as
// torch.maximum and torch.clamp do (inf-sized boxes give NaN unions).
//
// Bound: neither bytes nor operations. An image reads K * 24 bytes and does
// at most K^2 / 2 IoUs of ~15 f32 operations; at K = 256 and batch 64 that is
// 0.4 MB and ~30 M operations, well under a microsecond of the card. The
// greedy is a chain: candidate i can only be decided after every kept
// candidate before it has marked its victims. So the time is the chain's
// length times a CTA barrier, plus the launch.
//
// Design, simple and exact:
// - One CTA per image; the image's K boxes, areas, labels and dead flags
//   (inactive or suppressed) sit in dynamic shared memory, 25 bytes a
//   candidate, so K is bounded only by the 227 KB a CTA can have.
// - Every thread walks the candidates in rank order. A dead flag is the same
//   in every thread (each write to it is followed by a barrier before it is
//   read), so the walk is uniform and a candidate that is already dead costs
//   one shared-memory read and no barrier.
// - A kept candidate i: its threads test j = i+1, i+1+T, ... (T threads)
//   that are still alive and mark the ones i overlaps; then one barrier.
// - Only the first D kept candidates reach the output, so the walk stops at
//   the D-th: its victims could only have been later candidates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSharedBytes = 227 * 1024;
// box (float4), area (float), label (int), dead flag (byte)
constexpr int kBytesPerCandidate = 16 + 4 + 4 + 1;

// max and min that return NaN when either operand is NaN, as torch.maximum
// and jnp.maximum do (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

// torch.clamp(v, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp_min(__fsub_rn(b.z, b.x), 0.0f),
                   clamp_min(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float ix0 = max_nan(a.x, b.x);
  const float iy0 = max_nan(a.y, b.y);
  const float ix1 = min_nan(a.z, b.z);
  const float iy1 = min_nan(a.w, b.w);
  const float inter = __fmul_rn(clamp_min(__fsub_rn(ix1, ix0), 0.0f),
                                clamp_min(__fsub_rn(iy1, iy0), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, clamp_min(uni, 1e-9f));
}

__global__ void __launch_bounds__(kMaxThreads) nms_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const int32_t* __restrict__ labels, int k, int max_det, float conf,
    float iou_thr, int class_aware, float4* __restrict__ out_boxes,
    float* __restrict__ out_scores, int32_t* __restrict__ out_labels,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ out_num) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int32_t* slabel = reinterpret_cast<int32_t*>(sarea + k);
  int32_t* skept = slabel + k;                      // max_det entries
  uint8_t* sdead = reinterpret_cast<uint8_t*>(skept + max_det);

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = boxes[base + j];
    sbox[j] = b;
    sarea[j] = box_area(b);
    slabel[j] = labels[base + j];
    sdead[j] = !(scores[base + j] > conf);
  }
  __syncthreads();

  int kept = 0;
  for (int i = 0; i < k; ++i) {
    if (sdead[i]) continue;                         // uniform: see above
    if (threadIdx.x == 0) skept[kept] = i;
    if (++kept == max_det) break;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    const int32_t li = slabel[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (sdead[j]) continue;
      const float v = (class_aware && slabel[j] != li)
                          ? 0.0f : iou(bi, ai, sbox[j], sarea[j]);
      if (v > iou_thr) sdead[j] = 1;
    }
    __syncthreads();
  }
  __syncthreads();                                  // skept's last entry

  const size_t out = static_cast<size_t>(blockIdx.x) * max_det;
  for (int s = threadIdx.x; s < max_det; s += blockDim.x) {
    if (s < kept) {
      const int c = skept[s];
      out_boxes[out + s] = sbox[c];
      out_scores[out + s] = scores[base + c];
      out_labels[out + s] = slabel[c];
      out_valid[out + s] = 1;
    } else {
      out_boxes[out + s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      out_scores[out + s] = 0.0f;
      out_labels[out + s] = 0;
      out_valid[out + s] = 0;
    }
  }
  if (threadIdx.x == 0) out_num[blockIdx.x] = kept;
}

}  // namespace

// Greedy NMS of `batch` images of `num_candidates` (K) ranked candidates
// each: boxes (batch, K, 4) f32 xyxy, scores (batch, K) f32 in descending
// order, labels (batch, K) int32, all contiguous. Writes the first
// `max_detections` (D >= 1) kept candidates of every image in rank order:
// out_boxes (batch, D, 4) f32, out_scores (batch, D) f32, out_labels (batch,
// D) int32, out_valid (batch, D) bytes of 0 or 1 (torch.bool) and out_num
// (batch,) int32, zeros past the kept ones. Launches on `stream` and returns
// cudaGetLastError(); cudaErrorInvalidValue for a K and D whose candidates do
// not fit a CTA's shared memory (K * 25 + D * 4 bytes).
extern "C" int yolo_nms(const void* boxes, const void* scores,
                        const void* labels, int batch, int num_candidates,
                        int max_detections, float conf_threshold,
                        float iou_threshold, int class_aware, void* out_boxes,
                        void* out_scores, void* out_labels, void* out_valid,
                        void* out_num, void* stream) {
  if (batch < 0 || num_candidates < 0 || max_detections < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(num_candidates)
                        * kBytesPerCandidate + 4 * static_cast<size_t>(
                            max_detections);
  if (shared > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  // above 48 KB a kernel must ask for its dynamic shared memory, once per
  // device
  static int raised_on = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared > 48 * 1024 && device != raised_on) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised_on = device;
  }
  const int threads = min(kMaxThreads,
                          max(32, (num_candidates + 31) / 32 * 32));
  nms_kernel<<<batch, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int32_t*>(labels), num_candidates, max_detections,
      conf_threshold, iou_threshold, class_aware,
      static_cast<float4*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<int32_t*>(out_labels), static_cast<uint8_t*>(out_valid),
      static_cast<int32_t*>(out_num));
  return static_cast<int>(cudaGetLastError());
}
