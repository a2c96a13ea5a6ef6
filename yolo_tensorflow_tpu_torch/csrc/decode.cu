// Fused anchor decode + class scoring for YOLO heads, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel yolo_tensorflow_tpu/ops/pallas/decode.py
// (_decode_kernel, launched per scale by decode_scale_fused). Same math:
// for every head row of (5 + C) raw values
//   box   = ((col + s(tx)) / G, (row + s(ty)) / G,
//            exp(tw) * aw / G, exp(th) * ah / G) as xyxy corners,
//   score = s(obj) * best class probability,
//   label = argmax over the class logits (lowest index on ties, jnp.argmax),
// with s the logistic function. Sigmoid classes (v3) score as
// s(obj) * s(max logit), equal to max_c s(l_c) because s is monotone;
// softmax classes (v2) score as s(obj) / sum_c exp(l_c - max logit).
//
// Bound: memory. Each row is read once (85 values for COCO) and 24 bytes are
// written; there are ~20 flops per value. At yolov3-416, batch 64, bf16 the
// read is 64 * 10647 * 85 * 2 B = 116 MB, about 35 us at the H100's
// 3.35 TB/s. The backbone in front of it is ~65.9 GFLOP per image, so this
// kernel is a correctness milestone on the main path, not a speed lever.
//
// Design: one warp per row. Lanes stride over the row's contiguous values,
// so a warp reads the row in one coalesced sweep; max/argmax (and the
// softmax sum) reduce by warp shuffles, the five box/objectness values reach
// lane 0 by shuffle, and lane 0 does the per-row scalar work (box, cell and
// anchor from the row index). The TPU kernel padded each scale to a
// multiple of its row tile and sank the padded rows with score -1; here the
// warp index is bounds-checked instead, so nothing is padded. Each scale
// writes straight into its row range [row_offset, row_offset + G*G*A) of the
// caller's (B, total_rows, ...) outputs, so the scales need no concatenation.
// Inputs are f32 or bf16 (templated); all arithmetic is in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxAnchors = 16;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

struct Anchors {
  float w[kMaxAnchors];  // anchor widths in grid cells
  float h[kMaxAnchors];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float logistic(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_kernel(const T* __restrict__ feat, float* __restrict__ boxes,
              float* __restrict__ score, int32_t* __restrict__ label,
              int64_t rows, int rows_per_image, int grid, int num_anchors,
              int num_classes, Anchors anchors, int class_softmax,
              int row_offset, int total_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // r is the same for the whole warp

  const T* x = feat + r * (5 + num_classes);
  const T* logits = x + 5;

  // one coalesced sweep over the whole row: lanes 0-4 also pick up
  // (tx, ty, tw, th, obj), which reach lane 0 by shuffle below
  float head = 0.0f;
  float best = -INFINITY;
  int best_i = INT32_MAX;
  for (int j = lane; j < 5 + num_classes; j += 32) {
    const float v = to_float(x[j]);
    if (j < 5) {
      head = v;
    } else if (v > best || best_i == INT32_MAX) {
      best = v;  // j rises within a lane, so a tie keeps the first class
      best_i = j - 5;
    }
  }
  const float tx = __shfl_sync(kFullMask, head, 0);
  const float ty = __shfl_sync(kFullMask, head, 1);
  const float tw = __shfl_sync(kFullMask, head, 2);
  const float th = __shfl_sync(kFullMask, head, 3);
  const float obj = __shfl_sync(kFullMask, head, 4);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, best, off);
    const int oi = __shfl_xor_sync(kFullMask, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }

  float prob;
  if (class_softmax) {
    float sum = 0.0f;
    for (int c = lane; c < num_classes; c += 32) {
      sum += expf(to_float(logits[c]) - best);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFullMask, sum, off);
    }
    prob = 1.0f / sum;
  } else {
    prob = logistic(best);
  }

  if (lane != 0) return;
  const int64_t img = r / rows_per_image;
  const int i = static_cast<int>(r - img * rows_per_image);
  const int anchor = i % num_anchors;
  const int cell = i / num_anchors;
  const float g = static_cast<float>(grid);
  const float bx = (static_cast<float>(cell % grid) + logistic(tx)) / g;
  const float by = (static_cast<float>(cell / grid) + logistic(ty)) / g;
  // select with constant indices: a dynamic index into the by-value
  // Anchors parameter would copy all of it to local memory in every thread
  float aw = 0.0f, ah = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxAnchors; ++k) {
    if (k == anchor) {
      aw = anchors.w[k];
      ah = anchors.h[k];
    }
  }
  const float bw = expf(tw) * aw / g;
  const float bh = expf(th) * ah / g;
  const float half_w = bw * 0.5f;
  const float half_h = bh * 0.5f;

  const int64_t out = img * total_rows + row_offset + i;
  reinterpret_cast<float4*>(boxes)[out] =
      make_float4(bx - half_w, by - half_h, bx + half_w, by + half_h);
  score[out] = logistic(obj) * prob;
  label[out] = best_i;
}

}  // namespace

// Decode one head scale. feat: (batch, grid, grid, num_anchors * (5 +
// num_classes)) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// boxes (batch, total_rows, 4) f32, score (batch, total_rows) f32 and label
// (batch, total_rows) int32 are written at rows [row_offset, row_offset +
// grid*grid*num_anchors). anchors_wh: host array of num_anchors (w, h) pairs
// in grid cells. Launches on `stream` and returns cudaGetLastError().
extern "C" int yolo_decode_scale(const void* feat, int is_bf16, void* boxes,
                                 void* score, void* label, int batch,
                                 int grid, int num_anchors, int num_classes,
                                 const float* anchors_wh, int class_softmax,
                                 int row_offset, int total_rows,
                                 void* stream) {
  if (num_anchors < 1 || num_anchors > kMaxAnchors || num_classes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Anchors a = {};
  for (int k = 0; k < num_anchors; ++k) {
    a.w[k] = anchors_wh[2 * k];
    a.h[k] = anchors_wh[2 * k + 1];
  }
  const int rows_per_image = grid * grid * num_anchors;
  const int64_t rows = static_cast<int64_t>(batch) * rows_per_image;
  if (rows == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(boxes);
  float* sc = static_cast<float*>(score);
  int32_t* lb = static_cast<int32_t*>(label);
  if (is_bf16) {
    decode_kernel<__nv_bfloat16><<<blocks, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat), b, sc, lb, rows,
        rows_per_image, grid, num_anchors, num_classes, a, class_softmax,
        row_offset, total_rows);
  } else {
    decode_kernel<float><<<blocks, block, 0, s>>>(
        static_cast<const float*>(feat), b, sc, lb, rows, rows_per_image,
        grid, num_anchors, num_classes, a, class_softmax, row_offset,
        total_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
