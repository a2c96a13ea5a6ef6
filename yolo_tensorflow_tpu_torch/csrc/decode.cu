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
// softmax classes (v2, the region head) score as
// s(obj) / sum_c exp(l_c - max logit).
//
// Bound: memory. Each row is read once (85 values for COCO) and 24 bytes are
// written; there are a few f32 operations per value. At yolov3-416, batch
// 64, bf16 the read is 64 * 10647 * 85 * 2 B = 116 MB and the write 16 MB,
// about 40 us at the H100's 3.35 TB/s; a region head (845 rows an image) is
// a few microseconds, so its launch costs more than its bytes.
//
// Design, for a card whose scarce resource here is bytes in flight:
// - One launch decodes every scale of a head. The scales arrive as a small
//   by-value table (pointer, rows, grid, anchors in grid cells, first output
//   row, first tile); it is a __grid_constant__ parameter, so indexing it
//   with a runtime scale or anchor reads the constant bank and copies
//   nothing to local memory.
// - The rows of a scale are contiguous over the whole batch, so a tile of R
//   consecutive rows is one contiguous span of R * (5 + C) values. With R a
//   multiple of 8 every tile of an aligned scale starts on a 16-byte
//   boundary, for any C and both dtypes. A CTA walks tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... through a ring of 2 or 3 stages in dynamic
//   shared memory, filled with 16-byte cp.async: the next tiles' bytes are
//   in flight while this one is computed. The grid is what the card holds
//   at once (occupancy * SMs), not one CTA per tile.
// - A ragged last tile copies its whole 16-byte chunks and fills the few
//   values left by plain loads; a scale whose base is off a 16-byte boundary
//   (a view) fills every tile by plain loads.
// - One thread per row. The thread reads its row from shared memory (row
//   stride 5 + C values: odd for COCO and VOC, so f32 rows fall on distinct
//   banks), keeps max / argmax and the softmax sum in registers (first index
//   wins: the update is on >), and does its own transcendental tail and
//   (image, cell, anchor) index math. No shuffles, no idle lanes.
// - Consecutive threads own consecutive rows, so a warp stores 512 bytes of
//   boxes as float4 and 128 contiguous bytes each of score and label. Each
//   scale writes straight into its row range [row_offset, row_offset +
//   G*G*A) of the caller's (B, total_rows, ...) outputs: no concatenation,
//   and nothing is padded (the TPU kernel padded each scale to its row tile
//   and sank the padded rows with score -1).
// Inputs are f32 or bf16 (templated); all arithmetic is f32, with expf and
// IEEE division as in the plain PyTorch version.
//
// bf16 scoring (score_bf16, sigmoid classes only; a template parameter): the
// TPU package's score_dtype=bfloat16 (heads.decode_scored). The conf and
// class logits are rounded to bf16 and the label is the argmax of the
// rounded logits (first index on ties); the score is
//   bf16(s16(bf16(conf)) * s16(bf16(max logit))),
// with s16(x) = bf16(1 / bf16(1 + bf16(exp(-x)))), the bf16 logistic as XLA
// expands it (a rounding to bf16 after every step). Boxes stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxScales = 4;
constexpr int kMaxAnchors = 16;
constexpr int kMaxThreads = 256;   // also the most rows a tile can hold
constexpr int kMaxStages = 3;
constexpr int kMaxSharedBytes = 227 * 1024;

struct Scale {
  const void* feat;    // (B, G, G, A * (5 + C)) contiguous
  int rows;            // B * G * G * A
  int rows_per_image;  // G * G * A
  int grid;            // G
  int num_anchors;     // A
  int row_offset;      // first output row of this scale within an image
  int first_tile;      // index of the scale's first tile; INT_MAX if unused
  int aligned;         // feat lies on a 16-byte boundary
  float aw[kMaxAnchors];  // anchor widths in grid cells
  float ah[kMaxAnchors];
};

struct Table {
  Scale scale[kMaxScales];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float logistic(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the bf16 logistic of a bf16 value x, rounded to bf16 after each step
__device__ __forceinline__ float logistic_bf16(float x) {
  const float e = bf16_round(expf(-x));
  const float d = bf16_round(1.0f + e);
  return bf16_round(1.0f / d);
}

// a class or conf logit as the scoring reads it: rounded to bf16 in the
// bf16 scoring mode (a no-op for bf16 inputs)
template <bool kBf16Score, typename T>
__device__ __forceinline__ float score_logit(T v) {
  return kBf16Score ? bf16_round(to_float(v)) : to_float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0 or 1) of this thread's copy groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

// which scale a tile belongs to: unused scales have first_tile = INT_MAX
__device__ __forceinline__ int scale_of(const Table& tab, int tile) {
  return (tile >= tab.scale[1].first_tile) + (tile >= tab.scale[2].first_tile)
         + (tile >= tab.scale[3].first_tile);
}

// Start the copy of one tile into a stage. Every thread takes its share.
template <typename T>
__device__ __forceinline__ void fill_stage(const Table& tab, int tile,
                                           int tile_rows, int row_elems,
                                           T* stage) {
  const Scale& sc = tab.scale[scale_of(tab, tile)];
  const int row0 = (tile - sc.first_tile) * tile_rows;
  const int n = min(tile_rows, sc.rows - row0);
  const int elems = n * row_elems;
  const T* src = static_cast<const T*>(sc.feat)
                 + static_cast<int64_t>(row0) * row_elems;
  constexpr int kPerChunk = 16 / sizeof(T);
  const int chunks = sc.aligned ? elems / kPerChunk : 0;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    cp_async16(stage + c * kPerChunk, src + c * kPerChunk);
  }
  for (int e = chunks * kPerChunk + threadIdx.x; e < elems; e += blockDim.x) {
    stage[e] = src[e];
  }
}

template <typename T, bool kBf16Score>
__device__ __forceinline__ void decode_tile(const Table& tab, int tile,
                                            int tile_rows, int num_classes,
                                            int class_softmax, int total_rows,
                                            const T* stage,
                                            float4* __restrict__ boxes,
                                            float* __restrict__ score,
                                            int32_t* __restrict__ label) {
  const Scale& sc = tab.scale[scale_of(tab, tile)];
  const int r = (tile - sc.first_tile) * tile_rows + threadIdx.x;
  if (threadIdx.x >= tile_rows || r >= sc.rows) return;
  const T* x = stage + threadIdx.x * (5 + num_classes);
  const T* logits = x + 5;

  float best = score_logit<kBf16Score>(logits[0]);
  int best_i = 0;
#pragma unroll 4
  for (int c = 1; c < num_classes; ++c) {
    const float v = score_logit<kBf16Score>(logits[c]);
    if (v > best) {  // c rises, so a tie keeps the first class
      best = v;
      best_i = c;
    }
  }
  float prob;
  if (class_softmax) {
    float sum = 0.0f;
#pragma unroll 4
    for (int c = 0; c < num_classes; ++c) {
      sum += expf(to_float(logits[c]) - best);
    }
    prob = 1.0f / sum;
  } else {
    prob = logistic(best);
  }

  const int img = r / sc.rows_per_image;
  const int i = r - img * sc.rows_per_image;
  const int cell = i / sc.num_anchors;
  const int anchor = i - cell * sc.num_anchors;
  const int cy = cell / sc.grid;
  const int cx = cell - cy * sc.grid;
  const float g = static_cast<float>(sc.grid);
  const float bx = (static_cast<float>(cx) + logistic(to_float(x[0]))) / g;
  const float by = (static_cast<float>(cy) + logistic(to_float(x[1]))) / g;
  const float half_w = expf(to_float(x[2])) * sc.aw[anchor] / g * 0.5f;
  const float half_h = expf(to_float(x[3])) * sc.ah[anchor] / g * 0.5f;

  const int64_t out = static_cast<int64_t>(img) * total_rows + sc.row_offset
                      + i;
  boxes[out] = make_float4(bx - half_w, by - half_h, bx + half_w,
                           by + half_h);
  score[out] = kBf16Score && !class_softmax
                   ? bf16_round(logistic_bf16(score_logit<true>(x[4])) *
                                logistic_bf16(best))
                   : logistic(to_float(x[4])) * prob;
  label[out] = best_i;
}

template <typename T, bool kBf16Score>
__global__ void __launch_bounds__(kMaxThreads)
decode_kernel(const __grid_constant__ Table tab,
              float4* __restrict__ boxes, float* __restrict__ score,
              int32_t* __restrict__ label, int num_classes, int class_softmax,
              int tile_rows, int stages, int total_tiles, int total_rows) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* ring = reinterpret_cast<T*>(shared);
  const int row_elems = 5 + num_classes;
  const int stage_elems = tile_rows * row_elems;

  // prologue: the first stages - 1 tiles of this CTA are put in flight
  int next = blockIdx.x;
  for (int s = 0; s < stages - 1; ++s, next += gridDim.x) {
    if (next < total_tiles) {
      fill_stage(tab, next, tile_rows, row_elems, ring + s * stage_elems);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int tile = blockIdx.x; tile < total_tiles;
       tile += gridDim.x, next += gridDim.x) {
    // this tile's group is the oldest of the stages - 1 in flight. After the
    // barrier every thread's share of it has landed, and every thread is
    // done with the stage that the previous iteration decoded, which is the
    // one refilled now.
    cp_async_wait(stages - 2);
    __syncthreads();
    const int refill = stage == 0 ? stages - 1 : stage - 1;
    if (next < total_tiles) {
      fill_stage(tab, next, tile_rows, row_elems, ring + refill * stage_elems);
    }
    cp_async_commit();
    decode_tile<T, kBf16Score>(tab, tile, tile_rows, num_classes,
                               class_softmax, total_rows,
                               ring + stage * stage_elems, boxes, score,
                               label);
    stage = stage + 1 == stages ? 0 : stage + 1;
  }
}

template <typename T, bool kBf16Score>
int launch(const Table& tab, void* boxes, void* score, void* label,
           int num_classes, int class_softmax, int tile_rows, int stages,
           int total_tiles, int total_rows, cudaStream_t stream) {
  const int threads = (tile_rows + 31) / 32 * 32;
  const size_t shared = static_cast<size_t>(stages) * tile_rows
                        * (5 + num_classes) * sizeof(T);
  if (shared > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  // what the card holds at once, asked once per (device, threads, shared)
  static int cached_device = -1, cached_threads = 0, sms = 0, per_sm = 0;
  static size_t cached_shared = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != cached_device || threads != cached_threads
      || shared != cached_shared) {
    cached_device = -1;
    err = cudaFuncSetAttribute(decode_kernel<T, kBf16Score>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_kernel<T, kBf16Score>, threads, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    cached_device = device;
    cached_threads = threads;
    cached_shared = shared;
  }
  const int blocks = min(total_tiles, per_sm * sms);
  decode_kernel<T, kBf16Score><<<blocks, threads, shared, stream>>>(
      tab, static_cast<float4*>(boxes), static_cast<float*>(score),
      static_cast<int32_t*>(label), num_classes, class_softmax, tile_rows,
      stages, total_tiles, total_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode up to 4 head scales in one launch. feats: host array of num_scales
// device pointers, each (batch, grid, grid, num_anchors * (5 + num_classes))
// contiguous, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1). table: host
// array of 6 ints per scale: rows (batch * grid * grid * num_anchors), rows
// per image, grid, num_anchors, row_offset, first_tile; a scale's tiles are
// first_tile .. first_tile + ceil(rows / tile_rows) - 1, in scale order, and
// total_tiles is their count. anchors_wh: host array of the scales' (w, h)
// pairs in grid cells, scale after scale. tile_rows: rows a tile, a multiple
// of 8 up to 256; stages: depth of the shared-memory ring, 2 or 3.
// score_bf16 = 1 scores sigmoid classes in bf16 (see the header; ignored
// with class_softmax = 1). boxes
// (batch, total_rows, 4) f32, score (batch, total_rows) f32 and label (batch,
// total_rows) int32 are written at rows [row_offset, row_offset + grid *
// grid * num_anchors) of every image. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int yolo_decode(const void* const* feats, const int* table,
                           const float* anchors_wh, int num_scales,
                           int num_classes, int class_softmax,
                           int score_bf16, int is_bf16,
                           int tile_rows, int stages, int total_tiles,
                           int total_rows, void* boxes, void* score,
                           void* label, void* stream) {
  if (num_scales < 1 || num_scales > kMaxScales || num_classes < 1
      || tile_rows < 8 || tile_rows > kMaxThreads || tile_rows % 8 != 0
      || stages < 2 || stages > kMaxStages || total_tiles < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab = {};
  const float* wh = anchors_wh;
  for (int s = 0; s < kMaxScales; ++s) {
    Scale& sc = tab.scale[s];
    sc.first_tile = INT_MAX;
    if (s >= num_scales) continue;
    const int* t = table + 6 * s;
    sc.feat = feats[s];
    sc.rows = t[0];
    sc.rows_per_image = t[1];
    sc.grid = t[2];
    sc.num_anchors = t[3];
    sc.row_offset = t[4];
    sc.first_tile = t[5];
    sc.aligned = reinterpret_cast<uintptr_t>(sc.feat) % 16 == 0;
    if (sc.num_anchors < 1 || sc.num_anchors > kMaxAnchors || sc.grid < 1
        || sc.rows_per_image < 1 || sc.rows < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int k = 0; k < sc.num_anchors; ++k, wh += 2) {
      sc.aw[k] = wh[0];
      sc.ah[k] = wh[1];
    }
  }
  if (total_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16_score = score_bf16 && !class_softmax;
  if (is_bf16) {
    return bf16_score
               ? launch<__nv_bfloat16, true>(tab, boxes, score, label,
                                             num_classes, class_softmax,
                                             tile_rows, stages, total_tiles,
                                             total_rows, s)
               : launch<__nv_bfloat16, false>(tab, boxes, score, label,
                                              num_classes, class_softmax,
                                              tile_rows, stages, total_tiles,
                                              total_rows, s);
  }
  return bf16_score
             ? launch<float, true>(tab, boxes, score, label, num_classes,
                                   class_softmax, tile_rows, stages,
                                   total_tiles, total_rows, s)
             : launch<float, false>(tab, boxes, score, label, num_classes,
                                    class_softmax, tile_rows, stages,
                                    total_tiles, total_rows, s);
}
