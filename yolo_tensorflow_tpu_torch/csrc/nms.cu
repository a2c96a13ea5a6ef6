// The whole NMS stage of a batch in one kernel, for Hopper (sm_90a): exact
// top-K candidate selection, their ranking and the greedy walk.
//
// Replaces, of yolo_tensorflow_tpu/post/nms.py's _nms_single: the top-K
// candidates (lax.approx_max_k / lax.top_k, :144-146), the greedy fixpoint
// _greedy_keep (:103), a lax.while_loop over the K x K IoU matrix, and the
// final lax.top_k to max_detections (:167). On the TPU that was XLA, not a
// Pallas kernel. Per image, from the unranked decode (boxes, scores,
// labels of N rows):
//   active[i] = score[i] > conf (NaN never is);
//   the K = min(num_candidates, N) candidates are the first K of the
//   active ones in (score descending, index ascending) order: lax.top_k's
//   order of the masked scores, a stable sort's, with -0.0 equal to +0.0;
//   ranks past the active ones are inactive fill that is never kept;
//   keep[r] = no kept r' < r overlaps r,
//   overlap(r', r) = (class_aware and label[r'] != label[r] ? 0 : iou) > thr,
// the sequential greedy that the fixpoint converges to. The output is the
// first D kept candidates in rank order, then zeros and valid = false.
//
// Bound: bytes, then the launch. An image needs its N scores (4 N bytes),
// the boxes and labels of its selected candidates (20 bytes each) and writes
// D * 25 + 4 bytes: at yolov3-416 (N = 10647, K = 256, D = 20) and batch
// 64, 3.1 MB, about 1 us at 3.35 TB/s; the IoUs (at most K^2 / 2 of ~15
// f32 operations) are less. A launch costs about 2 us, and one CTA does an
// image's work alone, so what sets the time is each CTA's chain of
// dependent steps: device-memory latency (the scores, then the selected
// boxes), the barriers between the phases, and the greedy chain. The
// design keeps the stage one launch, reads each score once and each
// selected box once, and keeps the chain short: no sort of N, no step per
// dead rank, a few barriers per 32 ranks walked.
//
// Design, one CTA of kThreads an image:
// - Keys. Each warp owns a contiguous segment of the image's N scores
//   (coalesced reads, and index order is segment order), loaded kBatch at a
//   time a lane. A score becomes a 32-bit key that orders like it (sign
//   bit set for x >= 0, all bits flipped for x < 0; -0.0 first becomes
//   +0.0); an inactive one becomes 0, below every active key. The pass
//   counts the active ones (A) and ANDs and ORs their keys, so the bits
//   that vary among them are known. Where the keys fit beside the rest
//   they are staged in shared memory (43 KB at N = 10647, 91 KB at 22743);
//   otherwise every pass recomputes them from the scores, which L2 holds.
// - Selection. A <= K: every active key. Otherwise a radix select finds
//   the K-th largest key T in 8-bit digits over the varying bits only
//   (scores in (0.5, 1) share their top 9 bits, bf16 ones their low 16:
//   1 to 3 passes, not 4), each pass a 256-bin histogram per warp in
//   shared memory, summed and scanned by one warp; it stops early where
//   the chosen bin holds just the keys still wanted. Selected: every key
//   above T, and the first K - #(above T) keys equal to T in index order,
//   counted per warp segment, which is what lax.top_k and the stable sort
//   do with ties (bf16 scores tie often). Each warp knows from its counts
//   where its selected (key, index) pairs go: no atomic slots.
// - Ranking. Only the S = min(A, K) selected are ranked: each counts the
//   pairs ahead of it (64-bit compares; a thread takes two, a few lanes
//   share the count). Its box, label and score are loaded from device
//   memory before the count and stored into its rank after it.
// - The greedy walk goes through the ranks 32 at a time. A window's ranks
//   are tested in parallel against the candidates kept before it and
//   against each other, a warp ballot a row of 32; then one thread runs
//   the greedy chain through the window on those bitmasks in registers.
//   Two barriers a window, no step for a dead rank, and it stops at the
//   D-th kept candidate.
// - Where the candidates (36 bytes each) and the staged keys do not fit a
//   CTA's 227 KB, the candidates live in scratch that the caller gives,
//   (B, K) of each array, and the keys are recomputed each pass: any N and
//   K run, and any D whose kept list fits beside the histograms.
//
// Exactness: iou > thr decides as the plain version's does only if the IoU
// rounds the same, so it is written with round-to-nearest intrinsics in
// iou_matrix's order (area = max(x1-x0,0) * max(y1-y0,0), union = (area_i +
// area_j) - inter, inter / max(union, 1e-9)): nvcc would otherwise contract
// a product and a sum into one fma. min, max and the clamps keep a NaN, as
// torch.maximum and torch.clamp do (inf-sized boxes give NaN unions). The
// outputs are the input's own bits (a kept -0.0 stays -0.0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kBins = 256;                         // an 8-bit radix digit
// a candidate in shared memory or scratch: box (float4), selection pair
// (64-bit key and index), area, score and label
constexpr int kBytesPerCandidate = 16 + 8 + 4 + 4 + 4;
// a staged key
constexpr int kBytesPerScore = 4;
// the warps' histograms, their counts and the block's scalars
constexpr int kFixedBytes = kBins * kWarps * 4 + 2 * kWarps * 4 + 8 * 4;
constexpr int kBatch = 8;                          // loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;

enum Scalar { kActive, kAnd, kOr, kDigit, kAbove, kFits, kKept, kDead };

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

// 0 for an inactive score (NaN included); else a key > 0 that orders as
// the score, -0.0 equal to +0.0
__device__ __forceinline__ uint32_t score_key(float s, float conf) {
  if (!(s > conf)) return 0u;
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the candidates' arrays of one image, in shared memory or in scratch
struct Candidates {
  float4* box;
  unsigned long long* pair;          // key << 32 | ~index: larger ranks first
  float* area;
  float* score;
  int32_t* label;
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int32_t* __restrict__ labels, int n, int k, int max_det,
    float conf, float iou_thr, int class_aware,
    unsigned char* __restrict__ scratch, float4* __restrict__ out_boxes,
    float* __restrict__ out_scores, int32_t* __restrict__ out_labels,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ out_num) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  Candidates c;
  unsigned char* p = smem;
  uint32_t* skeys = nullptr;
  if (kStaged) {
    c.box = reinterpret_cast<float4*>(p);
    c.pair = reinterpret_cast<unsigned long long*>(c.box + k);
    c.area = reinterpret_cast<float*>(c.pair + k);
    c.score = c.area + k;
    c.label = reinterpret_cast<int32_t*>(c.score + k);
    skeys = reinterpret_cast<uint32_t*>(c.label + k);
    p = reinterpret_cast<unsigned char*>(skeys + n);
  } else {
    const size_t bk = static_cast<size_t>(gridDim.x) * k;
    const size_t at = static_cast<size_t>(img) * k;
    c.box = reinterpret_cast<float4*>(scratch) + at;
    c.pair = reinterpret_cast<unsigned long long*>(
        reinterpret_cast<float4*>(scratch) + bk) + at;
    c.area = reinterpret_cast<float*>(
        reinterpret_cast<unsigned long long*>(
            reinterpret_cast<float4*>(scratch) + bk) + bk) + at;
    c.score = c.area + bk;
    c.label = reinterpret_cast<int32_t*>(c.score + bk);
  }
  int32_t* kept_rank = reinterpret_cast<int32_t*>(p);
  uint32_t* hist = reinterpret_cast<uint32_t*>(kept_rank + max_det);
  uint32_t* warp_count = hist + kBins * kWarps;
  uint32_t* scalar = warp_count + 2 * kWarps;

  const float* img_scores = scores + static_cast<size_t>(img) * n;
  // this warp's segment of the scores, a multiple of 32 long
  const int seg = (n + kThreads - 1) / kThreads * 32;
  const int seg_lo = warp * seg;
  const int seg_hi = min(n, seg_lo + seg);
  auto key_at = [&](int i) -> uint32_t {
    if (i >= seg_hi) return 0u;
    return kStaged ? skeys[i] : score_key(img_scores[i], conf);
  };

  // [stamp:0]
  if (tid == 0) {
    scalar[kActive] = 0u;
    scalar[kAnd] = kFull;
    scalar[kOr] = 0u;
    scalar[kDead] = 0u;
  }
  for (int b = tid; b < kBins * kWarps; b += kThreads) hist[b] = 0u;
  __syncthreads();

  // keys: count the active ones, AND and OR their keys. A lane's loads are
  // issued kBatch at a time, so that they are in flight together.
  {
    uint32_t count = 0u, all = kFull, any = 0u;
    for (int i0 = seg_lo + lane; i0 < seg_lo + seg; i0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u;
        v[u] = i < seg_hi ? img_scores[i] : conf;        // conf: inactive
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u;
        const uint32_t key = score_key(v[u], conf);
        if (kStaged && i < seg_hi) skeys[i] = key;
        if (key) {
          ++count;
          all &= key;
          any |= key;
        }
      }
    }
    count = __reduce_add_sync(kFull, count);
    all = __reduce_and_sync(kFull, all);
    any = __reduce_or_sync(kFull, any);
    if (lane == 0) {                     // the compaction's, where A <= K
      warp_count[warp] = count;
      warp_count[kWarps + warp] = 0u;
    }
    if (lane == 0 && count) {
      atomicAdd(&scalar[kActive], count);
      atomicAnd(&scalar[kAnd], all);
      atomicOr(&scalar[kOr], any);
    }
  }
  __syncthreads();
  // [stamp:1]

  // selection: every key above `threshold`, and the first `need_equal` keys
  // equal to it in index order
  const uint32_t active = scalar[kActive];
  uint32_t threshold = 0u, need_equal = 0u;
  if (active > static_cast<uint32_t>(k)) {
    const uint32_t vary = scalar[kAnd] ^ scalar[kOr];
    uint32_t prefix = scalar[kAnd], decided = ~vary;
    uint32_t remaining = static_cast<uint32_t>(k);
    if (vary) {
      const int lo = __ffs(vary) - 1;
      int shift = 32 - __clz(vary);
      uint32_t* mine = hist + warp * kBins;        // this warp's histogram
      while (shift > lo) {
        const int width = min(8, shift - lo);
        shift -= width;
        const uint32_t digit = ((1u << width) - 1u) << shift;
#pragma unroll 4
        for (int i = seg_lo + lane; i < seg_lo + seg; i += 32) {
          const uint32_t key = key_at(i);
          if (key && ((key ^ prefix) & decided) == 0u) {
            atomicAdd(&mine[(key & digit) >> shift], 1u);
          }
        }
        __syncthreads();
        for (int b = tid; b < kBins; b += kThreads) {    // into warp 0's
          uint32_t sum = hist[b];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) {
            sum += hist[w * kBins + b];
            hist[w * kBins + b] = 0u;                    // the next pass's
          }
          hist[b] = sum;
        }
        __syncthreads();
        if (warp == 0) {
          // lane l holds bins 8l .. 8l + 7; find the bin where the count
          // from the top reaches `remaining`
          uint32_t h[8], sum = 0u;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            h[q] = hist[lane * 8 + q];
            hist[lane * 8 + q] = 0u;
            sum += h[q];
          }
          uint32_t upto = sum;                     // lanes >= this one
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t v = __shfl_down_sync(kFull, upto, o);
            if (lane + o < 32) upto += v;
          }
          const uint32_t above = upto - sum;
          const unsigned hit = __ballot_sync(
              kFull, above < remaining && remaining <= upto);
          if (lane == __ffs(hit) - 1) {
            uint32_t a = above, bin = 0u, in_bin = 0u;
            bool found = false;
#pragma unroll
            for (int q = 7; q >= 0; --q) {
              if (!found) {
                if (a + h[q] >= remaining) {
                  bin = static_cast<uint32_t>(lane * 8 + q);
                  in_bin = h[q];
                  found = true;
                } else {
                  a += h[q];
                }
              }
            }
            scalar[kDigit] = bin;
            scalar[kAbove] = a;
            scalar[kFits] = a + in_bin == remaining;
          }
        }
        __syncthreads();
        remaining -= scalar[kAbove];
        prefix = (prefix & ~digit) | (scalar[kDigit] << shift);
        decided |= digit;
        if (scalar[kFits]) {
          // the bin holds just the keys still wanted: every key from
          // `prefix` up (its undecided bits are 0) is taken
          prefix -= 1u;
          remaining = 0u;
          break;
        }
      }
    }
    threshold = prefix;
    need_equal = remaining;
  }

  // [stamp:2]
  // compaction of the selected (key, index) pairs: each warp counts its
  // keys above the threshold and equal to it, so that it knows where its
  // pairs go and how many of its equal keys are taken (the first
  // `need_equal` in index order)
  if (active > static_cast<uint32_t>(k)) {
    uint32_t gt = 0u, eq = 0u;
#pragma unroll 4
    for (int i = seg_lo + lane; i < seg_lo + seg; i += 32) {
      const uint32_t key = key_at(i);
      gt += key > threshold;
      eq += need_equal > 0u && key == threshold;
    }
    gt = __reduce_add_sync(kFull, gt);
    eq = __reduce_add_sync(kFull, eq);
    if (lane == 0) {
      warp_count[warp] = gt;
      warp_count[kWarps + warp] = eq;
    }
    __syncthreads();
  }
  uint32_t slot = 0u, equal_seen = 0u;
  for (int w = 0; w < warp; ++w) {
    const uint32_t eq = warp_count[kWarps + w];
    slot += warp_count[w]
            + (equal_seen < need_equal ? min(eq, need_equal - equal_seen)
                                       : 0u);
    equal_seen += eq;
  }
  for (int i = seg_lo + lane; i < seg_lo + seg; i += 32) {
    const uint32_t key = key_at(i);
    const bool eq = need_equal > 0u && key == threshold;
    const unsigned eqs = __ballot_sync(kFull, eq);
    const bool take = key > threshold
        || (eq && equal_seen + __popc(eqs & lanes_below) < need_equal);
    equal_seen += __popc(eqs);
    const unsigned takes = __ballot_sync(kFull, take);
    if (take) {
      c.pair[slot + __popc(takes & lanes_below)] =
          (static_cast<unsigned long long>(key) << 32)
          | static_cast<uint32_t>(~i);
    }
    slot += __popc(takes);
  }
  __syncthreads();
  // [stamp:3]

  // rank the S selected: a thread takes two of them (one load of each
  // pair ahead serves both), `parts` lanes share the pairs to count; each
  // one's box, label and score are loaded before the count, then stored
  // into its rank
  const int selected = static_cast<int>(
      min(active, static_cast<uint32_t>(k)));
  const int halves = (selected + 1) / 2;
  int parts = 1;
  while (parts < 32 && halves * parts * 2 <= kThreads) parts *= 2;
  const int part = lane & (parts - 1);
  const unsigned group = parts == 32
      ? kFull : ((1u << parts) - 1u) << (lane & ~(parts - 1));
  for (int e = tid / parts; e < halves; e += kThreads / parts) {
    unsigned long long mine[2];
    float4 box[2];
    float score[2];
    int32_t label[2];
    int rank[2] = {0, 0};
    const bool two = e + halves < selected;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      mine[t] = t == 0 || two ? c.pair[e + t * halves] : ~0ull;
      if (part == 0 && (t == 0 || two)) {
        const int i = static_cast<int>(~static_cast<uint32_t>(mine[t]));
        const float* b = boxes + (static_cast<size_t>(img) * n + i) * 4;
        box[t] = make_float4(b[0], b[1], b[2], b[3]);
        score[t] = img_scores[i];
        label[t] = labels[static_cast<size_t>(img) * n + i];
      }
    }
#pragma unroll 4
    for (int f = part; f < selected; f += parts) {
      const unsigned long long other = c.pair[f];
      rank[0] += other > mine[0];
      rank[1] += other > mine[1];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      for (int o = parts / 2; o > 0; o /= 2) {
        rank[t] += __shfl_xor_sync(group, rank[t], o);
      }
      if (part == 0 && (t == 0 || two)) {
        c.box[rank[t]] = box[t];
        c.area[rank[t]] = box_area(box[t]);
        c.score[rank[t]] = score[t];
        c.label[rank[t]] = label[t];
      }
    }
  }
  __syncthreads();
  // [stamp:4]

  // the greedy walk, a window of 32 ranks at a time. The window's ranks
  // are tested in parallel against the candidates kept before it (a warp a
  // kept one) and against each other (a warp a row); one thread then runs
  // the greedy chain through the window in its registers.
  int kept = 0;
  uint32_t* rows = hist;                             // 32 words, free now
  for (int q = 0; q * 32 < selected && kept < max_det; ++q) {
    const int left = selected - q * 32;
    const uint32_t members = left >= 32 ? kFull : (1u << left) - 1u;
    const int j = q * 32 + lane;
    for (int t = warp; t < 32 + kept; t += kWarps) {
      // t < 32: the window's rank q * 32 + t; else the (t - 32)-th kept
      const int r = t < 32 ? q * 32 + t : kept_rank[t - 32];
      bool hit = false;
      if ((members >> lane & 1u)
          && (t >= 32 || ((members >> t & 1u) && lane > t))) {
        const float v = (class_aware && c.label[r] != c.label[j])
                            ? 0.0f : iou(c.box[r], c.area[r], c.box[j],
                                         c.area[j]);
        hit = v > iou_thr;
      }
      const unsigned row = __ballot_sync(kFull, hit);
      if (lane == 0) {
        if (t < 32) {
          rows[t] = row;
        } else if (row) {
          atomicOr(&scalar[kDead], row);
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t row[32], removed = scalar[kDead];
      int now = kept;
#pragma unroll
      for (int i = 0; i < 32; ++i) row[i] = rows[i];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (now < max_det && (members >> i & 1u) && !(removed >> i & 1u)) {
          kept_rank[now++] = q * 32 + i;
          removed |= row[i];
        }
      }
      scalar[kKept] = static_cast<uint32_t>(now);
      scalar[kDead] = 0u;
    }
    __syncthreads();                   // also publishes kept_rank's entries
    kept = static_cast<int>(scalar[kKept]);
  }

  // [stamp:5]
  const size_t out = static_cast<size_t>(img) * max_det;
  for (int s = tid; s < max_det; s += kThreads) {
    if (s < kept) {
      const int r = kept_rank[s];
      out_boxes[out + s] = c.box[r];
      out_scores[out + s] = c.score[r];
      out_labels[out + s] = c.label[r];
      out_valid[out + s] = 1;
    } else {
      out_boxes[out + s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      out_scores[out + s] = 0.0f;
      out_labels[out + s] = 0;
      out_valid[out + s] = 0;
    }
  }
  if (tid == 0) out_num[img] = kept;
  // [stamp:6]
}

size_t streamed_bytes(int max_det) {
  return 4 * static_cast<size_t>(max_det) + kFixedBytes;
}

size_t staged_bytes(int n, int k, int max_det) {
  return static_cast<size_t>(k) * kBytesPerCandidate
         + static_cast<size_t>(n) * kBytesPerScore + streamed_bytes(max_det);
}

// above 48 KB a kernel must ask for its dynamic shared memory, once per
// device and instance
template <bool kStaged>
cudaError_t allow_shared(size_t shared) {
  static int raised_on = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || shared <= 48 * 1024 || device == raised_on) {
    return err;
  }
  err = cudaFuncSetAttribute(nms_kernel<kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err == cudaSuccess) raised_on = device;
  return err;
}

}  // namespace

// NMS of `batch` images of `n` decoded rows each: boxes (batch, n, 4) f32
// xyxy, scores (batch, n) f32 and labels (batch, n) int32, contiguous and
// in any order. `num_candidates` is K = min(num_candidates, n) (1 <= K <=
// n, or 0 when n is 0). Writes the first `max_detections` (D >= 1) kept
// candidates of every image in rank order: out_boxes (batch, D, 4) f32
// (16-byte aligned), out_scores (batch, D) f32, out_labels (batch, D)
// int32, out_valid (batch, D) bytes of 0 or 1 (torch.bool) and out_num
// (batch,) int32, zeros past the kept ones. Where the staged layout (K * 36
// + n * 4 + D * 4 + kFixedBytes) passes a CTA's shared memory, `scratch`
// must hold batch * K * 36 bytes, 16-byte aligned; else it is not read.
// Launches on `stream` and returns cudaGetLastError();
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int yolo_nms(const void* boxes, const void* scores,
                        const void* labels, int batch, int n,
                        int num_candidates, int max_detections,
                        float conf_threshold, float iou_threshold,
                        int class_aware, void* scratch, void* out_boxes,
                        void* out_scores, void* out_labels, void* out_valid,
                        void* out_num, void* stream) {
  if (batch < 0 || n < 0 || num_candidates < 0 || num_candidates > n
      || (n > 0 && num_candidates < 1) || max_detections < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = staged_bytes(n, num_candidates, max_detections)
                      <= kMaxSharedBytes;
  const size_t shared = staged
      ? staged_bytes(n, num_candidates, max_detections)
      : streamed_bytes(max_detections);
  if (shared > kMaxSharedBytes || (!staged && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaError_t err = staged ? allow_shared<true>(shared)
                           : allow_shared<false>(shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = staged ? nms_kernel<true> : nms_kernel<false>;
  kernel<<<batch, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const int32_t*>(labels), n, num_candidates,
      max_detections, conf_threshold, iou_threshold, class_aware,
      static_cast<unsigned char*>(scratch), static_cast<float4*>(out_boxes),
      static_cast<float*>(out_scores), static_cast<int32_t*>(out_labels),
      static_cast<uint8_t*>(out_valid), static_cast<int32_t*>(out_num));
  return static_cast<int>(cudaGetLastError());
}
