// 3x3 stride-1 convolution with the batch-norm batch statistics fused into
// its epilogue, for Hopper (sm_90a): an implicit GEMM that writes the conv
// output and, per output channel, the sum and the sum of squares of the f32
// accumulator over every output pixel of the batch.
//
// Replaces the Pallas TPU kernel tools/probe_conv_bnstat.py:47
// (pallas_conv3x3_bnstat):
//   acc[b, y, x, o] = sum over (ky, kx, c) of x[b, y + ky - 1, x + kx - 1, c]
//                                             * w[o, ky, kx, c]     f32
//   y   = acc rounded to the input dtype (bf16 or f32)
//   sum[o] = sum of acc over (b, y, x);  sq[o] = sum of acc * acc     f32
// The training forward (models/engine.TrainNetwork) runs it for every 3x3
// stride-1 BN conv; sum and sq are the inputs of the BN batch mean and the
// onepass variance. The probe's padded flat layout, halo windows and pad-row
// mask are artifacts of the TPU shift trick: here the GEMM runs over real
// output pixels only, so no mask exists. Rows past the last pixel and
// columns past the last channel gather zeros, whose accumulators are exactly
// 0, so the sums need no masking either.
//
// Bound. At yolov3-416, batch 32, bf16, the 33 such convs do 1.64 TFLOP.
// Taking each conv at the larger of its operations at the H100's 989 TFLOP/s
// dense bf16 and its bytes (input read once, weights, output written once)
// at 3.35 TB/s, the bound is 1.80 ms summed: operations bound except the
// first conv (Cin = 3) and the 208^2 one (Cin = 32), which are bytes bound.
//
// Design (a first, simple kernel: mma.sync without a pipeline; wgmma, TMA and
// cp.async pipelining are later work):
// - GEMM view: M = batch*H*W output pixels, N = Cout, K = 9*Cin in
//   (ky, kx, c) order. x is NHWC, w is OIHW in channels-last memory, i.e.
//   (Cout, 3, 3, Cin) bytes, so each output channel's K is contiguous.
// - bf16: one CTA of 8 warps per 128 x 128 output tile, K steps of 32
//   elements; each warp owns 64 x 32 of the tile as 4 x 4 mma.sync
//   m16n8k16 bf16 -> f32 products per 16 of K. Shared rows are padded to 80
//   bytes so that the fragment loads hit 32 distinct banks. Cin % 8 == 0
//   gathers 8 channels per 16-byte load; Cin = 3 (the first conv) gathers
//   element by element and zero-fills K = 27 up to the 32 of one step.
// - f32: the same tiles with scalar FFMA (the tensor cores' TF32 would not
//   hold the f32 training step to the CPU's float32): K steps of 16, tiles
//   staged K-major, each thread owns an 8 x 8 strided sub-tile.
// - Stats: each CTA reduces its tile's columns in registers, across lanes by
//   shuffles and across warps in shared memory, in a fixed order, into one
//   row of a (num_M_tiles, Cout) partials buffer per statistic. A second
//   kernel sums each column of the partials in a fixed order in double and
//   rounds once to f32. No float atomics: the run is deterministic.
// - CTAs are numbered N tile fastest, so the CTAs that share an A tile run
//   together and find it in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                 // output pixels per CTA
constexpr int kBN = 128;                 // output channels per CTA
constexpr int kThreads = 256;
// bf16 tiles: K step of 32 elements (64 bytes), rows padded to 40 elements
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;
// f32 tiles: K step of 16, staged K-major, rows padded by 4
constexpr int kBKf = 16;
constexpr int kLdf = kBM + 4;
constexpr int kReduceX = 32;             // channels per reduce CTA
constexpr int kReduceY = 16;             // tile strides per reduce CTA

struct Conv {
  const void* x;        // (batch, h, w, cin)
  const void* wt;       // (cout, 3, 3, cin)
  void* y;              // (batch, h, w, cout)
  float* part_sum;      // (m_tiles, cout)
  float* part_sq;       // (m_tiles, cout)
  int h, w, cin, cout;
  int m, kdim, n_tiles;
};

// The pixel a GEMM row m reads from: its image's first pixel and its output
// coordinates less the padding. Rows past the end read nothing.
struct Row {
  int pix, iy0, ix0;
};

__device__ __forceinline__ Row row_of(const Conv& p, int m) {
  Row r;
  if (m < p.m) {
    const int hw = p.h * p.w;
    const int b = m / hw;
    const int rem = m - b * hw;
    const int oy = rem / p.w;
    r.pix = b * hw;
    r.iy0 = oy - 1;
    r.ix0 = rem - oy * p.w - 1;
  } else {
    r.pix = 0;
    r.iy0 = -(1 << 28);                  // never in bounds: gathers zeros
    r.ix0 = 0;
  }
  return r;
}

// Input offset of K index kk for row r, or -1 in the zero padding or past K.
__device__ __forceinline__ int64_t src_of(const Conv& p, const Row& r,
                                          int kk) {
  if (kk >= p.kdim) return -1;
  const int kw_cin = 3 * p.cin;
  const int ky = kk / kw_cin;
  const int rem = kk - ky * kw_cin;
  const int kx = rem / p.cin;
  const int c = rem - kx * p.cin;
  const int iy = r.iy0 + ky;
  const int ix = r.ix0 + kx;
  if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) return -1;
  return static_cast<int64_t>(r.pix + iy * p.w + ix) * p.cin + c;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sum of the warps' column partials red[warp][col] in warp order, written as
// the CTA's row of the partials buffer.
template <int kWarps>
__device__ __forceinline__ void write_partials(const Conv& p,
                                               float (*red_sum)[kBN],
                                               float (*red_sq)[kBN],
                                               int m_tile, int n0) {
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kBN && n0 + col < p.cout) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      s += red_sum[i][col];
      q += red_sq[i][col];
    }
    const int64_t at = static_cast<int64_t>(m_tile) * p.cout + n0 + col;
    p.part_sum[at] = s;
    p.part_sq[at] = q;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_bnstat_bf16(const Conv p) {
  __shared__ __align__(16) bf16 a_s[kBM * kLd];
  __shared__ __align__(16) bf16 b_s[kBN * kLd];
  __shared__ float red_sum[2][kBN];
  __shared__ float red_sq[2][kBN];

  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.wt);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;               // mma groupID
  const int t = lane & 3;                // mma threadID_in_group
  const int wm = warp >> 2;              // warp's 64-row slice
  const int wn = warp & 3;               // warp's 32-column slice
  const int m_tile = static_cast<int>(blockIdx.x / p.n_tiles);
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * kBN;
  const int m0 = m_tile * kBM;

  // A: rows tid / 4 and tid / 4 + 64, 8-element chunk tid % 4 of each
  const int chunk = tid & 3;
  Row rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = row_of(p, m0 + (tid >> 2) + i * 64);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  for (int k0 = 0; k0 < p.kdim; k0 += kBK) {
    const int kk = k0 + chunk * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kVec) {
        // Cin % 8 == 0: the chunk's 8 channels share one (ky, kx)
        const int64_t at = src_of(p, rows[i], kk);
        if (at >= 0) v = __ldg(reinterpret_cast<const uint4*>(x + at));
      } else {
        alignas(16) bf16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int64_t at = src_of(p, rows[i], kk + j);
          e[j] = at >= 0 ? x[at] : __float2bfloat16_rn(0.0f);
        }
        v = *reinterpret_cast<const uint4*>(e);
      }
      *reinterpret_cast<uint4*>(
          &a_s[((tid >> 2) + i * 64) * kLd + chunk * 8]) = v;
    }
    // B: weights (cout, K), 8 elements per chunk, 2 chunks per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      const int n = id >> 2;
      const int kc = (id & 3) * 8;
      const int gn = n0 + n;
      const int gk = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < p.cout) {
        const bf16* src = w + static_cast<int64_t>(gn) * p.kdim + gk;
        if (kVec) {
          if (gk < p.kdim) v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          alignas(16) bf16 e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            e[j] = gk + j < p.kdim ? src[j] : __float2bfloat16_rn(0.0f);
          }
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(&b_s[n * kLd + kc]) = v;
    }
    __syncthreads();

    // fragments per the PTX ISA's m16n8k16 .bf16 layout
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* r0 = &a_s[(wm * 64 + mi * 16 + g) * kLd + ks + 2 * t];
        const bf16* r8 = r0 + 8 * kLd;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r8);
        af[mi][2] = lds32(r0 + 8);
        af[mi][3] = lds32(r8 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* c0 = &b_s[(wn * 32 + ni * 8 + g) * kLd + ks + 2 * t];
        bfr[ni][0] = lds32(c0);
        bfr[ni][1] = lds32(c0 + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // epilogue: c[0..1] are row g, columns 2t and 2t+1; c[2..3] row g + 8
  bf16* y = static_cast<bf16*>(p.y);
  const bool even = (p.cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        s0 += v0;
        s1 += v1;
        q0 = __fmaf_rn(v0, v0, q0);
        q1 = __fmaf_rn(v1, v1, q1);
        const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (m >= p.m || n >= p.cout) continue;
        bf16* dst = y + static_cast<int64_t>(m) * p.cout + n;
        const bf16 y0 = __float2bfloat16_rn(v0);
        if (n + 1 < p.cout) {
          const bf16 y1 = __float2bfloat16_rn(v1);
          if (even) {
            __nv_bfloat162 pair;
            pair.x = y0;
            pair.y = y1;
            *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
          } else {
            dst[0] = y0;
            dst[1] = y1;
          }
        } else {
          dst[0] = y0;
        }
      }
    }
    // the 8 lanes of one t share the columns: butterfly over g
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (g == 0) {
      const int col = wn * 32 + ni * 8 + 2 * t;
      red_sum[wm][col] = s0;
      red_sum[wm][col + 1] = s1;
      red_sq[wm][col] = q0;
      red_sq[wm][col + 1] = q1;
    }
  }
  write_partials<2>(p, red_sum, red_sq, m_tile, n0);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_bnstat_f32(const Conv p) {
  __shared__ __align__(16) float a_s[kBKf * kLdf];
  __shared__ __align__(16) float b_s[kBKf * kLdf];
  __shared__ float red_sum[kThreads / 32][kBN];
  __shared__ float red_sq[kThreads / 32][kBN];

  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.wt);
  const int tid = threadIdx.x;
  const int tx = tid & 15;               // owns columns tx + 16 j
  const int ty = tid >> 4;               // owns rows ty + 16 i
  const int m_tile = static_cast<int>(blockIdx.x / p.n_tiles);
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * kBN;
  const int m0 = m_tile * kBM;

  // staging: every thread gathers row (and weight row) tid % 128, K chunks
  // of 4 numbered tid / 128 and tid / 128 + 2
  const int srow = tid & (kBM - 1);
  const Row row = row_of(p, m0 + srow);
  const int gn = n0 + srow;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.kdim; k0 += kBKf) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int kc = ((tid >> 7) + 2 * pass) * 4;
      const int kk = k0 + kc;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kVec) {
        // Cin % 4 == 0: the chunk's 4 channels share one (ky, kx)
        const int64_t at = src_of(p, row, kk);
        if (at >= 0) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(x + at));
          a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
        }
        if (gn < p.cout && kk < p.kdim) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              w + static_cast<int64_t>(gn) * p.kdim + kk));
          b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t at = src_of(p, row, kk + j);
          if (at >= 0) a[j] = x[at];
          if (gn < p.cout && kk + j < p.kdim) {
            b[j] = w[static_cast<int64_t>(gn) * p.kdim + kk + j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_s[(kc + j) * kLdf + srow] = a[j];
        b_s[(kc + j) * kLdf + srow] = b[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKf; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a_s[k * kLdf + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b_s[k * kLdf + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j],
                                                          acc[i][j]);
    }
    __syncthreads();
  }

  float* y = static_cast<float*>(p.y);
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = acc[i][j];
      s += v;
      q = __fmaf_rn(v, v, q);
      const int m = m0 + ty + 16 * i;
      if (m < p.m && n < p.cout) y[static_cast<int64_t>(m) * p.cout + n] = v;
    }
    // lanes tx and tx + 16 of a warp hold the same column
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    if ((tid & 31) < 16) {
      red_sum[warp][tx + 16 * j] = s;
      red_sq[warp][tx + 16 * j] = q;
    }
  }
  write_partials<kThreads / 32>(p, red_sum, red_sq, m_tile, n0);
}

// Column sums of the (tiles, cout) partials, in double, in a fixed order:
// thread (cx, cy) sums tiles cy, cy + kReduceY, ... of channel c0 + cx, then
// thread cy = 0 sums the kReduceY results in order.
__global__ void __launch_bounds__(kReduceX * kReduceY)
bnstat_reduce(const float* part_sum, const float* part_sq, float* sum,
              float* sq, int tiles, int cout) {
  __shared__ double red_s[kReduceY][kReduceX];
  __shared__ double red_q[kReduceY][kReduceX];
  const int cx = threadIdx.x;
  const int cy = threadIdx.y;
  const int c = blockIdx.x * kReduceX + cx;
  double s = 0.0, q = 0.0;
  if (c < cout) {
    for (int i = cy; i < tiles; i += kReduceY) {
      s += part_sum[static_cast<int64_t>(i) * cout + c];
      q += part_sq[static_cast<int64_t>(i) * cout + c];
    }
  }
  red_s[cy][cx] = s;
  red_q[cy][cx] = q;
  __syncthreads();
  if (cy == 0 && c < cout) {
    double ts = 0.0, tq = 0.0;
    for (int i = 0; i < kReduceY; ++i) {
      ts += red_s[i][cx];
      tq += red_q[i][cx];
    }
    sum[c] = static_cast<float>(ts);
    sq[c] = static_cast<float>(tq);
  }
}

}  // namespace

// Number of M tiles, i.e. rows of the partials buffers, for batch*h*w pixels.
extern "C" int yolo_conv3x3_bnstat_tiles(int batch, int h, int w) {
  const int64_t m = static_cast<int64_t>(batch) * h * w;
  return static_cast<int>((m + kBM - 1) / kBM);
}

// One 3x3 stride-1 SAME convolution and its per-channel sums. x: (batch, h,
// w, cin) contiguous; wt: (cout, 3, 3, cin) contiguous; y: (batch, h, w,
// cout) contiguous; all f32 (is_bf16 = 0) or all bf16 (1). part_sum and
// part_sq: scratch of yolo_conv3x3_bnstat_tiles(batch, h, w) * cout floats
// each. sum, sq: (cout,) f32 outputs. vec = 1 requires cin % 8 == 0 (bf16)
// or cin % 4 == 0 (f32) and x and wt 16-byte aligned. Launches both kernels
// on `stream` and returns cudaGetLastError().
extern "C" int yolo_conv3x3_bnstat(const void* x, const void* wt, void* y,
                                   float* part_sum, float* part_sq,
                                   float* sum, float* sq, int is_bf16,
                                   int batch, int h, int w, int cin, int cout,
                                   int vec, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 1 || cout < 1 ||
      (vec && cin % (is_bf16 ? 8 : 4) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t m = static_cast<int64_t>(batch) * h * w;
  const int64_t kdim = 9 * static_cast<int64_t>(cin);
  const int n_tiles = (cout + kBN - 1) / kBN;
  const int64_t m_tiles = (m + kBM - 1) / kBM;
  const int64_t blocks = m_tiles * n_tiles;
  if (m > INT32_MAX - kBM || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    cudaMemsetAsync(sum, 0, cout * sizeof(float), s);
    cudaMemsetAsync(sq, 0, cout * sizeof(float), s);
    return static_cast<int>(cudaGetLastError());
  }
  Conv p;
  p.x = x;
  p.wt = wt;
  p.y = y;
  p.part_sum = part_sum;
  p.part_sq = part_sq;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.m = static_cast<int>(m);
  p.kdim = static_cast<int>(kdim);
  p.n_tiles = n_tiles;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (is_bf16) {
    if (vec) {
      conv_bnstat_bf16<true><<<nb, kThreads, 0, s>>>(p);
    } else {
      conv_bnstat_bf16<false><<<nb, kThreads, 0, s>>>(p);
    }
  } else {
    if (vec) {
      conv_bnstat_f32<true><<<nb, kThreads, 0, s>>>(p);
    } else {
      conv_bnstat_f32<false><<<nb, kThreads, 0, s>>>(p);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bnstat_reduce<<<(cout + kReduceX - 1) / kReduceX,
                  dim3(kReduceX, kReduceY), 0, s>>>(
      part_sum, part_sq, sum, sq, static_cast<int>(m_tiles), cout);
  return static_cast<int>(cudaGetLastError());
}
