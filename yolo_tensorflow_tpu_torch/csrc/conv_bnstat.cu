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
// Design:
// - GEMM view: M = batch*H*W output pixels, N = Cout, K = 9*Cin in
//   (ky, kx, c) order. x is NHWC, w is OIHW in channels-last memory, i.e.
//   (Cout, 3, 3, Cin) bytes, so each output channel's K is contiguous.
// - bf16, Cin % 8 == 0 and 16-byte aligned operands (every yolov3 conv but
//   the first): igemm_sm90.cuh's main loop, a ring of cp.async stages
//   of 128-byte-swizzled tiles read by wgmma m64nBNk16, 128 x BN output
//   tiles with BN in {256, 128, 64, 32} chosen by the caller from Cout, so
//   that Cout = 64 and 32 idle none of the tensor cores' columns and Cout
//   >= 256 reads each A tile half as often. What bounds it:
//   operations where K is deep (13^2 to 52^2), bytes at 208^2 and 416^2.
//   Other Cin or unaligned operands fill the same ring element by element.
// - bf16, Cin = 3 and Cout <= 32 (the first conv, bytes bound): a direct
//   kernel, one thread per output pixel with its 27 inputs in registers and
//   the 27 x 32 weights in shared memory, bf16 products summed in f32 by
//   FFMA, 16-byte stores. No tensor cores: K = 27 would idle most of a tile.
// - Epilogue of the wgmma instances: y = bf16(acc) is staged through the
//   freed ring and written 16 bytes a thread along Cout.
// - f32: 128 x 128 tiles with scalar FFMA (the tensor cores' TF32 would not
//   hold the f32 training step to the CPU's float32): K steps of 16, tiles
//   staged K-major, each thread owns an 8 x 8 strided sub-tile. It exists
//   for the f32 parity step only and has no pipeline.
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

#include "igemm_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = igemm::kBM;         // output pixels per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// f32 tiles: 128 output channels per CTA, K step of 16, staged K-major, rows
// padded by 4
constexpr int kBN = 128;
constexpr int kBKf = 16;
constexpr int kLdf = kBM + 4;
// direct kernel (Cin = 3): one thread per output pixel, up to 32 channels;
// staged output rows are padded by 16 bytes against bank conflicts
constexpr int kDirectThreads = kBM;
constexpr int kDirectParts = kDirectThreads / 32;
constexpr int kDirectK = 27;
constexpr int kDirectN = 32;
constexpr int kDirectPitch = kDirectN * 2 + 16;
constexpr int kReduceX = 32;             // channels per reduce CTA
constexpr int kReduceY = 16;             // tile strides per reduce CTA

// The f32 and direct kernels' view of the conv.
struct Conv {
  const void* x;        // (batch, h, w, cin)
  const void* wt;       // (cout, 3, 3, cin)
  void* y;              // (batch, h, w, cout)
  float* part_sum;      // (m_tiles, cout)
  float* part_sq;       // (m_tiles, cout)
  int h, w, cin, cout;
  int m, kdim, n_tiles;
};

// What the wgmma instances' epilogue writes.
struct Stats {
  bf16* y;              // (batch, h, w, cout)
  float* part_sum;      // (m_tiles, cout)
  float* part_sq;       // (m_tiles, cout)
  int y_vec;            // y rows take 16-byte stores
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

// Sum of the partials red[i][col], i < kParts, in that order, written as the
// CTA's row of the partials buffers.
template <int kParts, int BN>
__device__ __forceinline__ void write_partials(float* part_sum,
                                               float* part_sq, int cout,
                                               float (*red_sum)[BN],
                                               float (*red_sq)[BN],
                                               int m_tile, int n0) {
  __syncthreads();
  const int col = threadIdx.x;
  if (col < BN && n0 + col < cout) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      s += red_sum[i][col];
      q += red_sq[i][col];
    }
    const int64_t at = static_cast<int64_t>(m_tile) * cout + n0 + col;
    part_sum[at] = s;
    part_sq[at] = q;
  }
}

// bf16 through the shared wgmma main loop, then y = bf16(acc) staged through
// the ring and the tile's column sums of acc and acc * acc.
template <int BN, bool kAsync>
__global__ void __launch_bounds__(igemm::kThreads, igemm::ctas_per_sm<BN>())
conv_bnstat_wgmma(const igemm::Conv g, const Stats p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red_sum[kWarps][BN];
  __shared__ float red_sq[kWarps][BN];
  uint8_t* ring = igemm::align_1024(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_tile = static_cast<int>(blockIdx.x / g.n_tiles);
  const int n0 = static_cast<int>(blockIdx.x % g.n_tiles) * BN;
  const int m0 = m_tile * kBM;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  igemm::mainloop<uint16_t, BN, kAsync>(g, m0, n0, ring, acc);

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = igemm::frag_col(j);
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = acc[4 * j + 2 * half];
      const float v1 = acc[4 * j + 2 * half + 1];
      s0 += v0;
      s1 += v1;
      q0 = __fmaf_rn(v0, v0, q0);
      q1 = __fmaf_rn(v1, v1, q1);
      *reinterpret_cast<__nv_bfloat162*>(igemm::tile_at<bf16, BN>(
          ring, igemm::frag_row(half), col)) = __floats2bfloat162_rn(v0, v1);
    }
    // the 8 lanes of one lane & 3 share the columns: butterfly over the rest
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (lane < 4) {
      red_sum[warp][col] = s0;
      red_sum[warp][col + 1] = s1;
      red_sq[warp][col] = q0;
      red_sq[warp][col + 1] = q1;
    }
  }
  write_partials<kWarps, BN>(p.part_sum, p.part_sq, g.cout, red_sum, red_sq,
                             m_tile, n0);   // its barrier also ends staging
  igemm::copy_tile_out<bf16, BN>(ring, p.y, m0, n0, g.m, g.cout,
                                 p.y_vec != 0);
}

// bf16, Cin = 3, Cout <= 32 and Cout % 8 == 0: no tensor cores. Thread t of
// CTA i owns output pixel 128 i + t and all its channels. The CTA's 128
// output rows are one contiguous run of y: they are staged in shared memory
// and written as whole 16-byte chunks, neighbouring threads neighbouring
// chunks (a thread storing its own row would half-fill every sector).
__global__ void __launch_bounds__(kDirectThreads)
conv_bnstat_direct(const Conv p) {
  __shared__ __align__(16) float w_s[kDirectK][kDirectN];
  __shared__ float tile[kDirectThreads][kDirectN + 1];
  __shared__ __align__(16) uint8_t y_s[kDirectThreads * kDirectPitch];
  __shared__ float red_sum[kDirectParts][kDirectN];
  __shared__ float red_sq[kDirectParts][kDirectN];
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.wt);
  const int tid = threadIdx.x;
  const int m0 = static_cast<int>(blockIdx.x) * kDirectThreads;

  for (int i = tid; i < kDirectK * kDirectN; i += kDirectThreads) {
    const int o = i % kDirectN;
    const int k = i / kDirectN;
    w_s[k][o] = o < p.cout ? __bfloat162float(w[o * kDirectK + k]) : 0.0f;
  }
  float xin[kDirectK];
#pragma unroll
  for (int k = 0; k < kDirectK; ++k) xin[k] = 0.0f;
  const Row r = row_of(p, m0 + tid);
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int iy = r.iy0 + ky;
      const int ix = r.ix0 + kx;
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
        const bf16* src = x + static_cast<int64_t>(r.pix + iy * p.w + ix) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          xin[(ky * 3 + kx) * 3 + c] = __bfloat162float(src[c]);
        }
      }
    }
  }
  __syncthreads();

  float acc[kDirectN];
#pragma unroll
  for (int o = 0; o < kDirectN; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int k = 0; k < kDirectK; ++k) {
#pragma unroll
    for (int o = 0; o < kDirectN; o += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[k][o]);
      acc[o] = __fmaf_rn(xin[k], wv.x, acc[o]);
      acc[o + 1] = __fmaf_rn(xin[k], wv.y, acc[o + 1]);
      acc[o + 2] = __fmaf_rn(xin[k], wv.z, acc[o + 2]);
      acc[o + 3] = __fmaf_rn(xin[k], wv.w, acc[o + 3]);
    }
  }

  // rows past M hold zeros, which add nothing to the sums
#pragma unroll
  for (int o = 0; o < kDirectN; ++o) tile[tid][o] = acc[o];
#pragma unroll
  for (int o = 0; o < kDirectN; o += 8) {
    alignas(16) __nv_bfloat162 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __floats2bfloat162_rn(acc[o + 2 * e], acc[o + 2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(&y_s[tid * kDirectPitch + o * sizeof(bf16)]) =
        *reinterpret_cast<uint4*>(v);
  }
  __syncthreads();
  const int chunks_per_row = p.cout / 8;
  const int rows = min(kDirectThreads, p.m - m0);
  uint4* dst = reinterpret_cast<uint4*>(
      static_cast<bf16*>(p.y) + static_cast<int64_t>(m0) * p.cout);
  for (int i = tid; i < rows * chunks_per_row; i += kDirectThreads) {
    const int row = i / chunks_per_row;
    const int chunk = i - row * chunks_per_row;
    dst[i] = *reinterpret_cast<const uint4*>(
        &y_s[row * kDirectPitch + chunk * 16]);
  }
  // column sums: thread (col, part) sums 32 of the 128 rows in order
  const int col = tid % kDirectN;
  const int part = tid / kDirectN;
  float s = 0.0f, q = 0.0f;
  for (int i = 0; i < 32; ++i) {
    const float v = tile[part * 32 + i][col];
    s += v;
    q = __fmaf_rn(v, v, q);
  }
  red_sum[part][col] = s;
  red_sq[part][col] = q;
  write_partials<kDirectParts, kDirectN>(
      p.part_sum, p.part_sq, p.cout, red_sum, red_sq,
      static_cast<int>(blockIdx.x), 0);
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
  write_partials<kWarps, kBN>(p.part_sum, p.part_sq, p.cout, red_sum, red_sq,
                              m_tile, n0);
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

template <int BN, bool kAsync>
cudaError_t launch_wgmma(const igemm::Conv& g, const Stats& p,
                         cudaStream_t s) {
  static bool allowed[igemm::kMaxDevices];
  const int smem = igemm::smem_bytes<BN>();
  const cudaError_t err = igemm::allow_smem(conv_bnstat_wgmma<BN, kAsync>,
                                            smem, allowed);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((g.m + kBM - 1) / kBM) * g.n_tiles;
  conv_bnstat_wgmma<BN, kAsync><<<blocks, igemm::kThreads, smem, s>>>(g, p);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_bn(int bn, const igemm::Conv& g, const Stats& p,
                         cudaStream_t s) {
  switch (bn) {
    case 256: return launch_wgmma<256, kAsync>(g, p, s);
    case 128: return launch_wgmma<128, kAsync>(g, p, s);
    case 64: return launch_wgmma<64, kAsync>(g, p, s);
    case 32: return launch_wgmma<32, kAsync>(g, p, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
// each. sum, sq: (cout,) f32 outputs. `instance` names the kernel:
//   0  any shape and alignment, operands gathered element by element;
//   1  16-byte loads (bf16: cp.async): cin % 8 == 0 (bf16) or cin % 4 == 0
//      (f32) and x and wt 16-byte aligned;
//   2  bf16 only, the direct kernel: cin == 3, cout <= 32, cout % 8 == 0 and
//      y 16-byte aligned.
// `bn` is the output-channel tile of the bf16 instances 0 and 1: 256, 128,
// 64 or 32 (the f32 kernels' tile is 128). An instance whose conditions do
// not hold is refused with cudaErrorInvalidValue. Launches on `stream` and
// returns the first CUDA error, or 0.
extern "C" int yolo_conv3x3_bnstat(const void* x, const void* wt, void* y,
                                   float* part_sum, float* part_sq,
                                   float* sum, float* sq, int is_bf16,
                                   int batch, int h, int w, int cin, int cout,
                                   int instance, int bn, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 1 || cout < 1 || instance < 0 ||
      instance > (is_bf16 ? 2 : 1) || (!is_bf16 && bn != kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 1 && (cin % (is_bf16 ? 8 : 4) != 0 || !aligned16(x) ||
                        !aligned16(wt))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 2 && (cin != 3 || cout > kDirectN || cout % 8 != 0 ||
                        !aligned16(y))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  igemm::Conv g;
  g.a = x;
  g.b = wt;
  if (!igemm::set_shape(&g, batch, h, w, cin, cout, 3, 1, 1,
                        instance == 2 ? kDirectN : bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (g.m + kBM - 1) / kBM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.m == 0) {
    cudaMemsetAsync(sum, 0, cout * sizeof(float), s);
    cudaMemsetAsync(sq, 0, cout * sizeof(float), s);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (is_bf16 && instance != 2) {
    Stats p;
    p.y = static_cast<bf16*>(y);
    p.part_sum = part_sum;
    p.part_sq = part_sq;
    p.y_vec = cout % 8 == 0 && aligned16(y);
    err = instance == 1 ? launch_bn<true>(bn, g, p, s)
                        : launch_bn<false>(bn, g, p, s);
  } else {
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
    p.m = g.m;
    p.kdim = g.kdim;
    p.n_tiles = g.n_tiles;
    const unsigned nb = static_cast<unsigned>(m_tiles) * g.n_tiles;
    if (is_bf16) {
      conv_bnstat_direct<<<nb, kDirectThreads, 0, s>>>(p);
    } else if (instance == 1) {
      conv_bnstat_f32<true><<<nb, kThreads, 0, s>>>(p);
    } else {
      conv_bnstat_f32<false><<<nb, kThreads, 0, s>>>(p);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  bnstat_reduce<<<(cout + kReduceX - 1) / kReduceX,
                  dim3(kReduceX, kReduceY), 0, s>>>(
      part_sum, part_sq, sum, sq, m_tiles, cout);
  return static_cast<int>(cudaGetLastError());
}
