// Int8 (w8a8) convolution for Hopper (sm_90a): an implicit GEMM on the int8
// tensor cores, with the input quantized on load and the dequantize + bias +
// activation epilogue fused.
//
// Replaces the Pallas TPU kernels tools/probe_int8_3x3.py:35
// (pallas_conv3x3_int8), :75 (pallas_conv3x3_shiftgemm_int8) and :147
// (pallas_conv3x3_k3gemm_int8). Those are three TPU formulations of one
// function, the int8 x int8 -> int32 3x3 stride-1 conv, each gated bit-exact
// against XLA's lax.conv. This kernel computes that accumulator for every
// conv that int8 serving quantizes (k in {1, 3}, stride in {1, 2}, darknet
// padding k/2), and around it the rest of yolo_tensorflow_tpu/ops/quant.py
// conv2d_int8, which on the TPU was XLA's:
//   q   = clamp(rint(x / s_x), -127, 127)                 prologue, int8
//   acc = sum over (ky, kx, c) of q[b, oy*s - p + ky, ox*s - p + kx, c]
//                              * w_q[o, ky, kx, c]       int32, exact
//   y   = acc * (s_x * s_w[o]) + b[o]                     epilogue dtype
//   y   = max(y * alpha, y) for leaky, alpha = 0.1 in the epilogue dtype.
// The f32 epilogue is one fma, fmaf(float(acc), f32(s_x * s_w), b): XLA on
// the CPU contracts the JAX expression into exactly that. The bf16 epilogue
// rounds after every step, as JAX's bf16 arithmetic does:
//   a = bf16(acc), m = bf16(a * bf16(sc)), y = bf16(m + bf16(b)).
// The quantize uses IEEE division and rintf (half to even, as jnp.round):
// this file must not be built with --use_fast_math.
//
// Bound. At yolov3-416, batch 64, the 72 quantized convs do 4.18 T int8
// operations, 2.11 ms at the H100's 1,979 TOPS dense int8 peak, and move
// 9.99 GB (bf16 input read once, int8 weights, bf16 output written once),
// 2.98 ms at 3.35 TB/s. Taking each layer at the larger of its two terms,
// the bound is 3.78 ms summed over the layers: mostly bytes at the wide
// early layers, operations at the deep ones.
//
// Design (a first, simple kernel: mma.sync without a pipeline; wgmma, TMA and
// multi-stage cp.async are later work):
// - GEMM view: M = batch*Ho*Wo output pixels, N = Cout, K = k*k*Cin in
//   (ky, kx, c) order. The weights come as OIHW in channels-last memory,
//   i.e. (Cout, kh, kw, Cin) bytes, so each output channel's K is contiguous.
// - One CTA of 8 warps per 128 x 128 output tile; K steps of 64 bytes. Each
//   step gathers the A tile from the NHWC input (zeros at the padded border
//   and past K), quantizes it while staging it in shared memory, and copies
//   the B tile of weights. The 128-wide N tile keeps the number of times an
//   input element is re-gathered and re-quantized (once per N tile) low: the
//   IEEE division of the quantize, not the tensor cores, is the costliest
//   part of the A path.
// - Each warp owns a 64 x 32 sub-tile: 4 x 4 mma.sync m16n8k32 s8 products
//   per 32 bytes of K, accumulated in int32 registers. Shared-memory rows are
//   padded to 80 bytes, so the fragment loads (one 32-bit word per register)
//   hit 32 distinct banks.
// - Inputs with Cin % 16 == 0 (all of yolov3 but its first conv) load 8
//   channels per thread with 16-byte loads; the rest (Cin = 3) gathers byte
//   by byte and zero-fills the K tail.
// - CTAs are numbered N tile fastest, so the CTAs that share an A tile run
//   together and find it in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                        // output pixels per CTA
constexpr int kBN = 128;                        // output channels per CTA
constexpr int kBK = 64;                         // K bytes per step
constexpr int kLd = kBK + 16;                   // padded shared-memory row
constexpr int kThreads = 256;                   // 8 warps, 2 (M) x 4 (N)
constexpr int kChunks = kBK / 8;                // 8-byte A chunks per row
constexpr int kRowsPerPass = kThreads / kChunks;
constexpr int kPasses = kBM / kRowsPerPass;     // A rows per thread
constexpr int kBChunks = kBN * kBK / 16 / kThreads;  // 16-byte B chunks
constexpr float kAlpha = 0.1f;
constexpr float kAlphaBf16 = 0.10009765625f;    // bf16(0.1)

struct Conv {
  const void* x;        // (batch, h, w, cin) f32 or bf16
  const int8_t* wq;     // (cout, k, k, cin)
  const float* s_w;     // (cout,)
  const float* bias;    // (cout,)
  void* y;              // (batch, ho, wo, cout) f32 or bf16
  float s_x;
  int h, w, cin, ho, wo, cout, k, stride, pad, leaky;
  int m, kdim, n_tiles;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// clamp(rint(v / s), -127, 127) as one byte of a packed word
__device__ __forceinline__ uint32_t quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s) {
  return quant(v[0], s) | (quant(v[1], s) << 8) | (quant(v[2], s) << 16) |
         (quant(v[3], s) << 24);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float epilogue(int acc, float sc, float b,
                                          int leaky, float) {
  float y = __fmaf_rn(__int2float_rn(acc), sc, b);
  if (leaky) y = fmaxf(__fmul_rn(y, kAlpha), y);
  return y;
}

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float sc, float b,
                                                  int leaky, __nv_bfloat16) {
  const float a = bf16_round(__int2float_rn(acc));
  const float m = bf16_round(__fmul_rn(a, bf16_round(sc)));
  float y = bf16_round(__fadd_rn(m, bf16_round(b)));
  if (leaky) y = fmaxf(bf16_round(__fmul_rn(y, kAlphaBf16)), y);
  return __float2bfloat16_rn(y);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b, bool pair) {
  if (pair) {
    __nv_bfloat162 v;
    v.x = a;
    v.y = b;
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename Tin, typename Tout, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const Conv p) {
  __shared__ __align__(16) int8_t a_s[kBM * kLd];
  __shared__ __align__(16) int8_t b_s[kBN * kLd];

  const Tin* x = static_cast<const Tin*>(p.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;      // mma groupID
  const int t = lane & 3;       // mma threadID_in_group
  const int wm = warp >> 2;     // warp's 64-row slice of the tile
  const int wn = warp & 3;      // warp's 32-column slice
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * kBN;
  const int m0 = static_cast<int>(blockIdx.x / p.n_tiles) * kBM;

  // The A rows this thread gathers, row = tid / kChunks + pass *
  // kRowsPerPass, and the 8-byte K chunk it owns in each.
  const int chunk = tid % kChunks;
  int pix[kPasses], iy0[kPasses], ix0[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int m = m0 + tid / kChunks + i * kRowsPerPass;
    if (m < p.m) {
      const int hw = p.ho * p.wo;
      const int b = m / hw;
      const int r = m - b * hw;
      const int oy = r / p.wo;
      const int ox = r - oy * p.wo;
      pix[i] = b * p.h * p.w;
      iy0[i] = oy * p.stride - p.pad;
      ix0[i] = ox * p.stride - p.pad;
    } else {
      pix[i] = 0;
      iy0[i] = -(1 << 28);      // never in bounds: the row gathers zeros
      ix0[i] = 0;
    }
  }

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int kw_cin = p.k * p.cin;
  for (int k0 = 0; k0 < p.kdim; k0 += kBK) {
    // A: gather, quantize, stage
    const int kk = k0 + chunk * 8;
    if (kVec) {
      // Cin % 16 == 0: the chunk's 8 channels share one (ky, kx)
      const bool k_in = kk < p.kdim;
      int ky = 0, kx = 0, c = 0;
      if (k_in) {
        ky = kk / kw_cin;
        const int r = kk - ky * kw_cin;
        kx = r / p.cin;
        c = r - kx * p.cin;
      }
#pragma unroll
      for (int i = 0; i < kPasses; ++i) {
        uint2 q = make_uint2(0u, 0u);
        const int iy = iy0[i] + ky;
        const int ix = ix0[i] + kx;
        if (k_in && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
          float v[8];
          load8(x + static_cast<int64_t>(pix[i] + iy * p.w + ix) * p.cin + c,
                v);
          q.x = quant4(v, p.s_x);
          q.y = quant4(v + 4, p.s_x);
        }
        *reinterpret_cast<uint2*>(
            &a_s[(tid / kChunks + i * kRowsPerPass) * kLd + chunk * 8]) = q;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPasses; ++i) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = 0.0f;
          const int kj = kk + j;
          if (kj < p.kdim) {
            const int ky = kj / kw_cin;
            const int r = kj - ky * kw_cin;
            const int kx = r / p.cin;
            const int c = r - kx * p.cin;
            const int iy = iy0[i] + ky;
            const int ix = ix0[i] + kx;
            if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
              v[j] = to_float(
                  x[static_cast<int64_t>(pix[i] + iy * p.w + ix) * p.cin + c]);
            }
          }
        }
        // zeros quantize to zero, so padding and the K tail stay zero
        *reinterpret_cast<uint2*>(
            &a_s[(tid / kChunks + i * kRowsPerPass) * kLd + chunk * 8]) =
            make_uint2(quant4(v, p.s_x), quant4(v + 4, p.s_x));
      }
    }

    // B: weights (cout, K), 16 bytes per chunk
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int id = tid + i * kThreads;
      const int n = id / (kBK / 16);
      const int kc = (id % (kBK / 16)) * 16;
      const int gn = n0 + n;
      const int gk = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < p.cout) {
        const int8_t* src = p.wq + static_cast<int64_t>(gn) * p.kdim + gk;
        if (kVec) {
          if (gk < p.kdim) v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (gk + j < p.kdim) {
              word[j / 4] |= (static_cast<uint32_t>(src[j]) & 0xffu)
                             << (8 * (j % 4));
            }
          }
          v = make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      *reinterpret_cast<uint4*>(&b_s[n * kLd + kc]) = v;
    }
    __syncthreads();

    // tensor cores: mma fragments per the PTX ISA's m16n8k32 .s8 layout
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = &a_s[(wm * 64 + mi * 16 + g) * kLd + ks + t * 4];
        const int8_t* r8 = r0 + 8 * kLd;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r8);
        af[mi][2] = lds32(r0 + 16);
        af[mi][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = &b_s[(wn * 32 + ni * 8 + g) * kLd + ks + t * 4];
        bf[ni][0] = lds32(c0);
        bf[ni][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // epilogue: accumulator c[0..1] is row g, columns 2t, 2t+1; c[2..3] row g+8
  Tout* y = static_cast<Tout*>(p.y);
  const bool even = (p.cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;
    if (n >= p.cout) continue;
    const bool two = n + 1 < p.cout;
    const float sc0 = __fmul_rn(p.s_x, p.s_w[n]);
    const float b0 = p.bias[n];
    const float sc1 = two ? __fmul_rn(p.s_x, p.s_w[n + 1]) : 0.0f;
    const float b1 = two ? p.bias[n + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (m >= p.m) continue;
        Tout* dst = y + static_cast<int64_t>(m) * p.cout + n;
        const Tout v0 = epilogue(acc[mi][ni][2 * half], sc0, b0, p.leaky,
                                 Tout());
        const Tout v1 = epilogue(acc[mi][ni][2 * half + 1], sc1, b1, p.leaky,
                                 Tout());
        if (two && !even) {
          dst[0] = v0;
          dst[1] = v1;
        } else {
          store2(dst, v0, v1, two);
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
void launch(const Conv& p, bool vec, unsigned blocks, cudaStream_t s) {
  if (vec) {
    conv_int8_kernel<Tin, Tout, true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    conv_int8_kernel<Tin, Tout, false><<<blocks, kThreads, 0, s>>>(p);
  }
}

}  // namespace

// One int8 convolution. x: (batch, h, w, cin) contiguous, f32 (x_bf16 = 0)
// or bf16 (1). wq: (cout, ksize, ksize, cin) int8 contiguous. s_w, bias:
// (cout,) f32. y: (batch, ho, wo, cout) contiguous, f32 (y_bf16 = 0) or bf16
// (1), ho = (h + 2*pad - ksize) / stride + 1 and likewise wo. s_x is the
// input's quantization scale. vec = 1 requires cin % 16 == 0 and x and wq
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int yolo_conv2d_int8(const void* x, int x_bf16, const void* wq,
                                float s_x, const void* s_w, const void* bias,
                                void* y, int y_bf16, int batch, int h, int w,
                                int cin, int cout, int ksize, int stride,
                                int pad, int leaky, int vec, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 1 || cout < 1 || ksize < 1 ||
      stride < 1 || pad < 0 || (vec && cin % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Conv p;
  p.x = x;
  p.wq = static_cast<const int8_t*>(wq);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.s_x = s_x;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ho = (h + 2 * pad - ksize) / stride + 1;
  p.wo = (w + 2 * pad - ksize) / stride + 1;
  p.cout = cout;
  p.k = ksize;
  p.stride = stride;
  p.pad = pad;
  p.leaky = leaky;
  const int64_t m = static_cast<int64_t>(batch) * p.ho * p.wo;
  const int64_t kdim = static_cast<int64_t>(ksize) * ksize * cin;
  p.n_tiles = (cout + kBN - 1) / kBN;
  const int64_t blocks = (m + kBM - 1) / kBM * p.n_tiles;
  if (p.ho < 1 || p.wo < 1 || m > INT32_MAX - kBM || kdim > INT32_MAX ||
      static_cast<int64_t>(batch) * h * w > INT32_MAX || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.m = static_cast<int>(m);
  p.kdim = static_cast<int>(kdim);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const bool v = vec != 0;
  if (x_bf16) {
    if (y_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(p, v, nb, s);
    } else {
      launch<__nv_bfloat16, float>(p, v, nb, s);
    }
  } else {
    if (y_bf16) {
      launch<float, __nv_bfloat16>(p, v, nb, s);
    } else {
      launch<float, float>(p, v, nb, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
