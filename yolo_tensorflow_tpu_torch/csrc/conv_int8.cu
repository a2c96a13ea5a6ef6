// Int8 (w8a8) convolution for Hopper (sm_90a): an implicit GEMM on the int8
// tensor cores, with the input quantized by a prologue pass and the
// dequantize + bias + activation epilogue fused.
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
// The int8-in entry (yolo_conv2d_int8_q) is the conv of
// yolo_tensorflow_tpu/ops/quant.py apply_int8, the all-int8-activation path:
// the input is already int8 (the previous layer requantized it), so there is
// no quantize pass; the wgmma instances read it as their A operand and the
// direct kernel packs its bytes. Its epilogue, in f32:
//   y = fmaf(float(acc), f32(s_in * s_w[o]), b[o]), then leaky in f32,
//   then either int8 out, q = clamp(rint(y * inv_out), -127, 127), or f32.
// inv_out = f32(1 / s_out) is computed by the caller: XLA compiles
// apply_int8's y / s_out (a constant) into that multiply, so this is the
// JAX package's program bit for bit. The int8 tile goes out 16 bytes a
// thread along Cout, as the other dtypes do.
//
// Bound. At yolov3-416, batch 64, the 72 quantized convs do 4.18 T int8
// operations, 2.11 ms at the H100's 1,979 TOPS dense int8 peak, and move
// 9.99 GB (bf16 input read once, int8 weights, bf16 output written once),
// 2.98 ms at 3.35 TB/s. Taking each layer at the larger of its two terms,
// the bound is 3.78 ms summed over the layers: mostly bytes at the wide
// early layers, operations at the deep ones.
//
// Design:
// - GEMM view: M = batch*Ho*Wo output pixels, N = Cout, K = k*k*Cin in
//   (ky, kx, c) order. The weights come as OIHW in channels-last memory,
//   i.e. (Cout, kh, kw, Cin) bytes, so each output channel's K is contiguous.
// - The quantize is a pass of its own, quantize_act: it reads the NHWC input
//   once with 16-byte loads and writes it as int8 with 8-byte stores into a
//   scratch tensor of the caller's, bytes bound. Each element pays its IEEE
//   division once, not once per tap and N tile, and the GEMM's A operand
//   becomes plain int8 bytes that cp.async can copy. This is the order of
//   conv2d_int8 in the JAX package (quantize, then the conv), so results are
//   bit for bit the same. Its cost: the int8 copy is written and read once
//   more than the function's own bytes (the bound counts the input once).
// - Cin % 16 == 0 and 16-byte aligned operands (every yolov3 conv but the
//   first): igemm_sm90.cuh's main loop, a ring of cp.async stages of
//   128-byte-swizzled tiles read by wgmma m64nBNk32 s8 -> s32, 128 x BN
//   output tiles with BN in {128, 64, 32} chosen by the caller from Cout.
//   Other Cin or unaligned weights fill the same ring element by element.
// - Cin = 3, k = 3, Cout <= 32 (the first conv, bytes bound): a direct
//   kernel, one thread per output pixel. It quantizes its 27 inputs in
//   registers (no scratch pass), packs them four to a word, and takes the
//   int32 dot products with dp4a against the packed weights in shared
//   memory; 16-byte stores. No tensor cores: K = 27 would idle most of a tile.
// - Cin = 3, k = 7, Cout <= 64 (yolov1's first conv, 7x7 stride 2): the same
//   direct kernel at K = 147 (37 packed words) and a 64-channel tile, after
//   the quantize pass: each input element is read by up to 49 output
//   pixels, so the division is paid once per element in the pass and the
//   direct kernel packs int8 bytes, as for the int8-in entry. Bound at
//   yolov1-448, batch 64: 60.4 G int8 operations (0.031 ms at 1,979 TOPS)
//   and 488 MB (bf16 in and out), 0.146 ms at 3.35 TB/s: bytes. The kernel
//   does 37 dp4a per output value on the CUDA cores, 7.6 G at batch 64, so
//   it is set by the dp4a rate, not by the bound.
// - Epilogue of the wgmma instances: dequantize + bias + activation on the
//   accumulator fragments, staged through the freed ring and written 16
//   bytes a thread along Cout.
// - CTAs are numbered N tile fastest, so the CTAs that share an A tile run
//   together and find it in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm_sm90.cuh"

namespace {

constexpr int kBM = igemm::kBM;                 // output pixels per CTA
constexpr int kQuantThreads = 256;
constexpr int kDirectThreads = kBM;             // one output pixel each
constexpr int kDirectN3 = 32;                   // Cout tile of k = 3
constexpr int kDirectN7 = 64;                   // Cout tile of k = 7

// K = ks * ks * 3 bytes of the direct kernel, and the packed words holding
// them (27 -> 7 words, 147 -> 37)
__host__ __device__ constexpr int direct_k(int ks) { return ks * ks * 3; }
__host__ __device__ constexpr int direct_words(int ks) {
  return (direct_k(ks) + 3) / 4;
}
constexpr float kAlpha = 0.1f;
constexpr float kAlphaBf16 = 0.10009765625f;    // bf16(0.1)

// What the epilogue needs beside the accumulators.
struct Epilogue {
  const float* s_w;     // (cout,)
  const float* bias;    // (cout,)
  void* y;              // (batch, ho, wo, cout) f32, bf16 or int8
  float s_x;            // the input's scale
  float inv_out;        // int8 out: 1 / the output's scale
  int leaky;
  int y_vec;            // y rows take 16-byte stores
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

// One input byte of the direct kernel: a float quantized with scale s, or
// an int8 value as it is (the int8-in entry).
__device__ __forceinline__ uint32_t input_byte(float v, float s) {
  return quant(v, s);
}
__device__ __forceinline__ uint32_t input_byte(__nv_bfloat16 v, float s) {
  return quant(__bfloat162float(v), s);
}
__device__ __forceinline__ uint32_t input_byte(int8_t v, float) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v));
}

// clamp(rint(v * inv), -127, 127): the requantize of the int8-in entry
__device__ __forceinline__ int8_t requant(float v, float inv) {
  return static_cast<int8_t>(static_cast<int>(
      fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f)));
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s) {
  return quant(v[0], s) | (quant(v[1], s) << 8) | (quant(v[2], s) << 16) |
         (quant(v[3], s) << 24);
}

// Both values rounded to bf16 and widened again. The packed conversion
// (cvt.rn.bf16x2.f32) issues at the full rate; the scalar one does not, and
// the bf16 epilogue rounds five times per output.
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The epilogue of two neighbouring output channels: accumulators a0 and a1,
// scales sc = s_x * s_w and biases b of the two.
__device__ __forceinline__ float2 epilogue2(int a0, int a1, float2 sc,
                                            float2 b, const Epilogue& p,
                                            float) {
  float2 y = make_float2(__fmaf_rn(__int2float_rn(a0), sc.x, b.x),
                         __fmaf_rn(__int2float_rn(a1), sc.y, b.y));
  if (p.leaky) {
    y.x = fmaxf(__fmul_rn(y.x, kAlpha), y.x);
    y.y = fmaxf(__fmul_rn(y.y, kAlpha), y.y);
  }
  return y;
}

// int8 out: the f32 epilogue, then the requantize
__device__ __forceinline__ char2 epilogue2(int a0, int a1, float2 sc,
                                           float2 b, const Epilogue& p,
                                           int8_t) {
  const float2 y = epilogue2(a0, a1, sc, b, p, 0.0f);
  return make_char2(requant(y.x, p.inv_out), requant(y.y, p.inv_out));
}

__device__ __forceinline__ __nv_bfloat162 epilogue2(int a0, int a1, float2 sc,
                                                    float2 b,
                                                    const Epilogue& p,
                                                    __nv_bfloat16) {
  const float2 a = bf16_round2(__int2float_rn(a0), __int2float_rn(a1));
  const float2 s = bf16_round2(sc.x, sc.y);
  const float2 c = bf16_round2(b.x, b.y);
  const float2 m = bf16_round2(__fmul_rn(a.x, s.x), __fmul_rn(a.y, s.y));
  float2 y = bf16_round2(__fadd_rn(m.x, c.x), __fadd_rn(m.y, c.y));
  if (p.leaky) {
    const float2 l = bf16_round2(__fmul_rn(y.x, kAlphaBf16),
                                 __fmul_rn(y.y, kAlphaBf16));
    y.x = fmaxf(l.x, y.x);
    y.y = fmaxf(l.y, y.y);
  }
  return __floats2bfloat162_rn(y.x, y.y);      // exact: both are bf16 values
}

__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p,
                                           __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ void store_pair(int8_t* p, char2 v) {
  *reinterpret_cast<char2*>(p) = v;
}

// q[i] = clamp(rint(x[i] / s), -127, 127) for i < n. With `vec` (x 16-byte
// aligned, q 8-byte aligned) a thread takes 8 elements at a time; the
// ragged end, or everything without `vec`, goes element by element.
template <typename Tin>
__global__ void __launch_bounds__(kQuantThreads)
quantize_act(const Tin* __restrict__ x, int8_t* __restrict__ q, int64_t n,
             float s, int vec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kQuantThreads +
                      threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kQuantThreads;
  const int64_t n8 = vec ? n / 8 : 0;
  for (int64_t i = tid; i < n8; i += step) {
    float v[8];
    load8(x + 8 * i, v);
    *reinterpret_cast<uint2*>(q + 8 * i) =
        make_uint2(quant4(v, s), quant4(v + 4, s));
  }
  for (int64_t i = 8 * n8 + tid; i < n; i += step) {
    q[i] = static_cast<int8_t>(quant(to_float(x[i]), s));
  }
}

// int8 A and B through the shared wgmma main loop, then the epilogue on the
// int32 fragments, staged through the ring.
template <typename Tout, int BN, bool kAsync>
__global__ void __launch_bounds__(igemm::kThreads, igemm::ctas_per_sm<BN>())
conv_int8_wgmma(const igemm::Conv g, const Epilogue p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = igemm::align_1024(smem_raw);
  const int n0 = static_cast<int>(blockIdx.x % g.n_tiles) * BN;
  const int m0 = static_cast<int>(blockIdx.x / g.n_tiles) * kBM;

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  igemm::mainloop<uint8_t, BN, kAsync>(g, m0, n0, ring, acc);

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = igemm::frag_col(j);
    const int n = n0 + col;
    const bool in0 = n < g.cout, in1 = n + 1 < g.cout;
    const float2 sc =
        make_float2(in0 ? __fmul_rn(p.s_x, p.s_w[n]) : 0.0f,
                    in1 ? __fmul_rn(p.s_x, p.s_w[n + 1]) : 0.0f);
    const float2 b = make_float2(in0 ? p.bias[n] : 0.0f,
                                 in1 ? p.bias[n + 1] : 0.0f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      store_pair(igemm::tile_at<Tout, BN>(ring, igemm::frag_row(half), col),
                 epilogue2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1],
                           sc, b, p, Tout()));
    }
  }
  __syncthreads();
  igemm::copy_tile_out<Tout, BN>(ring, static_cast<Tout*>(p.y), m0, n0, g.m,
                                 g.cout, p.y_vec != 0);
}

// Cin = 3, a KS x KS conv, Cout <= N and Cout a whole number of 16-byte
// chunks of Tout: no tensor cores, and the quantize in registers (an int8
// input is packed as it is). Thread t of CTA i owns output pixel 128 i + t.
// The CTA's 128 output rows are one contiguous run of y: they are staged in
// shared memory and written as whole 16-byte chunks, neighbouring threads
// neighbouring chunks (a thread storing its own row would half-fill every
// sector).
template <typename Tin, typename Tout, int KS, int N>
__global__ void __launch_bounds__(kDirectThreads)
conv_int8_direct(const igemm::Conv g, const Epilogue p) {
  constexpr int kK = direct_k(KS);
  constexpr int kWords = direct_words(KS);
  constexpr int kEPV = 16 / sizeof(Tout);       // elements per 16 bytes
  constexpr int kPitch = N * sizeof(Tout) + 16;
  __shared__ __align__(16) int w_s[kWords][N];
  __shared__ __align__(16) uint8_t y_s[kDirectThreads * kPitch];
  __shared__ float sc_s[N];
  __shared__ float b_s[N];
  const Tin* x = static_cast<const Tin*>(g.a);
  const int8_t* wq = static_cast<const int8_t*>(g.b);
  const int tid = threadIdx.x;
  const int m0 = static_cast<int>(blockIdx.x) * kDirectThreads;
  const int m = m0 + tid;

  // word j of channel o: weight bytes 4 j .. 4 j + 3 of its kK, then zeros
  for (int i = tid; i < kWords * N; i += kDirectThreads) {
    const int o = i % N;
    const int j = i / N;
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * j + e;
      if (o < g.cout && k < kK) {
        word |= (static_cast<uint32_t>(wq[o * kK + k]) & 0xffu) << (8 * e);
      }
    }
    w_s[j][o] = static_cast<int>(word);
  }
  if (tid < N) {
    const bool in = tid < g.cout;
    sc_s[tid] = in ? __fmul_rn(p.s_x, p.s_w[tid]) : 0.0f;
    b_s[tid] = in ? p.bias[tid] : 0.0f;
  }

  uint32_t qw[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) qw[j] = 0u;
  if (m < g.m) {
    const int hw = g.ho * g.wo;
    const int img = m / hw;
    const int rem = m - img * hw;
    const int oy = rem / g.wo;
    const int iy0 = oy * g.stride - g.pad;
    const int ix0 = (rem - oy * g.wo) * g.stride - g.pad;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const int iy = iy0 + ky;
        const int ix = ix0 + kx;
        if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
          const Tin* src =
              x + (static_cast<int64_t>(img) * g.h * g.w + iy * g.w + ix) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int k = (ky * KS + kx) * 3 + c;
            qw[k / 4] |= input_byte(src[c], p.s_x) << (8 * (k % 4));
          }
        }
      }
    }
  }
  __syncthreads();

  int acc[N];
#pragma unroll
  for (int o = 0; o < N; ++o) acc[o] = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int a = static_cast<int>(qw[j]);
#pragma unroll
    for (int o = 0; o < N; o += 4) {
      const int4 wv = *reinterpret_cast<const int4*>(&w_s[j][o]);
      acc[o] = __dp4a(a, wv.x, acc[o]);
      acc[o + 1] = __dp4a(a, wv.y, acc[o + 1]);
      acc[o + 2] = __dp4a(a, wv.z, acc[o + 2]);
      acc[o + 3] = __dp4a(a, wv.w, acc[o + 3]);
    }
  }

#pragma unroll
  for (int o = 0; o < N; o += kEPV) {
    alignas(16) Tout v[kEPV];
#pragma unroll
    for (int e = 0; e < kEPV; e += 2) {
      store_pair(&v[e], epilogue2(
          acc[o + e], acc[o + e + 1],
          make_float2(sc_s[o + e], sc_s[o + e + 1]),
          make_float2(b_s[o + e], b_s[o + e + 1]), p, Tout()));
    }
    *reinterpret_cast<uint4*>(&y_s[tid * kPitch + o * sizeof(Tout)]) =
        *reinterpret_cast<uint4*>(v);
  }
  __syncthreads();
  const int chunks_per_row = g.cout / kEPV;
  const int rows = min(kDirectThreads, g.m - m0);
  uint4* dst = reinterpret_cast<uint4*>(
      static_cast<Tout*>(p.y) + static_cast<int64_t>(m0) * g.cout);
  for (int i = tid; i < rows * chunks_per_row; i += kDirectThreads) {
    const int row = i / chunks_per_row;
    const int chunk = i - row * chunks_per_row;
    dst[i] = *reinterpret_cast<const uint4*>(&y_s[row * kPitch + chunk * 16]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Tin>
cudaError_t launch_quantize(const void* x, void* q, int64_t n, float s_x,
                            cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  const int vec = aligned16(x) && aligned16(q);
  const int64_t work = vec ? (n + 7) / 8 : n;
  const int64_t blocks = (work + kQuantThreads - 1) / kQuantThreads;
  const unsigned nb = static_cast<unsigned>(blocks < 65536 * 16 ? blocks
                                                                : 65536 * 16);
  quantize_act<Tin><<<nb, kQuantThreads, 0, s>>>(
      static_cast<const Tin*>(x), static_cast<int8_t*>(q), n, s_x, vec);
  return cudaGetLastError();
}

template <typename Tout, int BN, bool kAsync>
cudaError_t launch_wgmma(const igemm::Conv& g, const Epilogue& p,
                         cudaStream_t s) {
  static bool allowed[igemm::kMaxDevices];
  const int smem = igemm::smem_bytes<BN>();
  const cudaError_t err = igemm::allow_smem(
      conv_int8_wgmma<Tout, BN, kAsync>, smem, allowed);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((g.m + kBM - 1) / kBM) * g.n_tiles;
  conv_int8_wgmma<Tout, BN, kAsync><<<blocks, igemm::kThreads, smem, s>>>(g,
                                                                          p);
  return cudaGetLastError();
}

template <typename Tout, bool kAsync>
cudaError_t launch_bn(int bn, const igemm::Conv& g, const Epilogue& p,
                      cudaStream_t s) {
  switch (bn) {
    case 128: return launch_wgmma<Tout, 128, kAsync>(g, p, s);
    case 64: return launch_wgmma<Tout, 64, kAsync>(g, p, s);
    case 32: return launch_wgmma<Tout, 32, kAsync>(g, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tin, typename Tout, int KS, int N>
cudaError_t launch_direct(const igemm::Conv& g, const Epilogue& p,
                          cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((g.m + kBM - 1) / kBM);
  conv_int8_direct<Tin, Tout, KS, N><<<blocks, kDirectThreads, 0, s>>>(g, p);
  return cudaGetLastError();
}

// The k = 7 direct kernel on int8 input (the quantize pass's scratch, or the
// int8-in entry's own input), at the Cout tile `bn` (32 or 64).
template <typename Tout>
cudaError_t launch_direct7(int bn, const igemm::Conv& g, const Epilogue& p,
                           cudaStream_t s) {
  return bn == kDirectN3 ? launch_direct<int8_t, Tout, 7, kDirectN3>(g, p, s)
                         : launch_direct<int8_t, Tout, 7, kDirectN7>(g, p, s);
}

// Whether the direct kernel takes this conv: Cin = 3, k = 3 with Cout <= 32
// or k = 7 with Cout <= 64 at a tile `bn` that covers it, Cout in whole
// 16-byte chunks of the output (`chunk` elements) and y 16-byte aligned.
bool direct_fits(int cin, int ksize, int cout, int bn, int chunk,
                 const void* y) {
  const bool k3 = ksize == 3 && cout <= kDirectN3;
  const bool k7 = ksize == 7 && cout <= bn &&
                  (bn == kDirectN3 || bn == kDirectN7);
  return cin == 3 && (k3 || k7) && cout % chunk == 0 && aligned16(y);
}

}  // namespace

// q = clamp(rint(x / s_x), -127, 127) as int8, for n elements of x, f32
// (x_bf16 = 0) or bf16 (1): the int8 conv's prologue on its own. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int yolo_quantize_act(const void* x, int x_bf16, void* q,
                                 long long n, float s_x, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_bf16 ? launch_quantize<__nv_bfloat16>(x, q, n, s_x, s)
             : launch_quantize<float>(x, q, n, s_x, s));
}

// One int8 convolution. x: (batch, h, w, cin) contiguous, f32 (x_bf16 = 0)
// or bf16 (1). xq: int8 scratch of x's shape, 16-byte aligned (unused by
// instance 2). wq: (cout, ksize, ksize, cin) int8 contiguous. s_w, bias:
// (cout,) f32. y: (batch, ho, wo, cout) contiguous, f32 (y_bf16 = 0) or bf16
// (1), ho = (h + 2*pad - ksize) / stride + 1 and likewise wo. s_x is the
// input's quantization scale. `instance` names the kernel:
//   0  quantize pass, then the wgmma GEMM with operands gathered element by
//      element: any cin and any alignment of wq;
//   1  quantize pass, then the wgmma GEMM fed by cp.async: cin % 16 == 0
//      and wq 16-byte aligned;
//   2  the direct kernel: cin == 3, cout % 8 == 0, y 16-byte aligned, and
//      ksize == 3 with cout <= 32 (it quantizes in registers; xq unused), or
//      ksize == 7 with cout <= bn (the quantize pass first, into xq).
// `bn` is the output-channel tile: 128, 64 or 32 for instances 0 and 1, 64
// or 32 for instance 2 at ksize 7. An instance whose conditions do not hold
// is refused with cudaErrorInvalidValue. Launches on `stream` and returns
// the first CUDA error, or 0.
extern "C" int yolo_conv2d_int8(const void* x, int x_bf16, void* xq,
                                const void* wq, float s_x, const void* s_w,
                                const void* bias, void* y, int y_bf16,
                                int batch, int h, int w, int cin, int cout,
                                int ksize, int stride, int pad, int leaky,
                                int instance, int bn, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 1 || cout < 1 || ksize < 1 ||
      stride < 1 || pad < 0 || instance < 0 || instance > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the direct kernel quantizes in registers at k = 3 only
  const bool fused_quant = instance == 2 && ksize == 3;
  if (!fused_quant && (xq == nullptr || (instance != 2 && !aligned16(xq)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 1 && (cin % 16 != 0 || !aligned16(wq))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 2 && !direct_fits(cin, ksize, cout, bn, 8, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  igemm::Conv g;
  g.a = fused_quant ? x : xq;
  g.b = wq;
  if (!igemm::set_shape(&g, batch, h, w, cin, cout, ksize, stride, pad,
                        fused_quant ? kDirectN3 : bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g.m == 0) return 0;
  Epilogue p;
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.s_x = s_x;
  p.inv_out = 0.0f;
  p.leaky = leaky;
  p.y_vec = cout % (y_bf16 ? 8 : 4) == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fused_quant) {
    using BF = __nv_bfloat16;
    if (x_bf16) {
      err = y_bf16 ? launch_direct<BF, BF, 3, kDirectN3>(g, p, s)
                   : launch_direct<BF, float, 3, kDirectN3>(g, p, s);
    } else {
      err = y_bf16 ? launch_direct<float, BF, 3, kDirectN3>(g, p, s)
                   : launch_direct<float, float, 3, kDirectN3>(g, p, s);
    }
    return static_cast<int>(err);
  }
  const int64_t n = static_cast<int64_t>(batch) * h * w * cin;
  err = x_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, n, s_x, s)
               : launch_quantize<float>(x, xq, n, s_x, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (instance == 2) {
    err = y_bf16 ? launch_direct7<__nv_bfloat16>(bn, g, p, s)
                 : launch_direct7<float>(bn, g, p, s);
  } else if (instance == 1) {
    err = y_bf16 ? launch_bn<__nv_bfloat16, true>(bn, g, p, s)
                 : launch_bn<float, true>(bn, g, p, s);
  } else {
    err = y_bf16 ? launch_bn<__nv_bfloat16, false>(bn, g, p, s)
                 : launch_bn<float, false>(bn, g, p, s);
  }
  return static_cast<int>(err);
}

// The int8-in convolution of the all-int8-activation path. xq: (batch, h, w,
// cin) int8 contiguous, the layer's input, already quantized with scale
// s_in. wq, s_w, bias, shapes, leaky, instance and bn as yolo_conv2d_int8,
// except that there is no quantize pass and no scratch: instances 0 and 1
// read xq itself (instance 1 needs it 16-byte aligned), instance 2 (k = 3,
// or k = 7 at the tile bn) packs its bytes. y: (batch, ho, wo, cout)
// contiguous, int8 requantized with inv_out = 1 / the output's scale
// (y_int8 = 1; instance 2 then needs cout % 16 == 0) or f32 (y_int8 = 0;
// cout % 8 == 0 for instance 2). Launches on `stream` and returns the first
// CUDA error, or 0.
extern "C" int yolo_conv2d_int8_q(const void* xq, const void* wq, float s_in,
                                  const void* s_w, const void* bias, void* y,
                                  int y_int8, float inv_out, int batch, int h,
                                  int w, int cin, int cout, int ksize,
                                  int stride, int pad, int leaky,
                                  int instance, int bn, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || cin < 1 || cout < 1 || ksize < 1 ||
      stride < 1 || pad < 0 || instance < 0 || instance > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 1 && (cin % 16 != 0 || !aligned16(wq) || !aligned16(xq))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 2 &&
      !direct_fits(cin, ksize, cout, bn, y_int8 ? 16 : 8, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = instance == 2 && ksize == 3 ? kDirectN3 : bn;
  igemm::Conv g;
  g.a = xq;
  g.b = wq;
  if (!igemm::set_shape(&g, batch, h, w, cin, cout, ksize, stride, pad,
                        tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g.m == 0) return 0;
  Epilogue p;
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.s_x = s_in;
  p.inv_out = inv_out;
  p.leaky = leaky;
  p.y_vec = cout % (y_int8 ? 16 : 4) == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 2 && ksize == 3) {
    err = y_int8 ? launch_direct<int8_t, int8_t, 3, kDirectN3>(g, p, s)
                 : launch_direct<int8_t, float, 3, kDirectN3>(g, p, s);
  } else if (instance == 2) {
    err = y_int8 ? launch_direct7<int8_t>(bn, g, p, s)
                 : launch_direct7<float>(bn, g, p, s);
  } else if (instance == 1) {
    err = y_int8 ? launch_bn<int8_t, true>(bn, g, p, s)
                 : launch_bn<float, true>(bn, g, p, s);
  } else {
    err = y_int8 ? launch_bn<int8_t, false>(bn, g, p, s)
                 : launch_bn<float, false>(bn, g, p, s);
  }
  return static_cast<int>(err);
}
