// Int8 (w8a8) convolution for Hopper (sm_90a): an implicit GEMM on the int8
// tensor cores, with the input quantized by a prologue pass and the
// dequantize + bias + activation epilogue fused.
//
// Replaces the Pallas TPU kernels tools/probe_int8_3x3.py:35
// (pallas_conv3x3_int8), :75 (pallas_conv3x3_shiftgemm_int8) and :147
// (pallas_conv3x3_k3gemm_int8). Those are three TPU formulations of one
// function, the int8 x int8 -> int32 3x3 stride-1 conv, each gated bit-exact
// against XLA's lax.conv. This kernel computes that accumulator for every
// conv that int8 serving quantizes (any square k, any stride, any padding,
// as lax.conv takes them: the implicit GEMM walks (ky, kx, c) from each
// output pixel's (oy * stride - pad, ox * stride - pad)), and around it the
// rest of yolo_tensorflow_tpu/ops/quant.py conv2d_int8, which on the TPU
// was XLA's:
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
// direct kernel stages its bytes. Its epilogue, in f32:
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
// - Cin = 3 (a network's first conv: yolov3's 3x3 s1 3 -> 32, yolov1's
//   7x7 s2 3 -> 64; k = 3 with Cout <= 32, k = 7 with Cout <= 64, any
//   padding, and a stride whose input patch fits a CTA's shared memory):
//   conv_int8_direct, for both entries. The stride may reach 8 at 7x7 with
//   Cout 64 and float32 out, 10 at 3x3; the wrapper sends a larger one to
//   the element-by-element instance. The direct kernel replaces
//   the same TPU function as the rest of this file (the probes above, and
//   yolo_tensorflow_tpu/ops/quant.py conv2d_int8: quantize, then lax.conv
//   with int32 accumulation) at the shapes where K = k * k * 3 is too short
//   for the implicit GEMM's 16-byte rows.
//   Bound: bytes. At batch 64 it moves 488 MB at yolov1-448 (bf16 input
//   read once, bf16 output written once: 0.1457 ms at 3.35 TB/s; its 60.4
//   G int8 operations take 0.031 ms) and 775 MB at yolov3-416 (0.2314 ms);
//   int8 in and out, half of each.
//   Design: a persistent CTA of 8 warps stages the weights once, then for
//   each 8 x 32 tile of output pixels stages its input halo patch in shared
//   memory as a word (R, G, B, 0) a pixel, quantizing each input element
//   once (the tile's neighbours read the halo again, from L2), and takes
//   the products on the int8 tensor cores with mma.sync m16n8k32: a pixel
//   word is one 32-bit A register at k = 7 (K = 49 taps x 4 bytes, 7 k32
//   steps); at k = 3 the 27 bytes (ky, kx, c) fill one k32 step, each A
//   register a byte permute of two words. The next tile's patch is staged
//   into a second buffer while a tile's products run, its loads issued a
//   tile ahead; the epilogue (epilogue2) runs on the C fragments, and each
//   warp writes its output row's run in whole 16-byte chunks. No quantize
//   pass and no scratch tensor at either k: the first conv reads its input
//   once and writes its output once. It is held back by instruction issue,
//   not by bytes: the bf16 epilogue's step-wise rounding, the tensor-core
//   latency of a short K, the patch's quantize (see PERF.md for the times
//   and ops/kernels/direct_probe.py for where they go).
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

// [probe:head]
constexpr int kBM = igemm::kBM;                 // output pixels per CTA
constexpr int kQuantThreads = 256;

// The direct first-conv kernel's tile plan (ops/kernels/conv_int8.py
// direct_plan mirrors it; tests/test_torch_kernel_host.py holds the two
// equal). A CTA owns kDirectTH x kDirectTW output pixels of one image, one
// output row per warp, each row two m16 tiles of the mma.
constexpr int kDirectTH = 8;                    // output rows per CTA
constexpr int kDirectTW = 32;                   // output columns per CTA
constexpr int kDirectThreads = 32 * kDirectTH;  // one warp a row
constexpr int kDirectMT = kDirectTW / 16;       // m16 tiles per warp
constexpr int kTapsPerStep = 8;                 // taps (4 bytes each) a k32
constexpr int kDirectWBank = 24;                // weight pitch mod 32 words
constexpr int kDirectYPad = 16;                 // bytes past a staged pixel
constexpr int kDirectN3 = 32;                   // Cout tile of k = 3
constexpr int kDirectN7 = 64;                   // widest Cout tile of k = 7
constexpr int kMaxSharedBytes = 232448;         // 227 KB a CTA (sm_90)

// K of the direct kernel, in k32 steps. Packed (k = 3): the ks * ks * 3
// bytes (ky, kx, c) back to back and zero bytes to the step's end, 27 -> 32
// bytes, one step; each A register joins two pixel words with a byte
// permute. Unpacked (k = 7): (tap, c) with c padded to 4, eight taps a
// step, the last step padded with taps whose weights are zero, 49 taps ->
// 7 steps; each A register is one pixel word. Packed, k = 7 would take 147
// bytes in 5 steps, 80 mma a warp's tile row instead of 112, but 80 A
// loads and 40 byte permutes instead of 56 loads; on an H100 it measured
// 11-14 % slower at both entries (direct_probe's pack7; PERF.md), so the
// tensor cores' rate is not what holds the 7x7 instance back.
__host__ __device__ constexpr bool direct_packed(int ks) {
  // [probe:k-order]
  return ks == 3;
}
__host__ __device__ constexpr int direct_k_steps(int ks) {
  return direct_packed(ks) ? (ks * ks * 3 + 31) / 32
                           : (ks * ks + kTapsPerStep - 1) / kTapsPerStep;
}
// Words of a channel's weight row in shared memory. Packed: the 8 words of
// each k32 step, a pitch of 8 mod 32 words. Else the taps, padded to a
// pitch of 24 mod 32 words. Either puts each half warp's 4 channels x 4
// lanes x 8 bytes of one B fragment load on 32 distinct banks.
__host__ __device__ constexpr int direct_w_pitch(int ks) {
  return direct_packed(ks)
             ? direct_k_steps(ks) * kTapsPerStep
             : direct_k_steps(ks) * kTapsPerStep +
                   ((kDirectWBank - direct_k_steps(ks) * kTapsPerStep) % 32 +
                    32) % 32;
}
// Patch pixels whose loads a thread issues one tile ahead, in registers:
// the whole patch at stride 1 (k = 3) and 2 (k = 7)
__host__ __device__ constexpr int direct_round(int ks) {
  return ks == 3 ? 2 : 6;
}
// CTAs an SM should hold at once (the registers a thread may take follow)
__host__ __device__ constexpr int direct_min_ctas(int ks) {
  return ks == 3 ? 3 : 2;
}
// The input patch that a CTA's output tile reads, in pixels
__host__ __device__ constexpr long long direct_patch_h(int ks, int stride) {
  return static_cast<long long>(kDirectTH - 1) * stride + ks;
}
__host__ __device__ constexpr long long direct_patch_w(int ks, int stride) {
  return static_cast<long long>(kDirectTW - 1) * stride + ks;
}
// Bytes of one staged output pixel: n channels and a pad
__host__ __device__ constexpr int direct_y_pitch(int n, int out_bytes) {
  return n * out_bytes + kDirectYPad;
}
// Dynamic shared memory of a CTA: weights (n rows of direct_w_pitch words),
// the n scales and n biases, the staged output tile, two buffers of the
// input patch (a word a pixel, each rounded up to 16 bytes).
__host__ __device__ constexpr long long direct_smem_bytes(int ks, int n,
                                                          int out_bytes,
                                                          int stride) {
  return 4LL * n * direct_w_pitch(ks) + 8LL * n +
         static_cast<long long>(kDirectTH) * kDirectTW *
             direct_y_pitch(n, out_bytes) +
         2 * ((direct_patch_h(ks, stride) * direct_patch_w(ks, stride) * 4 +
               15) / 16 * 16);
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

// clamp(rint(v * inv), -127, 127): the requantize of the int8-in entry,
// as max(v * inv, -127) rounded half to even and saturated to 127 by one
// cvt.rni.sat.s8.f32. The same byte for every float: rounding is monotone,
// so clamping below before it and above after it commute with it; NaN
// (fmaxf gives -127) and infinities come out -127 and +-127 either way.
__device__ __forceinline__ int8_t requant(float v, float inv) {
  int q;
  asm("cvt.rni.sat.s8.f32 %0, %1;"
      : "=r"(q) : "f"(fmaxf(__fmul_rn(v, inv), -127.0f)));
  return static_cast<int8_t>(q);
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
  // [probe:epilogue]
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
  // [probe:epilogue]
  const float2 y = epilogue2(a0, a1, sc, b, p, 0.0f);
  return make_char2(requant(y.x, p.inv_out), requant(y.y, p.inv_out));
}

__device__ __forceinline__ __nv_bfloat162 epilogue2(int a0, int a1, float2 sc,
                                                    float2 b,
                                                    const Epilogue& p,
                                                    __nv_bfloat16) {
  // [probe:epilogue]
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

// D += A B for one m16n8k32 tile: int8 x int8 -> int32 on the tensor cores.
// a: rows g and g + 8 of the A tile at k 4t..4t+3 and 16+4t..16+4t+3 (g =
// lane / 4, t = lane % 4); b: k 4t..4t+3 and 16+4t..16+4t+3 of column g;
// d: rows g and g + 8 at columns 2t and 2t + 1.
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  // [probe:mma]
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An output tile: its image, tile row and tile column (tiles are numbered
// image-major, then rows of tiles, then columns).
struct DirectTile {
  int img, ty, tx;
};

__device__ __forceinline__ DirectTile direct_tile(int tile, int tiles_w,
                                                  int tiles_h) {
  DirectTile t;
  t.tx = tile % tiles_w;
  tile /= tiles_w;
  t.ty = tile % tiles_h;
  t.img = tile / tiles_h;
  return t;
}

// The tile d tiles after t, for d as direct_tile gives it: a mixed-radix
// add, no division.
__device__ __forceinline__ DirectTile tile_add(DirectTile t,
                                               const DirectTile& d,
                                               int tiles_w, int tiles_h) {
  t.tx += d.tx;
  int carry = t.tx >= tiles_w;
  t.tx -= carry * tiles_w;
  t.ty += d.ty + carry;
  carry = t.ty >= tiles_h;
  t.ty -= carry * tiles_h;
  t.img += d.img + carry;
  return t;
}

// The input pixel (r, c) of a tile's ph x pw patch as three elements,
// zero outside the patch or the image (JAX pads the quantized tensor with
// 0).
template <typename Tin>
__device__ __forceinline__ void load_pixel(const Tin* __restrict__ x,
                                           const igemm::Conv& g,
                                           const DirectTile& t, int r, int c,
                                           int ph, Tin v[3]) {
  // [probe:load]
  const int iy = t.ty * kDirectTH * g.stride - g.pad + r;
  const int ix = t.tx * kDirectTW * g.stride - g.pad + c;
  const bool in = r < ph && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
  const Tin* src =
      x + (static_cast<int64_t>(t.img * g.h + iy) * g.w + ix) * 3;
#pragma unroll
  for (int e = 0; e < 3; ++e) v[e] = in ? src[e] : Tin();
}

// A pixel's word (R, G, B, 0): each element quantized (an int8 input as it
// is).
template <typename Tin>
__device__ __forceinline__ uint32_t pixel_word(const Tin v[3], float s_x) {
  return input_byte(v[0], s_x) | (input_byte(v[1], s_x) << 8) |
         (input_byte(v[2], s_x) << 16);
}

// Cin = 3, a KS x KS conv at any padding and at a stride whose patch fits
// the shared memory (direct_smem_bytes), Cout <= N and Cout a
// whole number of 16-byte chunks of Tout. The output is cut into kDirectTH
// x kDirectTW tiles of pixels of one image (DirectTile); the CTAs are
// persistent, CTA i taking tiles i, i + gridDim.x, ... Each CTA
// 1. repacks the weights into shared memory once, in the K order of its
//    A fragments, zero past Cout and past K;
// 2. stages each tile's input patch, ph x pw = ((TH - 1) s + KS) x ((TW -
//    1) s + KS) pixels, as a word (R, G, B, 0) a pixel: each element
//    quantized once. Two patch buffers: while the tensor cores run one
//    tile's products, the CTA stages the next tile's patch into the other
//    buffer from registers whose loads it issued a tile earlier (the
//    first R(KS) * 256 pixels of a patch: all of it at stride 1 for k = 3
//    and 2 for k = 7; the rest, at a larger stride, is loaded as it is
//    staged), and issues the loads of the tile after;
// 3. runs mma.sync m16n8k32 on a tile: K = (tap, c) with c padded to 4
//    (k = 7: each 32-bit register of an A fragment is one pixel's word,
//    one aligned shared-memory load; lane t's two words of step j are taps
//    8 j + 2 t and 8 j + 2 t + 1, so its B pair is one 8-byte load), or
//    the 27 bytes (ky, kx, c) in one step (k = 3: a register joins two
//    words with a byte permute); warp w takes output row w, kDirectMT m16
//    tiles of 16 pixels, all N / 8 n tiles;
// 4. runs the epilogue on the C fragments (a lane holds two neighbouring
//    channels of two pixels, epilogue2's pair), stages its row in shared
//    memory and writes the row's run of TW * Cout elements as whole
//    16-byte chunks, neighbouring lanes neighbouring chunks.
// One CTA barrier a tile. int32 sums are exact in any order, so the result
// is the one of every other int8 conv here and of the plain twins, bit for
// bit.
template <typename Tin, typename Tout, int KS, int N>
__global__ void __launch_bounds__(kDirectThreads, direct_min_ctas(KS))
conv_int8_direct(const igemm::Conv g, const Epilogue p, int tiles_w,
                 int tiles_h, int tiles) {
  // [probe:begin]
  constexpr int kSteps = direct_k_steps(KS);
  constexpr int kWP = direct_w_pitch(KS);
  constexpr int kYP = direct_y_pitch(N, sizeof(Tout));
  constexpr int kNT = N / 8;
  constexpr int kR = direct_round(KS);
  constexpr int kT = kDirectThreads;
  extern __shared__ __align__(16) uint8_t direct_smem[];
  uint32_t* w_s = reinterpret_cast<uint32_t*>(direct_smem);
  float* sc_s = reinterpret_cast<float*>(w_s + N * kWP);
  float* b_s = sc_s + N;
  uint8_t* y_s = reinterpret_cast<uint8_t*>(b_s + N);
  uint32_t* x_s =
      reinterpret_cast<uint32_t*>(y_s + kDirectTH * kDirectTW * kYP);
  const int tid = threadIdx.x;
  const int s = g.stride;
  const int pw = (kDirectTW - 1) * s + KS;
  const int ph = (kDirectTH - 1) * s + KS;
  const int n_px = ph * pw;
  const int buf_words = (n_px + 3) / 4 * 4;     // one of two patch buffers
  // the patch pixel tid, as (row, column), and the step of kT pixels: a
  // thread's pixels tid + u * kT without a division
  const int r0 = tid / pw;
  const int c0 = tid - r0 * pw;
  const int step_r = kT / pw;
  const int step_c = kT - step_r * pw;
  const Tin* x = static_cast<const Tin*>(g.a);
  Tout* y = static_cast<Tout*>(p.y);

  // the loads of a tile's first kR * kT patch pixels
  Tin v[kR][3];
  auto prefetch = [&](const DirectTile& at) {
    int r = r0, c = c0;
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      load_pixel(x, g, at, r, c, ph, v[u]);
      r += step_r;
      c += step_c;
      if (c >= pw) {
        c -= pw;
        ++r;
      }
    }
  };
  // tile `at`'s patch into buffer xb: the prefetched pixels, then the rest
  auto stage = [&](const DirectTile& at, uint32_t* xb) {
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int i = tid + u * kT;
      if (i < n_px) xb[i] = pixel_word(v[u], p.s_x);
    }
    for (int i = tid + kR * kT; i < n_px; i += kT) {
      Tin rest[3];
      load_pixel(x, g, at, i / pw, i % pw, ph, rest);
      xb[i] = pixel_word(rest, p.s_x);
    }
  };

  int tile = blockIdx.x;
  const DirectTile step = direct_tile(gridDim.x, tiles_w, tiles_h);
  DirectTile t = direct_tile(tile, tiles_w, tiles_h);
  prefetch(t);                  // in flight while the weights are staged
  const uint8_t* wq = static_cast<const uint8_t*>(g.b);
  for (int i = tid; i < N * kWP; i += kT) {
    const int o = i / kWP;
    const int slot = i - o * kWP;
    uint32_t word = 0u;
    if constexpr (direct_packed(KS)) {
      // K bytes 4 q .. 4 q + 3, with q = 8 j + i / 2 + 4 (i % 2) for slot
      // i of step j: a lane's two B words of a step, q and q + 4, side by
      // side for one 8-byte load
      const int q = (slot & ~7) + (slot & 7) / 2 + 4 * (slot & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        if (o < g.cout && k < KS * KS * 3) {
          word |= static_cast<uint32_t>(wq[o * KS * KS * 3 + k]) << (8 * e);
        }
      }
    } else if (o < g.cout && slot < KS * KS) {
      const uint8_t* src = wq + (o * KS * KS + slot) * 3;
      word = static_cast<uint32_t>(src[0]) |
             (static_cast<uint32_t>(src[1]) << 8) |
             (static_cast<uint32_t>(src[2]) << 16);
    }
    w_s[i] = word;
  }
  if (tid < N) {
    const bool in = tid < g.cout;
    sc_s[tid] = in ? __fmul_rn(p.s_x, p.s_w[tid]) : 0.0f;
    b_s[tid] = in ? p.bias[tid] : 0.0f;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // Unpacked: this lane's taps of step j, 8 j + 2 t and 8 j + 2 t + 1
  // (h = 0, 1), as patch word offsets. Packed: its K words q = 8 j + t + 4 h
  // (bytes 4 q .. 4 q + 3) span two taps, tap_off[j][h][0] (bytes from q %
  // 3 on) and tap_off[j][h][1], which a byte permute joins: sel[c] for
  // (t + c) % 3, c = (2 j + h) % 3. A tap past KS * KS meets zero weights,
  // so any word will do.
  constexpr int kTapWords = direct_packed(KS) ? 2 : 1;
  int tap_off[kSteps][2][kTapWords];
  uint32_t sel[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int r = (tq + c) % 3;
    sel[c] = r == 0 ? 0x4210u : r == 1 ? 0x5421u : 0x6542u;
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = j * kTapsPerStep + tq + 4 * h;
      const int tap = direct_packed(KS) ? 4 * q / 3
                                        : j * kTapsPerStep + 2 * tq + h;
#pragma unroll
      for (int e = 0; e < kTapWords; ++e) {
        tap_off[j][h][e] =
            tap + e < KS * KS ? ((tap + e) / KS) * pw + (tap + e) % KS : 0;
      }
    }
  }
  // the patch word of this lane's pixels g and g + 8 of each m16 tile
  int pix[kDirectMT][2];
#pragma unroll
  for (int mt = 0; mt < kDirectMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pix[mt][h] = warp * s * pw + (mt * 16 + gq + 8 * h) * s;
    }
  }
  const int n_tiles = (g.cout + 7) / 8;         // n tiles that hold Cout
  constexpr int kChunks = N * sizeof(Tout) / 16;
  const int chunks = g.cout * static_cast<int>(sizeof(Tout)) / 16;
  uint8_t* y_row = y_s + warp * kDirectTW * kYP;

  // the first tile's patch into buffer 0, the second's loads in flight
  stage(t, x_s);
  DirectTile next = tile_add(t, step, tiles_w, tiles_h);
  if (tile + static_cast<long long>(gridDim.x) < tiles) prefetch(next);
  __syncthreads();

  // [probe:phase7]
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const uint32_t* x_b = x_s + buf * buf_words;
    int acc[kDirectMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kDirectMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      }
    }
    // While the products run: the next tile's patch into the other buffer
    // (every warp read that buffer, for the tile before this one, before
    // the barrier that ended it), and the loads of the tile after.
    const DirectTile cur = t;
    auto advance = [&]() {
      // [probe:phase3]
      if (tile + static_cast<long long>(gridDim.x) < tiles) {
        stage(next, x_s + (buf ^ 1) * buf_words);
        // [probe:phase0]
        t = next;
        next = tile_add(next, step, tiles_w, tiles_h);
        if (tile + 2LL * gridDim.x < tiles) prefetch(next);
        // [probe:phase1]
      }
    };
    if constexpr (direct_packed(KS)) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        // a k32 step: its shared-memory loads first (after the last step's,
        // the next patch while they land), then the byte permutes and the
        // products
        uint32_t w[kDirectMT][4][2];
        uint2 bw[kNT];
#pragma unroll
        for (int mt = 0; mt < kDirectMT; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {        // pixel r % 2, half r / 2
            const uint32_t* px = x_b + pix[mt][r % 2];
            w[mt][r][0] = px[tap_off[j][r / 2][0]];
            w[mt][r][1] = px[tap_off[j][r / 2][1]];
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          bw[nt] = *reinterpret_cast<const uint2*>(
              w_s + (nt * 8 + gq) * kWP + j * kTapsPerStep + 2 * tq);
        }
        if (j == kSteps - 1) advance();
#pragma unroll
        for (int mt = 0; mt < kDirectMT; ++mt) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = __byte_perm(w[mt][r][0], w[mt][r][1],
                               sel[(2 * j + r / 2) % 3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (nt < n_tiles) mma_s8(acc[mt][nt], a, bw[nt].x, bw[nt].y);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        uint32_t a[kDirectMT][4];
#pragma unroll
        for (int mt = 0; mt < kDirectMT; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {        // pixel r % 2, half r / 2
            a[mt][r] = x_b[pix[mt][r % 2] + tap_off[j][r / 2][0]];
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt < n_tiles) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                w_s + (nt * 8 + gq) * kWP + j * kTapsPerStep + 2 * tq);
#pragma unroll
            for (int mt = 0; mt < kDirectMT; ++mt) {
              mma_s8(acc[mt][nt], a[mt], b.x, b.y);
            }
          }
        }
      }
      advance();
    }
    // [probe:phase3]

    // this warp's row: staged in y_s (its own stores of the previous tile
    // read it before the barrier that ended that tile), then written out
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < n_tiles) {
        const int n = nt * 8 + 2 * tq;
        const float2 sc = make_float2(sc_s[n], sc_s[n + 1]);
        const float2 b = make_float2(b_s[n], b_s[n + 1]);
#pragma unroll
        for (int mt = 0; mt < kDirectMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = mt * 16 + gq + 8 * h;
            store_pair(reinterpret_cast<Tout*>(y_row + px * kYP) + n,
                       epilogue2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1],
                                 sc, b, p, Tout()));
          }
        }
      }
    }
    // [probe:phase4]
    __syncwarp();
    const int oy = cur.ty * kDirectTH + warp;
    if (oy < g.ho) {
      const int ox0 = cur.tx * kDirectTW;
      const int run = min(kDirectTW, g.wo - ox0) * chunks;
      uint4* dst = reinterpret_cast<uint4*>(
          y + (static_cast<int64_t>(cur.img * g.ho + oy) * g.wo + ox0) *
                  g.cout);
      if (chunks == kChunks) {                  // Cout = N: no division
        for (int c = lane; c < run; c += 32) {
          // [probe:store]
          const int px = c / kChunks;
          dst[c] = *reinterpret_cast<const uint4*>(
              y_row + px * kYP + (c - px * kChunks) * 16);
        }
      } else {
        for (int c = lane; c < run; c += 32) {
          // [probe:store]
          const int px = c / chunks;
          dst[c] = *reinterpret_cast<const uint4*>(
              y_row + px * kYP + (c - px * chunks) * 16);
        }
      }
    }
    // [probe:phase5]
    __syncthreads();
    // [probe:phase2]
  }
  // [probe:end]
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
cudaError_t launch_direct(int batch, const igemm::Conv& g, const Epilogue& p,
                          cudaStream_t s) {
  static bool allowed[igemm::kMaxDevices];
  const long long smem = direct_smem_bytes(KS, N, sizeof(Tout), g.stride);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const cudaError_t err = igemm::allow_smem(
      conv_int8_direct<Tin, Tout, KS, N>, kMaxSharedBytes, allowed);
  if (err != cudaSuccess) return err;
  const int tiles_w = (g.wo + kDirectTW - 1) / kDirectTW;
  const int tiles_h = (g.ho + kDirectTH - 1) / kDirectTH;
  const long long tiles = static_cast<long long>(batch) * tiles_h * tiles_w;
  // persistent CTAs: as many as the SMs hold at once, or one a tile. That
  // count follows from the device and the shared memory (the stride), and
  // is kept for the last shared-memory size each device launched with (any
  // count computes the same output, so a stale one costs only time).
  static long long smem_of[igemm::kMaxDevices];
  static long long ctas_of[igemm::kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem_of[dev] != smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_int8_direct<Tin, Tout, KS, N>, kDirectThreads,
          static_cast<size_t>(smem));
    }
    if (e != cudaSuccess) return e;
    ctas_of[dev] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    smem_of[dev] = smem;
  }
  const long long ctas = ctas_of[dev];
  // a CTA's tile index, and the one after it, must fit an int
  if (tiles + ctas > INT32_MAX) return cudaErrorInvalidValue;
  conv_int8_direct<Tin, Tout, KS, N>
      <<<static_cast<unsigned>(tiles < ctas ? tiles : ctas), kDirectThreads,
         static_cast<int>(smem), s>>>(g, p, tiles_w, tiles_h,
                                      static_cast<int>(tiles));
  return cudaGetLastError();
}

// The direct kernel at k = 3 (Cout tile 32) or k = 7 (Cout tile `bn`, 32 or
// 64), on f32, bf16 or int8 input.
template <typename Tin, typename Tout>
cudaError_t launch_direct_k(int batch, int bn, const igemm::Conv& g,
                            const Epilogue& p, cudaStream_t s) {
  if (g.ksize == 3) {
    return launch_direct<Tin, Tout, 3, kDirectN3>(batch, g, p, s);
  }
  return bn == kDirectN3
             ? launch_direct<Tin, Tout, 7, kDirectN3>(batch, g, p, s)
             : launch_direct<Tin, Tout, 7, kDirectN7>(batch, g, p, s);
}

// Whether the direct kernel takes this conv: Cin = 3, k = 3 with Cout <= 32
// or k = 7 with Cout <= 64 at a tile `bn` that covers it, Cout in whole
// 16-byte chunks of the output (`chunk` elements) and y 16-byte aligned.
// (launch_direct refuses a stride whose input patch does not fit a CTA's
// shared memory.)
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
//   2  the direct kernel, which quantizes each input element once in
//      shared memory (no pass, xq unused): cin == 3, cout % 8 == 0, y
//      16-byte aligned, and ksize == 3 with cout <= 32 or ksize == 7 with
//      cout <= bn; a stride whose input patch does not fit a CTA's shared
//      memory is refused.
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
  const bool direct = instance == 2;
  if (!direct && (xq == nullptr || !aligned16(xq))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 1 && (cin % 16 != 0 || !aligned16(wq))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (direct && !direct_fits(cin, ksize, cout, bn, 8, y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  igemm::Conv g;
  g.a = direct ? x : xq;
  g.b = wq;
  if (!igemm::set_shape(&g, batch, h, w, cin, cout, ksize, stride, pad,
                        direct && ksize == 3 ? kDirectN3 : bn)) {
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
  if (direct) {
    using BF = __nv_bfloat16;
    if (x_bf16) {
      err = y_bf16 ? launch_direct_k<BF, BF>(batch, bn, g, p, s)
                   : launch_direct_k<BF, float>(batch, bn, g, p, s);
    } else {
      err = y_bf16 ? launch_direct_k<float, BF>(batch, bn, g, p, s)
                   : launch_direct_k<float, float>(batch, bn, g, p, s);
    }
    return static_cast<int>(err);
  }
  const int64_t n = static_cast<int64_t>(batch) * h * w * cin;
  err = x_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, n, s_x, s)
               : launch_quantize<float>(x, xq, n, s_x, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (instance == 1) {
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
// or k = 7 at the tile bn) stages its bytes as they are. y: (batch, ho, wo,
// cout) contiguous, int8 requantized with inv_out = 1 / the output's scale
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
  igemm::Conv g;
  g.a = xq;
  g.b = wq;
  if (!igemm::set_shape(&g, batch, h, w, cin, cout, ksize, stride, pad,
                        instance == 2 && ksize == 3 ? kDirectN3 : bn)) {
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
  if (instance == 2) {
    err = y_int8 ? launch_direct_k<int8_t, int8_t>(batch, bn, g, p, s)
                 : launch_direct_k<int8_t, float>(batch, bn, g, p, s);
  } else if (instance == 1) {
    err = y_int8 ? launch_bn<int8_t, true>(bn, g, p, s)
                 : launch_bn<float, true>(bn, g, p, s);
  } else {
    err = y_int8 ? launch_bn<int8_t, false>(bn, g, p, s)
                 : launch_bn<float, false>(bn, g, p, s);
  }
  return static_cast<int>(err);
}
