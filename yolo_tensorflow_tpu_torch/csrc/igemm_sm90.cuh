// The main loop that the package's two implicit-GEMM convolutions share on
// Hopper (sm_90a): conv_bnstat.cu (bf16) and conv_int8.cu (int8).
//
// GEMM view of a convolution: M = batch*Ho*Wo output pixels, N = Cout,
// K = k*k*Cin in (ky, kx, c) order. A is gathered from the NHWC input, B is
// the (Cout, K) weight rows, both K-major with elements of 1 or 2 bytes.
//
// - One CTA of 256 threads computes a 128 x BN tile, BN in {256, 128, 64,
//   32} chosen by the caller from Cout. K advances 128 bytes a step (64 bf16
//   or 128 int8 values): one tile row is one 128-byte swizzle row.
// - A ring of three or four stages (stages<BN>()) in dynamic shared memory,
//   each an A tile (128 rows) and a B tile (BN rows). Every thread copies its
//   share of both tiles with 16-byte cp.async; the padded border, rows past
//   M, columns past Cout and the K tail are zero-filled by cp.async's
//   src-size 0, so no data passes through registers. A thread keeps (pix,
//   iy0, ix0) of its four A rows and walks (ky, kx, c) of its chunk forward
//   tile by tile, with no division in the loop. That needs Cin * element
//   size % 16 == 0 and 16-byte aligned operands (kAsync); otherwise the same
//   ring is filled element by element through registers (the odd-shape
//   instance).
// - Tiles are stored with the 128-byte swizzle (16-byte chunk index XOR
//   row & 7, tile bases 1024-byte aligned), the layout wgmma reads through a
//   shared-memory matrix descriptor (K-major, SBO 1024 bytes).
// - Two warpgroups, each 64 rows x BN, issue wgmma.mma_async
//   (m64nBNk16 bf16 -> f32, m64nBNk32 s8 -> s32) on the stage that has
//   landed, commit, and wait for all but the newest group, so tile kt's
//   products run while tile kt + stages - 2 is being copied. A stage is
//   overwritten only after the CTA barrier that follows every warpgroup's
//   wait on the wgmma that read it.
// - cp.async writes shared memory through the generic proxy and wgmma reads
//   it through the async proxy: every thread issues
//   fence.proxy.async.shared::cta after its copies have landed and before
//   the CTA barrier that releases the stage to wgmma.
// - The accumulators stay in registers; mainloop() returns them in the
//   wgmma fragment layout (frag_row / frag_col below) and leaves the ring
//   free, so that the caller's epilogue stages its output tile there and
//   writes it out 16 bytes a thread along Cout (copy_tile_out).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int kBM = 128;                     // output pixels per CTA
constexpr int kRowBytes = 128;               // K bytes per stage and tile row
constexpr int kThreads = 256;                // two warpgroups
constexpr int kLoadRows = kThreads / 8;      // tile rows per loader pass
constexpr int kAPasses = kBM / kLoadRows;
constexpr int kATileBytes = kBM * kRowBytes;
constexpr int kPassBytes = kLoadRows * kRowBytes;
constexpr int kMaxDevices = 64;

// CTAs that share an SM (its 227 KB of shared memory and 64 K registers),
// and stages of the ring, by tile width. Two CTAs let one's epilogue and
// pipeline fill hide under the other's products, which on an H100 was worth
// more than a fourth stage at every yolov3 conv of the 128-wide tile (most
// where K is short); the 256-wide tile cannot share an SM: its accumulators
// take half the registers.
template <int BN>
__host__ __device__ constexpr int ctas_per_sm() {
  return BN == 256 ? 1 : 2;
}

template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 128 ? 3 : 4;
}

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kATileBytes + BN * kRowBytes;
}

// Dynamic shared memory of one CTA: the ring, and room to align it to 1024.
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BN>() * stage_bytes<BN>() + 1024;
}

struct Conv {
  const void* a;        // (batch, h, w, cin)
  const void* b;        // (cout, ksize, ksize, cin)
  int h, w, cin, ho, wo, cout, ksize, stride, pad;
  int m;                // batch * ho * wo
  int kdim;             // ksize * ksize * cin
  int n_tiles;          // ceil(cout / BN)
};

// Fill the shape fields of a Conv; false if an index would not fit an int.
inline bool set_shape(Conv* p, int batch, int h, int w, int cin, int cout,
                      int ksize, int stride, int pad, int bn) {
  p->h = h;
  p->w = w;
  p->cin = cin;
  p->cout = cout;
  p->ksize = ksize;
  p->stride = stride;
  p->pad = pad;
  p->ho = (h + 2 * pad - ksize) / stride + 1;
  p->wo = (w + 2 * pad - ksize) / stride + 1;
  if (p->ho < 1 || p->wo < 1) return false;
  const int64_t m = static_cast<int64_t>(batch) * p->ho * p->wo;
  const int64_t kdim = static_cast<int64_t>(ksize) * ksize * cin;
  p->n_tiles = (cout + bn - 1) / bn;
  const int64_t blocks = (m + kBM - 1) / kBM * p->n_tiles;
  if (m > INT32_MAX - kBM || 2 * kdim > INT32_MAX - kRowBytes ||
      static_cast<int64_t>(batch) * h * w > INT32_MAX ||
      blocks > INT32_MAX) {
    return false;
  }
  p->m = static_cast<int>(m);
  p->kdim = static_cast<int>(kdim);
  return true;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize), once per kernel instance
// and device; `done` is the instance's own table of kMaxDevices flags.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// start address, leading offset 1 (unused: K spans one swizzle row), stride
// between 8-row groups 1024 bytes, layout type 1 (128B swizzle). Adding
// bytes >> 4 to it moves the start along K inside the swizzle row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define IGEMM_C4(t, d, i) t(d[i]), t(d[i + 1]), t(d[i + 2]), t(d[i + 3])
#define IGEMM_C16(t, d, i)                                                   \
  IGEMM_C4(t, d, i), IGEMM_C4(t, d, i + 4), IGEMM_C4(t, d, i + 8),           \
      IGEMM_C4(t, d, i + 12)
#define IGEMM_C32(t, d, i) IGEMM_C16(t, d, i), IGEMM_C16(t, d, i + 16)
#define IGEMM_C64(t, d, i) IGEMM_C32(t, d, i), IGEMM_C32(t, d, i + 32)
#define IGEMM_C128(t, d, i) IGEMM_C64(t, d, i), IGEMM_C64(t, d, i + 64)

// wgmma.mma_async of one warpgroup: d (64 x N, N = 2 * the number of
// registers) += A (64 x 32 bytes of K) x B (N x 32 bytes of K), both
// K-major in shared memory behind descriptors da and db.

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : IGEMM_C128("+f", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : IGEMM_C64("+f", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : IGEMM_C32("+f", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : IGEMM_C16("+f", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : IGEMM_C128("+r", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : IGEMM_C64("+r", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : IGEMM_C32("+r", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[16], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : IGEMM_C16("+r", d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// Orders later reads of an accumulator after the wgmma_wait before it.
__device__ __forceinline__ void fence_acc(float& v) {
  asm volatile("" : "+f"(v) :: "memory");
}

__device__ __forceinline__ void fence_acc(int& v) {
  asm volatile("" : "+r"(v) :: "memory");
}

// Row of the 128-row tile that accumulator registers 4j + 2*half + {0, 1} of
// this thread hold; their columns are frag_col(j) and frag_col(j) + 1.
__device__ __forceinline__ int frag_row(int half) {
  const int tid = threadIdx.x;
  return (tid >> 5) * 16 + ((tid & 31) >> 2) + 8 * half;
}

__device__ __forceinline__ int frag_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

// K index kk of row (pix, iy0, ix0): byte offset into the input, or -1 in
// the zero padding or past K. The odd-shape instance's addressing.
__device__ __forceinline__ int64_t element_of(const Conv& p, int pix, int iy0,
                                              int ix0, int kk) {
  if (kk >= p.kdim) return -1;
  const int kwc = p.ksize * p.cin;
  const int ky = kk / kwc;
  const int rem = kk - ky * kwc;
  const int kx = rem / p.cin;
  const int c = rem - kx * p.cin;
  const int iy = iy0 + ky;
  const int ix = ix0 + kx;
  if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) return -1;
  return static_cast<int64_t>(pix + iy * p.w + ix) * p.cin + c;
}

// acc += A tile (rows m0.., 128 of them) x B tile (columns n0.., BN of them)
// over all of K. E is an unsigned integer of the element's size (uint16_t
// for bf16, uint8_t for int8); Acc is float or int accordingly. `ring` is
// 1024-byte aligned dynamic shared memory of stages<BN>() * stage_bytes<BN>().
// Ends with a CTA barrier after which the ring may be reused.
template <typename E, int BN, bool kAsync, typename Acc>
__device__ __forceinline__ void mainloop(const Conv& p, int m0, int n0,
                                         uint8_t* ring, Acc (&acc)[BN / 2]) {
  constexpr int kES = sizeof(E);
  constexpr int kEPC = 16 / kES;              // elements per 16-byte chunk
  constexpr int kBKE = kRowBytes / kES;       // elements of K per stage
  constexpr int kBPasses = BN / kLoadRows;
  constexpr int kStage = stage_bytes<BN>();
  constexpr int kStages = stages<BN>();
  constexpr int kAhead = kStages - 2;         // tiles in flight past kt
  const uint8_t* a = static_cast<const uint8_t*>(p.a);
  const uint8_t* b = static_cast<const uint8_t*>(p.b);
  const int tid = threadIdx.x;
  const int chunk = tid & 7;                  // 16-byte chunk of the K row
  const int r0 = tid >> 3;                    // tile rows r0 + 32 i
  const uint32_t ring_addr = smem_u32(ring);
  // (r0 + 32 i) & 7 == r0 & 7: one swizzled offset serves all passes
  const uint32_t dst0 = r0 * kRowBytes + ((chunk ^ (r0 & 7)) << 4);

  int pix[kAPasses], iy0[kAPasses], ix0[kAPasses];
#pragma unroll
  for (int i = 0; i < kAPasses; ++i) {
    const int m = m0 + r0 + i * kLoadRows;
    if (m < p.m) {
      const int hw = p.ho * p.wo;
      const int img = m / hw;
      const int rem = m - img * hw;
      const int oy = rem / p.wo;
      pix[i] = img * p.h * p.w;
      iy0[i] = oy * p.stride - p.pad;
      ix0[i] = (rem - oy * p.wo) * p.stride - p.pad;
    } else {
      pix[i] = 0;
      iy0[i] = -(1 << 28);                    // never in bounds: zeros
      ix0[i] = 0;
    }
  }

  // (ky, kx, c) of this thread's chunk in the next tile it loads
  int ky, kx, c;
  {
    const int kwc = p.ksize * p.cin;
    const int kk = chunk * kEPC;
    ky = kk / kwc;
    const int rem = kk - ky * kwc;
    kx = rem / p.cin;
    c = rem - kx * p.cin;
  }
  const int64_t b_row = static_cast<int64_t>(p.kdim) * kES;   // bytes
  const uint8_t* b_src = b + (n0 + r0) * b_row + chunk * 16;
  const int k_bytes = p.kdim * kES;

  auto load_tile = [&](int t) {
    const uint32_t a_dst = ring_addr + (t % kStages) * kStage + dst0;
    const uint32_t b_dst = a_dst + kATileBytes;
    if constexpr (kAsync) {
      const bool k_ok = ky < p.ksize;
#pragma unroll
      for (int i = 0; i < kAPasses; ++i) {
        const int iy = iy0[i] + ky;
        const int ix = ix0[i] + kx;
        const bool ok = k_ok && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
        const uint8_t* src = a;
        if (ok) {
          src += (static_cast<int64_t>(pix[i] + iy * p.w + ix) * p.cin + c) *
                 kES;
        }
        cp_async16(a_dst + i * kPassBytes, src, ok);
      }
      const int kbyte = t * kRowBytes + chunk * 16;
#pragma unroll
      for (int i = 0; i < kBPasses; ++i) {
        const bool ok = kbyte < k_bytes && n0 + r0 + i * kLoadRows < p.cout;
        const uint8_t* src = b;
        if (ok) src = b_src + i * kLoadRows * b_row + t * kRowBytes;
        cp_async16(b_dst + i * kPassBytes, src, ok);
      }
      c += kBKE;
      while (c >= p.cin) {
        c -= p.cin;
        if (++kx == p.ksize) {
          kx = 0;
          ++ky;
        }
      }
    } else {
      const E* ae = static_cast<const E*>(p.a);
      const E* be = static_cast<const E*>(p.b);
      const int kk0 = t * kBKE + chunk * kEPC;
#pragma unroll
      for (int i = 0; i < kAPasses; ++i) {
        alignas(16) E e[kEPC];
#pragma unroll
        for (int j = 0; j < kEPC; ++j) {
          const int64_t at = element_of(p, pix[i], iy0[i], ix0[i], kk0 + j);
          e[j] = at >= 0 ? ae[at] : static_cast<E>(0);
        }
        st_shared16(a_dst + i * kPassBytes, *reinterpret_cast<uint4*>(e));
      }
#pragma unroll
      for (int i = 0; i < kBPasses; ++i) {
        const int n = n0 + r0 + i * kLoadRows;
        alignas(16) E e[kEPC];
#pragma unroll
        for (int j = 0; j < kEPC; ++j) {
          const bool ok = n < p.cout && kk0 + j < p.kdim;
          e[j] = ok ? be[static_cast<int64_t>(n) * p.kdim + kk0 + j]
                    : static_cast<E>(0);
        }
        st_shared16(b_dst + i * kPassBytes, *reinterpret_cast<uint4*>(e));
      }
    }
  };

  const int nk = (k_bytes + kRowBytes - 1) / kRowBytes;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load_tile(s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kAhead - 1>();              // this thread's part of tile kt
    fence_proxy_async();                      // generic writes -> async proxy
    __syncthreads();                          // tile kt whole; wgmma kt-2 done
    const uint32_t stage = ring_addr + (kt % kStages) * kStage;
    const uint64_t da = smem_desc(stage + wg * (64 * kRowBytes));
    const uint64_t db = smem_desc(stage + kATileBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRowBytes / 32; ++ks) {
      wgmma(acc, da + 2 * ks, db + 2 * ks);   // 32 bytes of K each
    }
    wgmma_commit();
    if (kt + kAhead < nk) load_tile(kt + kAhead);
    cp_async_commit();
    wgmma_wait<1>();                          // wgmma kt-1 done
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_acc(acc[i]);
  __syncthreads();
}

// Bytes between rows of the output tile staged in shared memory: 16 more
// than the row, so that the fragment writes spread over the banks.
template <typename T, int BN>
__host__ __device__ constexpr int tile_pitch() { return BN * sizeof(T) + 16; }

template <typename T, int BN>
__device__ __forceinline__ T* tile_at(uint8_t* tile, int row, int col) {
  return reinterpret_cast<T*>(tile + row * tile_pitch<T, BN>()) + col;
}

// Write the staged 128 x BN tile to y (M, cout) at (m0, n0): 16 bytes a
// thread along cout where `vec` (cout * sizeof(T) % 16 == 0 and y 16-byte
// aligned), element by element otherwise and in the last, ragged chunk.
template <typename T, int BN>
__device__ __forceinline__ void copy_tile_out(const uint8_t* tile, T* y,
                                              int m0, int n0, int m, int cout,
                                              bool vec) {
  constexpr int kEPV = 16 / sizeof(T);        // elements per 16 bytes
  constexpr int kCPR = BN / kEPV;             // chunks per tile row
  for (int id = threadIdx.x; id < kBM * kCPR; id += kThreads) {
    const int r = id / kCPR;
    const int col = (id - r * kCPR) * kEPV;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm >= m || gn >= cout) continue;
    const uint8_t* src = tile + r * tile_pitch<T, BN>() + col * sizeof(T);
    T* dst = y + static_cast<int64_t>(gm) * cout + gn;
    if (vec && gn + kEPV <= cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const T* s = reinterpret_cast<const T*>(src);
#pragma unroll
      for (int e = 0; e < kEPV; ++e) {
        if (gn + e < cout) dst[e] = s[e];
      }
    }
  }
}

}  // namespace igemm
