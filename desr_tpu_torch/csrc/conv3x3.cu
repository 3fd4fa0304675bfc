// 3x3 stride-1 convolution with a fused normalise(+ReLU) prologue and
// per-(batch, output channel) moment partials, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind desr_tpu/ops/pallas_conv.py:
//   conv2d_pallas_fused (:353, body _conv_kernel :126-210)  -> prologue/stats on
//   conv2d_pallas       (:309, the same body)                -> prologue/stats off
//
// out[b, y, x, o] = sum_{dy, dx, c} in[b, y+dy-1, x+dx-1, c] * w[o, c, dy, dx]
// in = round_to_T([relu](x * scale[b, c] + shift[b, c]))   (prologue, f32 math)
//
// x and out are NHWC (T = float or bf16), scale/shift [B][C_in] f32. Borders
// are read directly through an index map on the halo load: reflect and
// replicate map the index (and the prologue runs on the mapped value, so the
// border is the border of the normalised input); zeros pads with 0 that the
// prologue never touches. The TPU kernel instead zero-pads virtually and adds
// the ring corrections outside (layers.py apply_ring).
//
// Halo rows: x may carry halo_top (0 or 1) rows above and halo_bottom (0 or
// 1) rows below the H output rows, another rank's rows of the same frame
// (x has H + halo_top + halo_bottom rows). Output row y reads input rows
// y + halo_top + dy - 1, and the index map runs over x's rows, so an end of H
// with a halo row is never padded and an end without one is padded with the
// border mode as before. The prologue applies to the halo rows too; the
// stats count output rows only.
//
// Stats: each block writes the sum and the sum of squares of its raw f32
// accumulators (before rounding to T) for each output channel into
// psum/psq[b][tile][o]; the caller reduces over tiles in a second pass. No
// atomics, so two runs give the same bits.
//
// Two bodies, chosen by dtype:
//
// * bf16 (the main path): an implicit GEMM on warpgroup MMA. M = a block's
//   TH x 16 output pixels, N = all output channels (one N tile of 64, 128 or
//   256; C_out > 256 takes more blocks along grid.y), K = 9 taps x C_in,
//   walked as (64-channel chunk, tap). What bounds it on the H100: at the
//   serving shape (B=8, 128x160, 128->128) a launch is 48.3 GFLOP against
//   ~84 MB of x read and out written, so the tensor cores (989 TFLOP/s
//   bf16), not HBM, set the floor (0.049 ms; 0.147 ms at the translator's
//   B=6 256->256). The design:
//   - the halo of a chunk, (TH+2) x 18 pixels x 64 channels (128 bytes a
//     pixel), and the chunk's scale/shift are loaded once per chunk with
//     cp.async (16 bytes; the border index worked out per 16-byte group)
//     into a raw buffer while the previous chunk's 9 taps run on the
//     tensor cores; the prologue then runs once per value (raw -> halo)
//     between chunks, and all 9 taps read that one halo. At N = 128 two
//     blocks share an SM, so one's loads, prologue and epilogue hide
//     behind the other's MMAs.
//   - the halo's 16-byte groups are XOR-swizzled by pixel, so the 8 rows of
//     each ldmatrix (8 neighbouring pixels) hit 8 different bank groups for
//     every tap's one-pixel shift.
//   - A comes from registers (ldmatrix per lane, its own shifted row
//     address), which sidesteps the shared-memory descriptor's need for
//     uniformly strided, swizzle-aligned 8-row core matrices.
//   - B, the (chunk, tap) weight tile NT x 64, is pre-packed by the wrapper
//     in the 128-byte-swizzled K-major layout wgmma reads, and streamed by
//     one 1-D bulk copy (TMA engine) per tile through a 4-stage ring: a
//     full mbarrier per stage, and the second warpgroup done with a stage
//     (a shared-memory counter) refills it, so neither waits on the other.
//   - wgmma.mma_async m64nNk16, f32 accumulators in registers, one group in
//     flight behind the next tap's ldmatrix; none across the prologue. A
//     divergent path while a group is in flight makes ptxas serialise every
//     wgmma of the kernel (its warning C7520), so the warp reconverges
//     (__syncwarp) after the one branch there, the stage refill.
//   - epilogue: moments reduced by warp shuffles and then across the 8 warps
//     in a fixed order through shared memory; the output staged (swizzled)
//     in shared memory and written with 16-byte coalesced stores.
//   One block covers all C_out of its tile, so the halo and the prologue
//   run once per pixel and chunk. C_in % 8 != 0 (or a misaligned x) takes
//   scalar halo loads in the same body; ragged channels and tiles are masked.
//
// * float32 (an exact float32 path, not on the bf16 main path): f32 FMAs on
//   CUDA cores (no TF32, so it stays exact enough to serve as a float32
//   path), one block per (b, 8x16 pixels, 64 c_out), single-buffered halo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;               // output tile rows
constexpr int TW = 16;              // output tile columns
constexpr int HH = TH + 2;          // halo rows
constexpr int HW = TW + 2;          // halo columns
constexpr int CO_T = 64;            // output channels per block
constexpr int NTHREADS = 256;       // 8 warps

enum PadMode { kZeros = 0, kReflect = 1, kReplicate = 2 };

// Source index of padded coordinate i in [0, n), or -1 for a zero.
// Rows/columns far past the edge (ragged tiles) map to -1 as well: they only
// feed outputs that are never written.
__device__ __forceinline__ int border_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  int j;
  if (mode == kReflect) {
    j = i < 0 ? -i : 2 * n - 2 - i;
  } else if (mode == kReplicate) {
    j = i < 0 ? 0 : n - 1;
  } else {
    return -1;
  }
  return (j >= 0 && j < n) ? j : -1;
}

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// One input value of the halo, with the prologue applied and rounded to T.
// The multiply and the add round separately (no FMA contraction), as the
// plain PyTorch version's two elementwise ops do.
template <typename T>
__device__ __forceinline__ T load_input(const T* __restrict__ xb,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        int b, int ih, int iw, int ci,
                                        int H, int W, int Cin, int mode, int relu) {
  int sh = border_index(ih, H, mode);
  int sw = border_index(iw, W, mode);
  if (sh < 0 || sw < 0 || ci >= Cin) return from_f32<T>(0.f);
  T raw = xb[((size_t)sh * W + sw) * Cin + ci];
  if (scale == nullptr) return raw;
  float v = __fadd_rn(__fmul_rn(to_f32(raw), scale[b * Cin + ci]), shift[b * Cin + ci]);
  if (relu) v = v < 0.f ? 0.f : v;
  return from_f32<T>(v);
}

// ---------------------------------------------------------------------------
// float: f32 FMAs, each thread owns 4 adjacent pixels x 8 output channels.
// ---------------------------------------------------------------------------

constexpr int CI_F = 8;   // input channels per shared-memory chunk
constexpr int PX = 4;     // pixels per thread (one row, adjacent columns)
constexpr int CO = 8;     // output channels per thread

__global__ void __launch_bounds__(NTHREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ shift,
                   float* __restrict__ out, float* __restrict__ psum,
                   float* __restrict__ psq, int H, int Hin, int ht, int W, int Cin,
                   int Cout, int tiles_w, int mode, int relu) {
  __shared__ float xs[CI_F][HH][HW];
  __shared__ __align__(16) float ws[9][CI_F][CO_T];

  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int oh0 = (tile / tiles_w) * TH;
  const int ow0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * CO_T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pr = lane >> 2;          // tile row of this thread's pixels
  const int pc = (lane & 3) * PX;    // first tile column
  const int cw = warp * CO;          // first block-local output channel

  const float* xb = x + (size_t)b * Hin * W * Cin;
  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[p][k] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_F) {
    for (int i = tid; i < CI_F * HH * HW; i += NTHREADS) {
      const int c = i % CI_F;
      const int pix = i / CI_F;
      const int hc = pix % HW;
      const int hr = pix / HW;
      xs[c][hr][hc] = load_input(xb, scale, shift, b, oh0 - 1 + ht + hr, ow0 - 1 + hc,
                                 ci0 + c, Hin, W, Cin, mode, relu);
    }
    for (int i = tid; i < 9 * CI_F * CO_T; i += NTHREADS) {
      const int o = i % CO_T;
      const int c = (i / CO_T) % CI_F;
      const int t = i / (CO_T * CI_F);
      const int ci = ci0 + c;
      const int og = co0 + o;
      ws[t][c][o] = (ci < Cin && og < Cout) ? w[((size_t)t * Cin + ci) * Cout + og] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CI_F; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xr[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xr[j] = xs[c][pr + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w0 = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][c][cw]);
          const float4 w1 = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][c][cw + 4]);
          const float wr[CO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int k = 0; k < CO; ++k) acc[p][k] = fmaf(xr[p + dx], wr[k], acc[p][k]);
        }
      }
    }
    __syncthreads();
  }

  const int oh = oh0 + pr;
  float s[CO], q[CO];
#pragma unroll
  for (int k = 0; k < CO; ++k) s[k] = q[k] = 0.f;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ow = ow0 + pc + p;
    if (oh >= H || ow >= W) continue;
    float* op = out + (((size_t)b * H + oh) * W + ow) * Cout;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int og = co0 + cw + k;
      if (og < Cout) op[og] = acc[p][k];
      s[k] += acc[p][k];
      q[k] += acc[p][k] * acc[p][k];
    }
  }
  if (psum != nullptr) {
    // the warp's 32 lanes cover the tile's 128 pixels for the same 8 channels
#pragma unroll
    for (int k = 0; k < CO; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
        q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
      }
    }
    if (lane == 0) {
      const size_t base = ((size_t)b * gridDim.x + tile) * Cout;
#pragma unroll
      for (int k = 0; k < CO; ++k) {
        const int og = co0 + cw + k;
        if (og < Cout) {
          psum[base + og] = s[k];
          psq[base + og] = q[k];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on wgmma (see the header). Two consumer warpgroups;
// warpgroup g owns MW m64 tiles; each warp's 16 A rows are one tile row of
// 16 pixels. Flat step j = chunk * 9 + tap walks the weight ring.
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int TW = 16;            // tile columns: a warp's 16 A rows
constexpr int HWD = TW + 2;       // halo columns
constexpr int KC = 64;            // input channels per chunk: 128 bytes a pixel
constexpr int STAGES = 4;         // weight ring depth
constexpr int NTHREADS = 256;     // two warpgroups

// N = 64 (narrow layers): MW = 2, one block per SM. N = 128 (the serving
// blocks): MW = 1 and two blocks per SM (<= 128 registers, <= 113 KB of
// shared memory each), so one block's chunk-0 load and epilogue hide behind
// the other's MMAs. N = 256 (the translator): MW = 1, one block per SM (the
// 64 x 256 f32 accumulator alone is 128 registers a thread).
template <int NT>
struct Cfg {
  static constexpr int MW = NT > 64 ? 1 : 2;        // m64 tiles per warpgroup
  static constexpr int MIN_BLOCKS = NT == 128 ? 2 : 1;
  static constexpr int TH = 8 * MW;                 // 2 warpgroups x MW x 4 rows
  static constexpr int HP = (TH + 2) * HWD;         // halo pixels
  static constexpr int WS_BYTES = NT * KC * 2;      // one (chunk, tap) weight tile
  static constexpr int RING = STAGES * WS_BYTES;
  static constexpr int HALO = HP * KC * 2;
  static constexpr int SMEM = 1024 + RING + 2 * HALO + 2 * KC * 4 + STAGES * 12;
  // the epilogue reuses the ring for the bf16 output tile and the raw
  // buffer for the per-warp moment partials
  static_assert(TH * TW * NT * 2 <= RING, "output stage must fit the ring");
  static_assert(8 * 2 * NT * 4 <= HALO, "moment partials must fit the raw buffer");
  static_assert(WS_BYTES % 1024 == 0, "ring stages must stay 1024-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one contiguous global -> shared copy by the TMA engine, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory descriptor of a K-major B tile: rows of 64 bf16 (128 bytes),
// 8-row core matrices 1024 bytes apart (SBO), 128-byte swizzle. The tile
// base is 1024-byte aligned; a k16 step adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D[64 x N] += A[64 x 16] (registers, the mma.m16n8k16 A layout per warp) *
// B[16 x N] (shared memory, desc); f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(float (&d)[NT / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (NT == 256) wgmma_m64n256(d, a, desc);
  else if constexpr (NT == 128) wgmma_m64n128(d, a, desc);
  else wgmma_m64n64(d, a, desc);
}

__device__ __forceinline__ uint32_t prologue2(uint32_t v, float s0, float s1, float f0,
                                              float f1, int relu) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  float2 f = __bfloat1622float2(h);
  float a = __fadd_rn(__fmul_rn(f.x, s0), f0);
  float b = __fadd_rn(__fmul_rn(f.y, s1), f1);
  if (relu) {
    a = a < 0.f ? 0.f : a;
    b = b < 0.f ? 0.f : b;
  }
  h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int NT>
__global__ void __launch_bounds__(NTHREADS, Cfg<NT>::MIN_BLOCKS)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                     const float* __restrict__ scale, const float* __restrict__ shift,
                     bf16* __restrict__ out, float* __restrict__ psum, float* __restrict__ psq,
                     int H, int Hin, int ht, int W, int Cin, int Cout, int tiles_w, int mode,
                     int relu, int vec) {
  using C = Cfg<NT>;
  constexpr int MW = C::MW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                   // STAGES x [NT][64] bf16, 128-byte swizzled
  uint8_t* halo = smem + C::RING;         // [HP][64] bf16, groups swizzled by pixel
  uint8_t* raw = halo + C::HALO;          // [HP][64] bf16 as loaded
  float* sbuf = reinterpret_cast<float*>(raw + C::HALO);   // the chunk's [scale, shift][64]
  int* cnt = reinterpret_cast<int*>(sbuf + 2 * KC);         // [STAGES]
  const uint32_t ring_u = smem_u32(ring), halo_u = smem_u32(halo);
  const uint32_t full_u = smem_u32(cnt + STAGES);                     // [STAGES] mbarriers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, grp = tid >> 7;
  const int b = blockIdx.z, tile = blockIdx.x;
  const int oh0 = (tile / tiles_w) * C::TH, ow0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * NT;
  const int nchunks = (Cin + KC - 1) / KC, nsteps = 9 * nchunks;
  const bf16* xb = x + (size_t)b * Hin * W * Cin;
  const uint8_t* wblk = reinterpret_cast<const uint8_t*>(wp) +
                        (size_t)blockIdx.y * nsteps * C::WS_BYTES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_u + 8 * s, 1);
      cnt[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < STAGES && j < nsteps; ++j) {
      mbar_expect_tx(full_u + 8 * j, C::WS_BYTES);
      bulk_load(ring_u + j * C::WS_BYTES, wblk + (size_t)j * C::WS_BYTES, C::WS_BYTES,
                full_u + 8 * j);
    }
  }

  // Halo entry e = pixel * 8 + 16-byte group; a thread keeps group tid & 7.
  // Source pixel of entry e, or -1 (zeros border, ragged edge, channels past C_in).
  auto source = [&](int e, int ci0) -> int {
    const int p = e >> 3, hr = p / HWD, hc = p - hr * HWD;
    const int sh = border_index(oh0 - 1 + ht + hr, Hin, mode);
    const int sw = border_index(ow0 - 1 + hc, W, mode);
    return (sh < 0 || sw < 0 || ci0 + 8 * (e & 7) >= Cin) ? -1 : sh * W + sw;
  };
  // chunk ch's x into raw and its scale/shift into sbuf: cp.async (16
  // bytes; 4 with zero fill past C_in), or scalar loads
  auto load_chunk = [&](int ch) {
    const int ci0 = ch * KC;
    if (scale != nullptr && tid < 2 * KC) {
      const int c = ci0 + (tid & (KC - 1));
      const float* src = (tid < KC ? scale : shift) + b * Cin + (c < Cin ? c : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_u32(sbuf + tid)), "l"(src), "r"(c < Cin ? 4 : 0) : "memory");
    }
    for (int e = tid; e < C::HP * 8; e += NTHREADS) {
      const int sp = source(e, ci0);
      if (sp < 0) continue;
      const int c = ci0 + 8 * (e & 7);
      const bf16* src = xb + (size_t)sp * Cin + c;
      if (vec) {
        cp_async16(smem_u32(raw + e * 16), src);
      } else {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = c + k < Cin ? src[k] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(raw + e * 16) = *reinterpret_cast<const uint4*>(v);
      }
    }
    cp_async_commit();
  };
  // halo <- prologue(raw) for chunk ch, swizzled; 0 where there is no source
  auto transform = [&](int ch) {
    float sc[8], sf[8];
    if (scale != nullptr) {
      const float4* sv = reinterpret_cast<const float4*>(sbuf + 8 * (tid & 7));
      const float4 a0 = sv[0], a1 = sv[1], f0 = sv[KC / 4], f1 = sv[KC / 4 + 1];
      sc[0] = a0.x; sc[1] = a0.y; sc[2] = a0.z; sc[3] = a0.w;
      sc[4] = a1.x; sc[5] = a1.y; sc[6] = a1.z; sc[7] = a1.w;
      sf[0] = f0.x; sf[1] = f0.y; sf[2] = f0.z; sf[3] = f0.w;
      sf[4] = f1.x; sf[5] = f1.y; sf[6] = f1.z; sf[7] = f1.w;
    }
    for (int e = tid; e < C::HP * 8; e += NTHREADS) {
      const int p = e >> 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (source(e, ch * KC) >= 0) {
        v = *reinterpret_cast<const uint4*>(raw + e * 16);
        if (scale != nullptr) {
          v.x = prologue2(v.x, sc[0], sc[1], sf[0], sf[1], relu);
          v.y = prologue2(v.y, sc[2], sc[3], sf[2], sf[3], relu);
          v.z = prologue2(v.z, sc[4], sc[5], sf[4], sf[5], relu);
          v.w = prologue2(v.w, sc[6], sc[7], sf[6], sf[7], relu);
        }
      }
      *reinterpret_cast<uint4*>(halo + p * 128 + (((e & 7) ^ (p & 7)) << 4)) = v;
    }
  };
  // this warpgroup is done with step p's weight stage; the second of the
  // two warpgroups to get there refills it with step p + STAGES
  auto release = [&](int p) {
    const int s = p % STAGES;
    if ((tid & 127) == 0 && atomicAdd(&cnt[s], 1) == 1) {
      atomicExch(&cnt[s], 0);
      if (p + STAGES < nsteps) {
        mbar_expect_tx(full_u + 8 * s, C::WS_BYTES);
        bulk_load(ring_u + s * C::WS_BYTES, wblk + (size_t)(p + STAGES) * C::WS_BYTES,
                  C::WS_BYTES, full_u + 8 * s);
      }
    }
    __syncwarp();   // reconverged before the next wgmma (else ptxas serialises them)
  };

  float acc[MW][NT / 2];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[mt][i] = 0.f;

  // ldmatrix.x4 rows: lane l gives A row l & 15 (a pixel column) at k-group l >> 4
  const int am = lane & 15, akh = lane >> 4;
  load_chunk(0);
  cp_async_wait_all();
  __syncthreads();
  transform(0);

  int pend = -1;
  for (int ch = 0; ch < nchunks; ++ch) {
    __syncthreads();          // the halo is complete; raw and sbuf are free
    if (ch + 1 < nchunks) load_chunk(ch + 1);   // lands while this chunk's taps run
    const int nks = min(4, (Cin - ch * KC + 15) / 16);   // k16 steps holding channels
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      const int j = ch * 9 + t, s = j % STAGES;
      uint32_t a[MW][4][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        const int p = (((grp * MW + mt) * 4 + (warp & 3)) + dy) * HWD + am + dx;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < nks)
            ldmatrix_x4(halo_u + p * 128 + (((2 * ks + akh) ^ (p & 7)) << 4), a[mt][ks]);
      }
      mbar_wait(full_u + 8 * s, (j / STAGES) & 1);
      wgmma_fence();
      const uint64_t desc = desc_b128(ring_u + s * C::WS_BYTES);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < nks)
#pragma unroll
          for (int mt = 0; mt < MW; ++mt) wgmma_tile<NT>(acc[mt], a[mt][ks], desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();          // step j - 1 is done: its stage can be refilled
      if (pend >= 0) release(pend);
      pend = j;
    }
    if (ch + 1 < nchunks) {
      wgmma_wait<0>();        // no wgmma in flight across the (divergent) prologue
      release(pend);
      pend = -1;
      cp_async_wait_all();
      __syncthreads();        // every warp is past this chunk's ldmatrix
      transform(ch + 1);
    }
  }
  wgmma_wait<0>();
  if (pend >= 0) release(pend);
  __syncthreads();            // the ring and the raw buffer are free for the epilogue
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) fence_regs(acc[mt]);

  // Epilogue. Accumulator fragment (per warp, per m64 tile): d[4j + i] is
  // tile-row pixel r = lane / 4 (+8 for i >= 2), channel 8j + 2 (lane % 4) + (i & 1).
  const int r = lane >> 2, cq = 2 * (lane & 3);
  if (psum != nullptr) {
    float* red = reinterpret_cast<float*>(raw);   // [8 warps][s, s2][NT]
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn) {
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        const int oh = oh0 + (grp * MW + mt) * 4 + (warp & 3);
        const float d0 = acc[mt][4 * jn], d1 = acc[mt][4 * jn + 1];
        const float d2 = acc[mt][4 * jn + 2], d3 = acc[mt][4 * jn + 3];
        if (oh < H && ow0 + r < W) {
          s0 += d0; q0 += d0 * d0;
          s1 += d1; q1 += d1 * d1;
        }
        if (oh < H && ow0 + r + 8 < W) {
          s0 += d2; q0 += d2 * d2;
          s1 += d3; q1 += d3 * d3;
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (r == 0) {
        red[(warp * 2) * NT + 8 * jn + cq] = s0;
        red[(warp * 2) * NT + 8 * jn + cq + 1] = s1;
        red[(warp * 2 + 1) * NT + 8 * jn + cq] = q0;
        red[(warp * 2 + 1) * NT + 8 * jn + cq + 1] = q1;
      }
    }
  }
  // bf16 output tile [TH * TW pixels][NT] in the ring, groups swizzled by pixel
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
    const int pix = ((grp * MW + mt) * 4 + (warp & 3)) * TW + r;
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[mt][4 * jn], acc[mt][4 * jn + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[mt][4 * jn + 2], acc[mt][4 * jn + 3]);
      *reinterpret_cast<__nv_bfloat162*>(ring + pix * NT * 2 + ((jn ^ (pix & 7)) << 4) + cq * 2) = lo;
      *reinterpret_cast<__nv_bfloat162*>(ring + (pix + 8) * NT * 2 +
                                         ((jn ^ ((pix + 8) & 7)) << 4) + cq * 2) = hi;
    }
  }
  __syncthreads();
  if (psum != nullptr && tid < NT && co0 + tid < Cout) {
    const float* red = reinterpret_cast<const float*>(raw);
    float s = 0.f, q = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) {   // fixed order: deterministic
      s += red[(w8 * 2) * NT + tid];
      q += red[(w8 * 2 + 1) * NT + tid];
    }
    const size_t base = ((size_t)b * gridDim.x + tile) * Cout;
    psum[base + co0 + tid] = s;
    psq[base + co0 + tid] = q;
  }
  const bool vec_out = (Cout & 7) == 0;
  for (int e = tid; e < C::TH * TW * (NT / 8); e += NTHREADS) {
    const int pix = e / (NT / 8), g = e % (NT / 8);
    const int oh = oh0 + pix / TW, ow = ow0 + pix % TW, co = co0 + 8 * g;
    if (oh >= H || ow >= W || co >= Cout) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ring + pix * NT * 2 + ((g ^ (pix & 7)) << 4));
    bf16* dst = out + (((size_t)b * H + oh) * W + ow) * Cout + co;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* vv = reinterpret_cast<const bf16*>(&v);
      for (int k = 0; k < 8 && co + k < Cout; ++k) dst[k] = vv[k];
    }
  }
}

template <int NT>
int launch_bf16(const void* x, const void* wp, const float* scale, const float* shift, void* out,
                float* psum, float* psq, int B, int H, int Hin, int ht, int W, int Cin,
                int Cout, int mode, int relu, int vec, cudaStream_t stream) {
  using C = Cfg<NT>;
  // above 48 KB, dynamic shared memory is opt-in (per device: set every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + C::TH - 1) / C::TH) * tiles_w, (Cout + NT - 1) / NT, B);
  conv3x3_wgmma_kernel<NT><<<grid, NTHREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp), scale, shift,
      static_cast<bf16*>(out), psum, psq, H, Hin, ht, W, Cin, Cout, tiles_w, mode, relu, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// scale/shift and psum/psq may be null (prologue off / stats off). Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for a tiling it was not built for).

// H is the output's rows; x has H + halo_top + halo_bottom (each 0 or 1).
//
// bf16: w packed by the wrapper as [C_out / nt][chunk][tap][nt][64], each
// (chunk, tap) tile 128-byte swizzled; psum/psq [B][tiles][C_out] with
// tiles = ceil(H / th) * ceil(W / 16). (nt, th) in {(64, 16), (128, 8), (256, 8)}.
extern "C" int desr_conv3x3_bf16(const void* x, const void* wp, const void* scale,
                                 const void* shift, void* out, void* psum, void* psq, int B,
                                 int H, int W, int Cin, int Cout, int mode, int relu,
                                 int halo_top, int halo_bottom, int nt, int th, void* stream) {
  if (halo_top < 0 || halo_top > 1 || halo_bottom < 0 || halo_bottom > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hin = H + halo_top + halo_bottom;
  const int vec = (Cin % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt == 256 && th == wg::Cfg<256>::TH)
    return wg::launch_bf16<256>(x, wp, sc, sh, out, ps, pq, B, H, hin, halo_top, W, Cin, Cout,
                                 mode, relu, vec, s);
  if (nt == 128 && th == wg::Cfg<128>::TH)
    return wg::launch_bf16<128>(x, wp, sc, sh, out, ps, pq, B, H, hin, halo_top, W, Cin, Cout,
                                 mode, relu, vec, s);
  if (nt == 64 && th == wg::Cfg<64>::TH)
    return wg::launch_bf16<64>(x, wp, sc, sh, out, ps, pq, B, H, hin, halo_top, W, Cin, Cout,
                                 mode, relu, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// float32: w as a [9][C_in][C_out] tap-major f32 matrix; psum/psq
// [B][tiles][C_out] with tiles = ceil(H / 8) * ceil(W / 16).
extern "C" int desr_conv3x3_f32(const void* x, const void* w, const void* scale,
                                const void* shift, void* out, void* psum, void* psq, int B,
                                int H, int W, int Cin, int Cout, int mode, int relu,
                                int halo_top, int halo_bottom, void* stream) {
  if (halo_top < 0 || halo_top > 1 || halo_bottom < 0 || halo_bottom > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Cout + CO_T - 1) / CO_T, B);
  conv3x3_f32_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), static_cast<float*>(psum), static_cast<float*>(psq), H,
      H + halo_top + halo_bottom, halo_top, W, Cin, Cout, tiles_w, mode, relu);
  return static_cast<int>(cudaGetLastError());
}
