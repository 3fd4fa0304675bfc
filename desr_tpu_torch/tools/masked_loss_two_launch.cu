// The earlier two-launch design of the masked-loss sums (K3), kept only as
// the yardstick the one-launch kernel in desr_tpu_torch/csrc/masked_loss.cu
// is timed against: chip_smoke.py's phase (d) (two_launch_ms) and
// desr_tpu_torch/tools/masked_loss_ab.py build it from this file. Nothing
// in the package calls it.
//
// Masked L1 / hole-L1 / hole-L2 sums of the stage-3 loss tail, in one pass
// over (pred, target, m1, m2), for Hopper (sm_90a), as the Pallas TPU kernel
// behind desr_tpu/ops/pallas_kernels.py computes them:
//   masked_loss_sums / masked_loss_sums_diff / fused_hole_means (:97, :120, :142;
//   body _kernel :46-68, pallas_call :83)
//
//   d1 = t*m1 - p*m1,  d2 = d1*m2
//   out = [sum |d1|, sum |d2|, sum d2^2]   (f32)
//
// pred and target are f32 or bf16, the masks f32; every value is upcast to
// f32 as it loads. The multiplies and the subtraction round separately (no FMA
// contraction), as the plain PyTorch version's elementwise ops do.
//
// The TPU kernel carried its sums in VMEM scratch across a sequential grid.
// CUDA blocks run in no order, so: a grid-stride loop (vector loads of 4
// values, 16 bytes in f32 and 8 in bf16, when every pointer is aligned for
// them; scalar loads for the
// ragged tail, which is masked, not padded), a warp-shuffle then
// shared-memory block reduction, and one [3] partial per block; a second
// one-block launch sums the partials in a fixed order. No float atomics, so
// two launches give the same bits.
//
// What bounds it on the H100: bytes. At the training shape (6, 512, 640) it
// reads 4 inputs x 4 B x 1.97 M values = 31.5 MB for ~0.02 GFLOP, about
// 9.4 us at 3.35 TB/s; the operations would take far less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 1024;
constexpr int VECS_PER_THREAD = 8;  // 4-value vectors per thread, sizing the grid

__device__ __forceinline__ float load1(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// values 4i .. 4i+3
__device__ __forceinline__ float4 load4(const float* p, size_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, size_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

struct Sums {
  float a1 = 0.f, a2 = 0.f, q2 = 0.f;

  __device__ __forceinline__ void add(float p, float t, float m1, float m2) {
    const float d1 = __fsub_rn(__fmul_rn(t, m1), __fmul_rn(p, m1));
    const float d2 = __fmul_rn(d1, m2);
    a1 += fabsf(d1);
    a2 += fabsf(d2);
    q2 = __fadd_rn(q2, __fmul_rn(d2, d2));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with sh
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < NTHREADS / 32 ? sh[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

template <typename P, typename T>
__global__ void __launch_bounds__(NTHREADS)
masked_loss_partials(const P* __restrict__ pred, const T* __restrict__ target,
                     const float* __restrict__ m1, const float* __restrict__ m2,
                     float* __restrict__ partials, size_t n, int vec) {
  Sums s;
  const size_t stride = (size_t)gridDim.x * NTHREADS;
  const size_t first = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  size_t tail = 0;
  if (vec) {
    const size_t nv = n / 4;
    for (size_t i = first; i < nv; i += stride) {
      const float4 p = load4(pred, i), t = load4(target, i);
      const float4 a = load4(m1, i), b = load4(m2, i);
      s.add(p.x, t.x, a.x, b.x);
      s.add(p.y, t.y, a.y, b.y);
      s.add(p.z, t.z, a.z, b.z);
      s.add(p.w, t.w, a.w, b.w);
    }
    tail = nv * 4;
  }
  for (size_t i = tail + first; i < n; i += stride)
    s.add(load1(pred, i), load1(target, i), m1[i], m2[i]);

  __shared__ float sh[NTHREADS / 32];
  const float a1 = block_sum(s.a1, sh);
  const float a2 = block_sum(s.a2, sh);
  const float q2 = block_sum(s.q2, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x * 3 + 0] = a1;
    partials[blockIdx.x * 3 + 1] = a2;
    partials[blockIdx.x * 3 + 2] = q2;
  }
}

// One block: out[k] = sum over blocks of partials[block][k], fixed order.
__global__ void __launch_bounds__(NTHREADS)
masked_loss_finish(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  float a1 = 0.f, a2 = 0.f, q2 = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += NTHREADS) {
    a1 += partials[i * 3 + 0];
    a2 += partials[i * 3 + 1];
    q2 += partials[i * 3 + 2];
  }
  __shared__ float sh[NTHREADS / 32];
  a1 = block_sum(a1, sh);
  a2 = block_sum(a2, sh);
  q2 = block_sum(q2, sh);
  if (threadIdx.x == 0) {
    out[0] = a1;
    out[1] = a2;
    out[2] = q2;
  }
}

template <typename P, typename T>
void launch(const void* pred, const void* target, const float* m1, const float* m2,
            float* partials, size_t n, int n_blocks, int vec, cudaStream_t s) {
  masked_loss_partials<P, T><<<n_blocks, NTHREADS, 0, s>>>(
      static_cast<const P*>(pred), static_cast<const T*>(target), m1, m2, partials, n, vec);
}

}  // namespace

// Blocks of the first launch for n values, so that the caller sizes the
// [n_blocks][3] f32 partials.
extern "C" int desr_masked_loss_blocks(long long n) {
  const long long per_block = (long long)NTHREADS * 4 * VECS_PER_THREAD;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return (int)b;
}

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// `vec` says that pred/target/m1/m2 are aligned for 4-value vector loads.
// Writes the three sums to out[0..2]. Launches both kernels on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int desr_masked_loss_sums(const void* pred, const void* target, const void* m1,
                                     const void* m2, void* partials, void* out, long long n,
                                     int pred_bf16, int target_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = desr_masked_loss_blocks(n);
  const float* a = static_cast<const float*>(m1);
  const float* b = static_cast<const float*>(m2);
  float* part = static_cast<float*>(partials);
  if (pred_bf16 && target_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(pred, target, a, b, part, (size_t)n, n_blocks, vec, s);
  else if (pred_bf16)
    launch<__nv_bfloat16, float>(pred, target, a, b, part, (size_t)n, n_blocks, vec, s);
  else if (target_bf16)
    launch<float, __nv_bfloat16>(pred, target, a, b, part, (size_t)n, n_blocks, vec, s);
  else
    launch<float, float>(pred, target, a, b, part, (size_t)n, n_blocks, vec, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_loss_finish<<<1, NTHREADS, 0, s>>>(part, n_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
