// Masked L1 / hole-L1 / hole-L2 sums of the stage-3 loss tail in one pass
// over (pred, target, m1, m2), and their gradient in one pass, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel behind desr_tpu/ops/pallas_kernels.py:
//   masked_loss_sums / masked_loss_sums_diff / fused_hole_means (:97, :120, :142;
//   body _kernel :46-68, pallas_call :83), and its custom VJP _mls_bwd (:129-136),
//   which XLA fuses into one elementwise pass.
//
//   d1 = t*m1 - p*m1,  d2 = d1*m2
//   sums:  out = [sum |d1|, sum |d2|, sum d2^2]   (f32)
//   grads: gt = (sign(d1)*g0 + m1*(sign(d2)*g1 + (2*d2)*g2))*m1,  dp = -gt, dt = gt
//
// pred and target are f32 or bf16, the masks f32; every value is upcast to
// f32 as it loads. Every multiply, add and subtraction rounds on its own
// (_rn intrinsics, no FMA contraction), in the order of the plain PyTorch
// versions in ops/masked_loss.py: the gradient equals the plain one bit for
// bit in f32, and in bf16 after the same rounding.
//
// What bounds both on the H100: bytes. The sums read 16 B a value (four f32
// inputs) for ~9 flops: 21 MB at (1, 1024, 1280), 6.3 us at 3.35 TB/s. The
// gradient reads the same and writes 4 B a value (8 with dt). At these sizes
// what costs beyond streaming is fixed: the first loads' latency, the last
// ones' drain, an uneven tail over the SMs, the cross-block sum, and the host.
//
// The sums' design against that:
//  - one launch: each block writes its three partials and takes a ticket
//    (an acq_rel atomic); the last block to take one sums every block's
//    partials in block order, 16 a lane in flight at once, and resets the
//    ticket to 0. The same bits on every launch for one n, no float atomics;
//  - a grid of whole waves (SMs x resident blocks, fewer for a small n), each
//    block one contiguous range of units (4 values, 8 with a bf16 input:
//    16 B of the narrowest input), the ranges equal to within one unit.
//    ops/masked_loss.py:launch_plan computes the grid, the head and the
//    units; the kernel splits them as block_range does;
//  - the ranges read straight into registers, 16-byte (f32) and 8-byte
//    (bf16) loads, software-pipelined: a thread's next batch of LDG_UNROLL
//    4-value groups of each input is in flight while it sums the current
//    one. With unit 1 (the four inputs share no 16-byte alignment) it reads
//    value by value. A ring in shared memory filled by 1-D TMA bulk copies
//    (4 stages x 4 inputs x 8 KB, one block an SM) was ~1 us slower at both
//    train-step shapes on the card (PERF.md);
//  - the values before every input is 16-byte aligned (the head) and the
//    ragged tail, fewer than 16 and 8, are read value by value by block 0.
// The gradient: 4-value groups, 16-byte (f32) / 8-byte (bf16) loads and
// stores, GRAD_UNROLL groups a thread and one tile of groups a block, so the
// grid covers the card several times over; value by value where the six
// pointers share no alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;
constexpr int LDG_UNROLL = 2;   // 4-value groups of each input a batch; two batches in flight
constexpr int GRAD_UNROLL = 4;  // gradient: 4-value groups a thread
constexpr int FINISH_LOADS = 16;  // partials a lane of the last block loads at once

__device__ __forceinline__ float load1(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load1(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}

// values 4j .. 4j+3 of p (16-byte aligned for f32, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p, long long j) {
  return reinterpret_cast<const float4*>(p)[j];
}
__device__ __forceinline__ float4 load4(const bf16* p, long long j) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[j];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(bf16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* p, long long j, float4 v) {
  reinterpret_cast<float4*>(p)[j] = v;
}
__device__ __forceinline__ void store4(bf16* p, long long j, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[j] = raw;
}

struct Sums {
  float a1 = 0.f, a2 = 0.f, q2 = 0.f;

  __device__ __forceinline__ void add(float p, float t, float m1, float m2) {
    const float d1 = __fsub_rn(__fmul_rn(t, m1), __fmul_rn(p, m1));
    const float d2 = __fmul_rn(d1, m2);
    a1 = __fadd_rn(a1, fabsf(d1));
    a2 = __fadd_rn(a2, fabsf(d2));
    q2 = __fadd_rn(q2, __fmul_rn(d2, d2));
  }
  __device__ __forceinline__ void add4(float4 p, float4 t, float4 a, float4 b) {
    add(p.x, t.x, a.x, b.x);
    add(p.y, t.y, a.y, b.y);
    add(p.z, t.z, a.z, b.z);
    add(p.w, t.w, a.w, b.w);
  }
};

// torch.sign: +0 for either zero
__device__ __forceinline__ float sgn(float x) { return (float)((0.f < x) - (x < 0.f)); }

// gt of one value, the plain backward's expression in its order
__device__ __forceinline__ float grad_t(float p, float t, float a, float b, float g0, float g1,
                                        float g2) {
  const float d1 = __fsub_rn(__fmul_rn(t, a), __fmul_rn(p, a));
  const float d2 = __fmul_rn(d1, b);
  const float inner = __fadd_rn(__fmul_rn(sgn(d2), g1), __fmul_rn(__fmul_rn(2.f, d2), g2));
  return __fmul_rn(__fadd_rn(__fmul_rn(sgn(d1), g0), __fmul_rn(a, inner)), a);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ticket += 1 at device scope, releasing this thread's writes and acquiring
// those released before it; returns the old value
__device__ __forceinline__ unsigned ticket_add(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

struct Range {
  long long begin, end;  // values
};

// This block's units of the body, as ops/masked_loss.py:launch_plan splits
// them: q = units / grid each, one more for the first units % grid blocks.
__device__ __forceinline__ Range block_range(long long head, long long units, int unit) {
  const long long b = blockIdx.x, q = units / gridDim.x, r = units % gridDim.x;
  const long long begin = b * q + (b < r ? b : r), count = q + (b < r ? 1 : 0);
  return {head + begin * unit, head + (begin + count) * unit};
}

// The head [0, head) and the tail [body_end, n), value by value, in block 0.
template <typename P, typename T>
__device__ __forceinline__ void add_edges(Sums& s, const P* pred, const T* target,
                                          const float* m1, const float* m2, long long n,
                                          long long head, long long body_end) {
  if (blockIdx.x != 0) return;
  const long long n_edge = head + (n - body_end);
  for (long long k = threadIdx.x; k < n_edge; k += NTHREADS) {
    const long long i = k < head ? k : body_end + (k - head);
    s.add(load1(pred, i), load1(target, i), m1[i], m2[i]);
  }
}

// The block's three sums (warps, then warp 0 over the warps: a fixed order),
// its partials, then the last block to finish sums every block's in block
// order into out and resets the ticket for the next launch. Past the one
// __syncthreads only warp 0 works, so the tail after the last block's loads
// is a few warp shuffles.
__device__ void finish(Sums s, float* partials, unsigned* ticket, float* out) {
  __shared__ float sh[NTHREADS / 32][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s.a1 = warp_sum(s.a1);
  s.a2 = warp_sum(s.a2);
  s.q2 = warp_sum(s.q2);
  if (lane == 0) {
    sh[warp][0] = s.a1;
    sh[warp][1] = s.a2;
    sh[warp][2] = s.q2;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool mine = lane < NTHREADS / 32;
  const float a1 = warp_sum(mine ? sh[lane][0] : 0.f);
  const float a2 = warp_sum(mine ? sh[lane][1] : 0.f);
  const float q2 = warp_sum(mine ? sh[lane][2] : 0.f);
  unsigned prior = 0;
  if (lane == 0) {
    partials[3 * blockIdx.x + 0] = a1;
    partials[3 * blockIdx.x + 1] = a2;
    partials[3 * blockIdx.x + 2] = q2;
    prior = ticket_add(ticket);  // releases the partials above
  }
  if (__shfl_sync(0xffffffffu, prior, 0) != gridDim.x - 1) return;
  __syncwarp();  // lane 0's acquire comes before the other lanes' loads
  // lane l sums blocks l, l + 32, ... in that order; FINISH_LOADS of them in
  // flight at once (from L2: other SMs wrote them), so up to 32 x
  // FINISH_LOADS blocks cost one round trip
  float x1 = 0.f, x2 = 0.f, x3 = 0.f;
  for (int i0 = lane; i0 < (int)gridDim.x; i0 += 32 * FINISH_LOADS) {
    float v[FINISH_LOADS][3];
#pragma unroll
    for (int k = 0; k < FINISH_LOADS; ++k) {
      const int i = i0 + 32 * k;
      if (i < (int)gridDim.x) {
        v[k][0] = __ldcg(partials + 3 * i + 0);
        v[k][1] = __ldcg(partials + 3 * i + 1);
        v[k][2] = __ldcg(partials + 3 * i + 2);
      }
    }
#pragma unroll
    for (int k = 0; k < FINISH_LOADS; ++k) {
      if (i0 + 32 * k >= (int)gridDim.x) break;
      x1 = __fadd_rn(x1, v[k][0]);
      x2 = __fadd_rn(x2, v[k][1]);
      x3 = __fadd_rn(x3, v[k][2]);
    }
  }
  x1 = warp_sum(x1);
  x2 = warp_sum(x2);
  x3 = warp_sum(x3);
  if (lane == 0) {
    out[0] = x1;
    out[1] = x2;
    out[2] = x3;
    *ticket = 0u;
  }
}

// LDG_UNROLL 4-value groups of each input, j0 + k * NTHREADS for k < LDG_UNROLL
struct Batch {
  float4 p[LDG_UNROLL], t[LDG_UNROLL], a[LDG_UNROLL], b[LDG_UNROLL];

  template <typename P, typename T>
  __device__ __forceinline__ void load(const P* pp, const T* tp, const float* ap,
                                       const float* bp, long long j0, long long groups) {
#pragma unroll
    for (int k = 0; k < LDG_UNROLL; ++k) {
      const long long j = j0 + k * NTHREADS;
      if (j < groups) {
        p[k] = load4(pp, j);
        t[k] = load4(tp, j);
        a[k] = load4(ap, j);
        b[k] = load4(bp, j);
      }
    }
  }
  __device__ __forceinline__ void add_to(Sums& s, long long j0, long long groups) const {
#pragma unroll
    for (int k = 0; k < LDG_UNROLL; ++k)
      if (j0 + k * NTHREADS < groups) s.add4(p[k], t[k], a[k], b[k]);
  }
};

template <typename P, typename T>
__global__ void __launch_bounds__(NTHREADS)
masked_loss_sums_kernel(const P* __restrict__ pred, const T* __restrict__ target,
                        const float* __restrict__ m1, const float* __restrict__ m2,
                        float* partials, unsigned* ticket, float* __restrict__ out, long long n,
                        long long head, long long units, int unit) {
  Sums s;
  const Range r = block_range(head, units, unit);
  if (unit == 1) {
    for (long long i = r.begin + threadIdx.x; i < r.end; i += NTHREADS)
      s.add(load1(pred, i), load1(target, i), m1[i], m2[i]);
  } else {
    const P* p = pred + r.begin;
    const T* t = target + r.begin;
    const float* a = m1 + r.begin;
    const float* b = m2 + r.begin;
    const long long groups = (r.end - r.begin) / 4, step = (long long)NTHREADS * LDG_UNROLL;
    // software pipeline: the next batch's loads are in flight while this
    // one is summed, so no thread waits on its loads with none in flight
    Batch cur, next;
    cur.load(p, t, a, b, threadIdx.x, groups);
    for (long long j0 = threadIdx.x; j0 < groups; j0 += step) {
      next.load(p, t, a, b, j0 + step, groups);
      cur.add_to(s, j0, groups);
      cur = next;
    }
  }
  add_edges(s, pred, target, m1, m2, n, head, head + units * unit);
  finish(s, partials, ticket, out);
}

template <typename P, typename T>
__global__ void __launch_bounds__(NTHREADS)
masked_loss_grads_kernel(const P* __restrict__ pred, const T* __restrict__ target,
                         const float* __restrict__ m1, const float* __restrict__ m2,
                         const float* __restrict__ g, P* __restrict__ dp, T* __restrict__ dt,
                         long long n, long long head, long long groups) {
  const float g0 = g[0], g1 = g[1], g2 = g[2];
  // the body: 4-value groups from `head` on, one tile of GRAD_UNROLL groups a thread
  const P* p = pred + head;
  const T* t = target + head;
  const float* a = m1 + head;
  const float* b = m2 + head;
  P* op = dp + head;
  T* ot = dt == nullptr ? nullptr : dt + head;
  const long long tile = (long long)NTHREADS * GRAD_UNROLL;
  for (long long j0 = blockIdx.x * tile + threadIdx.x; j0 < groups;
       j0 += (long long)gridDim.x * tile) {
    float4 vp[GRAD_UNROLL], vt[GRAD_UNROLL], va[GRAD_UNROLL], vb[GRAD_UNROLL];
#pragma unroll
    for (int k = 0; k < GRAD_UNROLL; ++k) {
      const long long j = j0 + k * NTHREADS;
      if (j < groups) {
        vp[k] = load4(p, j);
        vt[k] = load4(t, j);
        va[k] = load4(a, j);
        vb[k] = load4(b, j);
      }
    }
#pragma unroll
    for (int k = 0; k < GRAD_UNROLL; ++k) {
      const long long j = j0 + k * NTHREADS;
      if (j >= groups) continue;
      const float4 gt = make_float4(grad_t(vp[k].x, vt[k].x, va[k].x, vb[k].x, g0, g1, g2),
                                    grad_t(vp[k].y, vt[k].y, va[k].y, vb[k].y, g0, g1, g2),
                                    grad_t(vp[k].z, vt[k].z, va[k].z, vb[k].z, g0, g1, g2),
                                    grad_t(vp[k].w, vt[k].w, va[k].w, vb[k].w, g0, g1, g2));
      store4(op, j, make_float4(-gt.x, -gt.y, -gt.z, -gt.w));
      if (ot != nullptr) store4(ot, j, gt);
    }
  }
  // the head and the tail, value by value (everything when groups is 0)
  const long long body_end = head + 4 * groups, n_edge = head + (n - body_end);
  for (long long k = (long long)blockIdx.x * NTHREADS + threadIdx.x; k < n_edge;
       k += (long long)gridDim.x * NTHREADS) {
    const long long i = k < head ? k : body_end + (k - head);
    const float gt = grad_t(load1(pred, i), load1(target, i), m1[i], m2[i], g0, g1, g2);
    store1(dp, i, -gt);
    if (dt != nullptr) store1(dt, i, gt);
  }
}

template <typename P, typename T>
int occupancy(int* out) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, masked_loss_sums_kernel<P, T>,
                                                      NTHREADS, 0);
  out[0] = sms;
  out[1] = blocks;
  return static_cast<int>(e);
}

template <typename P, typename T>
int sums(const void* pred, const void* target, const void* m1, const void* m2, void* scratch,
         void* out, long long n, long long head, long long units, int unit, int grid,
         cudaStream_t s) {
  // scratch: the ticket, then (from 16 bytes on) 3 partials a block
  masked_loss_sums_kernel<P, T><<<grid, NTHREADS, 0, s>>>(
      static_cast<const P*>(pred), static_cast<const T*>(target), static_cast<const float*>(m1),
      static_cast<const float*>(m2), static_cast<float*>(scratch) + 4,
      static_cast<unsigned*>(scratch), static_cast<float*>(out), n, head, units, unit);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename T>
int grads(const void* pred, const void* target, const void* m1, const void* m2, const void* g,
          void* dp, void* dt, long long n, long long head, long long groups, cudaStream_t s) {
  const long long tile = (long long)NTHREADS * GRAD_UNROLL;
  const long long n_edge = n - 4 * groups;
  long long blocks = (groups + tile - 1) / tile;
  const long long edge_blocks = (n_edge + NTHREADS - 1) / NTHREADS;
  if (blocks < edge_blocks) blocks = edge_blocks;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;  // both loops stride over the grid
  masked_loss_grads_kernel<P, T><<<(int)blocks, NTHREADS, 0, s>>>(
      static_cast<const P*>(pred), static_cast<const T*>(target),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(g), static_cast<P*>(dp), static_cast<T*>(dt), n, head, groups);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long offset_bytes) {
  return (reinterpret_cast<uintptr_t>(p) + offset_bytes) % 16 == 0;
}

}  // namespace

#define DESR_DISPATCH(pbf, tbf, FN, ...)                                        \
  ((pbf) ? ((tbf) ? FN<bf16, bf16>(__VA_ARGS__) : FN<bf16, float>(__VA_ARGS__)) \
         : ((tbf) ? FN<float, bf16>(__VA_ARGS__) : FN<float, float>(__VA_ARGS__)))

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// each returns a CUDA error code (0 = success) and launches without
// synchronising.

// out[0] = SMs of the current device, out[1] = blocks of the sums kernel an
// SM holds for these dtypes.
extern "C" int desr_masked_loss_occupancy(int pred_bf16, int target_bf16, int* out) {
  return DESR_DISPATCH(pred_bf16, target_bf16, occupancy, out);
}

// The three sums into out[0..2], one launch, by ops/masked_loss.py:launch_plan:
// values [0, head) and [head + units * unit, n) one by one, the units between
// split over `grid` blocks. scratch holds the ticket (0 between launches) and
// 3 * grid partials; one scratch per stream.
extern "C" int desr_masked_loss_sums(const void* pred, const void* target, const void* m1,
                                     const void* m2, void* scratch, void* out, long long n,
                                     long long head, long long units, int unit, int grid,
                                     int pred_bf16, int target_bf16, void* stream) {
  const int ps = pred_bf16 ? 2 : 4, ts = target_bf16 ? 2 : 4;
  const bool vec = unit == 4 || unit == 8;
  if (grid < 1 || head < 0 || units < 0 || head + units * unit > n || !(vec || unit == 1) ||
      (unit == 4 && (ps == 2 || ts == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && units > 0 &&
      !(aligned16(pred, head * ps) && aligned16(target, head * ts) &&
        aligned16(m1, head * 4) && aligned16(m2, head * 4)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return DESR_DISPATCH(pred_bf16, target_bf16, sums, pred, target, m1, m2, scratch, out, n, head,
                       units, unit, grid, static_cast<cudaStream_t>(stream));
}

// dp (pred's dtype) and, unless dt is null, dt (target's) for the cotangents
// g[0..2] (a device pointer: nothing syncs). Values [0, head) and
// [head + 4 * groups, n) one by one, the groups of 4 between with vector
// loads and stores; groups = 0 runs everything value by value.
extern "C" int desr_masked_loss_grads(const void* pred, const void* target, const void* m1,
                                      const void* m2, const void* g, void* dp, void* dt,
                                      long long n, long long head, long long groups,
                                      int pred_bf16, int target_bf16, void* stream) {
  const int ps = pred_bf16 ? 2 : 4, ts = target_bf16 ? 2 : 4;
  if (head < 0 || groups < 0 || head + 4 * groups > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 0 &&
      !(aligned16(pred, head * ps) && aligned16(target, head * ts) && aligned16(m1, head * 4) &&
        aligned16(m2, head * 4) && aligned16(dp, head * ps) &&
        (dt == nullptr || aligned16(dt, head * ts))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return DESR_DISPATCH(pred_bf16, target_bf16, grads, pred, target, m1, m2, g, dp, dt, n, head,
                       groups, static_cast<cudaStream_t>(stream));
}
