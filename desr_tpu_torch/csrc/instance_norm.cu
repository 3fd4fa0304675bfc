// InstanceNorm's moments and its normalisation (K4), for Hopper (sm_90a):
// the norms of the serving nets where no gradient flows, and the tail of the
// ResnetBlocks' fused chain.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the JAX package's
// InstanceNorm (desr_tpu/models/layers.py:1129-1161) and the chain's last
// multiply-add and skip (layers.py:271-337) into the passes around them,
// where eager PyTorch runs about seven full-size passes a norm.
//
//   moments: s[b, c] = sum_hw x,  q[b, c] = sum_hw x^2            (f32)
//   apply:   out = [relu]((x - m) * r + h) [+ skip], f32, rounded once to x's dtype
//            m = mean = s / n, r = 1 / sqrt(max(q / n - mean^2, 0) + eps), h = 0
//            (from moments), or m = 0, r = scale, h = shift (the chain's tail)
//
// x is f32 or bf16, (B, C, H, W) in either of two layouts, NCHW-contiguous
// ("planes": each (b, c) plane is hw contiguous values) or channels_last
// ("pixels": each pixel's C values contiguous), and the output keeps it.
// Every value is read as f32, every multiply, add and subtraction of the
// apply rounds on its own (_rn intrinsics, no FMA contraction), so in f32 the
// apply is the plain version's arithmetic in its order.
//
// What bounds both on the H100: bytes. The moments read 2 B a value (bf16),
// the apply reads 2 and writes 2 (4 more with a skip: 6 B a value). The
// serving nets' largest norm, B=8 32x512x640 bf16, is 84 M values: 50 us of
// moments and 100 us of apply at 3.35 TB/s. The design against that:
//  - 16-byte loads and stores (8 bf16 or 4 f32 values), UNROLL of them in
//    flight a thread before any is summed or written; value by value where
//    the layout's contiguous run (hw for planes, C for pixels) is not a
//    multiple of 16 bytes or x is not 16-byte aligned;
//  - planes: each plane is split into `splits` chunks of contiguous values,
//    a block each, so the largest planes (327,680 values) fill the card;
//  - pixels: a block covers a tile of pixels of one image and a slice of up
//    to SLICE channels; its threads stand in rows of C/VEC vector groups,
//    so a warp reads whole pixel runs, and each thread keeps VEC channels'
//    sums (moments) or coefficients (apply) in registers for every pixel it
//    visits;
//  - the moments finish in one launch and in a fixed order, with no float
//    atomics: a block sums its threads in a fixed tree, writes its partials
//    and takes a ticket (an acq_rel atomic) on its plane or (image, slice);
//    the last block to take one sums the partials in a fixed order and
//    resets the ticket to 0 for the next launch. The same bits on every
//    launch of one shape on one card.
// ops/instance_norm.py:launch_plan gives the vector width, the splits or
// tiles and their sizes; both operators of a norm use the same plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;
constexpr int SLICE = 128;         // channels a pixels block covers (2 * SLICE <= NTHREADS)
constexpr int MOMENTS_UNROLL = 4;  // vectors a thread loads before it sums them
constexpr int APPLY_UNROLL = 2;    // vectors (of x, and of skip) a thread loads before it writes
constexpr int FINISH_LOADS = 8;    // partials a thread of a last block loads at once

// VEC values at p as f32: 16 bytes (VEC 4 f32, VEC 8 bf16), or one value
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ticket += 1 at device scope, releasing the writes before it and acquiring
// those released before it; returns the old value
__device__ __forceinline__ unsigned ticket_add(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The normalisation's coefficients of one (b, c): y = (x - m) * r + h.
struct Norm {
  const float* a;  // s, or scale
  const float* b;  // q, or shift
  float n, eps;
  int moments;     // a, b are (s, q) over n values; else (scale, shift)
  int relu;

  __device__ __forceinline__ void coeffs(long long i, float& m, float& r, float& h) const {
    if (moments) {
      m = __fdiv_rn(a[i], n);
      float var = __fsub_rn(__fdiv_rn(b[i], n), __fmul_rn(m, m));
      var = var < 0.f ? 0.f : var;  // clamp(min=0), NaN kept
      r = __frsqrt_rn(__fadd_rn(var, eps));
      h = 0.f;
    } else {
      m = 0.f;
      r = a[i];
      h = b[i];
    }
  }
  __device__ __forceinline__ float apply(float x, float m, float r, float h) const {
    const float y = __fadd_rn(__fmul_rn(__fsub_rn(x, m), r), h);
    return relu && y < 0.f ? 0.f : y;
  }
};

// ---------------------------------------------------------------- planes

// The block's (s, q) in thread 0, summed in a fixed tree.
__device__ __forceinline__ void block_sum2(float& s, float& q) {
  __shared__ float sh[NTHREADS / 32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    sh[warp][0] = s;
    sh[warp][1] = q;
  }
  __syncthreads();
  if (warp == 0) {
    const bool mine = lane < NTHREADS / 32;
    s = warp_sum(mine ? sh[lane][0] : 0.f);
    q = warp_sum(mine ? sh[lane][1] : 0.f);
  }
}

// Block b of the grid sums chunk b % splits of plane b / splits:
// values [k * chunk, min(hw, (k + 1) * chunk)); hw and chunk are multiples
// of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
moments_planes_kernel(const T* __restrict__ x, float* __restrict__ out_s,
                      float* __restrict__ out_q, float* partials, unsigned* tickets,
                      long long hw, long long chunk, int splits) {
  const long long plane = blockIdx.x / splits;
  const int k = blockIdx.x % splits;
  const long long begin = k * chunk;
  const long long end = min(hw, begin + chunk);
  const T* p = x + plane * hw;
  const long long step = (long long)NTHREADS * VEC;
  float s = 0.f, q = 0.f;
  long long i = begin + (long long)threadIdx.x * VEC;
  for (; i + (MOMENTS_UNROLL - 1) * step < end; i += MOMENTS_UNROLL * step) {
    float v[MOMENTS_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < MOMENTS_UNROLL; ++u) load_vec(p + i + u * step, v[u]);
#pragma unroll
    for (int u = 0; u < MOMENTS_UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s += v[u][e];
        q = fmaf(v[u][e], v[u][e], q);
      }
  }
  for (; i < end; i += step) {
    float v[VEC];
    load_vec(p + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s += v[e];
      q = fmaf(v[e], v[e], q);
    }
  }
  block_sum2(s, q);
  if (threadIdx.x != 0) return;
  if (splits == 1) {
    out_s[plane] = s;
    out_q[plane] = q;
    return;
  }
  float* mine = partials + 2 * (plane * splits + k);
  mine[0] = s;
  mine[1] = q;
  if (ticket_add(tickets + plane) != (unsigned)splits - 1) return;
  // the plane's last block: its chunks' partials in chunk order,
  // FINISH_LOADS chunks' in flight at once
  const float* all = partials + 2 * plane * splits;
  float ts = 0.f, tq = 0.f;
  for (int j0 = 0; j0 < splits; j0 += FINISH_LOADS) {
    float ps[FINISH_LOADS], pq[FINISH_LOADS];
#pragma unroll
    for (int u = 0; u < FINISH_LOADS; ++u) {
      const bool in = j0 + u < splits;
      ps[u] = in ? __ldcg(all + 2 * (j0 + u)) : 0.f;
      pq[u] = in ? __ldcg(all + 2 * (j0 + u) + 1) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FINISH_LOADS; ++u) {
      ts += ps[u];
      tq += pq[u];
    }
  }
  out_s[plane] = ts;
  out_q[plane] = tq;
  tickets[plane] = 0u;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
apply_planes_kernel(const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ out,
                    Norm nm, long long hw, long long chunk, int splits) {
  const long long plane = blockIdx.x / splits;
  const int k = blockIdx.x % splits;
  const long long begin = k * chunk;
  const long long end = min(hw, begin + chunk);
  const long long base = plane * hw;
  float m, r, h;
  nm.coeffs(plane, m, r, h);
  const long long step = (long long)NTHREADS * VEC;
  for (long long i0 = begin + (long long)threadIdx.x * VEC; i0 < end;
       i0 += APPLY_UNROLL * step) {
    float v[APPLY_UNROLL][VEC], sk[APPLY_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long i = i0 + u * step;
      if (i < end) {
        load_vec(x + base + i, v[u]);
        if (skip != nullptr) load_vec(skip + base + i, sk[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long i = i0 + u * step;
      if (i >= end) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[u][e] = nm.apply(v[u][e], m, r, h);
        if (skip != nullptr) v[u][e] = __fadd_rn(v[u][e], sk[u][e]);
      }
      store_vec(out + base + i, v[u]);
    }
  }
}

// ---------------------------------------------------------------- pixels

// A pixels block: image blockIdx.x / tiles, pixels [tile * tile_px,
// min(hw, (tile + 1) * tile_px)), channels [c0, c0 + cs) of the slice
// blockIdx.y. Its threads stand in rows of gs = cs / VEC vector groups: thread
// t reads group g = t % gs of pixel rows r, r + rows, ... (r = t / gs); the
// threads past rows * gs idle.
struct PixelTile {
  long long b, p0, p1;
  int tile, c0, cs, gs, rows, g, r;

  __device__ __forceinline__ PixelTile(long long hw, int c, long long tile_px, int tiles,
                                       int vec) {
    b = blockIdx.x / tiles;
    tile = blockIdx.x % tiles;
    p0 = tile * tile_px;
    p1 = min(hw, p0 + tile_px);
    c0 = blockIdx.y * SLICE;
    cs = min(SLICE, c - c0);
    gs = cs / vec;
    rows = NTHREADS / gs;
    g = threadIdx.x % gs;
    r = threadIdx.x / gs;
  }
};

// The block's sums (value j < cs: channel c0 + j's s; cs <= j < 2 cs: its q)
// into out or, with tiles > 1, its partials [b][tile][2][c]; the last block
// of (image, slice) then sums the tiles' partials in a fixed order into out.
template <int VEC>
__device__ void finish_pixels(const PixelTile& pt, float (*red)[NTHREADS][VEC],
                              float* __restrict__ out_s, float* __restrict__ out_q,
                              float* partials, unsigned* tickets, int c, int tiles) {
  const int t = threadIdx.x, nv = 2 * pt.cs;
  const int which = t < nv ? t / pt.cs : 0, ch = t < nv ? t % pt.cs : 0;
  float tot = 0.f;
  if (t < nv) {  // rows in order
    const int g = ch / VEC, e = ch % VEC;
    for (int rr = 0; rr < pt.rows; ++rr) tot += red[which][rr * pt.gs + g][e];
  }
  if (tiles == 1) {
    if (t < nv) (which ? out_q : out_s)[pt.b * c + pt.c0 + ch] = tot;
    return;
  }
  if (t < nv) {
    partials[((pt.b * tiles + pt.tile) * 2 + which) * c + pt.c0 + ch] = tot;
    __threadfence();
  }
  __shared__ unsigned last;
  unsigned* ticket = tickets + pt.b * gridDim.y + blockIdx.y;
  __syncthreads();  // every partial written (and the reads of red done)
  if (t == 0) last = ticket_add(ticket) == (unsigned)tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread t sums tiles sub, sub + subs, ... of value v (t = sub * nv + v),
  // FINISH_LOADS of them in flight at once (from L2: other SMs wrote them),
  // then thread v sums the subs in order
  const int subs = NTHREADS / nv, v = t % nv, sub = t / nv;
  const int vw = v / pt.cs, vc = v % pt.cs;
  const float* col = partials + (pt.b * tiles * 2 + vw) * c + pt.c0 + vc;  // tile k at + 2ck
  float acc = 0.f;
  if (sub < subs)
    for (int k0 = sub; k0 < tiles; k0 += FINISH_LOADS * subs) {
      float part[FINISH_LOADS];
#pragma unroll
      for (int u = 0; u < FINISH_LOADS; ++u) {
        const int k = k0 + u * subs;
        part[u] = k < tiles ? __ldcg(col + 2LL * c * k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < FINISH_LOADS; ++u) acc += part[u];
    }
  float* fin = &red[0][0][0];
  fin[t] = acc;
  __syncthreads();
  if (t < nv) {
    float total = 0.f;
    for (int j = 0; j < subs; ++j) total += fin[j * nv + t];
    (vw ? out_q : out_s)[pt.b * c + pt.c0 + vc] = total;
  }
  if (t == 0) *ticket = 0u;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
moments_pixels_kernel(const T* __restrict__ x, float* __restrict__ out_s,
                      float* __restrict__ out_q, float* partials, unsigned* tickets,
                      long long hw, int c, long long tile_px, int tiles) {
  __shared__ float red[2][NTHREADS][VEC];
  const PixelTile pt(hw, c, tile_px, tiles, VEC);
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (pt.r < pt.rows) {
    const T* p = x + pt.b * hw * c + pt.c0 + pt.g * VEC;
    const long long rows = pt.rows;
    long long px = pt.p0 + pt.r;
    for (; px + (MOMENTS_UNROLL - 1) * rows < pt.p1; px += MOMENTS_UNROLL * rows) {
      float v[MOMENTS_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < MOMENTS_UNROLL; ++u) load_vec(p + (px + u * rows) * c, v[u]);
#pragma unroll
      for (int u = 0; u < MOMENTS_UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s[e] += v[u][e];
          q[e] = fmaf(v[u][e], v[u][e], q[e]);
        }
    }
    for (; px < pt.p1; px += rows) {
      float v[VEC];
      load_vec(p + px * c, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += v[e];
        q[e] = fmaf(v[e], v[e], q[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[0][threadIdx.x][e] = s[e];
    red[1][threadIdx.x][e] = q[e];
  }
  __syncthreads();
  finish_pixels<VEC>(pt, red, out_s, out_q, partials, tickets, c, tiles);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
apply_pixels_kernel(const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ out,
                    Norm nm, long long hw, int c, long long tile_px, int tiles) {
  const PixelTile pt(hw, c, tile_px, tiles, VEC);
  if (pt.r >= pt.rows) return;
  const int ch = pt.c0 + pt.g * VEC;
  float m[VEC], r[VEC], h[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) nm.coeffs(pt.b * c + ch + e, m[e], r[e], h[e]);
  const long long base = pt.b * hw * c + ch, rows = pt.rows;
  for (long long px0 = pt.p0 + pt.r; px0 < pt.p1; px0 += APPLY_UNROLL * rows) {
    float v[APPLY_UNROLL][VEC], sk[APPLY_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long px = px0 + u * rows;
      if (px < pt.p1) {
        load_vec(x + base + px * c, v[u]);
        if (skip != nullptr) load_vec(skip + base + px * c, sk[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      const long long px = px0 + u * rows;
      if (px >= pt.p1) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[u][e] = nm.apply(v[u][e], m[e], r[e], h[e]);
        if (skip != nullptr) v[u][e] = __fadd_rn(v[u][e], sk[u][e]);
      }
      store_vec(out + base + px * c, v[u]);
    }
  }
}

// ---------------------------------------------------------------- launches

enum Layout { PLANES = 0, PIXELS = 1 };

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The plan's checks: VEC 1 or 16 bytes, the contiguous run a multiple of
// VEC, the splits or tiles covering hw, and 16-byte aligned pointers.
int check_plan(int layout, int vec, int bf16v, long long outer, long long hw, int c,
               long long chunk, int splits, const void* a, const void* b, const void* d) {
  const int full = bf16v ? 8 : 4;
  if ((layout != PLANES && layout != PIXELS) || (vec != 1 && vec != full) || outer < 1 ||
      hw < 1 || c < 1 || chunk < 1 || splits < 1 || (splits - 1) * chunk >= hw ||
      (long long)splits * chunk < hw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout == PLANES && (hw % vec != 0 || chunk % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout == PIXELS && c % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && !(aligned16(a) && aligned16(b) && aligned16(d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

template <typename T, int VEC>
int moments(const void* x, void* out_s, void* out_q, void* partials, void* tickets, int layout,
            long long outer, long long hw, int c, long long chunk, int splits, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float *s = static_cast<float*>(out_s), *q = static_cast<float*>(out_q);
  float* part = static_cast<float*>(partials);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (layout == PLANES) {
    moments_planes_kernel<T, VEC><<<(unsigned)(outer * splits), NTHREADS, 0, st>>>(
        xp, s, q, part, tk, hw, chunk, splits);
  } else {
    const dim3 grid((unsigned)(outer * splits), (unsigned)((c + SLICE - 1) / SLICE));
    moments_pixels_kernel<T, VEC><<<grid, NTHREADS, 0, st>>>(xp, s, q, part, tk, hw, c, chunk,
                                                             splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int apply(const void* x, const void* skip, void* out, Norm nm, int layout, long long outer,
          long long hw, int c, long long chunk, int splits, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(skip);
  T* op = static_cast<T*>(out);
  if (layout == PLANES) {
    apply_planes_kernel<T, VEC><<<(unsigned)(outer * splits), NTHREADS, 0, st>>>(
        xp, sp, op, nm, hw, chunk, splits);
  } else {
    const dim3 grid((unsigned)(outer * splits), (unsigned)((c + SLICE - 1) / SLICE));
    apply_pixels_kernel<T, VEC><<<grid, NTHREADS, 0, st>>>(xp, sp, op, nm, hw, c, chunk,
                                                           splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DESR_K4_DISPATCH(bf16v, vec, FN, ...)                                        \
  ((bf16v) ? ((vec) == 1 ? FN<bf16, 1>(__VA_ARGS__) : FN<bf16, 8>(__VA_ARGS__))      \
           : ((vec) == 1 ? FN<float, 1>(__VA_ARGS__) : FN<float, 4>(__VA_ARGS__)))

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// each returns a CUDA error code (0 = success) and launches without
// synchronising. `outer` is B * C planes (layout 0) or B images (layout 1);
// `chunk` / `splits` a plane's values a block and blocks a plane (layout 0)
// or an image's pixels a tile and tiles an image (layout 1).

// out_s, out_q: (B, C) f32. partials: 2 floats a block (layout 0) or
// 2 * C a tile (layout 1), used when splits > 1; tickets: one unsigned a
// plane (layout 0) or a (image, channel slice) (layout 1), 0 between launches.
extern "C" int desr_instance_norm_moments(const void* x, void* out_s, void* out_q,
                                          void* partials, void* tickets, int layout, int bf16v,
                                          int vec, long long outer, long long hw, int c,
                                          long long chunk, int splits, void* stream) {
  const int e = check_plan(layout, vec, bf16v, outer, hw, c, chunk, splits, x, nullptr,
                           nullptr);
  if (e != 0) return e;
  if (splits > 1 && (partials == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return DESR_K4_DISPATCH(bf16v, vec, moments, x, out_s, out_q, partials, tickets, layout,
                          outer, hw, c, chunk, splits, static_cast<cudaStream_t>(stream));
}

// out = [relu]((x - m) * r + h) [+ skip] in x's layout; (a, b) are the
// (B, C) f32 moments (s, q) over n values when `from_moments`, else the
// (scale, shift); skip is null or in x's layout and dtype.
extern "C" int desr_norm_apply(const void* x, const void* skip, void* out, const void* a,
                               const void* b, float n, float eps, int from_moments, int relu,
                               int layout, int bf16v, int vec, long long outer, long long hw,
                               int c, long long chunk, int splits, void* stream) {
  const int e = check_plan(layout, vec, bf16v, outer, hw, c, chunk, splits, x, skip, out);
  if (e != 0) return e;
  const Norm nm{static_cast<const float*>(a), static_cast<const float*>(b), n, eps,
                from_moments, relu};
  return DESR_K4_DISPATCH(bf16v, vec, apply, x, skip, out, nm, layout, outer, hw, c, chunk,
                          splits, static_cast<cudaStream_t>(stream));
}
