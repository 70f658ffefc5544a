// Bilinear warp gather, its coordinate gradient and its image-gradient
// splat, for Hopper (sm_90a). Replace the Pallas TPU kernels of
// sndepth_tpu/kernels/warp.py:
//   warp_gather      bilinear_sampler / _fwd_kernel: out[b, c, p] = sum over
//                    the four taps of w_tap * img[b, c, tap];
//   warp_coord_grad  the coordinate half of its VJP: d x[b, p] = sum over c
//                    of g[b, c, p] * d out / dx, likewise d y, from the same
//                    four taps read again (the TPU kernel saved the tangent
//                    planes instead: it had no cheap gather);
//   warp_splat       _scatter_d_imgs / _splat: d img[b, c, tap] += w_tap *
//                    g[b, c, p], the adjoint of the gather in the image.
// All take the modes edge_zero and zero_pad of sampler.cuh.
//
// Layout: img (B, C, Hs, Ws), coords (B, 2, Ht, Wt) with channels (x, y) in
// source pixels, out / g (B, C, Ht, Wt), d coords (B, 2, Ht, Wt); float32,
// contiguous. The target size is free of the source size, and C is a
// runtime argument. The gather and its coordinate gradient take any B in
// one launch (the batch runs over the grid's y and then z); the splat
// takes B <= 65535.
//
// Gather and coordinate gradient: DRAM bytes bound them (8 bytes of
// coordinates a pixel in, 4 C out; the coordinate gradient reads 4 C of
// cotangent and writes 8). The source plane comes through L1 and L2,
// because neighbouring pixels hit neighbouring taps. A thread takes V
// consecutive target pixels, with one V * 4-byte load each of x and y and
// one V * 4-byte store a channel, so that all 4 C V tap loads are in
// flight at once: V = 4 where B * Ht * Wt reaches kWidePixels, which
// still leaves a thread for every slot of the card (scattered taps then
// want the most loads in flight a thread), else V = 2, where more threads
// fill the card. V needs Ht * Wt a multiple of V and aligned planes; other
// shapes take the same code with one pixel a thread. C = 1, 2 and 3
// (RAFT3D's depth, a flow, an image) are compiled apart.
//
// Splat: two paths, chosen by the size of the source plane.
//  - Plane path, where one (b, c) source plane fits the card's shared memory
//    (Hs * Ws <= 58K cells on an H100: every stage-2 scale up to 128 x 416).
//    One block a plane, 1024 threads: it zeroes the plane in shared memory,
//    runs over every target pixel of image b adding w_tap * g[b, c, p] with
//    shared-memory atomics, and stores the plane with 16-byte stores. No
//    global atomic and no zeroing launch: the block writes every cell of
//    d img once. The coordinates are read once a channel (C = 2 for a flow).
//    Where a cell takes many taps (a deformable-attention level of 4 x 7
//    cells takes 45,000), the block keeps up to 32 copies of the plane, one
//    for each group of warps, no more than target pixels a cell and within
//    half the card's shared memory (two blocks an SM), and sums them in a
//    fixed order at the end: shorter chains of adds, with less float32
//    rounding and less contention. A flow's splat (about a tap a cell) keeps
//    one.
//  - Tile path, for larger planes: one block a target tile of 8 x 32
//    pixels, one pixel a thread. The block reduces the bounding box of the
//    taps that add. When the box times C fits kBoxFloats floats of shared
//    memory (a smooth flow: the box is the tile and a pixel or two around
//    it), the block adds into the box with shared-memory atomics and then
//    flushes it with one 16-byte atomic a group of 4 cells of a plane, rows
//    contiguous in x: about a tenth of the global atomics of one a tap. When
//    it does not fit (a wild flow, a NaN coordinate, whose taps land on
//    index 0), the block adds straight into global memory, the two taps of
//    a row as one vector atomic. Both branches are one kernel; the data
//    choose, block by block. The launcher zeroes d img on the stream first.
// In both paths the taps of a pixel that land on one cell are merged first:
// in edge_zero a clamped corner pair weighs w and -w exactly, and in
// zero_pad an invalid corner weighs 0, so a sample more than a pixel
// outside the image adds nothing, and is not added (a NaN weight is kept).
// Float atomics add in an order that changes from run to run, so the last
// bits of the splat do too. The TPU kernels' (8,128) tiles, row spans, band
// paths and tile metadata were devices for a machine without a gather and
// have no counterpart here.

#include <climits>
#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int NT = 256;
constexpr int kTileW = 32, kTileH = NT / kTileW;   // the splat's target tile
constexpr int kBoxFloats = 4096;                    // 16 KB of shared memory
// B * Ht * Wt from which the gather and K5b take 4 pixels a thread: 2^20 / 4
// threads fill an H100's 132 SMs x 2048 thread slots.
constexpr long long kWidePixels = 1 << 20;
constexpr int kPlaneThreads = 1024;                 // the splat's plane path
constexpr int kPlaneUnroll = 2;     // target pixels in flight a thread
constexpr int kMaxGridY = 65535;    // the largest gridDim.y (and gridDim.z)

template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

// The image of a gather or coordinate-gradient block. The batch runs over
// gridDim.y (at most kMaxGridY) and then gridDim.z, so that any B fits one
// launch; with B <= kMaxGridY the grid is (x, B, 1) and b is blockIdx.y.
__device__ __forceinline__ int batch_index() {
  return blockIdx.z * gridDim.y + blockIdx.y;
}

// CC > 0: C == CC, known to the compiler; CC == 0: C at run time.
template <int MODE, int V, int CC>
__global__ void __launch_bounds__(NT) warp_gather_kernel(
    const float* __restrict__ img, const float* __restrict__ coords,
    float* __restrict__ out, int B, int C_, int Hs, int Ws, int npix) {
  const int C = CC > 0 ? CC : C_;
  const int p = (blockIdx.x * NT + threadIdx.x) * V;
  const int b = batch_index();
  if (p >= npix || b >= B) return;
  const size_t hw = (size_t)Hs * Ws;
  const float* crd = coords + (size_t)b * 2 * npix;
  float x[V], y[V];
  load_v<V>(crd + p, x);
  load_v<V>(crd + npix + p, y);
  Taps t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = tap_setup<MODE>(x[v], y[v], Hs, Ws);
  const float* im = img + (size_t)b * C * hw;
  float* o = out + (size_t)b * C * npix + p;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a, d;
      tap_channel(t[v], im + c * hw, r[v], a, d);
    }
    store_v<V>(o + (size_t)c * npix, r);
  }
}

template <int MODE, int V, int CC>
__global__ void __launch_bounds__(NT) warp_coord_grad_kernel(
    const float* __restrict__ img, const float* __restrict__ coords,
    const float* __restrict__ g, float* __restrict__ dcoords, int B, int C_,
    int Hs, int Ws, int npix) {
  const int C = CC > 0 ? CC : C_;
  const int p = (blockIdx.x * NT + threadIdx.x) * V;
  const int b = batch_index();
  if (p >= npix || b >= B) return;
  const size_t hw = (size_t)Hs * Ws;
  const float* crd = coords + (size_t)b * 2 * npix;
  float x[V], y[V];
  load_v<V>(crd + p, x);
  load_v<V>(crd + npix + p, y);
  Taps t[V];
  float gx[V], gy[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    t[v] = tap_setup<MODE>(x[v], y[v], Hs, Ws);
    gx[v] = gy[v] = 0.f;
  }
  const float* im = img + (size_t)b * C * hw;
  const float* gp = g + (size_t)b * C * npix + p;
  // Channels in ascending order, as the plain version sums them.
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float gv[V];
    load_v<V>(gp + (size_t)c * npix, gv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float o, a, d;
      tap_channel(t[v], im + c * hw, o, a, d);
      gx[v] += gv[v] * a;
      gy[v] += gv[v] * d;
    }
  }
  float* dc = dcoords + (size_t)b * 2 * npix + p;
  store_v<V>(dc, gx);
  store_v<V>(dc + npix, gy);
}

// The weights of the taps p00, p01, p10, p11, merged where two land on one
// cell: one of two merged weights is 0, or they are exact negatives, so the
// sum is the other weight, or exactly 0, bit for bit.
__device__ __forceinline__ void merged_weights(const Taps& t, float (&w)[4]) {
  w[0] = t.wx0 * t.wy0; w[1] = t.wx0 * t.wy1;
  w[2] = t.wx1 * t.wy0; w[3] = t.wx1 * t.wy1;
  if (t.p00 == t.p10) {       // x0 == x1
    w[0] += w[2]; w[1] += w[3]; w[2] = w[3] = 0.f;
  }
  if (t.p00 == t.p01) {       // y0 == y1
    w[0] += w[1]; w[2] += w[3]; w[1] = w[3] = 0.f;
  }
}

// The plane path: block b * C + c builds plane (b, c) of d img whole in
// shared memory and stores it: `copies` (a power of two, at most 32) copies
// of the plane, each `stride` floats (16-byte aligned), warp w adding into
// copy w % copies.
template <int MODE>
__global__ void __launch_bounds__(kPlaneThreads) warp_splat_plane_kernel(
    const float* __restrict__ coords, const float* __restrict__ g,
    float* __restrict__ dimg, int C, int Hs, int Ws, int npix, int copies,
    bool vec) {
  extern __shared__ float4 smem4[];
  float* planes = reinterpret_cast<float*>(smem4);
  const int n = Hs * Ws;
  const int stride = (n + 3) & ~3;
  for (int i = threadIdx.x; i < copies * stride; i += kPlaneThreads)
    planes[i] = 0.f;
  __syncthreads();
  float* plane = planes + ((threadIdx.x >> 5) & (copies - 1)) * stride;
  const int b = blockIdx.x / C;
  const float* cx = coords + (size_t)b * 2 * npix;
  const float* cy = cx + npix;
  const float* gp = g + (size_t)blockIdx.x * npix;
  for (int p0 = threadIdx.x; p0 < npix; p0 += kPlaneUnroll * kPlaneThreads) {
    // The loads of kPlaneUnroll pixels first, so that they are in flight
    // together; each is coalesced across the block.
    float x[kPlaneUnroll], y[kPlaneUnroll], gv[kPlaneUnroll];
#pragma unroll
    for (int u = 0; u < kPlaneUnroll; ++u) {
      const int p = p0 + u * kPlaneThreads;
      const bool in = p < npix;
      x[u] = in ? __ldg(cx + p) : 0.f;
      y[u] = in ? __ldg(cy + p) : 0.f;
      gv[u] = in ? __ldg(gp + p) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPlaneUnroll; ++u) {
      if (p0 + u * kPlaneThreads >= npix) break;
      const Taps t = tap_setup<MODE>(x[u], y[u], Hs, Ws);
      float w[4];
      merged_weights(t, w);
      const int idx[4] = {t.p00, t.p01, t.p10, t.p11};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (w[k] != 0.f) atomicAdd(plane + idx[k], w[k] * gv[u]);
    }
  }
  __syncthreads();
  if (copies > 1) {
    // Copy 0 takes the sum, copies added in their order.
    for (int i = threadIdx.x; i < n; i += kPlaneThreads) {
      float sum = planes[i];
      for (int k = 1; k < copies; ++k) sum += planes[k * stride + i];
      planes[i] = sum;
    }
    __syncthreads();
  }
  float* out = dimg + (size_t)blockIdx.x * n;
  if (vec) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < n / 4; i += kPlaneThreads) out4[i] = smem4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kPlaneThreads) out[i] = planes[i];
  }
}

// Adds v0 and v1 into plane[q] and plane[q + 1]: one vector atomic where
// both cells sit in one 16-byte group of a 16-byte aligned plane (`vec`),
// else two scalar ones.
__device__ __forceinline__ void add_pair(float* plane, int q, float v0,
                                         float v1, bool vec) {
  if (vec && (q & 1) == 0) {
    atomicAdd(reinterpret_cast<float2*>(plane + q), make_float2(v0, v1));
  } else if (vec && (q & 3) == 1) {
    atomicAdd(reinterpret_cast<float4*>(plane + q - 1),
              make_float4(0.f, v0, v1, 0.f));
  } else {
    atomicAdd(plane + q, v0);
    atomicAdd(plane + q + 1, v1);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NT) warp_splat_kernel(
    const float* __restrict__ coords, const float* __restrict__ g,
    float* __restrict__ dimg, int C, int Hs, int Ws, int Ht, int Wt,
    bool vec) {
  __shared__ float box[kBoxFloats];
  __shared__ int part[4][NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xt = blockIdx.x * kTileW + lane;
  const int yt = blockIdx.y * kTileH + warp;
  const int b = blockIdx.z;
  const int npix = Ht * Wt;
  const size_t hw = (size_t)Hs * Ws;
  const int p = yt * Wt + xt;
  // The taps (x0,y0), (x0,y1), (x1,y0), (x1,y1), merged; a tap that adds
  // nothing weighs exactly 0.
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  if (xt < Wt && yt < Ht) {
    const float* crd = coords + (size_t)b * 2 * npix;
    const Taps t = tap_setup<MODE>(__ldg(crd + p), __ldg(crd + npix + p), Hs, Ws);
    y0 = t.p00 / Ws;
    x0 = t.p00 - y0 * Ws;
    y1 = t.p01 / Ws;
    x1 = t.p10 - y0 * Ws;
    merged_weights(t, w);
  }
  const bool live = w[0] != 0.f || w[1] != 0.f || w[2] != 0.f || w[3] != 0.f;
  const unsigned all = 0xffffffffu;
  const int wx0 = __reduce_min_sync(all, live ? x0 : INT_MAX);
  const int wy0 = __reduce_min_sync(all, live ? y0 : INT_MAX);
  const int wx1 = __reduce_max_sync(all, live ? x1 : INT_MIN);
  const int wy1 = __reduce_max_sync(all, live ? y1 : INT_MIN);
  if (lane == 0) {
    part[0][warp] = wx0;
    part[1][warp] = wy0;
    part[2][warp] = wx1;
    part[3][warp] = wy1;
  }
  __syncthreads();
  int bx0 = INT_MAX, by0 = INT_MAX, bx1 = INT_MIN, by1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < NT / 32; ++k) {
    bx0 = min(bx0, part[0][k]);
    by0 = min(by0, part[1][k]);
    bx1 = max(bx1, part[2][k]);
    by1 = max(by1, part[3][k]);
  }
  if (bx1 < bx0) return;   // no tap of the tile adds anything
  const int bw = bx1 - bx0 + 1, bh = by1 - by0 + 1;
  const long long cells = (long long)bw * bh;
  const float* gp = g + (size_t)b * C * npix + p;
  float* dp = dimg + (size_t)b * C * hw;
  if (cells * C > kBoxFloats) {
    // The taps spread too far for shared memory: add into global memory,
    // the two taps of a row as one vector atomic where both add.
    if (!live) return;
    const int r0 = y0 * Ws, r1 = y1 * Ws;
    for (int c = 0; c < C; ++c) {
      const float gv = __ldg(gp + (size_t)c * npix);
      float* plane = dp + c * hw;
      if (w[0] != 0.f && w[2] != 0.f) {
        add_pair(plane, r0 + x0, w[0] * gv, w[2] * gv, vec);
      } else {
        if (w[0] != 0.f) atomicAdd(plane + r0 + x0, w[0] * gv);
        if (w[2] != 0.f) atomicAdd(plane + r0 + x1, w[2] * gv);
      }
      if (w[1] != 0.f && w[3] != 0.f) {
        add_pair(plane, r1 + x0, w[1] * gv, w[3] * gv, vec);
      } else {
        if (w[1] != 0.f) atomicAdd(plane + r1 + x0, w[1] * gv);
        if (w[3] != 0.f) atomicAdd(plane + r1 + x1, w[3] * gv);
      }
    }
    return;
  }
  const int n = (int)cells;
  for (int i = threadIdx.x; i < n * C; i += NT) box[i] = 0.f;
  __syncthreads();
  if (live) {
    // Box offsets of the taps (x0,y0), (x0,y1), (x1,y0), (x1,y1).
    const int r0 = (y0 - by0) * bw, r1 = (y1 - by0) * bw;
    const int local[4] = {r0 + x0 - bx0, r1 + x0 - bx0, r0 + x1 - bx0,
                          r1 + x1 - bx0};
    for (int c = 0; c < C; ++c) {
      const float gv = __ldg(gp + (size_t)c * npix);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (w[k] != 0.f) atomicAdd(box + c * n + local[k], w[k] * gv);
    }
  }
  __syncthreads();
  // A cell no tap reached holds an exact 0: adding it changes nothing, so
  // a group or cell of zeros is skipped.
  if (vec) {
    // One float4 atomic a 16-byte group of the plane that a box row
    // touches; the group's cells outside the box add 0.
    const int groups = (bw + 3) / 4 + 1;   // the most a row can touch
    for (int i = threadIdx.x; i < bh * groups; i += NT) {
      const int r = i / groups;
      const int row = (by0 + r) * Ws + bx0;          // plane index of x = bx0
      const int q = ((row >> 2) + (i - r * groups)) << 2;
      if (q > row + bw - 1) continue;
      for (int c = 0; c < C; ++c) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = q + j - row;
          v[j] = (x >= 0 && x < bw) ? box[c * n + r * bw + x] : 0.f;
        }
        if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dp + c * hw + q),
                    make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += NT) {
      const int r = i / bw;
      const size_t cell = (size_t)(by0 + r) * Ws + bx0 + (i - r * bw);
      for (int c = 0; c < C; ++c) {
        const float v = box[c * n + i];
        if (v != 0.f) atomicAdd(dp + c * hw + cell, v);
      }
    }
  }
}

bool bad_shape(int B, int C, int Hs, int Ws, int Ht, int Wt, int mode) {
  return B < 1 || C < 1 || Hs < 1 || Ws < 1 || Ht < 1 || Wt < 1 ||
         (mode != kEdgeZero && mode != kZeroPad) ||
         (long long)Hs * Ws > 0x7fffffffLL || (long long)Ht * Wt > 0x7fffffffLL;
}

bool aligned(const void* p, int bytes) { return ((size_t)p % bytes) == 0; }

// One launch of the gather (grad == false) or of the coordinate gradient,
// with C compiled in where it is 1, 2 or 3.
template <int MODE, int V, int CC>
void launch_cc(bool grad, const float* img, const float* coords,
               const float* g, float* out, int B, int C, int Hs, int Ws,
               int npix, cudaStream_t stream) {
  const int threads = (npix + V - 1) / V;
  // B images over y and z: blocks past B (the last z slice's tail) return.
  const int gy = B < kMaxGridY ? B : kMaxGridY;
  const dim3 grid((threads + NT - 1) / NT, gy, (B + gy - 1) / gy);
  if (grad)
    warp_coord_grad_kernel<MODE, V, CC><<<grid, NT, 0, stream>>>(
        img, coords, g, out, B, C, Hs, Ws, npix);
  else
    warp_gather_kernel<MODE, V, CC><<<grid, NT, 0, stream>>>(
        img, coords, out, B, C, Hs, Ws, npix);
}

template <int MODE, int V>
void launch_v(bool grad, const float* img, const float* coords,
              const float* g, float* out, int B, int C, int Hs, int Ws,
              int npix, cudaStream_t s) {
  switch (C) {
    case 1: launch_cc<MODE, V, 1>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s); break;
    case 2: launch_cc<MODE, V, 2>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s); break;
    case 3: launch_cc<MODE, V, 3>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s); break;
    default: launch_cc<MODE, V, 0>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
  }
}

template <int MODE>
void launch_mode(int V, bool grad, const float* img, const float* coords,
                 const float* g, float* out, int B, int C, int Hs, int Ws,
                 int npix, cudaStream_t s) {
  if (V == 4) launch_v<MODE, 4>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
  else if (V == 2) launch_v<MODE, 2>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
  else launch_v<MODE, 1>(grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
}

// `out` is the gather's samples, or with `grad` the coordinate gradient.
int launch_sampler(bool grad, const float* img, const float* coords,
                   const float* g, float* out, int B, int C, int Hs, int Ws,
                   int Ht, int Wt, int mode, void* stream) {
  if (bad_shape(B, C, Hs, Ws, Ht, Wt, mode)) return (int)cudaErrorInvalidValue;
  const int npix = Ht * Wt;
  const auto fits = [&](int v) {
    return npix % v == 0 && aligned(coords, 4 * v) && aligned(out, 4 * v) &&
           (!grad || aligned(g, 4 * v));
  };
  const int V = (long long)B * npix >= kWidePixels && fits(4) ? 4
                : fits(2) ? 2 : 1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kEdgeZero)
    launch_mode<kEdgeZero>(V, grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
  else
    launch_mode<kZeroPad>(V, grad, img, coords, g, out, B, C, Hs, Ws, npix, s);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory a block of the current card may take,
// in bytes; the plane kernels are allowed that much once a card.
int plane_smem_limit() {
  constexpr int kCards = 64;
  static int limit[kCards];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kCards) return 0;
  if (limit[dev] == 0) {
    int bytes = 0;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(warp_splat_plane_kernel<kEdgeZero>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaFuncSetAttribute(warp_splat_plane_kernel<kZeroPad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      bytes = -1;
    limit[dev] = bytes;
  }
  return limit[dev];
}

}  // namespace

// Launches the gather on `stream`; returns the CUDA error code (0 = launched).
extern "C" int warp_gather_launch(const float* img, const float* coords,
                                  float* out, int B, int C, int Hs, int Ws,
                                  int Ht, int Wt, int mode, void* stream) {
  return launch_sampler(false, img, coords, nullptr, out, B, C, Hs, Ws, Ht,
                        Wt, mode, stream);
}

// Launches the coordinate gradient on `stream`: dcoords (B, 2, Ht, Wt) from
// img, coords and the cotangent g (B, C, Ht, Wt). Returns the CUDA error
// code (0 = launched).
extern "C" int warp_coord_grad_launch(const float* img, const float* coords,
                                      const float* g, float* dcoords, int B,
                                      int C, int Hs, int Ws, int Ht, int Wt,
                                      int mode, void* stream) {
  return launch_sampler(true, img, coords, g, dcoords, B, C, Hs, Ws, Ht, Wt,
                        mode, stream);
}

// Launches the splat into dimg (B, C, Hs, Ws) on `stream`: the plane path
// where a plane has at most `plane_cells` cells and fits the card's shared
// memory, else the tile path, which zeroes dimg on the stream first.
// Returns the CUDA error code (0 = launched).
extern "C" int warp_splat_launch(const float* coords, const float* g,
                                 float* dimg, int B, int C, int Hs, int Ws,
                                 int Ht, int Wt, int mode, int plane_cells,
                                 void* stream) {
  if (bad_shape(B, C, Hs, Ws, Ht, Wt, mode) || B > kMaxGridY ||
      (long long)B * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long cells = (long long)Hs * Ws;
  // Vector stores and atomics need every plane 16-byte aligned.
  const bool vec = cells % 4 == 0 && aligned(dimg, 16);
  if (cells <= plane_cells) {
    const int limit = plane_smem_limit();
    const long long one = (cells + 3) / 4 * 16;    // bytes of one copy
    if (one <= limit) {
      // Copies pay only where a cell takes many taps: at most one for each
      // target pixel a cell, within half the card's shared memory.
      const long long per_cell = (long long)Ht * Wt / cells;
      int copies = 1;
      while (copies < kPlaneThreads / 32 && 2 * copies <= per_cell &&
             2 * copies * one <= limit / 2)
        copies *= 2;
      const long long bytes = copies * one;
      const int npix = Ht * Wt;
      if (mode == kEdgeZero)
        warp_splat_plane_kernel<kEdgeZero><<<B * C, kPlaneThreads, bytes, s>>>(
            coords, g, dimg, C, Hs, Ws, npix, copies, vec);
      else
        warp_splat_plane_kernel<kZeroPad><<<B * C, kPlaneThreads, bytes, s>>>(
            coords, g, dimg, C, Hs, Ws, npix, copies, vec);
      return (int)cudaGetLastError();
    }
  }
  const dim3 grid((Wt + kTileW - 1) / kTileW, (Ht + kTileH - 1) / kTileH, B);
  if (grid.y > kMaxGridY) return (int)cudaErrorInvalidValue;
  const cudaError_t zeroed = cudaMemsetAsync(
      dimg, 0, (size_t)B * C * Hs * Ws * sizeof(float), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (mode == kEdgeZero)
    warp_splat_kernel<kEdgeZero><<<grid, NT, 0, s>>>(coords, g, dimg, C, Hs,
                                                     Ws, Ht, Wt, vec);
  else
    warp_splat_kernel<kZeroPad><<<grid, NT, 0, s>>>(coords, g, dimg, C, Hs,
                                                    Ws, Ht, Wt, vec);
  return (int)cudaGetLastError();
}
