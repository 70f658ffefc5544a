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
// runtime argument. The gather and its coordinate gradient take any B, in
// one launch for each batch of planes of fewer than 2^31 target pixels
// (one for every call of this repository: kernels/warp.py counts them);
// the splat takes B <= 65535.
//
// Gather and coordinate gradient: DRAM bytes bound them (8 bytes of
// coordinates a pixel in, 4 C out; the coordinate gradient reads 4 C of
// cotangent and writes 8). The source plane comes through L1 and L2,
// because neighbouring pixels hit neighbouring taps. The shapes run from
// a few planes of many pixels at small C (GeoNet's images and flows,
// RAFT3D's depth) over many planes of many pixels at C = 32 (UniAD's
// attention levels) to thousands of 81-pixel planes at C = 1 (RAFT2D's
// correlation lookup) and few pixels at C = 256 or 512 (UniAD's
// deformable convolutions and BEV shift). So:
//  - A thread takes V consecutive target pixels, with one V * 4-byte load
//    each of x and y and one V * 4-byte store (or cotangent load) a
//    channel: V = 4 where B * Ht * Wt reaches kWidePixels (scattered taps
//    then want many loads in flight a thread). Else, where C <= 3, V = 2,
//    and where C > 3, V = 1, so that a warp's lanes read neighbouring taps
//    of one channel plane. V needs Ht * Wt a multiple of V and aligned
//    planes; other shapes take the same code with one pixel a thread.
//    C = 1, 2 and 3 (RAFT3D's depth, a flow, an image) are compiled apart.
//  - Threads are numbered over all B * Ht * Wt / V pixel groups and find
//    their plane by a multiply and a shift (PlaneDiv), so that a block
//    spans several planes where they are small: a lookup plane of 81
//    targets no longer leaves 175 of a block's 256 threads idle.
//  - Where C > 3 a thread loads the taps of K channels (all V pixels)
//    before it uses any: K = kChunkValues / V (8 at V = 1, 2 at V = 4),
//    and 1 for the coordinate gradient at V = 4, where that divides C. A
//    loop over a run-time C had the taps of 4 V samples in flight.
//  - The coordinate gradient sums each chunk's K products pairwise, and the
//    chunks' sums in ascending order: independent adds, shorter chains of
//    float32 rounding than one sum over C, and the same bits from run to
//    run.
//  - Where C > 3 and the pixels leave the card idle, the gather splits the
//    channels into `groups` (a power of two, at most kMaxGroups, each of
//    at least kMinGroupChannels): a thread takes V pixels and one group,
//    and the groups grow towards two waves of the card's thread slots. A
//    block holds 256 / groups pixel threads of each group. Channel groups
//    made the coordinate gradient no faster at the repository's shapes
//    but the BEV shift, which is faster than grid_sample's either way.
//  - zero_pad, C > 3: where the samples of a whole warp lie wholly outside
//    the image (each a finite coordinate more than a pixel off it in x or
//    in y), their weights are 0 at all four taps and their tangents 0, and
//    their taps are not read: the gather stores zeros, and the coordinate
//    gradient adds g times 0. UniAD's camera attention has 83% of its
//    samples outside their camera. That is the only difference from the
//    plain version, which multiplies the clamped taps by 0: a non-finite
//    value in a cell that only such taps reach no longer turns the sample,
//    or the coordinate gradient, into NaN, and such a sample is +0 where
//    the plain version may give -0 (the two compare equal). A non-finite
//    coordinate or cotangent gives NaN as before. edge_zero's far-out
//    weights are not 0: it reads every tap.
// Each sample rounds as tap_channel (sampler.cuh) does, so the gather
// equals its plain version.
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
constexpr int kLgNT = 8;                            // log2(NT)
constexpr int kTileW = 32, kTileH = NT / kTileW;   // the splat's target tile
constexpr int kBoxFloats = 4096;                    // 16 KB of shared memory
// B * Ht * Wt from which the gather and K5b take 4 pixels a thread: 2^20 / 4
// threads fill an H100's 132 SMs x 2048 thread slots.
constexpr long long kWidePixels = 1 << 20;
// Where C > 3: the (channel, pixel) samples whose taps a gather or
// coordinate-gradient thread loads at once, and the least channels a
// gather group keeps (its threads each set up their pixels' taps for so
// many channels).
constexpr int kChunkValues = 8;
constexpr int kMinGroupChannels = 32;
// The gather's most channel groups: two measured faster than four at
// UniAD's deformable convolutions.
constexpr int kMaxGroups = 2;
constexpr int kPlaneThreads = 1024;                 // the splat's plane path
constexpr int kPlaneUnroll = 2;     // target pixels in flight a thread
constexpr int kMaxGridY = 65535;    // the largest gridDim.y

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

// f / npix for f < 2^31 by a multiply and a shift: (f * m) >> (32 + s)
// where m != 0, else f >> s (npix a power of two). The launcher sets it.
struct PlaneDiv {
  unsigned m;
  int s;
};

__device__ __forceinline__ unsigned plane_of(unsigned f, PlaneDiv d) {
  return d.m ? __umulhi(f, d.m) >> d.s : f >> d.s;
}

// Thread (blockIdx.x, threadIdx.x) of a gather or coordinate-gradient
// launch with 2^lgp pixel threads a block: its channel group `grp` (0 for
// the coordinate gradient), and, unless it lies past the last of the nq
// groups of V pixels, its plane b and the offset p of its first pixel in
// that plane.
template <int V>
__device__ __forceinline__ bool locate(unsigned nq, int npix, PlaneDiv div,
                                       int lgp, int& b, int& p, int& grp) {
  const unsigned q = (blockIdx.x << lgp) + (threadIdx.x & ((1u << lgp) - 1));
  grp = threadIdx.x >> lgp;
  if (q >= nq) return false;
  const unsigned f = q * V;
  b = (int)plane_of(f, div);
  p = (int)(f - (unsigned)b * npix);
  return true;
}

// The taps of the V pixels from offset p of plane b. Returns, with SKIP,
// whether all V samples lie wholly outside the image in zero_pad (a finite
// coordinate more than a pixel off it in x or in y): their weights and
// tangents are exactly 0 for finite taps.
template <int MODE, int V, bool SKIP>
__device__ __forceinline__ bool pixel_taps(const float* __restrict__ coords,
                                           int b, int p, int npix, int Hs,
                                           int Ws, Taps (&t)[V]) {
  const float* crd = coords + (size_t)b * 2 * npix;
  float x[V], y[V];
  load_v<V>(crd + p, x);
  load_v<V>(crd + npix + p, y);
  bool outside = SKIP && MODE == kZeroPad;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    t[v] = tap_setup<MODE>(x[v], y[v], Hs, Ws);
    outside = outside &&
              ((t[v].dx0 == 0.f && t[v].dx1 == 0.f) ||
               (t[v].dy0 == 0.f && t[v].dy1 == 0.f)) &&
              isfinite(x[v]) && isfinite(y[v]);
  }
  return outside;
}

// The four taps i00, i01, i10, i11 of channel plane `plane`.
__device__ __forceinline__ void read_taps(const Taps& t,
                                          const float* __restrict__ plane,
                                          float (&i)[4]) {
  i[0] = __ldg(plane + t.p00);
  i[1] = __ldg(plane + t.p01);
  i[2] = __ldg(plane + t.p10);
  i[3] = __ldg(plane + t.p11);
}

// tap_channel's sample and tangents (sampler.cuh, whose loads photo_pair.cu
// shares and which stays as it is) from taps read ahead, rounded alike.
__device__ __forceinline__ float blend(const Taps& t, const float (&i)[4]) {
  const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
  const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, i[0]),
                                       __fmul_rn(w01, i[1])),
                             __fmul_rn(w10, i[2])),
                   __fmul_rn(w11, i[3]));
}

__device__ __forceinline__ void tangents(const Taps& t, const float (&i)[4],
                                         float& tx, float& ty) {
  tx = __fadd_rn(
      __fmul_rn(t.wy0, __fsub_rn(__fmul_rn(t.dx1, i[2]), __fmul_rn(t.dx0, i[0]))),
      __fmul_rn(t.wy1, __fsub_rn(__fmul_rn(t.dx1, i[3]), __fmul_rn(t.dx0, i[1]))));
  ty = __fadd_rn(
      __fmul_rn(t.wx0, __fsub_rn(__fmul_rn(t.dy1, i[1]), __fmul_rn(t.dy0, i[0]))),
      __fmul_rn(t.wx1, __fsub_rn(__fmul_rn(t.dy1, i[3]), __fmul_rn(t.dy0, i[2]))));
}

// The taps of a live thread's pixels, and whether the zero_pad samples of
// its whole warp lie wholly outside the image, so that their taps need not
// be read (threads past the end count as outside). Only where C > 3: where
// C <= 3 a sample's few taps cost less than the test, and a test a thread
// would split the warps where only some samples lie outside.
template <int MODE, int V, int CC>
__device__ __forceinline__ bool thread_taps(const float* __restrict__ coords,
                                          bool live, int b, int p, int npix,
                                          int Hs, int Ws, Taps (&t)[V]) {
  constexpr bool kSkip = CC == 0 && MODE == kZeroPad;
  const bool outside =
      live ? pixel_taps<MODE, V, kSkip>(coords, b, p, npix, Hs, Ws, t) : true;
  return kSkip && __all_sync(0xffffffffu, outside);
}

// CC > 0: C == CC, known to the compiler, and one group; CC == 0: C at run
// time, and a thread takes the C >> (kLgNT - lgp) channels of its group. K
// channels at a time.
template <int MODE, int V, int CC, int K>
__global__ void __launch_bounds__(NT) warp_gather_kernel(
    const float* __restrict__ img, const float* __restrict__ coords,
    float* __restrict__ out, int C_, int Hs, int Ws, int npix, unsigned nq,
    PlaneDiv div, int lgp_) {
  const int C = CC > 0 ? CC : C_;
  const int lgp = CC > 0 ? kLgNT : lgp_;
  int b = 0, p = 0, grp;
  const bool live = locate<V>(nq, npix, div, lgp, b, p, grp);
  Taps t[V];
  const bool outside =
      thread_taps<MODE, V, CC>(coords, live, b, p, npix, Hs, Ws, t);
  if (!live) return;
  const size_t hw = (size_t)Hs * Ws;
  const int cg = CC > 0 ? CC : C >> (kLgNT - lgp);
  const float* im = img + ((size_t)b * C + grp * cg) * hw;
  float* o = out + ((size_t)b * C + grp * cg) * npix + p;
  if (outside) {
    const float zero[V] = {};
    for (int c = 0; c < cg; ++c) store_v<V>(o + (size_t)c * npix, zero);
    return;
  }
  for (int c = 0; c < cg; c += K) {
    float i[K][V][4];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) read_taps(t[v], im + (c + k) * hw, i[k][v]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = blend(t[v], i[k][v]);
      store_v<V>(o + (size_t)(c + k) * npix, r);
    }
  }
}

// A thread takes all C channels of its V pixels, K at a time.
template <int MODE, int V, int CC, int K>
__global__ void __launch_bounds__(NT) warp_coord_grad_kernel(
    const float* __restrict__ img, const float* __restrict__ coords,
    const float* __restrict__ g, float* __restrict__ dcoords, int C_, int Hs,
    int Ws, int npix, unsigned nq, PlaneDiv div) {
  const int C = CC > 0 ? CC : C_;
  int b = 0, p = 0, grp;
  const bool live = locate<V>(nq, npix, div, kLgNT, b, p, grp);
  Taps t[V];
  const bool outside =
      thread_taps<MODE, V, CC>(coords, live, b, p, npix, Hs, Ws, t);
  if (!live) return;
  const size_t hw = (size_t)Hs * Ws;
  const float* im = img + (size_t)b * C * hw;
  const float* gp = g + (size_t)b * C * npix + p;
  float gx[V], gy[V];
#pragma unroll
  for (int v = 0; v < V; ++v) gx[v] = gy[v] = 0.f;
  if (outside) {
    // Zero tangents: the sums take g times 0, NaN where g is not finite, as
    // in the plain version.
    for (int c = 0; c < C; ++c) {
      float gv[V];
      load_v<V>(gp + (size_t)c * npix, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gx[v] = __fadd_rn(gx[v], __fmul_rn(gv[v], 0.f));
        gy[v] = __fadd_rn(gy[v], __fmul_rn(gv[v], 0.f));
      }
    }
  } else {
    for (int c = 0; c < C; c += K) {
      float gv[K][V], i[K][V][4];
#pragma unroll
      for (int k = 0; k < K; ++k) load_v<V>(gp + (size_t)(c + k) * npix, gv[k]);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) read_taps(t[v], im + (c + k) * hw, i[k][v]);
      float px[K][V], py[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float tx, ty;
          tangents(t[v], i[k][v], tx, ty);
          px[k][v] = __fmul_rn(gv[k][v], tx);
          py[k][v] = __fmul_rn(gv[k][v], ty);
        }
      // Pairwise within the chunk: independent adds, and short chains of
      // float32 rounding.
#pragma unroll
      for (int s = 1; s < K; s *= 2)
#pragma unroll
        for (int k = 0; k + s < K; k += 2 * s)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            px[k][v] = __fadd_rn(px[k][v], px[k + s][v]);
            py[k][v] = __fadd_rn(py[k][v], py[k + s][v]);
          }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gx[v] = __fadd_rn(gx[v], px[0][v]);
        gy[v] = __fadd_rn(gy[v], py[0][v]);
      }
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

// The thread slots of the current card (SMs x threads an SM), 0 where
// they cannot be read; read once a card.
long long card_thread_slots() {
  constexpr int kCards = 64;
  static long long slots[kCards];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kCards) return 0;
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev) != cudaSuccess)
      sms = per_sm = 0;
    slots[dev] = (long long)sms * per_sm;
  }
  return slots[dev];
}

// K where C > 3: kChunkValues / V, but one channel for the coordinate
// gradient at V = 4, whose four pixels' taps and products fill the
// registers (two measured 1.5x slower at UniAD's camera attention).
constexpr int large_c_chunk(int V, bool grad) {
  return grad && V == 4 ? 1 : kChunkValues / V;
}

// How a gather or coordinate-gradient call is launched: V pixels a thread,
// K channels a chunk, `groups` channel groups.
struct SamplerLaunch {
  int V, K, groups;
};

SamplerLaunch sampler_launch(bool grad, const float* coords, const float* g,
                             const float* out, int B, int C, int npix) {
  const auto fits = [&](int v) {
    return npix % v == 0 && aligned(coords, 4 * v) && aligned(out, 4 * v) &&
           (!grad || aligned(g, 4 * v));
  };
  SamplerLaunch l;
  const long long pixels = (long long)B * npix;
  const bool wide = pixels >= kWidePixels && fits(4);
  l.groups = 1;
  if (C <= 3) {
    // An image's gather loads a channel's taps at a time (all three at once
    // measured 3-4% slower at GeoNet's image warp), its coordinate gradient
    // all three (a channel at a time measured 7-10% slower).
    l.V = wide ? 4 : fits(2) ? 2 : 1;
    l.K = C == 3 && !grad ? 1 : C;
    return l;
  }
  // Large C: one pixel a thread where the pixels do not fill the card, so
  // that a warp's lanes read neighbouring taps of one channel plane; and,
  // for the gather, channel groups towards two waves of the card's thread
  // slots. The coordinate gradient measured no faster with groups at any
  // of UniAD's shapes but the BEV shift, and slower at the deformable
  // convolutions: it takes one.
  l.V = wide ? 4 : 1;
  l.K = C % large_c_chunk(l.V, grad) == 0 ? large_c_chunk(l.V, grad) : 1;
  const long long threads = pixels / l.V, want = 2 * card_thread_slots();
  while (!grad && 2 * l.groups <= kMaxGroups &&
         C % (2 * l.groups * l.K) == 0 &&
         C / (2 * l.groups) >= kMinGroupChannels && threads * l.groups < want)
    l.groups *= 2;
  return l;
}

PlaneDiv plane_div(unsigned d) {
  int s = 0;
  while ((1ull << s) < d) ++s;   // 2^(s-1) < d <= 2^s
  if ((1ull << s) == d) return {0u, s};
  // m = ceil(2^(31 + s) / d) < 2^32; f m / 2^(31 + s) floors to f / d for
  // f < 2^31, since (m d - 2^(31 + s)) f < d 2^31 <= 2^(31 + s).
  const unsigned long long m = ((1ull << (31 + s)) + d - 1) / d;
  return {(unsigned)m, s - 1};
}

template <int MODE, int V, int CC, int K, bool GRAD>
void launch_k(const float* img, const float* coords, const float* g,
              float* out, int B, int C, int Hs, int Ws, int npix,
              const SamplerLaunch& l, cudaStream_t stream) {
  int lgg = 0;
  while ((1 << lgg) < l.groups) ++lgg;
  const int lgp = kLgNT - lgg;
  const PlaneDiv div = plane_div((unsigned)npix);
  // Batches of planes of fewer than 2^31 pixels, one launch each (one for
  // any call this repository makes; kernels/warp.py's sampler_launches
  // counts them alike).
  const int planes = (int)(0x7fffffffLL / npix < B ? 0x7fffffffLL / npix : B);
  for (int b0 = 0; b0 < B; b0 += planes) {
    const int nb = B - b0 < planes ? B - b0 : planes;
    const unsigned nq = (unsigned)((long long)nb * npix / V);
    const unsigned blocks = (nq + (1u << lgp) - 1) >> lgp;
    const size_t ib = (size_t)b0 * C * Hs * Ws, cb = (size_t)b0 * 2 * npix;
    if constexpr (GRAD)
      warp_coord_grad_kernel<MODE, V, CC, K><<<blocks, NT, 0, stream>>>(
          img + ib, coords + cb, g + (size_t)b0 * C * npix, out + cb, C, Hs,
          Ws, npix, nq, div);
    else
      warp_gather_kernel<MODE, V, CC, K><<<blocks, NT, 0, stream>>>(
          img + ib, coords + cb, out + (size_t)b0 * C * npix, C, Hs, Ws, npix,
          nq, div, lgp);
  }
}

template <int MODE, int V, bool GRAD>
void launch_v(const float* img, const float* coords, const float* g,
              float* out, int B, int C, int Hs, int Ws, int npix,
              const SamplerLaunch& l, cudaStream_t s) {
  constexpr int kChunk = large_c_chunk(V, GRAD);
  if (C == 1)
    launch_k<MODE, V, 1, 1, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (C == 2)
    launch_k<MODE, V, 2, 2, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (C == 3)
    launch_k<MODE, V, 3, GRAD ? 3 : 1, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (l.K == kChunk)
    launch_k<MODE, V, 0, kChunk, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else
    launch_k<MODE, V, 0, 1, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
}

template <int MODE, bool GRAD>
void launch_mode(const float* img, const float* coords, const float* g,
                 float* out, int B, int C, int Hs, int Ws, int npix,
                 const SamplerLaunch& l, cudaStream_t s) {
  if (l.V == 4) launch_v<MODE, 4, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (l.V == 2) launch_v<MODE, 2, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else launch_v<MODE, 1, GRAD>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
}

// `out` is the gather's samples, or with `grad` the coordinate gradient.
int launch_sampler(bool grad, const float* img, const float* coords,
                   const float* g, float* out, int B, int C, int Hs, int Ws,
                   int Ht, int Wt, int mode, void* stream) {
  if (bad_shape(B, C, Hs, Ws, Ht, Wt, mode)) return (int)cudaErrorInvalidValue;
  const int npix = Ht * Wt;
  const SamplerLaunch l = sampler_launch(grad, coords, g, out, B, C, npix);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kEdgeZero && grad)
    launch_mode<kEdgeZero, true>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (mode == kEdgeZero)
    launch_mode<kEdgeZero, false>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else if (grad)
    launch_mode<kZeroPad, true>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
  else
    launch_mode<kZeroPad, false>(img, coords, g, out, B, C, Hs, Ws, npix, l, s);
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

// The launch that warp_gather_launch (grad = 0) or warp_coord_grad_launch
// (grad = 1) makes for these pointers and shape, into cfg[4]: V pixels a
// thread, K channels a chunk, the channel groups and the target pixels a
// block. Returns the CUDA error code (0 = read).
extern "C" int warp_sampler_config(int grad, const float* coords,
                                   const float* g, const float* out, int B,
                                   int C, int Ht, int Wt, int* cfg) {
  if (bad_shape(B, C, 1, 1, Ht, Wt, kEdgeZero)) return (int)cudaErrorInvalidValue;
  const SamplerLaunch l = sampler_launch(grad != 0, coords, g, out, B, C, Ht * Wt);
  cfg[0] = l.V;
  cfg[1] = l.K;
  cfg[2] = l.groups;
  cfg[3] = NT / l.groups * l.V;
  return 0;
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
