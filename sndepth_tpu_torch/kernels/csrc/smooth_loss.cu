// Edge-aware smoothness sums and their depth gradients, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel of sndepth_tpu/kernels/smooth_loss.py
// (_kernel; entry smooth_loss_sums). For D depth planes of one sample that
// share the sample's image (D = 1: a depth; D = 2: the two channels of a
// flow), with the image's C channels:
//
//   wx[i, j] = exp(-mean_c |img[c, i, j] - img[c, i, j + 1]|)   (j < W - 1)
//   wy[i, j] = exp(-mean_c |img[c, i, j] - img[c, i + 1, j]|)   (i < H - 1)
//   sx = sum over planes of sum |d[i, j] - d[i, j + 1]| wx[i, j]
//   sy = sum over planes of sum |d[i, j] - d[i + 1, j]| wy[i, j]
//
// and, since the downstream cotangents are scalars, d sx / d d and
// d sy / d d in the same pass: with px = sign(d[i, j] - d[i, j + 1]) wx
// (0 at j = W - 1), ddx[i, j] = px[i, j] - px[i, j - 1]; likewise ddy with
// py and rows. The image gets no gradient.
//
// Layout: depth, ddx, ddy (N, D, H, W); image (N, C, H, W); float32,
// contiguous. out holds the two sums, then one pair of partial sums a block.
//
// What bounds it: DRAM bytes. It needs ~40 operations a pixel and plane
// against (4 + 4 C / D + 8) bytes, 24 at D = 1 and C = 3. The design:
//   * A warp owns a strip of 30 columns, a lane a column plus one column
//     each side (lanes 0 and 31), and walks a segment of rows down it. It
//     loads a chunk of rows of every plane at once (one 128-byte load a row
//     and plane), and the next chunk while it works on this one, so a warp
//     keeps loads in flight; the row above a chunk stays in registers. The
//     rows just above and below a segment are loaded once more, from L2. A
//     segment is kChunk k - 2 rows, k = 8, 4, 2 or 1 chunks (one row at
//     least): the most for which the grid still has MIN_WARPS warps, since
//     a warp's chunks run one after another and a small call is bound by
//     that chain, a large one by the bytes.
//   * Left and right neighbours come from the next lane by shuffle. Every
//     warp runs the same number of chunks, rows outside its segment only
//     predicated off, so that no branch around a shuffle depends on the
//     warp (the compiler gives such shuffles their slow divergent form).
//   * All D planes of a sample in one warp: the image is read once and the
//     edge weights formed once for both channels of a flow.
//   * One launch a call: each block writes one pair of partial sums, and the
//     last block to finish (a ticket taken after a fence) adds them in block
//     order, so the sums do not depend on scheduling and two runs give the
//     same bits. The ticket is a counter word the caller keeps for each
//     stream (zero before the first call), which the last block sets back
//     to 0: calls on one stream run in turn, so calls on different streams
//     may overlap.
// Measured (H100 80GB HBM3 at 700 W, against the Triton kernel before it
// in the same call): stage 1 at B = 128 over its four scales 0.381 ->
// 0.291 ms, 74% of the byte bound at 384x128x416 (a copy of as many bytes
// takes 0.167, 88% of it); a stage-2 step's calls 0.629 -> 0.323 ms (12
// calls against 20 and their channel copies). Tried before and slower: one
// row in flight a warp, where the chain of a warp's row loads set the
// time; chunks without double buffering; chunks of 8 rows, which spill. A
// build without fused multiply-adds takes the same time.
// Built with fused multiply-adds (kernels/build.py FMAD_SOURCES): the only
// tie is sign(0) of an exact difference, which no contraction touches.

#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;                   // warps per block
constexpr int NT = 32 * NW;             // threads per block
constexpr int COLS = 30;                // columns a warp owns
// Rows loaded at once: two chunks of the D + C planes (one in flight, one
// being processed) fit in 64 registers.
template <int D>
constexpr int kChunk = D == 1 ? 4 : 2;
constexpr int MIN_WARPS = 8192;         // see the segment rule above
constexpr int MIN_BLOCKS = 4;           // 4 blocks of 8 warps: 64 registers

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// exp(-mean_c |a_c - b_c|); the mean as the plain version's CUDA mean takes
// it, the sum times 1 / C.
template <int C>
__device__ __forceinline__ float edge_weight(const float (&a)[C],
                                             const float (&b)[C]) {
  float s = fabsf(a[0] - b[0]);
#pragma unroll
  for (int k = 1; k < C; ++k) s += fabsf(a[k] - b[k]);
  return expf(-(s * (1.f / C)));
}

// kChunk rows of the lane's column in every plane; zeros outside the image
// and past the last row walked.
template <int D, int C>
struct Chunk {
  float d[kChunk<D>][D];
  float im[kChunk<D>][C];
};

template <int D, int C>
struct Walker {
  const float* dp;
  const float* ip;
  float* gx;
  float* gy;
  size_t hw;
  int W, c, r0, r1, re;
  bool col_in, own, has_right;
  float pd[D], pim[C];  // the row above
  float pyp[D];         // py of the row above that

  __device__ __forceinline__ void load(int base, Chunk<D, C>& ch) const {
#pragma unroll
    for (int i = 0; i < kChunk<D>; ++i) {
      const int r = base + i;
      const bool in = col_in && r >= 0 && r <= re;
      const size_t p = (size_t)r * W + c;
#pragma unroll
      for (int k = 0; k < D; ++k)
        ch.d[i][k] = in ? __ldg(dp + k * hw + p) : 0.f;
#pragma unroll
      for (int k = 0; k < C; ++k)
        ch.im[i][k] = in ? __ldg(ip + k * hw + p) : 0.f;
    }
  }

  // Rows base .. base + kChunk - 1 in order. Every lane runs every row and
  // every shuffle; a row outside the segment only leaves nothing behind.
  __device__ __forceinline__ void process(int base, const Chunk<D, C>& ch,
                                          float& sx, float& sy) {
#pragma unroll
    for (int i = 0; i < kChunk<D>; ++i) {
      const int r = base + i;
      const bool walked = r <= re;
      // Vertical terms of row r - 1.
      const bool vert = walked && r >= r0 && r >= 1;
      const bool owned_y = vert && own && r - 1 >= r0;
      const float wy = edge_weight<C>(pim, ch.im[i]);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float gd = pd[k] - ch.d[i][k];
        const float pm = sgn(gd) * wy;
        if (owned_y) {
          sy += fabsf(gd) * wy;
          gy[k * hw + (size_t)(r - 1) * W + c] = pm - pyp[k];
        }
        if (vert) pyp[k] = pm;
      }
      // Horizontal terms of row r: every shuffle of the row before any
      // store, so that no shuffle follows a branch of the same row.
      const bool owned_x = own && r >= r0 && r < r1;
      float ir[C], gd[D], px[D], left[D];
#pragma unroll
      for (int k = 0; k < C; ++k)
        ir[k] = __shfl_down_sync(0xffffffffu, ch.im[i][k], 1);
      const float wx = has_right ? edge_weight<C>(ch.im[i], ir) : 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        gd[k] = ch.d[i][k] - __shfl_down_sync(0xffffffffu, ch.d[i][k], 1);
        px[k] = sgn(gd[k]) * wx;
        left[k] = __shfl_up_sync(0xffffffffu, px[k], 1);
      }
      if (owned_x) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          sx += fabsf(gd[k]) * wx;
          gx[k * hw + (size_t)r * W + c] = px[k] - left[k];
        }
      }
      if (walked) {
#pragma unroll
        for (int k = 0; k < D; ++k) pd[k] = ch.d[i][k];
#pragma unroll
        for (int k = 0; k < C; ++k) pim[k] = ch.im[i][k];
      }
    }
  }
};

// Warp `item` of the grid walks its segment: `nchunk` chunks from the row
// above it. The trip count is the same for every warp, so no branch or loop
// around a shuffle depends on the warp (the compiler would otherwise give
// the shuffles their divergent form); a warp past the last item loads
// nothing and writes nothing.
template <int D, int C>
__device__ __forceinline__ void walk(const float* __restrict__ depth,
                                     const float* __restrict__ image,
                                     float* __restrict__ ddx,
                                     float* __restrict__ ddy, int N, int H,
                                     int W, int nchunk, int nseg, int nstrip,
                                     long long item, int lane, float& sx,
                                     float& sy) {
  const bool active = item < (long long)N * nseg * nstrip;
  const int strip = (int)(item % nstrip);
  const int seg = (int)((item / nstrip) % nseg);
  const int n = active ? (int)(item / ((long long)nstrip * nseg)) : 0;
  const int rows = kChunk<D> * nchunk - 2;
  Walker<D, C> w;
  w.hw = (size_t)H * W;
  w.dp = depth + (size_t)n * D * w.hw;
  w.ip = image + (size_t)n * C * w.hw;
  w.gx = ddx + (size_t)n * D * w.hw;
  w.gy = ddy + (size_t)n * D * w.hw;
  w.W = W;
  w.c = strip * COLS - 1 + lane;               // the lane's column
  w.col_in = active && w.c >= 0 && w.c < W;
  w.own = lane >= 1 && lane <= COLS && w.col_in;
  w.has_right = w.c >= 0 && w.c < W - 1;       // a term between c and c + 1
  w.r0 = seg * rows;
  w.r1 = min(w.r0 + rows, H);
  w.re = min(w.r1, H - 1);                     // the last row walked
#pragma unroll
  for (int k = 0; k < D; ++k) w.pyp[k] = w.pd[k] = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) w.pim[k] = 0.f;
  // Two chunks in turn: the next one's loads are in flight while this one
  // is processed.
  Chunk<D, C> a, b;
  const int top = w.r0 - 1;
  w.load(top, a);
  for (int j = 0; j < nchunk; j += 2) {
    if (j + 1 < nchunk) w.load(top + (j + 1) * kChunk<D>, b);
    w.process(top + j * kChunk<D>, a, sx, sy);
    if (j + 1 >= nchunk) break;
    if (j + 2 < nchunk) w.load(top + (j + 2) * kChunk<D>, a);
    w.process(top + (j + 1) * kChunk<D>, b, sx, sy);
  }
  // The last row has no term below it: ddy = -py of the row above.
  if (w.r1 == H && w.own) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      w.gy[k * w.hw + (size_t)(H - 1) * W + w.c] = -w.pyp[k];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Adds (a, b) over the block in a fixed order; the result is in thread 0.
__device__ __forceinline__ void block_sum(float& a, float& b,
                                          float (&red)[2][NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = red[0][0];
    b = red[1][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
  __syncthreads();
}

template <int D, int C>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) smooth_kernel(
    const float* __restrict__ depth, const float* __restrict__ image,
    float* __restrict__ out, float* __restrict__ ddx,
    float* __restrict__ ddy, unsigned int* __restrict__ ticket, int N, int H,
    int W, int nchunk, int nseg, int nstrip) {
  __shared__ float red[2][NW];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sx = 0.f, sy = 0.f;
  walk<D, C>(depth, image, ddx, ddy, N, H, W, nchunk, nseg, nstrip,
             (long long)blockIdx.x * NW + warp, lane, sx, sy);
  float* part = out + 2;
  block_sum(sx, sy, red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = sx;
    part[2 * blockIdx.x + 1] = sy;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is visible past the fences; read them
  // from L2 and add them in block order.
  __threadfence();
  float ax = 0.f, ay = 0.f;
#pragma unroll 8
  for (unsigned b = threadIdx.x; b < gridDim.x; b += NT) {
    ax += __ldcg(part + 2 * b);
    ay += __ldcg(part + 2 * b + 1);
  }
  block_sum(ax, ay, red);
  if (threadIdx.x == 0) {
    out[0] = ax;
    out[1] = ay;
    *ticket = 0;
  }
}

// The grid of a call: chunks a segment, segments and strips a plane, blocks.
struct Grid {
  int nchunk, nseg, nstrip, nb;
};

template <int D>
Grid grid(int N, int H, int W) {
  Grid g;
  g.nstrip = (W + COLS - 1) / COLS;
  for (g.nchunk = 8;; g.nchunk /= 2) {
    g.nseg = (H + kChunk<D> * g.nchunk - 3) / (kChunk<D> * g.nchunk - 2);
    if ((long long)N * g.nseg * g.nstrip >= MIN_WARPS ||
        kChunk<D> * (g.nchunk / 2) - 2 < 1)
      break;
  }
  const long long nb = ((long long)N * g.nseg * g.nstrip + NW - 1) / NW;
  g.nb = nb > 0x7fffffffLL ? -1 : (int)nb;
  return g;
}

Grid grid(int N, int D, int H, int W) {
  return D == 1 ? grid<1>(N, H, W) : grid<2>(N, H, W);
}

using Kernel = void (*)(const float*, const float*, float*, float*, float*,
                       unsigned int*, int, int, int, int, int, int);

}  // namespace

// Floats of `out` a call needs: the two sums and two a block.
extern "C" long long smooth_out_floats(int N, int D, int H, int W) {
  if (D != 1 && D != 2) return -1;
  const Grid g = grid(N, D, H, W);
  return g.nb < 0 ? -1 : 2 + 2 * (long long)g.nb;
}

// Launches the kernel on `stream`; returns the CUDA error code (0 =
// launched). depth, ddx, ddy (N, D, H, W); image (N, 3, H, W), the only
// channel count built; D 1 or 2. out has smooth_out_floats(N, D, H, W)
// floats; out[0], out[1] get sx, sy. ticket is the stream's counter word:
// 0 before the call, and 0 again after it.
extern "C" int smooth_launch(const float* depth, const float* image,
                             float* out, long long out_floats, float* ddx,
                             float* ddy, unsigned int* ticket, int N, int D,
                             int C, int H, int W, void* stream) {
  if (C != 3 || (D != 1 && D != 2) || N < 1 || H < 2 || W < 2)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = D == 1 ? smooth_kernel<1, 3> : smooth_kernel<2, 3>;
  const Grid g = grid(N, D, H, W);
  if (g.nb < 0 || out_floats < 2 + 2 * (long long)g.nb)
    return (int)cudaErrorInvalidValue;
  kernel<<<g.nb, NT, 0, (cudaStream_t)stream>>>(
      depth, image, out, ddx, ddy, ticket, N, H, W, g.nchunk, g.nseg,
      g.nstrip);
  return (int)cudaGetLastError();
}
