// Fused rigid-warp photometric pair loss and its coordinate gradient, for
// Hopper (sm_90a). Replaces the Pallas TPU kernels of
// sndepth_tpu/kernels/photo_loss.py: _pair_kernel (entries
// warp_photo_pair_loss and, with its weights input,
// warp_photo_pair_loss_weighted) and _kernel (entry warp_photo_loss, one
// direction of the pair for one source).
//
// One block computes one TH x TW output tile of one (batch image, direction,
// source) plane:
//   direction 0: x = tgt[b],     warped y from srcs[b, s] at cf[b, s]
//   direction 1: x = srcs[b, s], warped y from tgt[b]     at cb[b, s]
// with err = alpha * clip((1 - SSIM(x, y)) / 2, 0, 1) + beta * |x - y|
// (beta = 1 - alpha), 3x3/9 zero-padded pools, and the edge_zero bilinear
// sampler. The block writes the sum of err over its in-image pixels and
// channels into one partial, and d(sum err)/d(coords) for its tile: the
// downstream loss is a sum, so the cotangent is a scalar and the complete
// gradient can be formed in the forward pass.
//
// A launch with ndir = 1 runs direction 0 only. With weight planes wf, wb
// (B, ns, H, W; null = all ones) each pixel's error, and with it the
// cotangent of that pixel's error, is scaled by its weight; the weights are
// constants and get no gradient.
//
// What bounds it: DRAM bytes, for the function. It needs ~419 float32
// operations a pixel, direction and source (chip_smoke.py PHOTO_FLOPS)
// against 84 bytes a pixel for both directions and two sources, under the
// bytes at the H100's rates. The measurements below point at the gathers
// as what holds the kernel back: the edge_zero taps of a rigid flow over a
// per-pixel depth land far apart, so a warp's tap load touches many sectors
// of L2; the time followed the number of blocks an SM (gathers in flight)
// and not the shared-memory passes, which this design cut 2.5-fold. The
// design:
//   * Tiles of 16 rows x 30 columns, 8 warps: a warp's 32 lanes are the 32
//     columns of the tile plus its 1-pixel halo, so each pass is one column
//     a lane. The block gathers x and the warped y on the tile plus a
//     2-pixel halo (20 x 34); the halo's gathers are recomputed by each
//     block, not exchanged.
//   * All gathers of a thread issued together: its 2 own pixels (a column
//     of its warp's 2 rows), whose tangents d y / d coords stay in
//     registers until the contraction, and one pixel of the halo ring.
//   * Separable pools by running sums. Pass 1: warp w walks its rows of the
//     tile plus 1-pixel halo, a column a lane, and keeps the horizontal
//     3-sums of the five moments of the last three rows in registers, so a
//     window costs three adds a moment; it forms the SSIM terms, the clip's
//     tie factors, the loss and the three adjoint coefficient planes of all
//     three channels. Pass 2: the adjoint pools of a thread's 2 pixels from
//     rows of 3-sums, dw = d err / d y, and the contraction with the
//     tangents. Three barriers a block (eight before); ~40 shared-memory
//     accesses a pixel and channel (~100 before); no tangents in shared
//     memory.
//   * 37 KB of shared memory and at most 51 registers a thread (32 bytes of
//     spill), so five blocks (40 warps) share an SM, as many as the kernel
//     before had.
// Measured (H100 80GB HBM3 at 700 W, CUDA events, stage 1 at B = 128 over
// its four scales, two calls, each against the kernel before in the same
// call): 2.810 -> 2.287 ms and 2.794 -> 2.274 with this design. Beside it in
// the first call: four blocks an SM 2.368, three 2.696, 32-row tiles (4
// rows a warp, 68 KB, two blocks an SM, 1.275 gathers an output against
// 1.417) 2.940, built with -fmad=false 1% slower; in the second: six blocks
// an SM (96 bytes of spill) 2.673, 8-row tiles (1.7 gathers an output)
// 2.742 at six blocks an SM and 2.926 at eight, though faster at B = 4 below
// 64 rows.
// Pixels outside the image are zero in every pool and carry no loss and no
// cotangent, as in the zero-padded reduce_window of sndepth_tpu/ops/ssim.py.
//
// The tap arithmetic is sampler.cuh's edge_zero mode and the SSIM algebra
// ssim.cuh's, shared with warp.cu and dssim.cu. Built with fused
// multiply-adds (kernels/build.py FMAD_SOURCES): the one exact tie, equal
// windows, is kept by ssim.cuh's unfused ssim_terms and by window sums that
// round alike on the x and y sides (row_moments); the sampler's taps and the
// moments' products round as the plain version's do (sampler.cuh).

#include <cuda_runtime.h>

#include "sampler.cuh"
#include "ssim.cuh"

namespace {

constexpr int TW = 30;                  // tile columns
constexpr int NW = 8;                   // warps per block
constexpr int NT = 32 * NW;             // threads per block
constexpr int NC = 3;                   // image channels
constexpr int RW = 2;                   // tile rows a warp
constexpr int MIN_BLOCKS = 5;           // blocks an SM (at most 51 registers)
constexpr int TH = NW * RW;             // tile rows
constexpr int GH = TH + 4, GW = TW + 4; // tile + 2-pixel halo (gathered)
constexpr int QH = TH + 2, QW = TW + 2; // tile + 1-pixel halo (pass 1)
// Gathered by the block besides the threads' own pixels.
constexpr int NRING = GH * GW - TH * QW;
constexpr int NPLANE = 3;               // adjoint coefficient planes
// Shared memory (floats): x and the warped y on the gathered region, the
// adjoint coefficient planes of the three channels on the pass-1 region.
constexpr int OFF_Y = NC * GH * GW;
constexpr int OFF_Q = 2 * NC * GH * GW;
constexpr int SMEM_FLOATS = OFF_Q + NC * NPLANE * QH * QW;

static_assert(QW == 32, "a warp's lanes are the pass-1 columns");
static_assert(NRING <= NT, "the halo ring is one round");

// The five moments' horizontal 3-sums at one column of a row: x, y, x x,
// y y, x y. Each product is rounded before it is summed, as the plain
// version pools the rounded planes x x, y y and x y (a far-out edge_zero
// sample can be large, and its square's sums cancel in sigma), and the x and
// y sides round alike, so equal windows tie exactly.
struct Moments {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ Moments row_moments(const float* __restrict__ px,
                                               const float* __restrict__ py) {
  const float x0 = px[0], x1 = px[1], x2 = px[2];
  const float y0 = py[0], y1 = py[1], y2 = py[2];
  Moments m;
  m.x = (x0 + x1) + x2;
  m.y = (y0 + y1) + y2;
  m.xx = __fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)),
                   __fmul_rn(x2, x2));
  m.yy = __fadd_rn(__fadd_rn(__fmul_rn(y0, y0), __fmul_rn(y1, y1)),
                   __fmul_rn(y2, y2));
  m.xy = __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                   __fmul_rn(x2, y2));
  return m;
}

// x, the edge_zero sample y and its tangents d y / dx, d y / dy of all
// channels at image pixel (r, c); zeros outside the image.
__device__ __forceinline__ void gather(const float* __restrict__ xim,
                                       const float* __restrict__ wim,
                                       const float* __restrict__ crd, int H,
                                       int W, size_t hw, int r, int c,
                                       float (&xv)[NC], float (&yv)[NC],
                                       float (&tx)[NC], float (&ty)[NC]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) xv[ch] = yv[ch] = tx[ch] = ty[ch] = 0.f;
  if (r < 0 || r >= H || c < 0 || c >= W) return;
  const size_t p = (size_t)r * W + c;
  const Taps t = tap_setup<kEdgeZero>(__ldg(crd + p), __ldg(crd + hw + p), H,
                                      W);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    tap_channel(t, wim + ch * hw, yv[ch], tx[ch], ty[ch]);
    xv[ch] = __ldg(xim + ch * hw + p);
  }
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) photo_pair_kernel(
    const float* __restrict__ tgt, const float* __restrict__ srcs,
    const float* __restrict__ cf, const float* __restrict__ cb,
    const float* __restrict__ wf, const float* __restrict__ wb,
    float* __restrict__ loss_part, float* __restrict__ dcf,
    float* __restrict__ dcb, int ns, int ndir, int H, int W, float alpha,
    float beta) {
  __shared__ float smem[SMEM_FLOATS];
  __shared__ float red[NW];
  float (*sx)[GH][GW] = reinterpret_cast<float (*)[GH][GW]>(smem);
  float (*sy)[GH][GW] = reinterpret_cast<float (*)[GH][GW]>(smem + OFF_Y);
  float (*sq)[NPLANE][QH][QW] =
      reinterpret_cast<float (*)[NPLANE][QH][QW]>(smem + OFF_Q);

  const int plane = blockIdx.z;
  const int s = plane % ns;
  const int dir = (plane / ns) % ndir;
  const int b = plane / (ndir * ns);
  const size_t hw = (size_t)H * W;
  const float* tgt_b = tgt + (size_t)b * NC * hw;
  const float* src_bs = srcs + ((size_t)b * ns + s) * NC * hw;
  const float* xim = dir == 0 ? tgt_b : src_bs;
  const float* wim = dir == 0 ? src_bs : tgt_b;
  const size_t coff = ((size_t)b * ns + s) * 2 * hw;
  const float* crd = (dir == 0 ? cf : cb) + coff;
  float* dcrd = (dir == 0 ? dcf : dcb) + coff;
  const float* wgt = dir == 0 ? wf : wb;
  if (wgt != nullptr) wgt += ((size_t)b * ns + s) * hw;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. Gathers, all issued together: a thread's own pixels (slots 0 .. RW
  //    - 1: gathered column lane + 2 of the tile's rows RW warp .. RW warp +
  //    RW - 1; columns TW, TW + 1 are halo, their tangents unused), then
  //    slot RW: one pixel of the rest of the 2-pixel ring (rows 0, 1, GH -
  //    2, GH - 1 whole, then columns 0 and 1 of the rows between).
  float tx[NC][RW], ty[NC][RW];
#pragma unroll
  for (int i = 0; i <= RW; ++i) {
    int gr, gc;
    if (i < RW) {
      gr = RW * warp + i + 2;
      gc = lane + 2;
    } else if (tid < 4 * GW) {
      const int k = tid / GW;
      gr = k < 2 ? k : GH - 4 + k;
      gc = tid % GW;
    } else {
      gr = 2 + (tid - 4 * GW) / 2;
      gc = (tid - 4 * GW) % 2;
    }
    if (i == RW && tid >= NRING) break;
    float xv[NC], yv[NC], a[NC], b2[NC];
    gather(xim, wim, crd, H, W, hw, r0 + gr - 2, c0 + gc - 2, xv, yv, a, b2);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      sx[ch][gr][gc] = xv[ch];
      sy[ch][gr][gc] = yv[ch];
      if (i < RW) {
        tx[ch][i] = a[ch];
        ty[ch][i] = b2[ch];
      }
    }
  }
  __syncthreads();

  // 2. Pass 1: warp w walks pass-1 rows [q0, q1), column lane; pass-1 row q
  //    is tile row q - 1, its window gathered rows q .. q + 2.
  const int q0 = QH * warp / NW, q1 = QH * (warp + 1) / NW;
  const int c = c0 + lane - 1;
  float err = 0.f;
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    Moments h0 = row_moments(&sx[ch][q0][lane], &sy[ch][q0][lane]);
    Moments h1 = row_moments(&sx[ch][q0 + 1][lane], &sy[ch][q0 + 1][lane]);
    for (int q = q0; q < q1; ++q) {
      const Moments h2 =
          row_moments(&sx[ch][q + 2][lane], &sy[ch][q + 2][lane]);
      const int r = r0 + q - 1;
      float va = 0.f, vb = 0.f, vc = 0.f;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const Ssim m = ssim_terms((h0.x + h1.x) + h2.x, (h0.y + h1.y) + h2.y,
                                  (h0.xx + h1.xx) + h2.xx,
                                  (h0.yy + h1.yy) + h2.yy,
                                  (h0.xy + h1.xy) + h2.xy);
        const float wv =
            wgt != nullptr ? __ldg(wgt + (size_t)r * W + c) : 1.f;
        const SsimAdjoint a = ssim_adjoint(m, wv * clip01_grad(m.s));
        va = a.a_y;
        vb = a.b;
        vc = a.c;
        if (q >= 1 && q <= TH && lane >= 1 && lane <= TW) {
          const float xv = sx[ch][q + 1][lane + 1];
          const float yv = sy[ch][q + 1][lane + 1];
          err += wv * (alpha * clip01(m.s) + beta * fabsf(xv - yv));
        }
      }
      sq[ch][0][q][lane] = va;
      sq[ch][1][q][lane] = vb;
      sq[ch][2][q][lane] = vc;
      h0 = h1;
      h1 = h2;
    }
  }
  __syncthreads();

  // 3. Pass 2: the adjoint pools of tile rows RW warp + i at column lane
  //    (pass-1 rows tr .. tr + 2, columns lane .. lane + 2), dw and the
  //    contraction with the tangents.
  if (lane < TW) {
    float gxs[RW], gys[RW], wout[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + RW * warp + i, cc = c0 + lane;
      gxs[i] = gys[i] = 0.f;
      wout[i] = (r < H && cc < W)
                    ? (wgt != nullptr ? __ldg(wgt + (size_t)r * W + cc) : 1.f)
                    : 0.f;
    }
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      float h[RW + 2][NPLANE];
#pragma unroll
      for (int u = 0; u < RW + 2; ++u) {
        const int q = RW * warp + u;
#pragma unroll
        for (int k = 0; k < NPLANE; ++k)
          h[u][k] = (sq[ch][k][q][lane] + sq[ch][k][q][lane + 1]) +
                    sq[ch][k][q][lane + 2];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int tr = RW * warp + i;
        const float pa = ((h[i][0] + h[i + 1][0]) + h[i + 2][0]) / 9.f;
        const float pb = ((h[i][1] + h[i + 1][1]) + h[i + 2][1]) / 9.f;
        const float pc = ((h[i][2] + h[i + 1][2]) + h[i + 2][2]) / 9.f;
        const float xv = sx[ch][tr + 2][lane + 2];
        const float yv = sy[ch][tr + 2][lane + 2];
        const float d_ssim = pa + 2.f * yv * pb + xv * pc;
        const float diff = xv - yv;
        const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
        const float dw = alpha * d_ssim + beta * (-sgn * wout[i]);
        gxs[i] += dw * tx[ch][i];
        gys[i] += dw * ty[ch][i];
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + RW * warp + i, cc = c0 + lane;
      if (r < H && cc < W) {
        const size_t p = (size_t)r * W + cc;
        dcrd[p] = gxs[i];
        dcrd[hw + p] = gys[i];
      }
    }
  }

  // 4. Block sum of err.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) err += __shfl_down_sync(0xffffffffu, err, o);
  if (lane == 0) red[warp] = err;
  __syncthreads();
  if (tid < 32) {
    float v = tid < NW ? red[tid] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (tid == 0)
      loss_part[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                blockIdx.x] = v;
  }
}

}  // namespace

extern "C" int photo_pair_tile_h() { return TH; }
extern "C" int photo_pair_tile_w() { return TW; }

// Launches the kernel on `stream`; returns the CUDA error code (0 = launched).
// tgt (B, 3, H, W); srcs (B, ns, 3, H, W); cf, cb, dcf, dcb (B, ns, 2, H, W);
// wf, wb (B, ns, H, W) or null; ndir is 2 (both directions) or 1 (direction 0
// only: cb, wb and dcb are not read and may be null). loss_part has one float
// per block: ceil(W/TW) * ceil(H/TH) * B * ndir * ns.
extern "C" int photo_pair_launch(const float* tgt, const float* srcs,
                                 const float* cf, const float* cb,
                                 const float* wf, const float* wb,
                                 float* loss_part, float* dcf, float* dcb,
                                 int B, int ns, int ndir, int C, int H, int W,
                                 float alpha, float beta, void* stream) {
  if (C != NC || B < 1 || ns < 1 || H < 1 || W < 1 ||
      (ndir != 1 && ndir != 2) || (long long)B * ndir * ns > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * ndir * ns);
  photo_pair_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      tgt, srcs, cf, cb, wf, wb, loss_part, dcf, dcb, ns, ndir, H, W, alpha,
      beta);
  return (int)cudaGetLastError();
}
