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
// Steps:
//   1. gather x and the warped y (and, on the tile, the tangents
//      dy/dcoord) into shared memory on the tile plus a 2-pixel halo; the
//      halo's gathers are recomputed by each block, not exchanged;
//   2. per channel, on the tile plus a 1-pixel halo: the pools, SSIM terms,
//      the clip's tie factors and the three adjoint coefficient planes;
//   3. on the tile: the adjoint pools, dw = d err / d y, contracted with the
//      tangents over channels;
//   4. reduce err over the block into its partial.
// Pixels outside the image are zero in every pool and carry no loss and no
// cotangent, as in the zero-padded reduce_window of sndepth_tpu/ops/ssim.py.
//
// The tap arithmetic is sampler.cuh's edge_zero mode and the SSIM algebra
// ssim.cuh's, shared with warp.cu and dssim.cu. Build with -fmad=false (see
// ssim.cuh).

#include <cuda_runtime.h>

#include "sampler.cuh"
#include "ssim.cuh"

namespace {

constexpr int TH = 16;                  // tile rows
constexpr int TW = 32;                  // tile columns
constexpr int NT = 256;                 // threads per block
constexpr int NC = 3;                   // image channels
constexpr int RH = TH + 4, RW = TW + 4; // tile + 2-pixel halo
constexpr int QH = TH + 2, QW = TW + 2; // tile + 1-pixel halo
constexpr int PPT = TH * TW / NT;       // tile pixels per thread

// edge_zero bilinear sample of all channels of img at (x, y), with the
// tangents d out / dx and d out / dy.
__device__ __forceinline__ void sample(const float* __restrict__ img,
                                       int H, int W, size_t hw, float x,
                                       float y, float* out, float* tx,
                                       float* ty) {
  const Taps t = tap_setup<kEdgeZero>(x, y, H, W);
#pragma unroll
  for (int c = 0; c < NC; ++c) tap_channel(t, img + c * hw, out[c], tx[c], ty[c]);
}

__global__ void __launch_bounds__(NT) photo_pair_kernel(
    const float* __restrict__ tgt, const float* __restrict__ srcs,
    const float* __restrict__ cf, const float* __restrict__ cb,
    const float* __restrict__ wf, const float* __restrict__ wb,
    float* __restrict__ loss_part, float* __restrict__ dcf,
    float* __restrict__ dcb, int ns, int ndir, int H, int W, float alpha,
    float beta) {
  __shared__ float sx[NC][RH][RW];
  __shared__ float sy[NC][RH][RW];
  __shared__ float stx[NC][TH][TW];
  __shared__ float sty[NC][TH][TW];
  __shared__ float qa[QH][QW], qb[QH][QW], qc[QH][QW];
  __shared__ float sw[QH][QW];
  __shared__ float red[NT / 32];

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
  const int tid = threadIdx.x;

  // 1. x and warped y on the tile + 2-pixel halo; tangents on the tile.
  for (int k = tid; k < RH * RW; k += NT) {
    const int rr = k / RW, cc = k % RW;
    const int r = r0 + rr - 2, c = c0 + cc - 2;
    float xv[NC], yv[NC], txv[NC], tyv[NC];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) xv[ch] = yv[ch] = txv[ch] = tyv[ch] = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const size_t p = (size_t)r * W + c;
      sample(wim, H, W, hw, __ldg(crd + p), __ldg(crd + hw + p), yv, txv,
             tyv);
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) xv[ch] = __ldg(xim + ch * hw + p);
    }
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      sx[ch][rr][cc] = xv[ch];
      sy[ch][rr][cc] = yv[ch];
    }
    const int tr = rr - 2, tc = cc - 2;
    if (tr >= 0 && tr < TH && tc >= 0 && tc < TW) {
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        stx[ch][tr][tc] = txv[ch];
        sty[ch][tr][tc] = tyv[ch];
      }
    }
  }
  // The pixel weights on the tile + 1-pixel halo.
  for (int k = tid; k < QH * QW; k += NT) {
    const int r = r0 + k / QW - 1, c = c0 + k % QW - 1;
    float wv = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W)
      wv = wgt != nullptr ? __ldg(wgt + (size_t)r * W + c) : 1.f;
    sw[k / QW][k % QW] = wv;
  }
  __syncthreads();

  float err = 0.f;
  float gx[PPT], gy[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) gx[i] = gy[i] = 0.f;

  for (int ch = 0; ch < NC; ++ch) {
    // 2. SSIM terms and adjoint coefficients on the tile + 1-pixel halo.
    for (int k = tid; k < QH * QW; k += NT) {
      const int qr = k / QW, qcol = k % QW;
      const int r = r0 + qr - 1, c = c0 + qcol - 1;
      float va = 0.f, vb = 0.f, vc = 0.f;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        float s_x = 0.f, s_y = 0.f, s_xx = 0.f, s_yy = 0.f, s_xy = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float xv = sx[ch][qr + i][qcol + j];
            const float yv = sy[ch][qr + i][qcol + j];
            s_x += xv;
            s_y += yv;
            s_xx += xv * xv;
            s_yy += yv * yv;
            s_xy += xv * yv;
          }
        }
        const Ssim m = ssim_terms(s_x, s_y, s_xx, s_yy, s_xy);
        const float wv = sw[qr][qcol];
        const SsimAdjoint a = ssim_adjoint(m, wv * clip01_grad(m.s));
        va = a.a_y;
        vb = a.b;
        vc = a.c;
        if (qr >= 1 && qr <= TH && qcol >= 1 && qcol <= TW) {
          const float xv = sx[ch][qr + 1][qcol + 1];
          const float yv = sy[ch][qr + 1][qcol + 1];
          err += wv * (alpha * clip01(m.s) + beta * fabsf(xv - yv));
        }
      }
      qa[qr][qcol] = va;
      qb[qr][qcol] = vb;
      qc[qr][qcol] = vc;
    }
    __syncthreads();

    // 3. Adjoint pools and the tangent contraction on the tile.
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int k = tid + i * NT;
      const int tr = k / TW, tc = k % TW;
      float pa = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          pa += qa[tr + u][tc + v];
          pb += qb[tr + u][tc + v];
          pc += qc[tr + u][tc + v];
        }
      }
      pa /= 9.f;
      pb /= 9.f;
      pc /= 9.f;
      const float xv = sx[ch][tr + 2][tc + 2];
      const float yv = sy[ch][tr + 2][tc + 2];
      const float d_ssim = pa + 2.f * yv * pb + xv * pc;
      const float diff = xv - yv;
      const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
      const float dw = alpha * d_ssim + beta * (-sgn * sw[tr + 1][tc + 1]);
      gx[i] += dw * stx[ch][tr][tc];
      gy[i] += dw * sty[ch][tr][tc];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int k = tid + i * NT;
    const int r = r0 + k / TW, c = c0 + k % TW;
    if (r < H && c < W) {
      const size_t p = (size_t)r * W + c;
      dcrd[p] = gx[i];
      dcrd[hw + p] = gy[i];
    }
  }

  // 4. Block sum of err.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) err += __shfl_down_sync(0xffffffffu, err, o);
  if ((tid & 31) == 0) red[tid >> 5] = err;
  __syncthreads();
  if (tid < 32) {
    float v = tid < NT / 32 ? red[tid] : 0.f;
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
