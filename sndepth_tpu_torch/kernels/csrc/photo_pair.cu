// Fused rigid-warp photometric pair loss and its coordinate gradient, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel
// sndepth_tpu/kernels/photo_loss.py:_pair_kernel (entry warp_photo_pair_loss).
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
// Build with -fmad=false: every product and sum then rounds as in the plain
// PyTorch version, so windows where x == y give exactly SSIM = 1 and take
// the clip's 0.5 tie factor in both.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;                  // tile rows
constexpr int TW = 32;                  // tile columns
constexpr int NT = 256;                 // threads per block
constexpr int NC = 3;                   // image channels
constexpr int RH = TH + 4, RW = TW + 4; // tile + 2-pixel halo
constexpr int QH = TH + 2, QW = TW + 2; // tile + 1-pixel halo
constexpr int PPT = TH * TW / NT;       // tile pixels per thread
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

// edge_zero bilinear sample of all channels of img at (x, y), with the
// tangents d out / dx and d out / dy. Corner indices are clamped before
// the weights are formed, so the weights of an out-of-image corner vanish.
__device__ __forceinline__ void sample(const float* __restrict__ img,
                                       int H, int W, size_t hw, float x,
                                       float y, float* out, float* tx,
                                       float* ty) {
  const float xf = floorf(x), yf = floorf(y);
  const float x0 = fminf(fmaxf(xf, 0.f), W - 1.f);
  const float x1 = fminf(fmaxf(xf + 1.f, 0.f), W - 1.f);
  const float y0 = fminf(fmaxf(yf, 0.f), H - 1.f);
  const float y1 = fminf(fmaxf(yf + 1.f, 0.f), H - 1.f);
  const float wx0 = x1 - x, wx1 = x - x0, wy0 = y1 - y, wy1 = y - y0;
  const float w00 = wx0 * wy0, w01 = wx0 * wy1;
  const float w10 = wx1 * wy0, w11 = wx1 * wy1;
  const int p00 = (int)y0 * W + (int)x0, p01 = (int)y1 * W + (int)x0;
  const int p10 = (int)y0 * W + (int)x1, p11 = (int)y1 * W + (int)x1;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float* p = img + c * hw;
    const float i00 = __ldg(p + p00), i01 = __ldg(p + p01);
    const float i10 = __ldg(p + p10), i11 = __ldg(p + p11);
    out[c] = w00 * i00 + w01 * i01 + w10 * i10 + w11 * i11;
    tx[c] = wy0 * (i10 - i00) + wy1 * (i11 - i01);
    ty[c] = wx0 * (i01 - i00) + wx1 * (i11 - i10);
  }
}

__global__ void __launch_bounds__(NT) photo_pair_kernel(
    const float* __restrict__ tgt, const float* __restrict__ srcs,
    const float* __restrict__ cf, const float* __restrict__ cb,
    float* __restrict__ loss_part, float* __restrict__ dcf,
    float* __restrict__ dcb, int ns, int H, int W, float alpha,
    float beta) {
  __shared__ float sx[NC][RH][RW];
  __shared__ float sy[NC][RH][RW];
  __shared__ float stx[NC][TH][TW];
  __shared__ float sty[NC][TH][TW];
  __shared__ float qa[QH][QW], qb[QH][QW], qc[QH][QW];
  __shared__ float red[NT / 32];

  const int plane = blockIdx.z;
  const int s = plane % ns;
  const int dir = (plane / ns) % 2;
  const int b = plane / (2 * ns);
  const size_t hw = (size_t)H * W;
  const float* tgt_b = tgt + (size_t)b * NC * hw;
  const float* src_bs = srcs + ((size_t)b * ns + s) * NC * hw;
  const float* xim = dir == 0 ? tgt_b : src_bs;
  const float* wim = dir == 0 ? src_bs : tgt_b;
  const size_t coff = ((size_t)b * ns + s) * 2 * hw;
  const float* crd = (dir == 0 ? cf : cb) + coff;
  float* dcrd = (dir == 0 ? dcf : dcb) + coff;
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
        const float mu_x = s_x / 9.f, mu_y = s_y / 9.f;
        const float sigma_x = s_xx / 9.f - mu_x * mu_x;
        const float sigma_y = s_yy / 9.f - mu_y * mu_y;
        const float sigma_xy = s_xy / 9.f - mu_x * mu_y;
        const float t1 = 2.f * sigma_xy + kC2;
        const float t2 = 2.f * mu_x * mu_y + kC1;
        const float t3 = sigma_x + sigma_y + kC2;
        const float t4 = mu_x * mu_x + mu_y * mu_y + kC1;
        const float n = t2 * t1, d = t4 * t3;
        const float sv = 0.5f * (1.f - n / d);
        // d clip / d s: 1 inside, 0 outside, 0.5 at a tie with 0 or 1.
        const float lo = 0.5f * ((sv > 0.f ? 1.f : 0.f) +
                                 (sv >= 0.f ? 1.f : 0.f));
        const float hi = 0.5f * ((sv < 1.f ? 1.f : 0.f) +
                                 (sv <= 1.f ? 1.f : 0.f));
        const float gp = lo * hi;
        const float inv_d = 1.f / d;
        const float a_n = -0.5f * gp * inv_d;
        const float a_d = 0.5f * gp * n * inv_d * inv_d;
        va = mu_x * (2.f * a_n * (t1 - t2)) + mu_y * (2.f * a_d * (t3 - t4));
        vb = a_d * t4;
        vc = 2.f * a_n * t2;
        if (qr >= 1 && qr <= TH && qcol >= 1 && qcol <= TW) {
          const float xv = sx[ch][qr + 1][qcol + 1];
          const float yv = sy[ch][qr + 1][qcol + 1];
          err += alpha * fminf(fmaxf(sv, 0.f), 1.f) + beta * fabsf(xv - yv);
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
      const float dw = alpha * d_ssim + beta * -sgn;
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
// loss_part has one float per block: ceil(W/TW) * ceil(H/TH) * B * 2 * ns.
extern "C" int photo_pair_launch(const float* tgt, const float* srcs,
                                 const float* cf, const float* cb,
                                 float* loss_part, float* dcf, float* dcb,
                                 int B, int ns, int C, int H, int W,
                                 float alpha, float beta, void* stream) {
  if (C != NC || B < 1 || ns < 1 || H < 1 || W < 1 || B * 2 * ns > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * 2 * ns);
  photo_pair_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      tgt, srcs, cf, cb, loss_part, dcf, dcb, ns, H, W, alpha, beta);
  return (int)cudaGetLastError();
}
