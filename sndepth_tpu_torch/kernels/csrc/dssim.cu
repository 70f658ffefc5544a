// DSSIM map and its adjoint, for Hopper (sm_90a). Replace the Pallas TPU
// kernels of sndepth_tpu/kernels/dssim.py (_dssim_kernel, _dssim_bwd_kernel;
// entry dssim_pallas):
//   forward   out = clip((1 - SSIM(x, y)) / 2, 0, 1) per pixel, with 3x3/9
//             zero-padded average pools;
//   backward  for a cotangent plane g, dX = P(A_x) + 2 x P(B) + y P(Cxy) and
//             dY = P(A_y) + 2 y P(B) + x P(Cxy) (ssim.cuh), clip ties split 0.5.
//
// Layout: x, y, g, out, dx, dy are N planes of H x W float32, contiguous (the
// caller folds batch and channels into N).
//
// Both are bound by DRAM bytes: 12 bytes a pixel forward, 12 in and 4 or 8 out
// backward, against ~60 and ~150 flops. One block computes one TH x TW tile of
// one plane from shared memory: the forward stages x and y on a 1-pixel halo;
// the backward stages x and y on a 2-pixel halo and g on a 1-pixel halo, forms
// the four adjoint coefficient planes on the 1-pixel halo, then pools them on
// the tile. Halos are recomputed by each block, not exchanged, so blocks are
// independent and every intermediate plane stays out of DRAM. The TPU kernel
// held whole planes in VMEM instead.

#include <cuda_runtime.h>

#include "ssim.cuh"

namespace {

constexpr int TH = 16;                  // tile rows
constexpr int TW = 32;                  // tile columns
constexpr int NT = 256;                 // threads per block
constexpr int RH = TH + 4, RW = TW + 4; // tile + 2-pixel halo
constexpr int QH = TH + 2, QW = TW + 2; // tile + 1-pixel halo
constexpr int PPT = TH * TW / NT;       // tile pixels per thread

// The five sums of the 3x3 window whose top-left corner is (r, c) of the
// staged planes (row stride `stride`).
__device__ __forceinline__ Ssim window_terms(const float* sx, const float* sy,
                                             int stride, int r, int c) {
  float s_x = 0.f, s_y = 0.f, s_xx = 0.f, s_yy = 0.f, s_xy = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float xv = sx[(r + i) * stride + c + j];
      const float yv = sy[(r + i) * stride + c + j];
      s_x += xv;
      s_y += yv;
      s_xx += xv * xv;
      s_yy += yv * yv;
      s_xy += xv * yv;
    }
  }
  return ssim_terms(s_x, s_y, s_xx, s_yy, s_xy);
}

__global__ void __launch_bounds__(NT) dssim_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int H, int W) {
  __shared__ float sx[QH * QW];
  __shared__ float sy[QH * QW];
  const size_t base = (size_t)blockIdx.z * H * W;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  for (int k = tid; k < QH * QW; k += NT) {
    const int r = r0 + k / QW - 1, c = c0 + k % QW - 1;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    const size_t p = base + (size_t)r * W + c;
    sx[k] = in ? __ldg(x + p) : 0.f;
    sy[k] = in ? __ldg(y + p) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int k = tid + i * NT;
    const int tr = k / TW, tc = k % TW;
    const int r = r0 + tr, c = c0 + tc;
    if (r < H && c < W)
      out[base + (size_t)r * W + c] =
          clip01(window_terms(sx, sy, QW, tr, tc).s);
  }
}

__global__ void __launch_bounds__(NT) dssim_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ dy, int H, int W) {
  __shared__ float sx[RH * RW];
  __shared__ float sy[RH * RW];
  __shared__ float qax[QH * QW], qay[QH * QW], qb[QH * QW], qc[QH * QW];
  const size_t base = (size_t)blockIdx.z * H * W;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  for (int k = tid; k < RH * RW; k += NT) {
    const int r = r0 + k / RW - 2, c = c0 + k % RW - 2;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    const size_t p = base + (size_t)r * W + c;
    sx[k] = in ? __ldg(x + p) : 0.f;
    sy[k] = in ? __ldg(y + p) : 0.f;
  }
  __syncthreads();
  // Adjoint coefficients on the tile + 1-pixel halo; zero outside the image,
  // where there is no output pixel and so no cotangent.
  for (int k = tid; k < QH * QW; k += NT) {
    const int qr = k / QW, qcol = k % QW;
    const int r = r0 + qr - 1, c = c0 + qcol - 1;
    SsimAdjoint a = {0.f, 0.f, 0.f, 0.f};
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const Ssim m = window_terms(sx, sy, RW, qr, qcol);
      const float gp = __ldg(g + base + (size_t)r * W + c) * clip01_grad(m.s);
      a = ssim_adjoint(m, gp);
    }
    qax[k] = a.a_x;
    qay[k] = a.a_y;
    qb[k] = a.b;
    qc[k] = a.c;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int k = tid + i * NT;
    const int tr = k / TW, tc = k % TW;
    const int r = r0 + tr, c = c0 + tc;
    if (r >= H || c >= W) continue;
    float pax = 0.f, pay = 0.f, pb = 0.f, pc = 0.f;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int q = (tr + u) * QW + tc + v;
        pax += qax[q];
        pay += qay[q];
        pb += qb[q];
        pc += qc[q];
      }
    }
    pax /= 9.f;
    pay /= 9.f;
    pb /= 9.f;
    pc /= 9.f;
    const float xv = sx[(tr + 2) * RW + tc + 2];
    const float yv = sy[(tr + 2) * RW + tc + 2];
    const size_t p = base + (size_t)r * W + c;
    if (dx != nullptr) dx[p] = pax + 2.f * xv * pb + yv * pc;
    if (dy != nullptr) dy[p] = pay + 2.f * yv * pb + xv * pc;
  }
}

bool bad_shape(int N, int H, int W) {
  return N < 1 || N > 65535 || H < 1 || W < 1 ||
         (long long)H * W > 0x7fffffffLL;
}

dim3 tiles(int N, int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, N);
}

}  // namespace

// Launch on `stream`; each returns the CUDA error code (0 = launched).
// x, y, out: N planes of H x W.
extern "C" int dssim_fwd_launch(const float* x, const float* y, float* out,
                                int N, int H, int W, void* stream) {
  if (bad_shape(N, H, W)) return (int)cudaErrorInvalidValue;
  dssim_fwd_kernel<<<tiles(N, H, W), NT, 0, (cudaStream_t)stream>>>(x, y, out,
                                                                   H, W);
  return (int)cudaGetLastError();
}

// dx or dy may be null: that side is not written.
extern "C" int dssim_bwd_launch(const float* x, const float* y, const float* g,
                                float* dx, float* dy, int N, int H, int W,
                                void* stream) {
  if (bad_shape(N, H, W) || (dx == nullptr && dy == nullptr))
    return (int)cudaErrorInvalidValue;
  dssim_bwd_kernel<<<tiles(N, H, W), NT, 0, (cudaStream_t)stream>>>(
      x, y, g, dx, dy, H, W);
  return (int)cudaGetLastError();
}
