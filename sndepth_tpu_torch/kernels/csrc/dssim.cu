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
// The function is bound by DRAM bytes: 12 bytes a pixel forward, 12 in and
// 4 or 8 out backward, against ~100 and ~170 operations. Halos are
// recomputed, not exchanged, so every intermediate plane stays out of DRAM;
// the TPU kernel held whole planes in VMEM instead.
//   * Forward: one block computes one TH x TW tile of one plane from x and y
//     staged in shared memory on a 1-pixel halo, nine taps a window.
//   * Backward: one warp walks a strip of BW_COLS columns (a lane a column,
//     plus a 2-column halo each side) down BW_ROWS rows, everything in
//     registers and no shared memory: the five moments' row 3-sums from the
//     lanes beside it by shuffle, each window's sums, SSIM terms and adjoint
//     coefficients, the coefficients' row 3-sums by shuffle, and the pools
//     from the last three rows of those. A side that is not wanted is a
//     template parameter: its coefficient plane is neither formed nor
//     pooled. The 2-pixel halo costs (32 / 28) x (BW_ROWS + 2) / BW_ROWS =
//     1.21 windows an output (1.41 for the 16 x 32 tiles of before); 10
//     shuffles a row with one side, 12 with both, against ~60 shared-memory
//     accesses a pixel before.
// What holds the backward back is its own instructions, not its bytes:
// 0.049 ms of bytes at 64x3x128x416 against a loop of ~1250 SASS
// instructions for three rows (divisions, plain-order window sums).
// Measured there (H100 80GB HBM3 at 700 W, dY only as the step calls it,
// against the kernel before it in the same call): 0.221 -> 0.117 ms, 42%
// of the byte bound; both sides 0.235 -> 0.139; a fused build the same
// time. Tried and dropped: window sums from row 3-sums (faster, but off
// the plain gradients by more than the tolerance where the SSIM
// denominator is small); __fdiv_rn for the 1/9s; a loop bound per warp,
// which gave the shuffles their divergent form; shorter segments; fewer
// registers.
//
// Built without fused multiply-adds (the default flags): the backward is as
// fast either way, and the forward then stays bit-equal to the plain
// version. The one exact tie, equal windows, holds because the x and y
// sides of every window term round alike (ssim.cuh).

#include <cuda_runtime.h>

#include "ssim.cuh"

namespace {

constexpr int TH = 16;                  // forward tile rows
constexpr int TW = 32;                  // forward tile columns
constexpr int NT = 256;                 // forward threads per block
constexpr int QH = TH + 2, QW = TW + 2; // tile + 1-pixel halo
constexpr int PPT = TH * TW / NT;       // tile pixels per thread
constexpr int BW_ROWS = 32;             // backward rows a warp
constexpr int BW_COLS = 28;             // backward columns a warp
constexpr int BW_NW = 4;                // backward warps per block
constexpr int BW_NT = 32 * BW_NW;
constexpr int BW_MIN_BLOCKS = 8;        // blocks an SM: 64 registers

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

__device__ __forceinline__ float left_of(float v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}

__device__ __forceinline__ float right_of(float v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// Adjoint coefficients A_x, A_y, B, Cxy; a side not wanted leaves its A
// unused, and the compiler drops it.
struct Coef {
  float ax, ay, b, c;
};

// Row 3-sums of the coefficient planes the wanted sides need.
template <bool DX, bool DY>
__device__ __forceinline__ Coef row_sum3(const Coef& v) {
  Coef h{};
  if (DX) h.ax = (left_of(v.ax) + v.ax) + right_of(v.ax);
  if (DY) h.ay = (left_of(v.ay) + v.ay) + right_of(v.ay);
  h.b = (left_of(v.b) + v.b) + right_of(v.b);
  h.c = (left_of(v.c) + v.c) + right_of(v.c);
  return h;
}

// One warp walks BW_ROWS output rows of a strip of BW_COLS columns of one
// plane: lane l is image column c0 - 2 + l, and lanes 2 .. 29 are the
// strip's columns. At image row t it loads x, y and g, forms the row's
// moment 3-sums (valid on lanes 1 .. 30), the window centred on row t - 1
// from the last three rows of them, that window's adjoint coefficients and
// their row 3-sums (valid on lanes 2 .. 29), and the output of row t - 2
// from the last three rows of those.
template <bool DX, bool DY>
__global__ void __launch_bounds__(BW_NT, BW_MIN_BLOCKS) dssim_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ dy, int N, int H, int W, int nseg, int nstrip) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * BW_NW + (threadIdx.x >> 5);
  // A warp past the last item loads nothing and writes nothing; it runs
  // the loop all the same, whose trip count is the same for every warp, so
  // that no branch or loop around a shuffle depends on the warp (the
  // compiler would otherwise give the shuffles their divergent form).
  const bool active = item < (long long)N * nseg * nstrip;
  const int strip = (int)(item % nstrip);
  const int seg = (int)((item / nstrip) % nseg);
  const size_t base =
      active ? (size_t)(item / ((long long)nstrip * nseg)) * H * W : 0;
  const int c = strip * BW_COLS - 2 + lane;
  const bool col_in = active && c >= 0 && c < W;
  const bool mid = lane >= 1 && lane <= 30;       // window columns
  const bool out_col = lane >= 2 && lane <= BW_COLS + 1 && col_in;
  const int r0 = seg * BW_ROWS, r1 = min(r0 + BW_ROWS, H);

  auto load = [&](int t, float& xv, float& yv, float& gv) {
    const bool in = col_in && t >= 0 && t < H;
    const size_t p = base + (size_t)t * W + c;
    xv = in ? __ldg(x + p) : 0.f;
    yv = in ? __ldg(y + p) : 0.f;
    gv = in ? __ldg(g + p) : 0.f;
  };

  Moments h0{}, h1{};                  // moments of rows t - 2, t - 1
  float wx[2][3] = {}, wy[2][3] = {};   // x, y of rows t - 1, t around the lane
  Coef q0{}, q1{};                     // coefficient 3-sums, rows t - 3, t - 2
  float xa = 0.f, ya = 0.f, ga = 0.f;  // x, y, g at row t - 1
  float xb = 0.f, yb = 0.f;            // x, y at row t - 2
  float xn, yn, gn;
  load(r0 - 2, xn, yn, gn);
#pragma unroll 3
  for (int i = 0; i < BW_ROWS + 4; ++i) {
    const int t = r0 - 2 + i;               // the row of xt, yt, gt
    const float xt = xn, yt = yn, gt = gn;
    if (i + 1 < BW_ROWS + 4) load(t + 1, xn, yn, gn);
    const float xl = left_of(xt), xr = right_of(xt);
    const float yl = left_of(yt), yr = right_of(yt);
    const Moments h2 = moments3(xl, xt, xr, yl, yt, yr);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wx[0][j] = wx[1][j];
      wy[0][j] = wy[1][j];
    }
    wx[1][0] = xl;
    wx[1][1] = xt;
    wx[1][2] = xr;
    wy[1][0] = yl;
    wy[1][1] = yt;
    wy[1][2] = yr;
    if (i >= 2) {
      // The window centred on row t - 1; no cotangent outside the image.
      Coef v{};
      if (mid && col_in && t - 1 < H && t >= 1) {
        // The plain version's order (avg_pool2d): the nine taps row by row,
        // the first row's three being h0, products and sums rounded one by
        // one, so that mu and sigma round as the plain version's do: where
        // the SSIM denominator is small its adjoint magnifies any
        // difference (window sums taken from row 3-sums missed the plain
        // gradients by more than the tolerance).
        float s_x = h0.x, s_y = h0.y, s_xx = h0.xx, s_yy = h0.yy,
              s_xy = h0.xy;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float a = wx[i][j], b = wy[i][j];
            s_x = __fadd_rn(s_x, a);
            s_y = __fadd_rn(s_y, b);
            s_xx = __fadd_rn(s_xx, __fmul_rn(a, a));
            s_yy = __fadd_rn(s_yy, __fmul_rn(b, b));
            s_xy = __fadd_rn(s_xy, __fmul_rn(a, b));
          }
        const Ssim m = ssim_terms(s_x, s_y, s_xx, s_yy, s_xy);
        // The pool's 1/9 rides the cotangent: the coefficients are linear
        // in it.
        const SsimAdjoint a =
            ssim_adjoint(m, ga * clip01_grad(m.s) * (1.f / 9.f));
        v.ax = a.a_x;
        v.ay = a.a_y;
        v.b = a.b;
        v.c = a.c;
      }
      const Coef q2 = row_sum3<DX, DY>(v);
      if (i >= 4 && out_col && t - 2 < r1) {
        const size_t p = base + (size_t)(t - 2) * W + c;
        const float pb = (q0.b + q1.b) + q2.b;
        const float pc = (q0.c + q1.c) + q2.c;
        if (DX) dx[p] = ((q0.ax + q1.ax) + q2.ax) + 2.f * xb * pb + yb * pc;
        if (DY) dy[p] = ((q0.ay + q1.ay) + q2.ay) + 2.f * yb * pb + xb * pc;
      }
      q0 = q1;
      q1 = q2;
    }
    h0 = h1;
    h1 = h2;
    xb = xa;
    yb = ya;
    xa = xt;
    ya = yt;
    ga = gt;
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
  const int nseg = (H + BW_ROWS - 1) / BW_ROWS;
  const int nstrip = (W + BW_COLS - 1) / BW_COLS;
  const long long nb = ((long long)N * nseg * nstrip + BW_NW - 1) / BW_NW;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = dx == nullptr   ? dssim_bwd_kernel<false, true>
                : dy == nullptr ? dssim_bwd_kernel<true, false>
                                : dssim_bwd_kernel<true, true>;
  kernel<<<(unsigned)nb, BW_NT, 0, (cudaStream_t)stream>>>(
      x, y, g, dx, dy, N, H, W, nseg, nstrip);
  return (int)cudaGetLastError();
}
