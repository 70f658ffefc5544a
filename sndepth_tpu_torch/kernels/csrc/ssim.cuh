// SSIM terms of one 3x3 window and their adjoint coefficients, shared by
// dssim.cu and photo_pair.cu. Counterpart of the algebra in
// sndepth_tpu/kernels/dssim.py:_dssim_bwd_kernel:
//
//   t1 = 2 sigma_xy + C2   t2 = 2 mu_x mu_y + C1
//   t3 = sigma_x + sigma_y + C2   t4 = mu_x^2 + mu_y^2 + C1
//   n = t2 t1, d = t4 t3, s = (1 - n / d) / 2, DSSIM = clip(s, 0, 1)
//
// and for a cotangent gp (already times the clip's gradient):
//   a_n = -gp / (2 d), a_d = gp n / (2 d^2)
//   A_x = mu_y c1 + mu_x c2, A_y = mu_x c1 + mu_y c2,
//     c1 = 2 a_n (t1 - t2), c2 = 2 a_d (t3 - t4)
//   B = a_d t4 (coefficient of both x^2 and y^2 pools), Cxy = 2 a_n t2
// so that dX = P(A_x) + 2 x P(B) + y P(Cxy), dY = P(A_y) + 2 y P(B) + x P(Cxy),
// P the zero-padded 3x3/9 pool, which is its own adjoint.
//
// The tie: windows where x == y must give exactly SSIM = 1 and take the
// clip's 0.5 tie factor, as in the plain PyTorch version. That holds when
// the x and the y side of every term round alike (mu_x mu_x + mu_y mu_y ==
// 2 mu_x mu_y, sigma_x + sigma_y == 2 sigma_xy, so n == d); a fused
// multiply-add on one side only breaks it. ssim_terms is therefore written
// in __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and div9, which the
// compiler never contracts: it rounds every step whatever -fmad says, and
// the same as the plain arithmetic under -fmad=false. The callers' window sums must round
// alike on the two sides too: photo_pair.cu (built with fused multiply-adds)
// and dssim.cu's backward form their x x, y y and x y products and sums
// with moments3 below or with __fmul_rn / __fadd_rn; dssim.cu's forward
// builds with -fmad=false. The adjoint below carries no tie.

#pragma once

constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

struct Ssim {
  float mu_x, mu_y, t1, t2, t3, t4, n, d, s;
};

// s / 9 rounded to nearest, as __fdiv_rn(s, 9.f) gives it, in three
// operations: q = RN(s * RN(1/9)) lies within an ulp of s / 9, the fused
// multiply-add gives its residual exactly, and one correction by RN(1/9)
// rounds to the nearest quotient (Markstein's theorem; it holds unless s /
// 9 falls below the normal range, far below any window sum of an image).
__device__ __forceinline__ float div9(float s) {
  constexpr float kNinth = 1.f / 9.f;
  const float q = __fmul_rn(s, kNinth);
  const float r = __fmaf_rn(-q, 9.f, s);
  return __fmaf_rn(r, kNinth, q);
}

// From the five window sums (zero padding included, divisor 9).
__device__ __forceinline__ Ssim ssim_terms(float s_x, float s_y, float s_xx,
                                           float s_yy, float s_xy) {
  Ssim m;
  m.mu_x = div9(s_x);
  m.mu_y = div9(s_y);
  const float sigma_x = __fsub_rn(div9(s_xx), __fmul_rn(m.mu_x, m.mu_x));
  const float sigma_y = __fsub_rn(div9(s_yy), __fmul_rn(m.mu_y, m.mu_y));
  const float sigma_xy = __fsub_rn(div9(s_xy), __fmul_rn(m.mu_x, m.mu_y));
  m.t1 = __fadd_rn(__fmul_rn(2.f, sigma_xy), kC2);
  m.t2 = __fadd_rn(__fmul_rn(__fmul_rn(2.f, m.mu_x), m.mu_y), kC1);
  m.t3 = __fadd_rn(__fadd_rn(sigma_x, sigma_y), kC2);
  m.t4 = __fadd_rn(
      __fadd_rn(__fmul_rn(m.mu_x, m.mu_x), __fmul_rn(m.mu_y, m.mu_y)), kC1);
  m.n = __fmul_rn(m.t2, m.t1);
  m.d = __fmul_rn(m.t4, m.t3);
  m.s = __fmul_rn(0.5f, __fsub_rn(1.f, __fdiv_rn(m.n, m.d)));
  return m;
}

// The five moments' horizontal 3-sums at one column of a row (x, y, x x,
// y y, x y), from the values left of it, at it and right of it. Each
// product is rounded before it is summed, as the plain version pools the
// rounded planes x x, y y and x y (a far-out edge_zero sample can be large,
// and its square's sums cancel in sigma), and the x and y sides round
// alike, so equal windows tie exactly.
struct Moments {
  float x, y, xx, yy, xy;
};

__device__ __forceinline__ Moments moments3(float x0, float x1, float x2,
                                            float y0, float y1, float y2) {
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

__device__ __forceinline__ float clip01(float s) {
  return fminf(fmaxf(s, 0.f), 1.f);
}

// d clip(s, 0, 1) / d s: 1 inside, 0 outside, 0.5 at a tie with 0 or 1.
__device__ __forceinline__ float clip01_grad(float s) {
  const float lo = 0.5f * ((s > 0.f ? 1.f : 0.f) + (s >= 0.f ? 1.f : 0.f));
  const float hi = 0.5f * ((s < 1.f ? 1.f : 0.f) + (s <= 1.f ? 1.f : 0.f));
  return lo * hi;
}

struct SsimAdjoint {
  float a_x, a_y, b, c;
};

__device__ __forceinline__ SsimAdjoint ssim_adjoint(const Ssim& m, float gp) {
  const float inv_d = 1.f / m.d;
  const float a_n = -0.5f * gp * inv_d;
  const float a_d = 0.5f * gp * m.n * inv_d * inv_d;
  const float c1 = 2.f * a_n * (m.t1 - m.t2);
  const float c2 = 2.f * a_d * (m.t3 - m.t4);
  SsimAdjoint a;
  a.a_x = m.mu_y * c1 + m.mu_x * c2;
  a.a_y = m.mu_x * c1 + m.mu_y * c2;
  a.b = a_d * m.t4;
  a.c = 2.f * a_n * m.t2;
  return a;
}
