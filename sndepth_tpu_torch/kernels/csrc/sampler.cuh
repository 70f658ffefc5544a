// Bilinear tap setup shared by warp.cu (gather and splat) and photo_pair.cu.
// Counterpart of sndepth_tpu/kernels/warp.py:_tap_setup, in two modes:
//
//   edge_zero  the GeoNet sampler: corners floor(x), floor(x)+1 clamped to the
//              image BEFORE the weights are formed (wx0 = x1c - x, wx1 = x -
//              x0c), so a corner outside the image, and the exact last row or
//              column, weigh 0. floor and clamp carry no gradient, so every
//              weight's coordinate derivative has magnitude 1.
//   zero_pad   standard zero-padded sampling: fractional weights times the
//              validity of each corner; an invalid corner also contributes no
//              derivative.
//
// Indices are always in range: fminf/fmaxf clamp in float (a NaN coordinate
// lands on index 0 while its weights stay NaN).
//
// tap_channel rounds every product and sum on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, which the compiler never contracts into a fused
// multiply-add), in the plain PyTorch version's order, whatever -fmad says:
// far outside the image an edge_zero weight grows with the distance, a
// sample is a difference of large products, and only the same roundings give
// the plain version's value (warp.cu builds with -fmad=false, photo_pair.cu
// with fused multiply-adds).

#pragma once

constexpr int kEdgeZero = 0;
constexpr int kZeroPad = 1;

struct Taps {
  int p00, p01, p10, p11;   // y * W + x of (x0,y0), (x0,y1), (x1,y0), (x1,y1)
  float wx0, wx1, wy0, wy1; // weights, the mode's masking included
  float dx0, dx1, dy0, dy1; // |d weight / d coordinate|
};

template <int MODE>
__device__ __forceinline__ Taps tap_setup(float x, float y, int H, int W) {
  Taps t;
  const float xf = floorf(x), yf = floorf(y);
  const float x0 = fminf(fmaxf(xf, 0.f), W - 1.f);
  const float x1 = fminf(fmaxf(xf + 1.f, 0.f), W - 1.f);
  const float y0 = fminf(fmaxf(yf, 0.f), H - 1.f);
  const float y1 = fminf(fmaxf(yf + 1.f, 0.f), H - 1.f);
  if (MODE == kEdgeZero) {
    t.wx0 = x1 - x;
    t.wx1 = x - x0;
    t.wy0 = y1 - y;
    t.wy1 = y - y0;
    t.dx0 = t.dx1 = t.dy0 = t.dy1 = 1.f;
  } else {
    const float fx = x - xf, fy = y - yf;
    t.dx0 = (xf >= 0.f && xf <= W - 1.f) ? 1.f : 0.f;
    t.dx1 = (xf + 1.f >= 0.f && xf + 1.f <= W - 1.f) ? 1.f : 0.f;
    t.dy0 = (yf >= 0.f && yf <= H - 1.f) ? 1.f : 0.f;
    t.dy1 = (yf + 1.f >= 0.f && yf + 1.f <= H - 1.f) ? 1.f : 0.f;
    t.wx0 = (1.f - fx) * t.dx0;
    t.wx1 = fx * t.dx1;
    t.wy0 = (1.f - fy) * t.dy0;
    t.wy1 = fy * t.dy1;
  }
  t.p00 = (int)y0 * W + (int)x0;
  t.p01 = (int)y1 * W + (int)x0;
  t.p10 = (int)y0 * W + (int)x1;
  t.p11 = (int)y1 * W + (int)x1;
  return t;
}

// One channel plane `p` sampled at the taps: the value and its tangents
// d out / dx and d out / dy.
__device__ __forceinline__ void tap_channel(const Taps& t,
                                            const float* __restrict__ p,
                                            float& out, float& tx, float& ty) {
  const float i00 = __ldg(p + t.p00), i01 = __ldg(p + t.p01);
  const float i10 = __ldg(p + t.p10), i11 = __ldg(p + t.p11);
  const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
  const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
  out = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, i00), __fmul_rn(w01, i01)),
                            __fmul_rn(w10, i10)),
                  __fmul_rn(w11, i11));
  tx = __fadd_rn(
      __fmul_rn(t.wy0, __fsub_rn(__fmul_rn(t.dx1, i10), __fmul_rn(t.dx0, i00))),
      __fmul_rn(t.wy1, __fsub_rn(__fmul_rn(t.dx1, i11), __fmul_rn(t.dx0, i01))));
  ty = __fadd_rn(
      __fmul_rn(t.wx0, __fsub_rn(__fmul_rn(t.dy1, i01), __fmul_rn(t.dy0, i00))),
      __fmul_rn(t.wx1, __fsub_rn(__fmul_rn(t.dy1, i11), __fmul_rn(t.dy0, i10))));
}
