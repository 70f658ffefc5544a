// Bilinear warp gather and its image-gradient splat, for Hopper (sm_90a).
// Replace the Pallas TPU kernels of sndepth_tpu/kernels/warp.py:
//   warp_gather  bilinear_sampler / _fwd_kernel: out[b, c, p] = sum over the
//                four taps of w_tap * img[b, c, tap], and under
//                differentiation the tangent planes Tx = d out / dx and
//                Ty = d out / dy from the same loads, so that the coordinate
//                gradient is the elementwise contraction sum_c g * Tx;
//   warp_splat   _scatter_d_imgs / _splat: d img[b, c, tap] += w_tap * g[b, c, p],
//                the adjoint of the gather in the image.
// Both take the modes edge_zero and zero_pad of sampler.cuh.
//
// Layout: img (B, C, Hs, Ws), coords (B, 2, Ht, Wt) with channels (x, y) in
// source pixels, out / Tx / Ty / g (B, C, Ht, Wt); float32, contiguous. The
// target size is free of the source size, and C is a runtime argument.
//
// One thread per target pixel, a loop over channels. The gather is bound by
// DRAM bytes (coords in, C values out, 3C with tangents; the source plane is
// read through L2 because neighbouring pixels hit neighbouring taps), so
// there is nothing to stage in shared memory: coalesced coordinate loads and
// stores, read-only cached tap loads. The splat adds with float atomics into
// a plane that the caller zeroed; taps of neighbouring pixels collide, so the
// order of the sums, and with it the last bits of the result, change from
// run to run. The TPU kernels' (8,128) tiles, row spans, band paths and tile
// metadata were devices for a machine without a gather and have no
// counterpart here.

#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int NT = 256;

template <int MODE>
__global__ void __launch_bounds__(NT) warp_gather_kernel(
    const float* __restrict__ img, const float* __restrict__ coords,
    float* __restrict__ out, float* __restrict__ tx, float* __restrict__ ty,
    int C, int Hs, int Ws, int npix) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= npix) return;
  const int b = blockIdx.y;
  const size_t hw = (size_t)Hs * Ws;
  const float* crd = coords + (size_t)b * 2 * npix;
  const Taps t = tap_setup<MODE>(__ldg(crd + p), __ldg(crd + npix + p), Hs, Ws);
  const float* im = img + (size_t)b * C * hw;
  const size_t o = (size_t)b * C * npix + p;
  for (int c = 0; c < C; ++c) {
    float v, a, d;
    tap_channel(t, im + c * hw, v, a, d);
    out[o + (size_t)c * npix] = v;
    if (tx != nullptr) {
      tx[o + (size_t)c * npix] = a;
      ty[o + (size_t)c * npix] = d;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NT) warp_splat_kernel(
    const float* __restrict__ coords, const float* __restrict__ g,
    float* __restrict__ dimg, int C, int Hs, int Ws, int npix) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= npix) return;
  const int b = blockIdx.y;
  const size_t hw = (size_t)Hs * Ws;
  const float* crd = coords + (size_t)b * 2 * npix;
  const Taps t = tap_setup<MODE>(__ldg(crd + p), __ldg(crd + npix + p), Hs, Ws);
  const float w00 = t.wx0 * t.wy0, w01 = t.wx0 * t.wy1;
  const float w10 = t.wx1 * t.wy0, w11 = t.wx1 * t.wy1;
  const float* gp = g + (size_t)b * C * npix + p;
  float* dp = dimg + (size_t)b * C * hw;
  for (int c = 0; c < C; ++c) {
    const float gv = __ldg(gp + (size_t)c * npix);
    float* plane = dp + c * hw;
    atomicAdd(plane + t.p00, w00 * gv);
    atomicAdd(plane + t.p01, w01 * gv);
    atomicAdd(plane + t.p10, w10 * gv);
    atomicAdd(plane + t.p11, w11 * gv);
  }
}

bool bad_shape(int B, int C, int Hs, int Ws, int Ht, int Wt, int mode) {
  return B < 1 || B > 65535 || C < 1 || Hs < 1 || Ws < 1 || Ht < 1 || Wt < 1 ||
         (mode != kEdgeZero && mode != kZeroPad) ||
         (long long)Hs * Ws > 0x7fffffffLL || (long long)Ht * Wt > 0x7fffffffLL;
}

}  // namespace

// Launches the gather on `stream`; returns the CUDA error code (0 = launched).
// tx and ty are both null (no tangents) or both (B, C, Ht, Wt).
extern "C" int warp_gather_launch(const float* img, const float* coords,
                                  float* out, float* tx, float* ty, int B,
                                  int C, int Hs, int Ws, int Ht, int Wt,
                                  int mode, void* stream) {
  if (bad_shape(B, C, Hs, Ws, Ht, Wt, mode) || (tx == nullptr) != (ty == nullptr))
    return (int)cudaErrorInvalidValue;
  const int npix = Ht * Wt;
  const dim3 grid((npix + NT - 1) / NT, B);
  if (mode == kEdgeZero)
    warp_gather_kernel<kEdgeZero><<<grid, NT, 0, (cudaStream_t)stream>>>(
        img, coords, out, tx, ty, C, Hs, Ws, npix);
  else
    warp_gather_kernel<kZeroPad><<<grid, NT, 0, (cudaStream_t)stream>>>(
        img, coords, out, tx, ty, C, Hs, Ws, npix);
  return (int)cudaGetLastError();
}

// Launches the splat on `stream`; dimg (B, C, Hs, Ws) must be zeroed by the
// caller. Returns the CUDA error code (0 = launched).
extern "C" int warp_splat_launch(const float* coords, const float* g,
                                 float* dimg, int B, int C, int Hs, int Ws,
                                 int Ht, int Wt, int mode, void* stream) {
  if (bad_shape(B, C, Hs, Ws, Ht, Wt, mode)) return (int)cudaErrorInvalidValue;
  const int npix = Ht * Wt;
  const dim3 grid((npix + NT - 1) / NT, B);
  if (mode == kEdgeZero)
    warp_splat_kernel<kEdgeZero><<<grid, NT, 0, (cudaStream_t)stream>>>(
        coords, g, dimg, C, Hs, Ws, npix);
  else
    warp_splat_kernel<kZeroPad><<<grid, NT, 0, (cudaStream_t)stream>>>(
        coords, g, dimg, C, Hs, Ws, npix);
  return (int)cudaGetLastError();
}
