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
// the TPU kernel held whole planes in VMEM instead. Both kernels are warps
// that walk strips of columns down segments of rows, everything in
// registers, neighbours by shuffle, no shared memory and no barrier:
//   * Forward: a warp owns FW_COLS = 30 columns (a lane a column, plus one
//     halo column each side) of one plane and walks a segment of rows. It
//     loads x and y a chunk of FW_CHUNK rows at a time, the next chunk
//     while it works on this one, so that a warp keeps rows in flight (the
//     lesson of smooth_loss.cu: time follows the loads a warp keeps in
//     flight). A row's left and right values come by shuffle; a window is
//     summed in avg_pool2d's order, the top row's 3-sums (moments3) then the
//     six taps below one by one, each product rounded, so the map stays
//     bit-equal to the plain version and equal windows give exactly 0. The
//     segment length is chosen a launch so that the grid holds at least
//     FW_MIN_WARPS warps; the 2 rows above and below a segment and the 2 halo
//     columns a strip are loaded again (32/30 x (R + 2)/R loads an output,
//     1.13 at 64x3x128x416, against 1.195 for the 16 x 32 tiles before).
//     Each row's nine products are formed once in the source; where
//     registers are short the compiler forms some again inside a window.
//     Measured (H100 80GB HBM3 at 700 W, against the 16 x 32 shared-memory
//     tiles before it in the same call): 0.101 -> 0.066 ms at 64x3x128x416,
//     55% of the byte bound (a copy of as many bytes takes 0.046 ms);
//     8x3x376x1248 0.111 -> 0.070. Bit-equal to the plain version. What
//     holds it back is its instructions (~1620 SASS for a loop of eight
//     rows: the six taps of a window added one by one in plain order, the
//     five divisions by 9 and the SSIM ratio's IEEE division, each with its
//     slow-path branch), at 64 registers (12 bytes of spill). Walking row
//     pointers instead of forming each address from the row took 3% off.
//     Tried and slower: the map as an instantiation of the adjoint's walker
//     below (0.079 ms: one row in flight, a 2-column halo, and its shuffles
//     took their divergent form); chunks of 2 rows (0.141) or 8 (0.072); 3
//     or 5 blocks an SM (0.067, 0.086 with spills); shorter or longer
//     segments (0.070-0.074); the window formed on every lane with only the
//     store predicated (0.0665).
//   * Backward: one warp walks a strip of BW_COLS columns (a lane a column,
//     plus a 2-column halo each side) down BW_ROWS rows: the five moments'
//     row 3-sums from the lanes beside it by shuffle, each window's sums,
//     SSIM terms and adjoint coefficients, the coefficients' row 3-sums by
//     shuffle, and the pools from the last three rows of those. A side that
//     is not wanted is a template parameter: its coefficient plane is
//     neither formed nor pooled. The 2-pixel halo costs (32 / 28) x
//     (BW_ROWS + 2) / BW_ROWS = 1.21 windows an output; 10 shuffles a row
//     with one side, 12 with both.
// Every warp of a launch runs the same trip count and only predicates the
// rows outside its segment, so that no branch or loop around a shuffle
// depends on the warp (the compiler would otherwise give the shuffles their
// slow divergent form).
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
// fast either way. The forward forms every product and sum with __fmul_rn /
// __fadd_rn, which no build contracts, so it is bit-equal to the plain
// version under either flag. The one exact tie, equal windows, holds
// because the x and y sides of every window term round alike (ssim.cuh).

#include <cuda_runtime.h>

#include "ssim.cuh"

namespace {

constexpr int FW_COLS = 30;             // forward columns a warp
constexpr int FW_CHUNK = 4;             // forward rows loaded at once
constexpr int FW_NW = 8;                // forward warps per block
constexpr int FW_NT = 32 * FW_NW;
constexpr int FW_MIN_BLOCKS = 4;        // 4 blocks of 8 warps: 64 registers
constexpr int FW_MIN_WARPS = 8192;      // the segment rule (fwd_grid)
constexpr int FW_MIN_ROWS = 4;          // the shortest segment
constexpr int BW_ROWS = 32;             // backward rows a warp
constexpr int BW_COLS = 28;             // backward columns a warp
constexpr int BW_NW = 4;                // backward warps per block
constexpr int BW_NT = 32 * BW_NW;
constexpr int BW_MIN_BLOCKS = 8;        // blocks an SM: 64 registers

__device__ __forceinline__ float left_of(float v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}

__device__ __forceinline__ float right_of(float v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// FW_CHUNK rows of x and y at the lane's column; zeros outside the image.
struct FwdChunk {
  float x[FW_CHUNK], y[FW_CHUNK];
};

// One row's taps around the lane (left of, at and right of its column): x,
// y and the three products, each rounded, formed once a row and used by
// the three windows that hold the row.
struct Taps {
  float x[3], y[3], xx[3], yy[3], xy[3];
};

__device__ __forceinline__ Taps row_taps(float xl, float xt, float xr,
                                         float yl, float yt, float yr) {
  Taps r;
  r.x[0] = xl, r.x[1] = xt, r.x[2] = xr;
  r.y[0] = yl, r.y[1] = yt, r.y[2] = yr;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.xx[j] = __fmul_rn(r.x[j], r.x[j]);
    r.yy[j] = __fmul_rn(r.y[j], r.y[j]);
    r.xy[j] = __fmul_rn(r.x[j], r.y[j]);
  }
  return r;
}

// The row's 3-sums, in the order of moments3 (ssim.cuh).
__device__ __forceinline__ Moments row_sums(const Taps& r) {
  Moments m;
  m.x = __fadd_rn(__fadd_rn(r.x[0], r.x[1]), r.x[2]);
  m.y = __fadd_rn(__fadd_rn(r.y[0], r.y[1]), r.y[2]);
  m.xx = __fadd_rn(__fadd_rn(r.xx[0], r.xx[1]), r.xx[2]);
  m.yy = __fadd_rn(__fadd_rn(r.yy[0], r.yy[1]), r.yy[2]);
  m.xy = __fadd_rn(__fadd_rn(r.xy[0], r.xy[1]), r.xy[2]);
  return m;
}

// Adds a row's three taps to the window sums, one by one.
__device__ __forceinline__ void add_taps(Moments& s, const Taps& r) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.x = __fadd_rn(s.x, r.x[j]);
    s.y = __fadd_rn(s.y, r.y[j]);
    s.xx = __fadd_rn(s.xx, r.xx[j]);
    s.yy = __fadd_rn(s.yy, r.yy[j]);
    s.xy = __fadd_rn(s.xy, r.xy[j]);
  }
}

// One warp of the forward walk: lane l is image column c = c0 - 1 + l, and
// lanes 1 .. 30 own the strip's columns. At image row t it forms the row's
// taps (left and right values by shuffle), the window centred on row t - 1
// from the top row's 3-sums (row t - 2) and the taps of rows t - 1 and t,
// and that row's output; then row t's 3-sums. The loads and the stores walk
// row pointers down the lane's column (a lane outside the image keeps a
// pointer it never dereferences), and a row's bounds are one unsigned
// comparison.
struct FwdWalker {
  const float* xr;          // x, y at the next row to load
  const float* yr;
  float* orow;              // the output at row t - 1
  int W, rload, rt;         // the next row to load; the row t processed next
  unsigned re, rows;        // the last row loaded; rows of the segment
  int r0;
  bool col_in, own;
  Moments ha, hb;           // 3-sums of rows t - 2, t - 1
  Taps prev;                // taps of row t - 1

  __device__ __forceinline__ void load(FwdChunk& ch) {
#pragma unroll
    for (int i = 0; i < FW_CHUNK; ++i) {
      const bool in = col_in && (unsigned)rload <= re;
      ch.x[i] = in ? __ldg(xr) : 0.f;
      ch.y[i] = in ? __ldg(yr) : 0.f;
      xr += W;
      yr += W;
      ++rload;
    }
  }

  // FW_CHUNK rows in order. Every lane runs every row and every shuffle; a
  // row outside the segment only writes nothing.
  __device__ __forceinline__ void process(const FwdChunk& ch) {
#pragma unroll
    for (int i = 0; i < FW_CHUNK; ++i) {
      const float xt = ch.x[i], yt = ch.y[i];
      const Taps cur = row_taps(left_of(xt), xt, right_of(xt), left_of(yt),
                                yt, right_of(yt));
      if (own && (unsigned)(rt - 1 - r0) < rows) {
        // avg_pool2d's order: the nine taps row by row, the first row's
        // three being ha.
        Moments s = ha;
        add_taps(s, prev);
        add_taps(s, cur);
        *orow = clip01(ssim_terms(s.x, s.y, s.xx, s.yy, s.xy).s);
      }
      ha = hb;
      hb = row_sums(cur);
      prev = cur;
      orow += W;
      ++rt;
    }
  }
};

// Warp `item` walks its segment: rows r0 - 1 .. r0 + rows, in nchunk chunks
// (the same count for every warp); a warp past the last item loads nothing
// and writes nothing.
__global__ void __launch_bounds__(FW_NT, FW_MIN_BLOCKS) dssim_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int N, int H, int W, int rows, int nchunk,
    int nseg, int nstrip) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * FW_NW + (threadIdx.x >> 5);
  const bool active = item < (long long)N * nseg * nstrip;
  const int strip = (int)(item % nstrip);
  const int seg = (int)((item / nstrip) % nseg);
  const long long plane =
      active ? (item / ((long long)nstrip * nseg)) * H * W : 0;
  const int c = strip * FW_COLS - 1 + lane;
  const int r0 = seg * rows, r1 = min(r0 + rows, H);
  const int top = r0 - 1;
  const long long start = plane + (long long)top * W + c;
  FwdWalker w;
  w.xr = x + start;
  w.yr = y + start;
  w.orow = out + start - W;
  w.W = W;
  w.rload = w.rt = top;
  w.re = (unsigned)min(r1, H - 1);
  w.rows = (unsigned)(r1 - r0);
  w.r0 = r0;
  w.col_in = active && c >= 0 && c < W;
  w.own = lane >= 1 && lane <= FW_COLS && w.col_in;
  w.ha = Moments{};
  w.hb = Moments{};
  w.prev = Taps{};
  // Two chunks in turn: the next one's loads are in flight while this one
  // is processed.
  FwdChunk a, b;
  w.load(a);
  for (int j = 0; j < nchunk; j += 2) {
    if (j + 1 < nchunk) w.load(b);
    w.process(a);
    if (j + 1 >= nchunk) break;
    if (j + 2 < nchunk) w.load(a);
    w.process(b);
  }
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

// The forward grid of a call: rows a segment, chunks a segment, segments
// and strips a plane, blocks. Segments are as long as the grid allows while
// it holds FW_MIN_WARPS warps (a warp's chunks run one after another, so a
// small call is bound by that chain, a large one by the bytes), and no
// shorter than FW_MIN_ROWS rows.
struct FwdGrid {
  int rows, nchunk, nseg, nstrip;
  long long nb;
};

FwdGrid fwd_grid(int N, int H, int W) {
  FwdGrid g;
  g.nstrip = (W + FW_COLS - 1) / FW_COLS;
  const long long per_seg = (long long)N * g.nstrip;
  long long want = (FW_MIN_WARPS + per_seg - 1) / per_seg;
  const int most = (H + FW_MIN_ROWS - 1) / FW_MIN_ROWS;
  const int nseg = want > most ? most : (int)want;
  g.rows = (H + nseg - 1) / nseg;
  g.nseg = (H + g.rows - 1) / g.rows;
  g.nchunk = (g.rows + 2 + FW_CHUNK - 1) / FW_CHUNK;
  g.nb = (per_seg * g.nseg + FW_NW - 1) / FW_NW;
  return g;
}

}  // namespace

// Launch on `stream`; each returns the CUDA error code (0 = launched).
// x, y, out: N planes of H x W.
extern "C" int dssim_fwd_launch(const float* x, const float* y, float* out,
                                int N, int H, int W, void* stream) {
  if (bad_shape(N, H, W)) return (int)cudaErrorInvalidValue;
  const FwdGrid g = fwd_grid(N, H, W);
  if (g.nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dssim_fwd_kernel<<<(unsigned)g.nb, FW_NT, 0, (cudaStream_t)stream>>>(
      x, y, out, N, H, W, g.rows, g.nchunk, g.nseg, g.nstrip);
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
