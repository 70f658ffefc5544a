// The adjoint of one pair (i, j) of the dense-SE3 Gauss-Newton build,
// derived by hand, and the block helpers that the build (gn_build.cu) and
// its backward (gn_build_bwd.cu) share: the owner map of a warp's 8 x 4
// patch, the grid width, the reach of a block, staging by cp.async and the
// embedding product on the tensor cores. The backward evaluates the adjoint
// twice for each pair (p, q) it visits: once with p as i and once with p as
// j.
//
// The forward (gn_build.cu) adds, for a pair inside the radius,
//     tri[p(c,d)] += attn w_m J_mc J_md   (c <= d),   g[c] += attn w_m J_mc r_m
// over the three residual rows m, with
//     P = R_i X_j + t_i,  z = 1 / P_z,
//     r = tgt_j - (fx P_x z + cx, fy P_y z + cy, z),
//     J = d pi / d delta (3 x 6, tangent order [tau, phi]).
// Given the cotangents of i, folded onto the 21 upper-triangle sums (T) and
// the 6 of g (cg), the pair's share of the loss is attn * S with
//     S = sum_m w_m q_m,   q_m = sum_{c<=d} T_cd J_mc J_md + (cg . J_m) r_m.
// With A = T + T^t (so the diagonal doubled) and v_m = A J_m:
//     q_m = 1/2 J_m . v_m + s_m r_m,          s_m = cg . J_m,
//     d q_m / d J_m = v_m + cg r_m,           d q_m / d r_m = s_m,
// and from there
//     d attn = S                (the caller turns it into d dist),
//     d w_m = attn q_m,         d tgt_m = attn w_m s_m,
//     d J_m, d r_m -> d (P_x, P_y, z) and d (fx, fy, cx, cy)   (GEOM only),
//     d P_z = -z^2 d z.
// The caller chains d P to d R_i = d P (x) X_j, d t_i = d P, d X_j = R_i^t d P.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace gn {

constexpr int EMB = 32;            // embedding width
constexpr int NCT = 27;            // cotangents an i: 21 of T, 6 of cg
constexpr int TO = 32;             // owned pixels per block, one a lane
constexpr int JL = 8;              // warps sharing the streamed loop
constexpr int TS = 64;             // streamed pixels per staged tile
constexpr int NT = TO * JL;
constexpr int CH = 11;             // running sums reduced at a time
// A warp's patch of the grid: PATCH_ROWS rows x PATCH_COLS columns, TO
// pixels.
constexpr int PATCH_ROWS = 8;
constexpr int PATCH_COLS = 4;
constexpr int QW = TS / JL;        // streamed pixels of a tile per warp
constexpr int SO = 36;             // row stride of the owned embedding
constexpr int SD = 40;             // row stride of a warp's pair buffer

static_assert(PATCH_ROWS * PATCH_COLS == TO, "a patch is one warp");

// Index of entry (c, d) among the 21 upper-triangle sums, row-major.
__host__ __device__ constexpr int tri(int c, int d) {
    const int lo = c < d ? c : d, hi = c < d ? d : c;
    return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
}

// Whether p is one of the diagonal entries tri(c, c).
__host__ __device__ constexpr bool tri_diagonal(int p) {
    return p == 0 || p == 6 || p == 11 || p == 15 || p == 18 || p == 20;
}

// Columns of J that are not structural zeros: row u {0,2,3,4,5}, row v
// {1,2,3,4,5}, row inverse depth {2,3,4}.
__host__ __device__ constexpr bool nz(int m, int c) {
    return (((m == 0 ? 61 : m == 1 ? 62 : 28) >> c) & 1) != 0;
}

// A: the 21 folded cotangents with the diagonal doubled; cg: the 6 of g.
// Out: S, q[3], br[3] = attn w_m s_m and, with GEOM, bP[3] = d (Px, Py, Pz)
// and bK[4] = d (fx, fy, cx, cy); without GEOM bP and bK are left untouched.
template <bool GEOM>
__device__ __forceinline__ void pair_adjoint(
        const float (&A)[21], const float (&cg)[6], float Px, float Py,
        float Pz, float fx, float fy, float cx, float cy, float tu, float tv,
        float tz, float wu, float wv, float wz, float attn, float& S,
        float (&q)[3], float (&br)[3], float (&bP)[3], float (&bK)[4]) {
    const float z = 1.0f / Pz;
    const float z2 = z * z;
    float J[3][6];
    J[0][0] = fx * z;              J[0][1] = 0.0f;
    J[0][2] = -fx * Px * z2;       J[0][3] = -fx * Px * Py * z2;
    J[0][4] = fx * (1.0f + Px * Px * z2);
    J[0][5] = -fx * Py * z;
    J[1][0] = 0.0f;                J[1][1] = fy * z;
    J[1][2] = -fy * Py * z2;       J[1][3] = -fy * (1.0f + Py * Py * z2);
    J[1][4] = fy * Px * Py * z2;   J[1][5] = fy * Px * z;
    J[2][0] = 0.0f;                J[2][1] = 0.0f;
    J[2][2] = -z2;                 J[2][3] = -Py * z2;
    J[2][4] = Px * z2;             J[2][5] = 0.0f;
    const float r[3] = {tu - (fx * Px * z + cx), tv - (fy * Py * z + cy),
                        tz - z};
    const float w[3] = {wu, wv, wz};

    float bJ[3][6];
    S = 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        float v[6];
        float quad = 0.0f, s = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
            v[c] = 0.0f;
            if (!nz(m, c)) continue;
#pragma unroll
            for (int d = 0; d < 6; ++d)
                if (nz(m, d)) v[c] = fmaf(A[tri(c, d)], J[m][d], v[c]);
            quad = fmaf(J[m][c], v[c], quad);
            s = fmaf(cg[c], J[m][c], s);
        }
        q[m] = fmaf(s, r[m], 0.5f * quad);
        S = fmaf(w[m], q[m], S);
        const float a = attn * w[m];
        br[m] = a * s;
        if constexpr (GEOM) {
#pragma unroll
            for (int c = 0; c < 6; ++c)
                bJ[m][c] = nz(m, c) ? a * fmaf(cg[c], r[m], v[c]) : 0.0f;
        }
    }
    if constexpr (!GEOM) return;

    const float b00 = bJ[0][0], b02 = bJ[0][2], b03 = bJ[0][3];
    const float b04 = bJ[0][4], b05 = bJ[0][5];
    const float b11 = bJ[1][1], b12 = bJ[1][2], b13 = bJ[1][3];
    const float b14 = bJ[1][4], b15 = bJ[1][5];
    const float b22 = bJ[2][2], b23 = bJ[2][3], b24 = bJ[2][4];
    const float bru = br[0], brv = br[1], brz = br[2];
    const float PxPy = Px * Py;

    // J_0c = fx j_0c and J_1c = fy j_1c: the sums over the normalised rows
    // are d fx and d fy, and times fx, fy they feed d (Px, Py, z).
    bP[0] = fx * (-bru * z - b02 * z2 - b03 * Py * z2 + 2.0f * b04 * Px * z2)
            + fy * (b14 * Py * z2 + b15 * z) + b24 * z2;
    bP[1] = fy * (-brv * z - b12 * z2 - 2.0f * b13 * Py * z2 + b14 * Px * z2)
            + fx * (-b03 * Px * z2 - b05 * z) - b23 * z2;
    const float bz =
        fx * (-bru * Px + b00 - 2.0f * b02 * Px * z - 2.0f * b03 * PxPy * z
              + 2.0f * b04 * Px * Px * z - b05 * Py)
        + fy * (-brv * Py + b11 - 2.0f * b12 * Py * z
                - 2.0f * b13 * Py * Py * z + 2.0f * b14 * PxPy * z + b15 * Px)
        - brz - 2.0f * b22 * z - 2.0f * b23 * Py * z + 2.0f * b24 * Px * z;
    bP[2] = -bz * z2;
    bK[0] = -bru * Px * z + b00 * z - b02 * Px * z2 - b03 * PxPy * z2
            + b04 * (1.0f + Px * Px * z2) - b05 * Py * z;
    bK[1] = -brv * Py * z + b11 * z - b12 * Py * z2
            - b13 * (1.0f + Py * Py * z2) + b14 * PxPy * z2 + b15 * Px * z;
    bK[2] = -bru;
    bK[3] = -brv;
}

// The box of a warp's grid positions grown by the radius: a streamed pixel
// outside it reaches no pixel the warp owns.
struct Reach {
    float ylo, yhi, xlo, xhi;
    __device__ __forceinline__ Reach(float gy, float gx, float radius) {
        ylo = yhi = gy;
        xlo = xhi = gx;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
            yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
            xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
            xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
        }
        ylo -= radius; yhi += radius; xlo -= radius; xhi += radius;
    }
    __device__ __forceinline__ bool holds(float y, float x) const {
        return y >= ylo && y <= yhi && x >= xlo && x <= xhi;
    }
};

// The JL partial sums of each of an owner's NACC running sums, added in a
// fixed order (no atomics: the same result from run to run), CH sums at a
// time through `red`, into out[p][owner]. Ends on a barrier.
template <int NACC>
__device__ __forceinline__ void block_sums(
        const float (&acc)[NACC], float (*red)[JL][TO], float (*out)[TO],
        int tx, int ty, int tid) {
#pragma unroll
    for (int base = 0; base < NACC; base += CH) {
#pragma unroll
        for (int p = 0; p < CH; ++p)
            if (base + p < NACC) red[p][ty][tx] = acc[base + p];
        __syncthreads();
        for (int k = tid; k < CH * TO; k += NT) {
            const int p = k / TO, o = k % TO;
            if (base + p < NACC) {
                float s = 0.0f;
#pragma unroll
                for (int w = 0; w < JL; ++w) s += red[p][w][o];
                out[base + p][o] = s;
            }
        }
        __syncthreads();
    }
}


// Offset of row q in a staged tile of ROW floats a row, with 4 floats of
// padding after every JL rows: the rows w, w + JL, ... of warp w fall in
// different banks. Warp w takes rows w, w + JL, ...: the in-reach pixels of
// a tile, mostly one or two runs of a grid row, are spread over all warps,
// which meet at a barrier every tile.
template <int ROW>
__device__ __forceinline__ int tile_row(int q) {
    return q * ROW + 4 * (q / JL);
}

// Pixel of owner slot k: row bands of PATCH_ROWS rows, each cut into
// patches of PATCH_ROWS x PATCH_COLS left to right (the last one narrower
// where PATCH_COLS does not divide the width), owners in a patch
// row-major; a last, partial grid row keeps its order. A permutation of
// [0, n) for any width w >= 1.
__device__ __forceinline__ int owner_pixel(int k, int n, int w) {
    const int rows = n / w;
    if (k >= rows * w) return k;
    const int band = k / (PATCH_ROWS * w);
    const int hb = min(PATCH_ROWS, rows - PATCH_ROWS * band);
    const int o = k - band * PATCH_ROWS * w;
    const int ncg = w / PATCH_COLS;
    const int in_groups = hb * PATCH_COLS * ncg;
    int r, c;
    if (o < in_groups) {
        const int g = o / (hb * PATCH_COLS), i = o - g * hb * PATCH_COLS;
        r = i / PATCH_COLS;
        c = g * PATCH_COLS + i % PATCH_COLS;
    } else {
        const int wl = w - PATCH_COLS * ncg, i = o - in_groups;
        r = i / wl;
        c = PATCH_COLS * ncg + i % wl;
    }
    return (PATCH_ROWS * band + r) * w + c;
}

// The grid width: the first index where gy differs from gy[0], n if none.
// Block-wide; every thread returns the same value.
__device__ inline int grid_width(const float* __restrict__ gy, int n,
                                 int lane, int warp, int* scratch) {
    const float y0 = gy[0];
    for (int base = 1; base < n; base += NT) {
        const int i = base + warp * TO + lane;
        const unsigned m = __ballot_sync(0xffffffffu, i < n && gy[i] != y0);
        if (lane == 0) scratch[warp] = m ? i + __ffs(m) - 1 : n;
        __syncthreads();
        int w = n;
#pragma unroll
        for (int k = 0; k < JL; ++k) w = min(w, scratch[k]);
        __syncthreads();
        if (w < n) return w;
    }
    return n;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo, both TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

// d += a b for one m16n8k8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in float32 accuracy: the small products first, then the large.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
    mma(d, al, bh);
    mma(d, ah, bl);
    mma(d, ah, bh);
}

// D[q][o] = (2 x_o) . x_q for the warp's QW streamed pixels q (tile rows
// warp, warp + JL, ...; embedding first in a row of ROW floats) and the TO
// owners o, whose doubled embedding is kept split in xhi and xlo.
template <int ROW>
__device__ __forceinline__ void dot_products(const float* __restrict__ tile,
                                             const float* __restrict__ xhi,
                                             const float* __restrict__ xlo,
                                             float* __restrict__ D, int warp,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    float c[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < EMB / 8; ++ks) {
        // B (k = embedding, n = streamed): column g is row warp + JL g.
        const float* qe = tile + tile_row<ROW>(warp + JL * g) + 8 * ks + t;
        uint32_t bh[2], bl[2];
        split(qe[0], bh[0], bl[0]);
        split(qe[4], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            // A (m = owner, k = embedding), kept split.
            const int at = (16 * mt + g) * SO + 8 * ks + t;
            const uint32_t ah[4] = {
                __float_as_uint(xhi[at]), __float_as_uint(xhi[at + 8 * SO]),
                __float_as_uint(xhi[at + 4]),
                __float_as_uint(xhi[at + 8 * SO + 4])};
            const uint32_t al[4] = {
                __float_as_uint(xlo[at]), __float_as_uint(xlo[at + 8 * SO]),
                __float_as_uint(xlo[at + 4]),
                __float_as_uint(xlo[at + 8 * SO + 4])};
            mma3(c[mt], ah, al, bh, bl);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int o = 16 * mt + g;
        D[(2 * t) * SD + o] = c[mt][0];
        D[(2 * t + 1) * SD + o] = c[mt][1];
        D[(2 * t) * SD + o + 8] = c[mt][2];
        D[(2 * t + 1) * SD + o + 8] = c[mt][3];
    }
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(d), "l"(src), "n"(BYTES));
}

template <int N>
__device__ __forceinline__ void wait_async() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The first tile at or after j that a pixel of the block can reach, n if
// none; block-wide, at least one barrier when j < n.
__device__ __forceinline__ int next_tile(int j, int n, const Reach& reach,
                                         const float* __restrict__ gy,
                                         const float* __restrict__ gx,
                                         int tid) {
    for (; j < n; j += TS) {
        int any = 0;
        if (tid < TS && j + tid < n)
            any = reach.holds(gy[j + tid], gx[j + tid]);
        if (__syncthreads_or(any)) return j;
    }
    return n;
}

}  // namespace gn
