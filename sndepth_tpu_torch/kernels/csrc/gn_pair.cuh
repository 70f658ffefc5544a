// The adjoint of one pair (i, j) of the dense-SE3 Gauss-Newton build,
// derived by hand, and the block helpers of the backward kernel
// (gn_build_bwd.cu), which evaluates it twice for each pair (p, q) it
// visits: once with p as i and once with p as j.
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

#include <cuda_runtime.h>

namespace gn {

constexpr int EMB = 32;            // embedding width
constexpr int NCT = 27;            // cotangents an i: 21 of T, 6 of cg
constexpr int TO = 32;             // owned pixels per block, one a lane
constexpr int JL = 8;              // warps sharing the streamed loop
constexpr int TS = 64;             // streamed pixels per staged tile
constexpr int NT = TO * JL;
constexpr int CH = 11;             // running sums reduced at a time

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

}  // namespace gn
