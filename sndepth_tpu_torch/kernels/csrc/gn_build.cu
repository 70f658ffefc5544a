// Dense-SE3 Gauss-Newton build (K8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of sndepth_tpu/kernels/gn_build.py
// (gn_build_hg -> _gn_pallas -> _kernel, pair arithmetic _pair_contribs).
// For every pixel i it sums, over the pixels j whose grid position lies
// within `radius` of i's on both axes, the 21 upper-triangle entries of the
// 6x6 normal matrix H_i and the 6 entries of the right-hand side g_i of the
// reprojection residuals of T_i applied to the point X_j against tgt_j, each
// pair weighted by sigmoid(2 x_i.x_j - sq_i - sq_j) * wgt_j per residual
// channel. It writes H (B, n, 6, 6) with both triangles from the same sums,
// so H is symmetric bit for bit, and g (B, n, 6). Its backward is the kernel
// in gn_build_bwd.cu.
//
// What bounds it: operations. A pair in the radius costs ~250 float32
// operations (64 of them the 32-wide embedding product) against 176 bytes of
// j data that every i of the block shares; the inputs together are a few
// megabytes and stay in L2. The design therefore keeps everything a pair
// needs in registers and shared memory and spends its cycles on pairs
// that count:
//   * a block owns TI = 32 consecutive pixels i, one per lane of a warp, and
//     JL = 8 warps that split the pixels j among them; each thread holds its
//     i's rotation, translation, doubled embedding and 27 running sums in
//     registers;
//   * pixels j are staged through shared memory TJ = 64 at a time, 44 floats
//     each, 16-byte aligned; the 32 lanes of a warp read the same j, so each
//     read is one broadcast;
//   * a tile none of whose j can reach any i of the block (by the bounding
//     box of the block's grid positions) is skipped before it is staged, and
//     a pair outside the radius is skipped before its embedding product.
//     Skipping is the same function: such a pair's weight is exactly 0. The
//     one difference from the TPU kernel is a pair outside the radius whose
//     transformed depth Pz is exactly 0: there the TPU kernel forms 0 * inf =
//     NaN, this kernel adds nothing.
//   * the JL partial sums of an i are added in a fixed order through shared
//     memory: no atomics, the result is the same from run to run.
// The TPU kernel's 8x128 tiles, its 128-lane padding of the i columns and
// its dummy j rows are the TPU's layout and have no counterpart here.
//
// The running sums use fused multiply-adds (fmaf) whatever -fmad says: no
// result here depends on a tie staying a tie (the radius test compares
// integers held as floats). ptxas for sm_90a: 125 registers a thread, no
// spills, 38,912 bytes of shared memory a block.

#include <cuda_runtime.h>

namespace {

constexpr int EMB = 32;            // embedding width
constexpr int TI = 32;             // pixels i per block
constexpr int JL = 8;              // warps sharing the j loop of one block
constexpr int TJ = 64;             // pixels j per staged tile
constexpr int ROW = 44;            // floats per staged j:
constexpr int R_X = 32;            //   emb 0-31, X 32-34, sq 35, gy 36,
constexpr int R_SQ = 35;           //   gx 37, tgt 38-40, wgt 41-43
constexpr int R_GY = 36;
constexpr int R_GX = 37;
constexpr int R_TGT = 38;
constexpr int R_WGT = 41;
constexpr int NACC = 27;           // 21 upper-triangle H entries + 6 of g
constexpr int NT = TI * JL;

#define ACC(p, a, b) acc[p] = fmaf((a), (b), acc[p])

__global__ void __launch_bounds__(NT)
gn_build_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                const float* __restrict__ x, const float* __restrict__ sq,
                const float* __restrict__ gy, const float* __restrict__ gx,
                const float* __restrict__ X, const float* __restrict__ tgt,
                const float* __restrict__ wgt, const float* __restrict__ intr,
                float* __restrict__ H, float* __restrict__ g, int n,
                float radius) {
    __shared__ __align__(16) float tile[TJ * ROW];
    __shared__ float red[NACC][JL][TI];

    const int b = blockIdx.y;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TI + tx;
    const int i0 = blockIdx.x * TI;
    // A lane past the end repeats the last pixel and writes nothing.
    const int i = min(i0 + tx, n - 1);
    const size_t bi = (size_t)b * n + i;

    float R[9], T[3], x2[EMB];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = rot[bi * 9 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) T[k] = trans[bi * 3 + k];
#pragma unroll
    for (int k = 0; k < EMB; ++k) x2[k] = 2.0f * x[bi * EMB + k];
    const float sqi = sq[bi], gyi = gy[i], gxi = gx[i];
    const float fx = intr[b * 4 + 0], fy = intr[b * 4 + 1];
    const float cx = intr[b * 4 + 2], cy = intr[b * 4 + 3];

    // Bounding box of the block's grid positions, grown by the radius.
    float ylo = gyi, yhi = gyi, xlo = gxi, xhi = gxi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
        yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
        xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
        xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
    }
    ylo -= radius; yhi += radius; xlo -= radius; xhi += radius;

    float acc[NACC];
#pragma unroll
    for (int p = 0; p < NACC; ++p) acc[p] = 0.0f;

    const float* xb = x + (size_t)b * n * EMB;
    const float* Xb = X + (size_t)b * n * 3;
    const float* tgtb = tgt + (size_t)b * n * 3;
    const float* wgtb = wgt + (size_t)b * n * 3;
    const float* sqb = sq + (size_t)b * n;

    for (int j0 = 0; j0 < n; j0 += TJ) {
        int reach = 0;
        if (tid < TJ && j0 + tid < n) {
            const float yj = gy[j0 + tid], xj = gx[j0 + tid];
            reach = yj >= ylo && yj <= yhi && xj >= xlo && xj <= xhi;
        }
        // Also the barrier that keeps the previous tile until all are done.
        if (!__syncthreads_or(reach)) continue;

        const int tj = min(TJ, n - j0);
        for (int k = tid; k < tj * EMB; k += NT)
            tile[(k / EMB) * ROW + (k % EMB)] = xb[(size_t)j0 * EMB + k];
        for (int k = tid; k < tj * 3; k += NT) {
            const int at = (k / 3) * ROW + (k % 3);
            tile[at + R_X] = Xb[(size_t)j0 * 3 + k];
            tile[at + R_TGT] = tgtb[(size_t)j0 * 3 + k];
            tile[at + R_WGT] = wgtb[(size_t)j0 * 3 + k];
        }
        if (tid < tj) {
            tile[tid * ROW + R_SQ] = sqb[j0 + tid];
            tile[tid * ROW + R_GY] = gy[j0 + tid];
            tile[tid * ROW + R_GX] = gx[j0 + tid];
        }
        __syncthreads();

        for (int jj = ty; jj < tj; jj += JL) {
            const float4* row = reinterpret_cast<const float4*>(
                tile + jj * ROW);
            const float4 q9 = row[9];      // gy, gx, tgt0, tgt1
            if (!(fabsf(gyi - q9.x) <= radius && fabsf(gxi - q9.y) <= radius))
                continue;
            const float4 q8 = row[8];      // X0, X1, X2, sq
            const float4 q10 = row[10];    // tgt2, wgt0, wgt1, wgt2

            float dist = -sqi - q8.w;
#pragma unroll
            for (int c = 0; c < EMB / 4; ++c) {
                const float4 e = row[c];
                dist = fmaf(x2[4 * c + 0], e.x, dist);
                dist = fmaf(x2[4 * c + 1], e.y, dist);
                dist = fmaf(x2[4 * c + 2], e.z, dist);
                dist = fmaf(x2[4 * c + 3], e.w, dist);
            }
            const float attn = 1.0f / (1.0f + expf(-dist));

            const float Px = R[0] * q8.x + R[1] * q8.y + R[2] * q8.z + T[0];
            const float Py = R[3] * q8.x + R[4] * q8.y + R[5] * q8.z + T[1];
            const float Pz = R[6] * q8.x + R[7] * q8.y + R[8] * q8.z + T[2];
            const float dinv = 1.0f / Pz;
            const float d2 = dinv * dinv;

            const float ru = q9.z - (fx * Px * dinv + cx);
            const float rv = q9.w - (fy * Py * dinv + cy);
            const float rz = q10.x - dinv;

            // Rows of J = d pi / d delta, tangent order [tau(3), phi(3)];
            // J01, J10, J20, J21 and J25 are structural zeros.
            const float J00 = fx * dinv, J02 = -fx * Px * d2;
            const float J03 = -fx * Px * Py * d2;
            const float J04 = fx * (1.0f + Px * Px * d2);
            const float J05 = -fx * Py * dinv;
            const float J11 = fy * dinv, J12 = -fy * Py * d2;
            const float J13 = -fy * (1.0f + Py * Py * d2);
            const float J14 = fy * Px * Py * d2, J15 = fy * Px * dinv;
            const float J22 = -d2, J23 = -Py * d2, J24 = Px * d2;

            {   // residual u: columns 0, 2, 3, 4, 5
                const float aw = attn * q10.y;
                const float a0 = aw * J00, a2 = aw * J02, a3 = aw * J03;
                const float a4 = aw * J04, a5 = aw * J05;
                ACC(0, a0, J00); ACC(2, a0, J02); ACC(3, a0, J03);
                ACC(4, a0, J04); ACC(5, a0, J05);
                ACC(11, a2, J02); ACC(12, a2, J03); ACC(13, a2, J04);
                ACC(14, a2, J05);
                ACC(15, a3, J03); ACC(16, a3, J04); ACC(17, a3, J05);
                ACC(18, a4, J04); ACC(19, a4, J05); ACC(20, a5, J05);
                ACC(21, a0, ru); ACC(23, a2, ru); ACC(24, a3, ru);
                ACC(25, a4, ru); ACC(26, a5, ru);
            }
            {   // residual v: columns 1, 2, 3, 4, 5
                const float aw = attn * q10.z;
                const float a1 = aw * J11, a2 = aw * J12, a3 = aw * J13;
                const float a4 = aw * J14, a5 = aw * J15;
                ACC(6, a1, J11); ACC(7, a1, J12); ACC(8, a1, J13);
                ACC(9, a1, J14); ACC(10, a1, J15);
                ACC(11, a2, J12); ACC(12, a2, J13); ACC(13, a2, J14);
                ACC(14, a2, J15);
                ACC(15, a3, J13); ACC(16, a3, J14); ACC(17, a3, J15);
                ACC(18, a4, J14); ACC(19, a4, J15); ACC(20, a5, J15);
                ACC(22, a1, rv); ACC(23, a2, rv); ACC(24, a3, rv);
                ACC(25, a4, rv); ACC(26, a5, rv);
            }
            {   // residual inverse depth: columns 2, 3, 4
                const float aw = attn * q10.w;
                const float a2 = aw * J22, a3 = aw * J23, a4 = aw * J24;
                ACC(11, a2, J22); ACC(12, a2, J23); ACC(13, a2, J24);
                ACC(15, a3, J23); ACC(16, a3, J24); ACC(18, a4, J24);
                ACC(23, a2, rz); ACC(24, a3, rz); ACC(25, a4, rz);
            }
        }
    }

#pragma unroll
    for (int p = 0; p < NACC; ++p) red[p][ty][tx] = acc[p];
    __syncthreads();

    // The JL partial sums of each entry, added in a fixed order; entry
    // (c, d) and entry (d, c) of H read the same sums.
    const int ni = min(TI, n - i0);
    float* Hb = H + ((size_t)b * n + i0) * 36;
    float* gb = g + ((size_t)b * n + i0) * 6;
    for (int k = tid; k < ni * 36; k += NT) {
        const int il = k / 36, c = (k % 36) / 6, d = k % 6;
        const int lo = min(c, d), hi = max(c, d);
        const int p = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < JL; ++q) s += red[p][q][il];
        Hb[k] = s;
    }
    for (int k = tid; k < ni * 6; k += NT) {
        const int il = k / 6, p = 21 + k % 6;
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < JL; ++q) s += red[p][q][il];
        gb[k] = s;
    }
}

}  // namespace

extern "C" int gn_build_launch(
        const void* rot, const void* trans, const void* x, const void* sq,
        const void* gy, const void* gx, const void* X, const void* tgt,
        const void* wgt, const void* intr, void* H, void* g, int b, int n,
        float radius, void* stream) {
    const dim3 block(TI, JL);
    const dim3 grid((n + TI - 1) / TI, b);
    gn_build_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(x), static_cast<const float*>(sq),
        static_cast<const float*>(gy), static_cast<const float*>(gx),
        static_cast<const float*>(X), static_cast<const float*>(tgt),
        static_cast<const float*>(wgt), static_cast<const float*>(intr),
        static_cast<float*>(H), static_cast<float*>(g), n, radius);
    return static_cast<int>(cudaGetLastError());
}
