// Backward of the dense-SE3 Gauss-Newton build, per-i half (K8b-i), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of sndepth_tpu/kernels/gn_build.py
// (gn_build_hg_bwd -> _gn_bwd_i_pallas -> _bwd_i_kernel). For every pixel i
// it sums, over the pixels j within `radius` of i on both grid axes, the
// pair adjoint of gn_pair.cuh into the gradients of what belongs to i:
//     d rot_i (9), d trans_i (3), d x_i (32), d sq_i (1)
// and the pair's share of d (fx, fy, cx, cy), written per i as (B, n, 4):
// the caller adds those over i. `ct` is (B, n, 27): the cotangent of H
// folded onto the 21 upper-triangle sums (off-diagonal ct_H[c,d] +
// ct_H[d,c], diagonal once), then the 6 of g. A null output pointer skips
// that gradient; without d rot, d trans and d intr the geometry chain of the
// adjoint is compiled out (the training path: the pose is detached).
//
// The TPU kernel takes jax.grad of the pair helper inside its body; here the
// adjoint is written out by hand (gn_pair.cuh). What bounds it: operations,
// ~560 float32 operations a pair in the radius (~385 without the geometry
// chain) against inputs of a few megabytes that stay in L2. The design is the
// forward's (gn_build.cu): a block owns 32 pixels i, one a lane; 8 warps split
// the pixels j, staged 64 at a time through shared memory and read as
// broadcasts; a tile no i of the block can reach is skipped before it is
// staged, a pair outside the radius before any arithmetic, so a masked pair
// adds exactly nothing, also where its depth P_z is 0. Each thread holds its
// i's pose, its 27 cotangents and up to 49 running sums in registers; the
// doubled embedding of the 32 pixels i lives in shared memory, one bank a
// lane, to leave the registers to the sums. The 8 partial sums of an i are
// added in a fixed order: no atomics, the same bits from run to run.
// ptxas for sm_90a: 203 registers a thread with the geometry chain, 167
// without, no spills, 32,896 and 30,848 bytes of shared memory a block: one
// block of 256 threads an SM, where the forward has two.

#include "gn_pair.cuh"

namespace {

using namespace gn;

constexpr int ROW = 44;            // floats per staged j:
constexpr int R_X = 32;            //   emb 0-31, X 32-34, sq 35, gy 36,
constexpr int R_SQ = 35;           //   gx 37, tgt 38-40, wgt 41-43
constexpr int R_GY = 36;
constexpr int R_GX = 37;
constexpr int R_TGT = 38;
constexpr int R_WGT = 41;
// Running sums of an i: dx 0-31, dsq 32, drot 33-41, dtrans 42-44, dintr
// 45-48 (the last three groups only with GEOM).
constexpr int A_SQ = 32;
constexpr int A_ROT = 33;
constexpr int A_TR = 42;
constexpr int A_K = 45;

template <bool GEOM>
__global__ void __launch_bounds__(NT)
gn_bwd_i_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                const float* __restrict__ x, const float* __restrict__ sq,
                const float* __restrict__ gy, const float* __restrict__ gx,
                const float* __restrict__ X, const float* __restrict__ tgt,
                const float* __restrict__ wgt, const float* __restrict__ intr,
                const float* __restrict__ ct, float* __restrict__ drot,
                float* __restrict__ dtrans, float* __restrict__ dx,
                float* __restrict__ dsq, float* __restrict__ dintr, int n,
                float radius) {
    constexpr int NACC = GEOM ? 49 : 33;
    __shared__ __align__(16) float tile[TS * ROW];
    __shared__ float x2[EMB][TO];
    __shared__ float red[CH][JL][TO];
    __shared__ float out[NACC][TO];

    const int b = blockIdx.y;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TO + tx;
    const int i0 = blockIdx.x * TO;
    // A lane past the end repeats the last pixel and writes nothing.
    const int i = min(i0 + tx, n - 1);
    const size_t bi = (size_t)b * n + i;

    float R[9], T[3], A[21], cg[6];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = rot[bi * 9 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) T[k] = trans[bi * 3 + k];
#pragma unroll
    for (int p = 0; p < 21; ++p)
        A[p] = (tri_diagonal(p) ? 2.0f : 1.0f) * ct[bi * NCT + p];
#pragma unroll
    for (int k = 0; k < 6; ++k) cg[k] = ct[bi * NCT + 21 + k];
    for (int k = ty; k < EMB; k += JL) x2[k][tx] = 2.0f * x[bi * EMB + k];
    const float sqi = sq[bi], gyi = gy[i], gxi = gx[i];
    const float fx = intr[b * 4 + 0], fy = intr[b * 4 + 1];
    const float cx = intr[b * 4 + 2], cy = intr[b * 4 + 3];
    const Reach reach(gyi, gxi, radius);

    float acc[NACC];
#pragma unroll
    for (int p = 0; p < NACC; ++p) acc[p] = 0.0f;

    const float* xb = x + (size_t)b * n * EMB;
    const float* Xb = X + (size_t)b * n * 3;
    const float* tgtb = tgt + (size_t)b * n * 3;
    const float* wgtb = wgt + (size_t)b * n * 3;
    const float* sqb = sq + (size_t)b * n;

    for (int j0 = 0; j0 < n; j0 += TS) {
        int any = 0;
        if (tid < TS && j0 + tid < n)
            any = reach.holds(gy[j0 + tid], gx[j0 + tid]);
        // Also the barrier that keeps the previous tile (and, the first
        // time, publishes x2) until all are done.
        if (!__syncthreads_or(any)) continue;

        const int tj = min(TS, n - j0);
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
                dist = fmaf(x2[4 * c + 0][tx], e.x, dist);
                dist = fmaf(x2[4 * c + 1][tx], e.y, dist);
                dist = fmaf(x2[4 * c + 2][tx], e.z, dist);
                dist = fmaf(x2[4 * c + 3][tx], e.w, dist);
            }
            const float attn = 1.0f / (1.0f + expf(-dist));

            const float Px = R[0] * q8.x + R[1] * q8.y + R[2] * q8.z + T[0];
            const float Py = R[3] * q8.x + R[4] * q8.y + R[5] * q8.z + T[1];
            const float Pz = R[6] * q8.x + R[7] * q8.y + R[8] * q8.z + T[2];

            float S, q[3], br[3], bP[3], bK[4];
            pair_adjoint<GEOM>(A, cg, Px, Py, Pz, fx, fy, cx, cy, q9.z, q9.w,
                               q10.x, q10.y, q10.z, q10.w, attn, S, q, br, bP,
                               bK);

            // d dist; dist = 2 x_i . x_j - sq_i - sq_j (the 2 goes on at the
            // end).
            const float dd = attn * (1.0f - attn) * S;
#pragma unroll
            for (int c = 0; c < EMB / 4; ++c) {
                const float4 e = row[c];
                acc[4 * c + 0] = fmaf(dd, e.x, acc[4 * c + 0]);
                acc[4 * c + 1] = fmaf(dd, e.y, acc[4 * c + 1]);
                acc[4 * c + 2] = fmaf(dd, e.z, acc[4 * c + 2]);
                acc[4 * c + 3] = fmaf(dd, e.w, acc[4 * c + 3]);
            }
            acc[A_SQ] -= dd;
            if constexpr (GEOM) {
                const float Xj[3] = {q8.x, q8.y, q8.z};
#pragma unroll
                for (int m = 0; m < 3; ++m) {
#pragma unroll
                    for (int k = 0; k < 3; ++k)
                        acc[A_ROT + 3 * m + k] =
                            fmaf(bP[m], Xj[k], acc[A_ROT + 3 * m + k]);
                    acc[A_TR + m] += bP[m];
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[A_K + k] += bK[k];
            }
        }
    }

    block_sums<NACC>(acc, red, out, tx, ty, tid);

    const int ni = min(TO, n - i0);
    const size_t base = (size_t)b * n + i0;
    if (dx != nullptr)
        for (int k = tid; k < ni * EMB; k += NT)
            dx[base * EMB + k] = 2.0f * out[k % EMB][k / EMB];
    if (dsq != nullptr)
        for (int k = tid; k < ni; k += NT) dsq[base + k] = out[A_SQ][k];
    if constexpr (GEOM) {
        if (drot != nullptr)
            for (int k = tid; k < ni * 9; k += NT)
                drot[base * 9 + k] = out[A_ROT + k % 9][k / 9];
        if (dtrans != nullptr)
            for (int k = tid; k < ni * 3; k += NT)
                dtrans[base * 3 + k] = out[A_TR + k % 3][k / 3];
        if (dintr != nullptr)
            for (int k = tid; k < ni * 4; k += NT)
                dintr[base * 4 + k] = out[A_K + k % 4][k / 4];
    }
}

}  // namespace

extern "C" int gn_build_bwd_i_launch(
        const void* rot, const void* trans, const void* x, const void* sq,
        const void* gy, const void* gx, const void* X, const void* tgt,
        const void* wgt, const void* intr, const void* ct, void* drot,
        void* dtrans, void* dx, void* dsq, void* dintr, int b, int n,
        float radius, void* stream) {
    const dim3 block(TO, JL);
    const dim3 grid((n + TO - 1) / TO, b);
    const bool geom = drot != nullptr || dtrans != nullptr || dintr != nullptr;
    auto kernel = geom ? gn_bwd_i_kernel<true> : gn_bwd_i_kernel<false>;
    kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(x), static_cast<const float*>(sq),
        static_cast<const float*>(gy), static_cast<const float*>(gx),
        static_cast<const float*>(X), static_cast<const float*>(tgt),
        static_cast<const float*>(wgt), static_cast<const float*>(intr),
        static_cast<const float*>(ct), static_cast<float*>(drot),
        static_cast<float*>(dtrans), static_cast<float*>(dx),
        static_cast<float*>(dsq), static_cast<float*>(dintr), n, radius);
    return static_cast<int>(cudaGetLastError());
}
