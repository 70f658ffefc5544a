// Backward of the dense-SE3 Gauss-Newton build, per-j half (K8b-j), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of sndepth_tpu/kernels/gn_build.py
// (gn_build_hg_bwd -> _gn_bwd_j_pallas -> _bwd_j_kernel). For every pixel j
// it sums, over the pixels i within `radius` of j on both grid axes, the
// pair adjoint of gn_pair.cuh into the gradients of what belongs to j:
//     d X_j (3), d x_j (32), d sq_j (1), d tgt_j (3), d wgt_j (3).
// `ct` is (B, n, 27) as in gn_build_bwd_i.cu. A null output pointer skips
// that gradient; without d X the geometry chain of the adjoint is compiled
// out (the training path: the depth is data).
//
// It is gn_build_bwd_i.cu with the roles exchanged: a block owns 32 pixels
// j, one a lane, each thread holding its j's point, target, confidence and
// 42 running sums in registers and its doubled embedding in shared memory;
// 8 warps split the pixels i, staged 64 at a time, 76 floats each (the
// embedding, the pose, the grid position and the 27 cotangents, the
// diagonal of the folded H cotangent doubled as it is staged). A tile no j
// of the block can reach is skipped before it is staged and a pair outside
// the radius before any arithmetic. What bounds it: operations, as for the
// i half, plus 27 shared-memory reads a pair for the cotangents. The 8
// partial sums of a j are added in a fixed order, without atomics. ptxas for
// sm_90a: 186 registers a thread with the geometry chain, 168 without, no
// spills, 40,192 and 39,808 bytes of shared memory a block.

#include "gn_pair.cuh"

namespace {

using namespace gn;

constexpr int ROW = 76;            // floats per staged i:
constexpr int R_ROT = 32;          //   emb 0-31, rot 32-40, trans 41-43,
constexpr int R_TR = 41;           //   sq 44, gy 45, gx 46, (47 unused),
constexpr int R_SQ = 44;           //   ct 48-74, (75 unused)
constexpr int R_GY = 45;
constexpr int R_GX = 46;
constexpr int R_CT = 48;
// Running sums of a j: dx 0-31, dsq 32, dtgt 33-35, dwgt 36-38, dX 39-41
// (the last group only with GEOM).
constexpr int A_SQ = 32;
constexpr int A_TGT = 33;
constexpr int A_WGT = 36;
constexpr int A_X = 39;

template <bool GEOM>
__global__ void __launch_bounds__(NT)
gn_bwd_j_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                const float* __restrict__ x, const float* __restrict__ sq,
                const float* __restrict__ gy, const float* __restrict__ gx,
                const float* __restrict__ X, const float* __restrict__ tgt,
                const float* __restrict__ wgt, const float* __restrict__ intr,
                const float* __restrict__ ct, float* __restrict__ dX,
                float* __restrict__ dx, float* __restrict__ dsq,
                float* __restrict__ dtgt, float* __restrict__ dwgt, int n,
                float radius) {
    constexpr int NACC = GEOM ? 42 : 39;
    __shared__ __align__(16) float tile[TS * ROW];
    __shared__ float x2[EMB][TO];
    __shared__ float red[CH][JL][TO];
    __shared__ float out[NACC][TO];

    const int b = blockIdx.y;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TO + tx;
    const int j0 = blockIdx.x * TO;
    // A lane past the end repeats the last pixel and writes nothing.
    const int j = min(j0 + tx, n - 1);
    const size_t bj = (size_t)b * n + j;

    float Xj[3], tj[3], wj[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        Xj[k] = X[bj * 3 + k];
        tj[k] = tgt[bj * 3 + k];
        wj[k] = wgt[bj * 3 + k];
    }
    for (int k = ty; k < EMB; k += JL) x2[k][tx] = 2.0f * x[bj * EMB + k];
    const float sqj = sq[bj], gyj = gy[j], gxj = gx[j];
    const float fx = intr[b * 4 + 0], fy = intr[b * 4 + 1];
    const float cx = intr[b * 4 + 2], cy = intr[b * 4 + 3];
    const Reach reach(gyj, gxj, radius);

    float acc[NACC];
#pragma unroll
    for (int p = 0; p < NACC; ++p) acc[p] = 0.0f;

    const float* xb = x + (size_t)b * n * EMB;
    const float* rotb = rot + (size_t)b * n * 9;
    const float* trb = trans + (size_t)b * n * 3;
    const float* ctb = ct + (size_t)b * n * NCT;
    const float* sqb = sq + (size_t)b * n;

    for (int i0 = 0; i0 < n; i0 += TS) {
        int any = 0;
        if (tid < TS && i0 + tid < n)
            any = reach.holds(gy[i0 + tid], gx[i0 + tid]);
        // Also the barrier that keeps the previous tile (and, the first
        // time, publishes x2) until all are done.
        if (!__syncthreads_or(any)) continue;

        const int ti = min(TS, n - i0);
        for (int k = tid; k < ti * EMB; k += NT)
            tile[(k / EMB) * ROW + (k % EMB)] = xb[(size_t)i0 * EMB + k];
        for (int k = tid; k < ti * 9; k += NT)
            tile[(k / 9) * ROW + R_ROT + (k % 9)] = rotb[(size_t)i0 * 9 + k];
        for (int k = tid; k < ti * 3; k += NT)
            tile[(k / 3) * ROW + R_TR + (k % 3)] = trb[(size_t)i0 * 3 + k];
        for (int k = tid; k < ti * NCT; k += NT) {
            const int p = k % NCT;
            tile[(k / NCT) * ROW + R_CT + p] =
                (tri_diagonal(p) ? 2.0f : 1.0f)
                * ctb[(size_t)i0 * NCT + k];
        }
        if (tid < ti) {
            tile[tid * ROW + R_SQ] = sqb[i0 + tid];
            tile[tid * ROW + R_GY] = gy[i0 + tid];
            tile[tid * ROW + R_GX] = gx[i0 + tid];
        }
        __syncthreads();

        for (int ii = ty; ii < ti; ii += JL) {
            const float* rowf = tile + ii * ROW;
            const float4* row = reinterpret_cast<const float4*>(rowf);
            const float4 q11 = row[11];    // sq, gy, gx, -
            if (!(fabsf(q11.y - gyj) <= radius && fabsf(q11.z - gxj) <= radius))
                continue;

            float dist = -q11.x - sqj;
#pragma unroll
            for (int c = 0; c < EMB / 4; ++c) {
                const float4 e = row[c];
                dist = fmaf(x2[4 * c + 0][tx], e.x, dist);
                dist = fmaf(x2[4 * c + 1][tx], e.y, dist);
                dist = fmaf(x2[4 * c + 2][tx], e.z, dist);
                dist = fmaf(x2[4 * c + 3][tx], e.w, dist);
            }
            const float attn = 1.0f / (1.0f + expf(-dist));

            float R[9], T[3], A[21], cg[6];
#pragma unroll
            for (int k = 0; k < 9; ++k) R[k] = rowf[R_ROT + k];
#pragma unroll
            for (int k = 0; k < 3; ++k) T[k] = rowf[R_TR + k];
#pragma unroll
            for (int p = 0; p < 21; ++p) A[p] = rowf[R_CT + p];
#pragma unroll
            for (int k = 0; k < 6; ++k) cg[k] = rowf[R_CT + 21 + k];

            const float Px = R[0] * Xj[0] + R[1] * Xj[1] + R[2] * Xj[2] + T[0];
            const float Py = R[3] * Xj[0] + R[4] * Xj[1] + R[5] * Xj[2] + T[1];
            const float Pz = R[6] * Xj[0] + R[7] * Xj[1] + R[8] * Xj[2] + T[2];

            float S, q[3], br[3], bP[3], bK[4];
            pair_adjoint<GEOM>(A, cg, Px, Py, Pz, fx, fy, cx, cy, tj[0], tj[1],
                               tj[2], wj[0], wj[1], wj[2], attn, S, q, br, bP,
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
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                acc[A_TGT + m] += br[m];
                acc[A_WGT + m] = fmaf(attn, q[m], acc[A_WGT + m]);
            }
            if constexpr (GEOM) {
                // d X_j = R_i^t d P
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    acc[A_X + k] += R[k] * bP[0] + R[3 + k] * bP[1]
                                    + R[6 + k] * bP[2];
            }
        }
    }

    block_sums<NACC>(acc, red, out, tx, ty, tid);

    const int nj = min(TO, n - j0);
    const size_t base = (size_t)b * n + j0;
    if (dx != nullptr)
        for (int k = tid; k < nj * EMB; k += NT)
            dx[base * EMB + k] = 2.0f * out[k % EMB][k / EMB];
    if (dsq != nullptr)
        for (int k = tid; k < nj; k += NT) dsq[base + k] = out[A_SQ][k];
    if (dtgt != nullptr)
        for (int k = tid; k < nj * 3; k += NT)
            dtgt[base * 3 + k] = out[A_TGT + k % 3][k / 3];
    if (dwgt != nullptr)
        for (int k = tid; k < nj * 3; k += NT)
            dwgt[base * 3 + k] = out[A_WGT + k % 3][k / 3];
    if constexpr (GEOM) {
        if (dX != nullptr)
            for (int k = tid; k < nj * 3; k += NT)
                dX[base * 3 + k] = out[A_X + k % 3][k / 3];
    }
}

}  // namespace

extern "C" int gn_build_bwd_j_launch(
        const void* rot, const void* trans, const void* x, const void* sq,
        const void* gy, const void* gx, const void* X, const void* tgt,
        const void* wgt, const void* intr, const void* ct, void* dX, void* dx,
        void* dsq, void* dtgt, void* dwgt, int b, int n, float radius,
        void* stream) {
    const dim3 block(TO, JL);
    const dim3 grid((n + TO - 1) / TO, b);
    auto kernel = dX != nullptr ? gn_bwd_j_kernel<true>
                                : gn_bwd_j_kernel<false>;
    kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(x), static_cast<const float*>(sq),
        static_cast<const float*>(gy), static_cast<const float*>(gx),
        static_cast<const float*>(X), static_cast<const float*>(tgt),
        static_cast<const float*>(wgt), static_cast<const float*>(intr),
        static_cast<const float*>(ct), static_cast<float*>(dX),
        static_cast<float*>(dx), static_cast<float*>(dsq),
        static_cast<float*>(dtgt), static_cast<float*>(dwgt), n, radius);
    return static_cast<int>(cudaGetLastError());
}
