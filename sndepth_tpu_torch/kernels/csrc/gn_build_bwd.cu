// Backward of the dense-SE3 Gauss-Newton build (K8b) for Hopper (sm_90a):
// one pass over the pairs, both roles of a pixel at once.
//
// Replaces the two Pallas TPU kernels of sndepth_tpu/kernels/gn_build.py
// that gn_build_hg_bwd calls: _gn_bwd_i_pallas -> _bwd_i_kernel (the sums
// over j of what belongs to pixel i) and _gn_bwd_j_pallas -> _bwd_j_kernel
// (the sums over i of what belongs to pixel j). Given the cotangents of H
// (B, n, 6, 6) and g (B, n, 6) it writes, for every pixel p,
//     d rot_p (9), d trans_p (3), d intrinsics share_p (4)   as i,
//     d X_p (3), d tgt_p (3), d wgt_p (3)                    as j,
//     d x_p (32), d sq_p (1)                                 as both,
// summing the hand-derived adjoint of a pair (gn_pair.cuh) over the pixels
// q within `radius` of p on both grid axes. A null output pointer skips that
// gradient; the geometry chain of a role is compiled in only where one of
// its gradients is wanted (the training path wants x, sq, tgt and wgt: the
// pose is detached, depth and intrinsics are data).
//
// What bounds it: operations. For the training path's gradients the
// function needs ~350 float32 operations an ordered pair in the radius (one
// adjoint of ~240; the embedding product and the sigmoid once per unordered
// pair; the d x sum), ~100 of them in two matrix products that the tensor
// cores can take, against inputs of a few megabytes that stay in L2: 0.052
// ms at 2 x 3328 on an H100 (chip_smoke.py GN_BWD_PAIR_FLOPS), which the
// kernel takes 0.525 ms for (10%; the two kernels it replaced took 1.231).
// One owner a sum costs work besides: a visit of (p, q) runs the adjoint,
// the embedding product and the sigmoid of both (p, q) and (q, p), so each
// runs twice a pair (~630 operations a visit, 0.097 ms at the same rates).
// What the design does about it:
//   * One pass, both roles. The attention is symmetric (dist_pq = dist_qp,
//     and so is the radius test), so a block that owns pixels p evaluates
//     pair (p, q) with p as i and pair (q, p) with p as j from one staging
//     of q and one sigmoid, and adds (dd_pq + dd_qp) x_q into d x_p once.
//     Every sum has one owner: no atomics, no cross-block reduction, and a
//     fixed order, so the same bits come out from run to run. The kernel
//     reads the cotangent of H as it is, so a backward is one launch.
//   * A warp owns a patch of 8 grid rows x 4 columns (owner_pixel), not 32
//     pixels of one row: of the lanes that run a pair, ~96% (32x104) and
//     ~91% (47x156) are in the radius at radius 32, against 66% for a row
//     (gn_build.py lane_share mirrors the map). The grid width is the first
//     index where gy changes, read by each block: no host sync, no
//     argument. Correctness does not depend on the map: the radius test
//     reads both pixels' gy and gx and tiles are skipped by the block's box,
//     so any bijection gives the same sums; only the speed does.
//   * The embedding product and the d x sum are matrix products over a
//     (32 owned x 8 streamed) tile of each warp: they run on the tensor
//     cores as mma.sync m16n8k8 TF32 in the split three-product form
//     (a = a_hi + a_lo; lo.hi + hi.lo + hi.hi), which keeps float32 accuracy
//     (single-pass TF32 would move dist by ~1e-3). The owned doubled
//     embedding is kept split in shared memory; the dot products land in a
//     per-warp (streamed x owned) buffer, which the pair loop reads and
//     overwrites with dd_pq + dd_qp, the A operand of the d x product. The
//     d x sums stay in shared memory between tiles, so the pair loop keeps
//     only the owner's pose, cotangents, point, target and confidence and
//     7 running sums in registers. Chosen by a measurement (H100 80GB HBM3
//     at 700 W): the same kernel with both products on the float32 pipe
//     (the owner's embedding in registers, four independent partial sums a
//     dot) took 0.622 ms against 0.525 at 2 x 3328 and 1.005 against 0.823
//     at 1 x 7332 (train step's gradients). The split form's d x is ~6e-5 of
//     the mean entry off a float64 evaluation, the float32 plain version's
//     ~8e-6 (chip_smoke.py's gn_build_bwd phase).
//   * The next tile of 64 streamed pixels is copied into a second buffer
//     with cp.async while this one is computed: the copies leave the
//     critical path (staging in turn with the compute took 0.714 ms at
//     2 x 3328, 0.537 with the copies ahead). The cotangent of H is staged
//     as it is and folded in the pair loop (A = ct_H + ct_H^t on the upper
//     triangle, 21 adds). Warp w takes the tile's rows w, w + 8, ...: the
//     in-reach pixels of a tile, mostly one or two runs of a grid row, are
//     spread over the warps that meet at each tile's barrier (8 consecutive
//     rows a warp took 0.537 and 0.892 ms).
//   * __launch_bounds__(256, 2): two blocks (16 warps) an SM, 109 KB of
//     shared memory each (at 128 registers a thread two blocks fill the
//     register file); the grid is one block per 32 owned pixels and
//     batch (208 blocks at 2 x 3328, 230 at 1 x 7332), so every block is
//     resident at once.
//   * A tile no owned pixel can reach is skipped before it is copied, a
//     warp's 8 streamed pixels when none reaches, and a pair outside the
//     radius before any arithmetic: a masked pair adds exactly nothing, also
//     where its depth P_z is 0.
// Built without -fmad=false (kernels/build.py): no result here depends on
// a tie staying a tie.
// ptxas for sm_90a: 128 registers a thread in each instantiation; spill
// stores of 44 bytes (train step's gradients, no geometry chain), 48 (the
// j role's chain), 120 (the i role's) and 168 (both); 160 bytes of static
// and 111,872 of dynamic shared memory a block. Times: H100 80GB HBM3 at
// 700 W, CUDA events (PERF.md names the runs).

#include "gn_pair.cuh"

namespace {

using namespace gn;

constexpr int ROW = 100;           // floats per staged pixel q:
constexpr int R_X = 32;            //   emb 0-31, X 32-34, sq 35, gy 36,
constexpr int R_ROT = 44;          //   gx 37, tgt 38-40, wgt 41-43,
constexpr int R_TR = 53;           //   rot 44-52, trans 53-55,
constexpr int R_CTH = 56;          //   ct_H 56-91, ct_g 92-97,
constexpr int R_CTG = 92;          //   (98-99 unused)
constexpr int SA = 40;             // row stride of a warp's d x sums
// A staged tile: TS rows, 4 floats of padding after every JL rows, so that
// the rows w, w + JL, ... of one warp fall in different banks.
constexpr int TILE = TS * ROW + 4 * (TS / JL);
// Shared memory (floats): two staged tiles (one computed on while the next
// arrives), the owned doubled embedding (hi and lo), each warp's (QW x TO)
// pair buffer and (TO x EMB) d x sums.
constexpr int OFF_XHI = 2 * TILE;
constexpr int OFF_XLO = OFF_XHI + TO * SO;
constexpr int OFF_D = OFF_XLO + TO * SO;
constexpr int OFF_ACC = OFF_D + JL * QW * SD;
constexpr int SMEM_FLOATS = OFF_ACC + JL * TO * SA;
// Running sums of an owner: dsq 0, dtgt 1-3, dwgt 4-6, then with the i
// role's chain drot, dtrans, dintr, then with the j role's chain dX.
constexpr int A_SQ = 0;
constexpr int A_TGT = 1;
constexpr int A_WGT = 4;
constexpr int A_GI = 7;

static_assert(CH * JL * TO + 26 * TO <= 2 * TILE, "sums fit the tiles");
static_assert(R_ROT % 4 == 0 && R_CTH % 4 == 0 && ROW % 4 == 0,
              "16-byte rows");

// Offset of row q in a staged tile (gn_pair.cuh tile_row).
__device__ __forceinline__ int row_at(int q) { return tile_row<ROW>(q); }

// acc[o][e] += sum_q D[q][o] x_q[e] over the warp's QW streamed pixels.
__device__ __forceinline__ void dx_products(const float* __restrict__ tile,
                                            const float* __restrict__ D,
                                            float* __restrict__ acc, int warp,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3;
    // B (k = streamed, n = embedding).
    uint32_t bh[EMB / 8][2], bl[EMB / 8][2];
#pragma unroll
    for (int nt = 0; nt < EMB / 8; ++nt) {
        split(tile[row_at(warp + JL * t) + 8 * nt + g], bh[nt][0],
              bl[nt][0]);
        split(tile[row_at(warp + JL * (t + 4)) + 8 * nt + g], bh[nt][1],
              bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        // A (m = owner, k = streamed) from the pair buffer.
        const int o = 16 * mt + g;
        uint32_t ah[4], al[4];
        split(D[t * SD + o], ah[0], al[0]);
        split(D[t * SD + o + 8], ah[1], al[1]);
        split(D[(t + 4) * SD + o], ah[2], al[2]);
        split(D[(t + 4) * SD + o + 8], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < EMB / 8; ++nt) {
            float* cp = acc + o * SA + 8 * nt + 2 * t;
            float c[4] = {cp[0], cp[1], cp[8 * SA], cp[8 * SA + 1]};
            mma3(c, ah, al, bh[nt], bl[nt]);
            cp[0] = c[0];
            cp[1] = c[1];
            cp[8 * SA] = c[2];
            cp[8 * SA + 1] = c[3];
        }
    }
}

// The streamed pixels' inputs of one batch.
struct Streamed {
    const float *x, *X, *tgt, *wgt, *rot, *trans, *cth, *ctg, *sq, *gy, *gx;
};

// Start copying tile j0 (tq pixels) into buf, one commit group; the
// embedding of rows past tq is zeroed (the d x product reads it).
__device__ __forceinline__ void stage(float* buf, const Streamed& s, int j0,
                                      int tq, int tid) {
    const size_t j = j0;
    for (int i = tid; i < tq * EMB / 4; i += NT)
        copy_async<16>(buf + row_at(i / 8) + 4 * (i % 8),
                       s.x + j * EMB + 4 * i);
    for (int i = tid; i < tq * 9; i += NT) {
        copy_async<16>(buf + row_at(i / 9) + R_CTH + 4 * (i % 9),
                       s.cth + j * 36 + 4 * i);
        copy_async<4>(buf + row_at(i / 9) + R_ROT + i % 9, s.rot + j * 9 + i);
    }
    for (int i = tid; i < tq * 3; i += NT) {
        float* at = buf + row_at(i / 3) + i % 3;
        copy_async<8>(buf + row_at(i / 3) + R_CTG + 2 * (i % 3),
                      s.ctg + j * 6 + 2 * i);
        copy_async<4>(at + R_X, s.X + j * 3 + i);
        copy_async<4>(at + R_X + 6, s.tgt + j * 3 + i);
        copy_async<4>(at + R_X + 9, s.wgt + j * 3 + i);
        copy_async<4>(at + R_TR, s.trans + j * 3 + i);
    }
    for (int i = tid; i < tq; i += NT) {
        copy_async<4>(buf + row_at(i) + R_X + 3, s.sq + j + i);
        copy_async<4>(buf + row_at(i) + R_X + 4, s.gy + j + i);
        copy_async<4>(buf + row_at(i) + R_X + 5, s.gx + j + i);
    }
    for (int i = tq * EMB + tid; i < TS * EMB; i += NT)
        buf[row_at(i / EMB) + i % EMB] = 0.0f;
    asm volatile("cp.async.commit_group;\n" ::);
}

template <bool GI, bool GJ>
__global__ void __launch_bounds__(NT, 2)
gn_bwd_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
              const float* __restrict__ x, const float* __restrict__ sq,
              const float* __restrict__ gy, const float* __restrict__ gx,
              const float* __restrict__ X, const float* __restrict__ tgt,
              const float* __restrict__ wgt, const float* __restrict__ intr,
              const float* __restrict__ cth, const float* __restrict__ ctg,
              float* __restrict__ drot, float* __restrict__ dtrans,
              float* __restrict__ dx, float* __restrict__ dsq,
              float* __restrict__ dX, float* __restrict__ dtgt,
              float* __restrict__ dwgt, float* __restrict__ dintr, int n,
              float radius) {
    constexpr int A_GJ = A_GI + (GI ? 16 : 0);
    constexpr int NACC = A_GJ + (GJ ? 3 : 0);
    extern __shared__ __align__(16) float smem[];
    __shared__ int own_pix[TO];
    __shared__ int scratch[JL];
    float* xhi = smem + OFF_XHI;
    float* xlo = smem + OFF_XLO;

    const int b = blockIdx.y;
    const int lane = threadIdx.x, warp = threadIdx.y;
    const int tid = warp * TO + lane;
    const int w = grid_width(gy, n, lane, warp, scratch);
    // A lane past the end stands in for the block's first pixel, reaches
    // nothing and writes nothing.
    const int k = blockIdx.x * TO + lane;
    const bool valid = k < n;
    const int p = owner_pixel(valid ? k : blockIdx.x * TO, n, w);
    if (warp == 0) own_pix[lane] = valid ? p : -1;
    const size_t bp = (size_t)b * n + p;

    // The owner's doubled embedding, 4 entries a warp.
#pragma unroll
    for (int e = warp * 4; e < warp * 4 + 4; ++e) {
        const float v = 2.0f * x[bp * EMB + e];
        uint32_t hi, lo;
        split(v, hi, lo);
        xhi[lane * SO + e] = __uint_as_float(hi);
        xlo[lane * SO + e] = __uint_as_float(lo);
    }
    float* D = smem + OFF_D + warp * QW * SD;
    float* accx = smem + OFF_ACC + warp * TO * SA;
    for (int i = lane; i < TO * SA; i += TO) accx[i] = 0.0f;

    float R[9], T[3], A[21], cg[6], Xp[3], tp[3], wp[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = rot[bp * 9 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        T[i] = trans[bp * 3 + i];
        Xp[i] = X[bp * 3 + i];
        tp[i] = tgt[bp * 3 + i];
        wp[i] = wgt[bp * 3 + i];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int d = c; d < 6; ++d)
            A[tri(c, d)] = cth[bp * 36 + 6 * c + d] + cth[bp * 36 + 6 * d + c];
        cg[c] = ctg[bp * 6 + c];
    }
    const float sqp = sq[bp], gyp = gy[p], gxp = gx[p];
    const float fx = intr[b * 4 + 0], fy = intr[b * 4 + 1];
    const float cx = intr[b * 4 + 2], cy = intr[b * 4 + 3];
    const Reach reach(gyp, gxp, radius);

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

    const size_t bn = (size_t)b * n;
    const Streamed streamed = {x + bn * EMB, X + bn * 3, tgt + bn * 3,
                               wgt + bn * 3, rot + bn * 9, trans + bn * 3,
                               cth + bn * 36, ctg + bn * 6, sq + bn, gy, gx};

    // Tiles in turn through two buffers: the next one is copied while this
    // one is computed on. The barriers of next_tile keep a buffer until
    // every warp is done with it (and, the first time, publish the owned
    // embedding).
    int j0 = next_tile(0, n, reach, gy, gx, tid);
    if (j0 < n) stage(smem, streamed, j0, min(TS, n - j0), tid);
    for (int cur = 0; j0 < n; cur ^= 1) {
        const int next = next_tile(j0 + TS, n, reach, gy, gx, tid);
        if (next < n) {
            stage(smem + (cur ^ 1) * TILE, streamed, next,
                  min(TS, n - next), tid);
            wait_async<1>();
        } else {
            wait_async<0>();
        }
        __syncthreads();
        const float* tile = smem + cur * TILE;
        const int tq = min(TS, n - j0);
        j0 = next;

        // This warp's QW streamed pixels: skipped if none reaches an owner.
        const int qm = warp + JL * lane;
        const bool mine = lane < QW && qm < tq
            && reach.holds(tile[row_at(qm) + R_X + 4],
                           tile[row_at(qm) + R_X + 5]);
        if (!__any_sync(0xffffffffu, mine)) continue;

        dot_products<ROW>(tile, xhi, xlo, D, warp, lane);
        __syncwarp();

        for (int i = 0; i < QW; ++i) {
            const float* rowf = tile + row_at(warp + JL * i);
            const float4* row = reinterpret_cast<const float4*>(rowf);
            const float4 q8 = row[8];      // X0, X1, X2, sq
            const float4 q9 = row[9];      // gy, gx, tgt0, tgt1
            float dd = 0.0f;
            if (valid && warp + JL * i < tq && fabsf(gyp - q9.x) <= radius
                    && fabsf(gxp - q9.y) <= radius) {
                const float4 q10 = row[10];    // tgt2, wgt0, wgt1, wgt2
                const float dist = D[i * SD + lane] - sqp - q8.w;
                const float attn = 1.0f / (1.0f + expf(-dist));

                // Pair (p, q): p is i, q is j.
                float Si, qi[3], bri[3], bPi[3], bKi[4];
                pair_adjoint<GI>(
                    A, cg, R[0] * q8.x + R[1] * q8.y + R[2] * q8.z + T[0],
                    R[3] * q8.x + R[4] * q8.y + R[5] * q8.z + T[1],
                    R[6] * q8.x + R[7] * q8.y + R[8] * q8.z + T[2], fx, fy,
                    cx, cy, q9.z, q9.w, q10.x, q10.y, q10.z, q10.w, attn, Si,
                    qi, bri, bPi, bKi);

                // Pair (q, p): q is i, p is j.
                // Floats 44-99 of the row as fourteen float4 reads; the
                // cotangent of H folded as the forward mirrors it.
                float f[ROW - R_ROT];
#pragma unroll
                for (int e = 0; e < (ROW - R_ROT) / 4; ++e) {
                    const float4 v = row[R_ROT / 4 + e];
                    f[4 * e] = v.x;
                    f[4 * e + 1] = v.y;
                    f[4 * e + 2] = v.z;
                    f[4 * e + 3] = v.w;
                }
                const float* Rq = f;
                const float* Tq = f + (R_TR - R_ROT);
                const float* Hq = f + (R_CTH - R_ROT);
                float Aq[21], cgq[6];
#pragma unroll
                for (int c = 0; c < 6; ++c) {
#pragma unroll
                    for (int d = c; d < 6; ++d)
                        Aq[tri(c, d)] = Hq[6 * c + d] + Hq[6 * d + c];
                    cgq[c] = f[R_CTG - R_ROT + c];
                }
                float Sj, qj[3], brj[3], bPj[3], bKj[4];
                pair_adjoint<GJ>(
                    Aq, cgq,
                    Rq[0] * Xp[0] + Rq[1] * Xp[1] + Rq[2] * Xp[2] + Tq[0],
                    Rq[3] * Xp[0] + Rq[4] * Xp[1] + Rq[5] * Xp[2] + Tq[1],
                    Rq[6] * Xp[0] + Rq[7] * Xp[1] + Rq[8] * Xp[2] + Tq[2],
                    fx, fy, cx, cy, tp[0], tp[1], tp[2], wp[0], wp[1], wp[2],
                    attn, Sj, qj, brj, bPj, bKj);

                // d dist of both pairs; dist = 2 x_p . x_q - sq_p - sq_q
                // (the 2 goes on at the end).
                dd = attn * (1.0f - attn) * (Si + Sj);
                acc[A_SQ] -= dd;
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    acc[A_TGT + m] += brj[m];
                    acc[A_WGT + m] = fmaf(attn, qj[m], acc[A_WGT + m]);
                }
                if constexpr (GI) {
                    const float Xq[3] = {q8.x, q8.y, q8.z};
#pragma unroll
                    for (int m = 0; m < 3; ++m) {
#pragma unroll
                        for (int e = 0; e < 3; ++e)
                            acc[A_GI + 3 * m + e] =
                                fmaf(bPi[m], Xq[e], acc[A_GI + 3 * m + e]);
                        acc[A_GI + 9 + m] += bPi[m];
                    }
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[A_GI + 12 + e] += bKi[e];
                }
                if constexpr (GJ) {
                    // d X_p = R_q^t d P
#pragma unroll
                    for (int e = 0; e < 3; ++e)
                        acc[A_GJ + e] += Rq[e] * bPj[0] + Rq[3 + e] * bPj[1]
                                         + Rq[6 + e] * bPj[2];
                }
            }
            D[i * SD + lane] = dd;
        }
        __syncwarp();
        if (dx != nullptr) dx_products(tile, D, accx, warp, lane);
    }
    __syncthreads();

    // d x: each warp's sums added in warp order.
    if (dx != nullptr) {
        for (int i = tid; i < TO * EMB; i += NT) {
            const int o = i / EMB, e = i % EMB;
            if (own_pix[o] < 0) continue;
            float s = 0.0f;
#pragma unroll
            for (int v = 0; v < JL; ++v)
                s += smem[OFF_ACC + v * TO * SA + o * SA + e];
            dx[(bn + own_pix[o]) * EMB + e] = 2.0f * s;
        }
    }
    // The other sums through the tile buffers, in warp order.
    float (*red)[JL][TO] = reinterpret_cast<float (*)[JL][TO]>(smem);
    float (*out)[TO] = reinterpret_cast<float (*)[TO]>(smem + CH * JL * TO);
    block_sums<NACC>(acc, red, out, lane, warp, tid);

    for (int i = tid; i < TO * 3; i += NT) {
        const int o = i / 3, m = i % 3;
        const int q = own_pix[o];
        if (q < 0) continue;
        if (dtgt != nullptr) dtgt[(bn + q) * 3 + m] = out[A_TGT + m][o];
        if (dwgt != nullptr) dwgt[(bn + q) * 3 + m] = out[A_WGT + m][o];
        if constexpr (GI) {
            if (dtrans != nullptr)
                dtrans[(bn + q) * 3 + m] = out[A_GI + 9 + m][o];
        }
        if constexpr (GJ) {
            if (dX != nullptr) dX[(bn + q) * 3 + m] = out[A_GJ + m][o];
        }
    }
    if (dsq != nullptr && tid < TO && own_pix[tid] >= 0)
        dsq[bn + own_pix[tid]] = out[A_SQ][tid];
    if constexpr (GI) {
        for (int i = tid; i < TO * 9; i += NT) {
            const int o = i / 9, q = own_pix[o];
            if (drot != nullptr && q >= 0)
                drot[(bn + q) * 9 + i % 9] = out[A_GI + i % 9][o];
        }
        for (int i = tid; i < TO * 4; i += NT) {
            const int o = i / 4, q = own_pix[o];
            if (dintr != nullptr && q >= 0)
                dintr[(bn + q) * 4 + i % 4] = out[A_GI + 12 + i % 4][o];
        }
    }
}

template <bool GI, bool GJ>
int launch(const dim3 grid, cudaStream_t stream, const float* const (&in)[12],
           float* const (&out)[8], int n, float radius) {
    constexpr int bytes = SMEM_FLOATS * sizeof(float);
    // Above 48 KB a block's shared memory has to be asked for, once.
    static const cudaError_t set = cudaFuncSetAttribute(
        gn_bwd_kernel<GI, GJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    gn_bwd_kernel<GI, GJ><<<grid, dim3(TO, JL), bytes, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], out[5],
        out[6], out[7], n, radius);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs: rot, trans, x, sq, gy, gx, X, tgt, wgt, intr, ct_H, ct_g; outputs
// (null: not wanted): d rot, d trans, d x, d sq, d X, d tgt, d wgt and each
// pixel's share of d intrinsics (B, n, 4).
extern "C" int gn_build_bwd_launch(
        const void* rot, const void* trans, const void* x, const void* sq,
        const void* gy, const void* gx, const void* X, const void* tgt,
        const void* wgt, const void* intr, const void* cth, const void* ctg,
        void* drot, void* dtrans, void* dx, void* dsq, void* dX, void* dtgt,
        void* dwgt, void* dintr, int b, int n, float radius, void* stream) {
    const float* const in[12] = {
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(x), static_cast<const float*>(sq),
        static_cast<const float*>(gy), static_cast<const float*>(gx),
        static_cast<const float*>(X), static_cast<const float*>(tgt),
        static_cast<const float*>(wgt), static_cast<const float*>(intr),
        static_cast<const float*>(cth), static_cast<const float*>(ctg)};
    float* const out[8] = {
        static_cast<float*>(drot), static_cast<float*>(dtrans),
        static_cast<float*>(dx), static_cast<float*>(dsq),
        static_cast<float*>(dX), static_cast<float*>(dtgt),
        static_cast<float*>(dwgt), static_cast<float*>(dintr)};
    const dim3 grid((n + TO - 1) / TO, b);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool gi = drot != nullptr || dtrans != nullptr || dintr != nullptr;
    const bool gj = dX != nullptr;
    if (gi)
        return gj ? launch<true, true>(grid, s, in, out, n, radius)
                  : launch<true, false>(grid, s, in, out, n, radius);
    return gj ? launch<false, true>(grid, s, in, out, n, radius)
              : launch<false, false>(grid, s, in, out, n, radius);
}
