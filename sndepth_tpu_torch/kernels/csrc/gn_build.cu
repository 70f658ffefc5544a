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
// in gn_build_bwd.cu, whose owner map, staging and embedding product this
// kernel shares (gn_pair.cuh).
//
// What bounds it: operations. The build needs ~218 operations an ordered
// pair in the radius: the 32-wide embedding product and the sigmoid once
// per unordered pair (the attention is symmetric), the product on the
// tensor cores, and ~186 float32 operations of geometry and sums (the
// transformed point, residuals, 13 Jacobian entries, 54 accumulated
// products); chip_smoke.py GN_PAIR_FLOPS. The inputs are a few megabytes
// and stay in L2. The kernel evaluates the product for every ordered pair
// (each owner its own), ~254 operations a pair. What the design does:
//   * A block owns 32 pixels, one a lane; a warp's 32 lanes are an 8 x 4
//     patch of the grid (owner_pixel), so that most lanes that run a pair
//     are in the radius (gn_build.py lane_share: 96% at 32x104, 91% at
//     47x156 for radius 32; 66% with 32 pixels of one grid row, the map
//     before). The 8 warps of a block split the streamed pixels: warp w
//     takes rows w, w + 8, ... of each staged tile of 64.
//   * A cluster of C blocks on neighbouring SMs owns the same 32 pixels and
//     deals the in-reach tiles to its blocks in turn. C is the largest of
//     8, 4, 2, 1 that keeps the grid within two blocks on each of an H100's
//     132 SMs (cluster_size), a function of the shape alone: 26 blocks
//     become 208 at 1 x 832, 208 at 2 x 3328 and 230 at 1 x 7332 stay as
//     they are. After the pair loop each block adds its 8 warps' 27 sums a
//     pixel in warp order, then each block writes a share of H and g from
//     the C blocks' sums read through distributed shared memory in rank
//     order. No atomics; the same bits from run to run.
//   * The embedding product takes one of two paths, chosen with the
//     cluster size. In clusters (small builds, few tiles a block) a warp's
//     (32 owned x 8 streamed) product runs on the tensor cores as mma.sync
//     m16n8k8 TF32 in the split three-product form (lo.hi + hi.lo + hi.hi),
//     which keeps float32 accuracy: the owned doubled embedding kept split
//     in shared memory, the products landing in a per-warp buffer that the
//     pair loop reads. Without clusters each lane forms its pairs' products
//     on the float32 pipe, the owned embedding in registers, four
//     independent partial sums a dot, and only for the pairs in the radius.
//     The pair loop keeps the owner's pose and 27 running sums in
//     registers.
//   * The next tile arrives by cp.async into a second buffer while this one
//     is computed on.
//   * A tile that no owned pixel can reach (by the box of the block's grid
//     positions) is skipped before it is copied, a warp's 8 streamed pixels
//     when none reaches, and a pair outside the radius before any of its
//     arithmetic past the embedding product. Skipping is the same function:
//     such a pair's weight is exactly 0. The one difference from the TPU
//     kernel is a pair outside the radius whose transformed depth Pz is
//     exactly 0: there the TPU kernel forms 0 * inf = NaN, this kernel adds
//     nothing.
// The TPU kernel's 8x128 tiles, its 128-lane padding of the i columns and
// its dummy j rows are the TPU's layout and have no counterpart here.
//
// Built with fused multiply-adds (kernels/build.py FMAD_SOURCES): no result
// here depends on a tie staying a tie (the radius test compares integers
// held as floats).
// ptxas for sm_90a: 126 registers a thread with the product on the float32
// pipe, 120 on the tensor cores, no spills, 42,400 bytes of static shared
// memory a block.
// Measured (H100 80GB HBM3 at 700 W, CUDA events, radius 32, the launch
// alone), against the kernel before (32 pixels of a grid row a block, one
// block per 32 pixels, the product on the float32 pipe for every pair,
// -fmad=false) in the same call: 0.069 -> 0.029 ms at 1 x 832, 0.294 ->
// 0.238 at 2 x 3328, 0.471 -> 0.374 at 1 x 7332. The choices, from two such
// calls: at 1 x 832 without clusters 0.066, in clusters with the product on
// the float32 pipe 0.036; at 2 x 3328 and 1 x 7332 the product on the
// tensor cores 0.247 and 0.399 (the warp's products are formed for every
// pair of its tile, in the radius or not, and their chain of 12 dependent
// mma.sync a tile is not hidden by 16 warps an SM), clusters there too (up
// to 4 or 8 blocks a cluster) 0.258 / 0.409 and 0.305 / 0.503; the sigmoid
// by the approximate __expf and __frcp_rn no faster (0.237 / 0.373); built
// with -fmad=false 1-3.5% slower.

#include <cooperative_groups.h>

#include "gn_pair.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gn;

constexpr int ROW = 44;            // floats per staged pixel j:
constexpr int R_X = 32;            //   emb 0-31, X 32-34, sq 35, gy 36,
                                   //   gx 37, tgt 38-40, wgt 41-43
constexpr int NACC = 27;           // 21 upper-triangle H entries + 6 of g
// A staged tile: TS rows, 4 floats of padding after every JL rows.
constexpr int TILE = TS * ROW + 4 * (TS / JL);
// Shared memory (floats): two staged tiles, the owned doubled embedding (hi
// and lo), each warp's (QW x TO) pair buffer. After the pair loop the tiles
// hold the reduction buffer and the block's sums (OFF_SUMS).
constexpr int OFF_XHI = 2 * TILE;
constexpr int OFF_XLO = OFF_XHI + TO * SO;
constexpr int OFF_D = OFF_XLO + TO * SO;
constexpr int SMEM_FLOATS = OFF_D + JL * QW * SD;
constexpr int OFF_SUMS = CH * JL * TO;
// The grid a build fills: two blocks on each of an H100's 132 SMs.
constexpr int SLOTS = 2 * 132;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

static_assert(OFF_SUMS + NACC * TO <= 2 * TILE, "sums fit the tiles");
static_assert(ROW % 4 == 0, "16-byte rows");

#define ACC(p, a, b) acc[p] = fmaf((a), (b), acc[p])

__device__ __forceinline__ int row_at(int q) { return tile_row<ROW>(q); }

// Blocks a cluster: the largest of MAX_CLUSTER, ..., 2, 1 that keeps
// `blocks` x C within SLOTS (1 if `blocks` alone exceeds it).
constexpr int cluster_size(int blocks) {
    int c = MAX_CLUSTER;
    while (c > 1 && blocks * c > SLOTS) c /= 2;
    return c;
}

// The streamed pixels' inputs of one batch.
struct Streamed {
    const float *x, *X, *tgt, *wgt, *sq, *gy, *gx;
};

// Start copying tile j0 (tq pixels) into buf, one commit group; the
// embedding of rows past tq is zeroed (the embedding product reads it).
__device__ __forceinline__ void stage(float* buf, const Streamed& s, int j0,
                                      int tq, int tid) {
    const size_t j = j0;
    for (int i = tid; i < tq * EMB / 4; i += NT)
        copy_async<16>(buf + row_at(i / 8) + 4 * (i % 8),
                       s.x + j * EMB + 4 * i);
    for (int i = tid; i < tq * 3; i += NT) {
        float* at = buf + row_at(i / 3) + R_X + i % 3;
        copy_async<4>(at, s.X + j * 3 + i);
        copy_async<4>(at + 6, s.tgt + j * 3 + i);
        copy_async<4>(at + 9, s.wgt + j * 3 + i);
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

// The next tile at or after j that is this block's: the tiles a pixel of
// the block can reach, in order, are dealt to the cluster's blocks in turn;
// `seen` counts those passed. n if none; block-wide.
__device__ __forceinline__ int next_mine(int j, int n, const Reach& reach,
                                         const float* __restrict__ gy,
                                         const float* __restrict__ gx,
                                         int tid, int rank, int csize,
                                         int& seen) {
    for (;;) {
        j = next_tile(j, n, reach, gy, gx, tid);
        if (j >= n) return n;
        if (seen++ % csize == rank) return j;
        j += TS;
    }
}

template <bool MMA>
__global__ void __launch_bounds__(NT, 2)
gn_build_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                const float* __restrict__ x, const float* __restrict__ sq,
                const float* __restrict__ gy, const float* __restrict__ gx,
                const float* __restrict__ X, const float* __restrict__ tgt,
                const float* __restrict__ wgt, const float* __restrict__ intr,
                float* __restrict__ H, float* __restrict__ g, int n,
                float radius) {
    __shared__ __align__(16) float smem[SMEM_FLOATS];
    __shared__ int own_pix[TO];
    __shared__ int scratch[JL];
    float* xhi = smem + OFF_XHI;
    float* xlo = smem + OFF_XLO;
    const cg::cluster_group cluster = cg::this_cluster();
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());

    const int b = blockIdx.y;
    const int lane = threadIdx.x, warp = threadIdx.y;
    const int tid = warp * TO + lane;
    const int w = grid_width(gy, n, lane, warp, scratch);
    // A lane past the end stands in for the block's first pixel, reaches
    // nothing and writes nothing.
    const int k0 = (blockIdx.x / csize) * TO;
    const int k = k0 + lane;
    const bool valid = k < n;
    const int p = owner_pixel(valid ? k : k0, n, w);
    if (warp == 0) own_pix[lane] = valid ? p : -1;
    const size_t bp = (size_t)b * n + p;

    // The owner's doubled embedding: split in shared memory, 4 entries a
    // warp, for the tensor cores; in registers for the float32 pipe.
    if constexpr (MMA) {
#pragma unroll
        for (int e = warp * 4; e < warp * 4 + 4; ++e) {
            uint32_t hi, lo;
            split(2.0f * x[bp * EMB + e], hi, lo);
            xhi[lane * SO + e] = __uint_as_float(hi);
            xlo[lane * SO + e] = __uint_as_float(lo);
        }
    }
    float* D = smem + OFF_D + warp * QW * SD;
    float x2[MMA ? 1 : EMB];
    if constexpr (!MMA) {
#pragma unroll
        for (int e = 0; e < EMB; ++e) x2[e] = 2.0f * x[bp * EMB + e];
    }

    float R[9], T[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = rot[bp * 9 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = trans[bp * 3 + i];
    const float sqp = sq[bp], gyp = gy[p], gxp = gx[p];
    const float fx = intr[b * 4 + 0], fy = intr[b * 4 + 1];
    const float cx = intr[b * 4 + 2], cy = intr[b * 4 + 3];
    const Reach reach(gyp, gxp, radius);

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

    const size_t bn = (size_t)b * n;
    const Streamed streamed = {x + bn * EMB, X + bn * 3, tgt + bn * 3,
                               wgt + bn * 3, sq + bn, gy, gx};

    // This block's tiles in turn through two buffers: the next one is
    // copied while this one is computed on. The barriers of next_tile keep
    // a buffer until every warp is done with it (and, the first time,
    // publish the owned embedding).
    int seen = 0;
    int j0 = next_mine(0, n, reach, gy, gx, tid, rank, csize, seen);
    if (j0 < n) stage(smem, streamed, j0, min(TS, n - j0), tid);
    for (int cur = 0; j0 < n; cur ^= 1) {
        const int next = next_mine(j0 + TS, n, reach, gy, gx, tid, rank,
                                   csize, seen);
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

        if constexpr (MMA) {
            dot_products<ROW>(tile, xhi, xlo, D, warp, lane);
            __syncwarp();
        }

        for (int i = 0; i < QW; ++i) {
            const float4* row = reinterpret_cast<const float4*>(
                tile + row_at(warp + JL * i));
            const float4 q9 = row[9];      // gy, gx, tgt0, tgt1
            if (!(valid && warp + JL * i < tq
                  && fabsf(gyp - q9.x) <= radius
                  && fabsf(gxp - q9.y) <= radius))
                continue;
            const float4 q8 = row[8];      // X0, X1, X2, sq
            const float4 q10 = row[10];    // tgt2, wgt0, wgt1, wgt2
            float dist;
            if constexpr (MMA) {
                dist = D[i * SD + lane] - sqp - q8.w;
            } else {
                // Four independent partial sums: a shorter dependent chain.
                float d4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int c = 0; c < EMB / 4; ++c) {
                    const float4 e = row[c];
                    d4[0] = fmaf(x2[4 * c + 0], e.x, d4[0]);
                    d4[1] = fmaf(x2[4 * c + 1], e.y, d4[1]);
                    d4[2] = fmaf(x2[4 * c + 2], e.z, d4[2]);
                    d4[3] = fmaf(x2[4 * c + 3], e.w, d4[3]);
                }
                dist = ((d4[0] + d4[1]) + (d4[2] + d4[3])) - sqp - q8.w;
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
    __syncthreads();

    // The block's sums, its warps added in warp order, into sums[p][owner].
    float (*red)[JL][TO] = reinterpret_cast<float (*)[JL][TO]>(smem);
    float (*sums)[TO] = reinterpret_cast<float (*)[TO]>(smem + OFF_SUMS);
    block_sums<NACC>(acc, red, sums, lane, warp, tid);
    cluster.sync();

    // H and g from the cluster's blocks' sums, added in rank order; this
    // block writes every csize-th entry. Entry (c, d) and entry (d, c) of H
    // read the same sums.
    const int ni = min(TO, n - k0);
    float* Hb = H + bn * 36;
    float* gb = g + bn * 6;
    for (int i = rank * NT + tid; i < ni * 42; i += csize * NT) {
        const int o = i / 42, e = i % 42;
        const int at = (e < 36 ? tri(e / 6, e % 6) : 21 + e - 36) * TO + o;
        float s = 0.0f;
        for (int r = 0; r < csize; ++r)
            s += cluster.map_shared_rank(smem + OFF_SUMS, r)[at];
        if (e < 36)
            Hb[(size_t)own_pix[o] * 36 + e] = s;
        else
            gb[(size_t)own_pix[o] * 6 + e - 36] = s;
    }
    // No block leaves while another reads its sums.
    cluster.sync();
}

}  // namespace

extern "C" int gn_build_launch(
        const void* rot, const void* trans, const void* x, const void* sq,
        const void* gy, const void* gx, const void* X, const void* tgt,
        const void* wgt, const void* intr, void* H, void* g, int b, int n,
        float radius, void* stream) {
    const int groups = (n + TO - 1) / TO;
    const int csize = cluster_size(b * groups);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(groups * csize, b);
    config.blockDim = dim3(TO, JL);
    config.dynamicSmemBytes = 0;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attr;
    config.numAttrs = 1;
    // The product on the tensor cores in clusters, on the float32 pipe
    // without (the note at the top).
    const cudaError_t err = cudaLaunchKernelEx(
        &config, csize > 1 ? gn_build_kernel<true> : gn_build_kernel<false>,
        static_cast<const float*>(rot),
        static_cast<const float*>(trans), static_cast<const float*>(x),
        static_cast<const float*>(sq), static_cast<const float*>(gy),
        static_cast<const float*>(gx), static_cast<const float*>(X),
        static_cast<const float*>(tgt), static_cast<const float*>(wgt),
        static_cast<const float*>(intr), static_cast<float*>(H),
        static_cast<float*>(g), n, radius);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
