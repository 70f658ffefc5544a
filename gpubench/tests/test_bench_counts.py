"""The yardstick's arithmetic against chip_smoke.py's figures at the stage-2
shapes (B = 32, 2 sources, 128x416, 4 scales), with whole images read,
and the touched-cell count of the gathers."""

from __future__ import annotations

import pytest
import torch

from gpubench import work

N = 64                              # 32 samples x 2 sources
SCALES = ((128, 416), (64, 208), (32, 104), (16, 52))


def ms(bytes_and_flops) -> float:
    return work.bound_s(*bytes_and_flops) * 1e3


def test_k5_k5b_k6_stage2_bounds():
    """PERF.md's kernel table: one call at each of K5's shapes (the image
    at scale 0, the flows at four scales) bounds it at 0.065 ms, K5b at
    0.084, K6 (flows) at 0.032, all by bytes."""
    k5 = ms(work.gather_call(3, 128, 416, (N, 2, 128, 416), None))
    k5b = ms(work.coord_grad_call(3, 128, 416, (N, 2, 128, 416), None))
    k6 = 0.0
    for h, w in SCALES:
        k5 += ms(work.gather_call(2, h, w, (N, 2, h, w), None))
        k5b += ms(work.coord_grad_call(2, h, w, (N, 2, h, w), None))
        k6 += ms(work.splat_call(2, h, w, (N, 2, h, w)))
    assert k5 == pytest.approx(0.065, abs=5e-4)
    assert k5b == pytest.approx(0.084, abs=5e-4)
    assert k6 == pytest.approx(0.032, abs=5e-4)


def test_loss_kernel_bounds():
    """K7's map 0.037 and adjoint 0.049 ms at 64x3x128x416; K2's stage-2
    step 0.146 ms over its 12 calls; K1 at stage 1, B = 128: 0.270 ms over
    four scales."""
    numel = N * 3 * 128 * 416
    assert ms(work.dssim_fwd_call(numel)) == pytest.approx(0.037, abs=5e-4)
    assert ms(work.dssim_bwd_call(numel, 1)) == pytest.approx(0.049,
                                                              abs=5e-4)
    k2 = 0.0
    for h, w in SCALES:
        k2 += ms(work.smooth_call(32 * 3 * h * w, 32 * 3 * 3 * h * w))
        k2 += 2 * ms(work.smooth_call(N * 2 * h * w, N * 3 * h * w))
    assert k2 == pytest.approx(0.146, abs=5e-4)
    k1 = 0.0
    for h, w in SCALES:
        hw = 128 * h * w
        in_bytes = 4 * (3 * hw + 6 * hw + 4 * hw + 4 * hw)
        k1 += ms(work.photo_call(2 * 2 * hw, in_bytes, 4 * 8 * hw))
    assert k1 == pytest.approx(0.270, abs=1e-3)


def test_touched_cells():
    h, w = 6, 8
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs, ys])[None]
    assert work.touched_cells(grid, h, w, "zero_pad") == h * w
    assert work.touched_cells(grid, h, w, "edge_zero") == h * w
    half = grid + torch.tensor([0.5, 0.5]).reshape(1, 2, 1, 1)
    assert work.touched_cells(half, h, w, "zero_pad") == h * w
    outside = grid + 100.0
    assert work.touched_cells(outside, h, w, "zero_pad") == 0
    assert work.touched_cells(outside, h, w, "edge_zero") == 1
    two = torch.cat([grid, outside])
    assert work.touched_cells(two, h, w, "zero_pad") == h * w
    # Fewer cells read, a lower bound than whole images.
    assert (work.gather_call(1, h, w, two.shape, h * w)[0]
            < work.gather_call(1, h, w, two.shape, None)[0])


def test_log_sums_by_kernel():
    with work.recording() as log:
        work.note("K5", 3.35e9, 0.0, names=("warp_gather_kernel",))
        work.note("K5", 3.35e9, 0.0, names=("warp_gather_kernel",))
        with work.paused():
            work.note("K5", 1e12, 0.0, names=("warp_gather_kernel",))
        work.note("K2", 0.0, 67e9, names=("smooth_kernel",))
    assert not work.active()
    bounds = work.bound_by_kernel(log, per=2)
    assert bounds["K5"] == pytest.approx(1e-3)
    assert bounds["K2"] == pytest.approx(0.5e-3)
    assert work.names_by_kernel(log) == {"K5": ("warp_gather_kernel",),
                                         "K2": ("smooth_kernel",)}
