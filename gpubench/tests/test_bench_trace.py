"""The trace reduction on made-up profiler events: kernel groups, the
device's busy time as a union of intervals, launches, and idle gaps named
by the innermost host operation open during them."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gpubench import readers, trace
from gpubench.harness import Readings


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    device_type: object
    time_range: Range


def dev(name, start, end):
    return Event(name, torch.autograd.DeviceType.CUDA, Range(start, end))


def host(name, start, end):
    return Event(name, torch.autograd.DeviceType.CPU, Range(start, end))


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::warp_gather_kernel<1, 4, 0, 2>(float",
     "K5 warp_gather"),
    ("warp_coord_grad_kernel<3>", "K5b warp_coord_grad"),
    ("photo_pair_kernel", "K1/K3/K4 photo_pair"),
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float>", "convolutions"),
    ("void internal::region_transform_ABC_val<int, 32>", "convolutions"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16", "convolutions"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>",
     "layout transposes"),
    ("multi_tensor_apply_kernel", "adam"),
    ("something_new", "other")])
def test_groups(name, group):
    assert trace.group_of(name) == group


def test_reduce():
    events = [
        host("train_step", 0, 100), host("aten::item", 25, 45),
        dev("warp_gather_kernel", 0, 10), dev("gemm_a", 5, 20),
        dev("gemm_b", 50, 70), dev("Memset (Device)", 90, 95),
        dev("ProfilerStep#1", 0, 100)]
    r = trace.reduce(events, units=2, window_s=1e-4)
    assert r["launches"] == 4
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["group_s"]["convolutions"] == pytest.approx(35e-6)
    assert r["group_s"]["K5 warp_gather"] == pytest.approx(10e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert gaps["train_step"] == pytest.approx(20e-6)
    assert r["device_ops"][0] == ["gemm_b", pytest.approx(20e-6)]
    assert r["op_s"]["warp_gather_kernel"] == pytest.approx(10e-6)


def test_readers_per_unit():
    t = {"units": 2, "window_s": 1.0, "busy_s": 0.1, "launches": 10,
         "group_s": {"K5 warp_gather": 0.02, "convolutions": 0.05},
         "op_s": {"void warp_gather_kernel<1, 4>(float)": 0.015,
                  "warp_gather_kernel<32, 8>": 0.005, "gemm": 0.05}}
    r = Readings(units=10, window_s=2.0, trace=t, bounds={"K5": 0.005},
                 kernel_names={"K5": ("warp_gather_kernel",)},
                 flops_per_unit=1e12, peak_flops_per_s=1e15)
    assert readers.launches_per_unit(r) == 5
    assert readers.group_ms_per_unit(r, "convolutions") == pytest.approx(25)
    # busy 0.05 s a unit against 0.2 s a unit untraced
    assert readers.idle_pct(r) == pytest.approx(75)
    assert readers.mfu_pct(r) == pytest.approx(0.5)
    assert readers.roofline_pct(r, ("K5",)) == pytest.approx(50)
    assert readers.roofline_pct(r, ("K2",)) is None
    assert readers.span_mean_ms(r, "input_wait") is None


def test_roofline_follows_a_new_kernels_names():
    """A kernel that no table here knows: its time is found by the names
    its reference noted with its calls."""
    t = {"units": 1, "window_s": 1.0, "busy_s": 0.1, "launches": 3,
         "group_s": {"other": 0.004},
         "op_s": {"fused_thing_kernel<8>": 0.003, "gemm": 0.001}}
    r = Readings(units=1, window_s=1.0, trace=t, bounds={"K9": 0.0015},
                 kernel_names={"K9": ("fused_thing_kernel",)})
    assert readers.roofline_pct(r, ("K9",)) == pytest.approx(50)
