"""Shared fixtures of the benchmark's CPU tests: tiny sizes of the cells'
configurations (the cells' own files and limits otherwise), two torch
threads, and the ``card`` marker for tests that need a CUDA device.

Run: ``python -m pytest gpubench/tests -q`` (CPU); the ``card`` tests skip
here and run on a machine with a card by the same command.
"""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import harness

_LOAD_CONFIG, _LOAD_TRAFFIC = harness.load_config, harness.load_traffic
TINY_GEONET = dict(img_height=32, img_width=64, compute_dtype="float32")
TINY_UNIAD = dict(num_query=12, num_classes=3, embed_dims=32, bev_h=4,
                  bev_w=4, encoder_layers=1, decoder_layers=2,
                  backbone_blocks=[1, 1, 1, 1], mem_len=2)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_config(name: str) -> dict:
    cfg = _LOAD_CONFIG(name)
    if name == "geonet_kitti_128x416":
        cfg["model"] = {**cfg["model"], **TINY_GEONET}
    elif name == "uniad_base_track":
        cfg["model"] = {**cfg["model"], **TINY_UNIAD}
        cfg["image"] = {"height": 64, "width": 64}
    return cfg


def tiny_traffic(name: str) -> dict:
    mix = dict(_LOAD_TRAFFIC(name))
    if mix["kind"] == "snippets":
        mix.update(batch=2, pool=3)
    return mix


@pytest.fixture
def tiny(monkeypatch):
    """The harness reads tiny configurations and traffic; returns a
    function that makes a driver's context for a cell."""
    monkeypatch.setattr(harness, "load_config", tiny_config)
    monkeypatch.setattr(harness, "load_traffic", tiny_traffic)

    def make(cell_name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3,
             trace: bool = False):
        cell = harness.load_workload(cell_name)
        if "setup_steps" in cell:
            cell["setup_steps"] = 3
        return harness.Context(
            cell=cell, config=tiny_config(cell["config"]),
            traffic=tiny_traffic(cell["traffic"]), seed=seed,
            seconds=seconds, trace=trace, device=torch.device("cpu"),
            t_start=time.perf_counter())
    return make


def driver(cell_name: str):
    cell = harness.load_workload(cell_name)
    return harness.load_module("drivers", cell["driver"], "driver")


