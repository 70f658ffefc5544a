"""``kernels/build.py`` names a library by everything that decides its
contents: the source, the ``csrc/`` headers it includes, directly or through
another header, and the compiler flags."""

import os
import shutil

import pytest

from sndepth_tpu_torch.kernels import build
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    monkeypatch.setattr(build, "CSRC", str(dst))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    return dst


def test_source_closure_follows_quoted_includes_only():
    assert build.source_closure("photo_pair.cu") == [
        "photo_pair.cu", "sampler.cuh", "ssim.cuh"]
    assert build.source_closure("warp.cu") == ["warp.cu", "sampler.cuh"]
    assert build.source_closure("dssim.cu") == ["dssim.cu", "ssim.cuh"]
    assert build.source_closure("smooth_loss.cu") == ["smooth_loss.cu"]


@pytest.mark.parametrize("source,header,rebuilds", [
    ("photo_pair.cu", "sampler.cuh", True),
    ("photo_pair.cu", "ssim.cuh", True),
    ("warp.cu", "sampler.cuh", True),
    ("warp.cu", "ssim.cuh", False),
    ("dssim.cu", "sampler.cuh", False),
    ("dssim.cu", "ssim.cuh", True),
    ("smooth_loss.cu", "ssim.cuh", False),
    ("gn_build.cu", "gn_pair.cuh", True),
    ("gn_build_bwd.cu", "gn_pair.cuh", True),
])
def test_a_changed_header_renames_the_libraries_that_include_it(
        csrc_copy, source, header, rebuilds):
    before = build.library_path(source)
    with open(csrc_copy / header, "a") as f:
        f.write("\n// changed\n")
    assert (build.library_path(source) != before) == rebuilds


def test_a_header_included_through_a_header_counts(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    with open(csrc_copy / "ssim.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    assert build.source_closure("dssim.cu") == ["dssim.cu", "ssim.cuh",
                                                "inner.cuh"]
    before = build.library_path("dssim.cu")
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// changed\n")
    assert build.library_path("dssim.cu") != before


def test_source_and_flags_rename_the_library(csrc_copy, monkeypatch):
    before = build.library_path("warp.cu")
    assert os.path.basename(before).startswith("libwarp_")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-g"])
    flagged = build.library_path("warp.cu")
    assert flagged != before
    with open(csrc_copy / "warp.cu", "a") as f:
        f.write("\n// changed\n")
    assert build.library_path("warp.cu") not in (before, flagged)


def test_flags_keep_the_target_and_the_unfused_arithmetic():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-fmad=false" in build.NVCC_FLAGS


def test_only_the_gauss_newton_backward_fuses_multiply_adds():
    """The DSSIM and warp kernels build with ``-fmad=false``, which keeps
    the DSSIM map and the gather bit-equal to their plain versions; the
    Gauss-Newton build and backward have no tie to keep, the photo kernel
    keeps its tie by unfused arithmetic in ``csrc/ssim.cuh``, and the
    smoothness kernel's only tie involves no product, so those four build
    with fused multiply-adds."""
    for source in ("dssim.cu", "warp.cu"):
        assert build.nvcc_flags(source) == build.NVCC_FLAGS
    assert sorted(build.FMAD_SOURCES) == ["gn_build.cu", "gn_build_bwd.cu",
                                          "photo_pair.cu", "smooth_loss.cu"]
    for source in build.FMAD_SOURCES:
        fused = build.nvcc_flags(source)
        assert "-fmad=false" not in fused
        assert fused == [f for f in build.NVCC_FLAGS if f != "-fmad=false"]
        assert "arch=compute_90a,code=sm_90a" in fused
