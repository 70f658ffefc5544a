"""Serving artifacts of the PyTorch port (``serving/export.py``,
``cli/export_model.py``) and ``cli/kitti_submission.py --data_parallel``,
on the CPU.

The JAX package's ``tests/test_serving.py`` cases, ported: an artifact
loaded without the model's code equals the eager model (bit for bit: the
exported program runs the same operators), and a wrong input shape raises.
Here for the three models the export CLI takes, DispNetS (bf16), NormalNet
in test mode (bf16, a narrow encoder) and RAFT3D (float32, 64x64, one
iteration: each more adds ~7 s of export and load here), whose loaded
program calls the gather and the Gauss-Newton build as the operators
``sndepth::warp_gather`` and ``sndepth::gn_build`` (their plain versions on
the CPU, the CUDA kernels on the card), once an iteration each
(``chip_smoke.py``'s ``export`` phase counts 16 launches of each a frame
on the card).

The submission writer under two gloo ranks (a spawned group, a file store,
one torch thread a process) writes the files one process writes, byte for
byte.
"""

import os
import shutil

import pytest
import torch

from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """An artifact holds its weights (0.1-0.3 GB): a test's files go when
    it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _narrow_normal_net():
    """NormalNet in test mode with one narrow encoder block a stage (the
    plan of ``test_torch_nnet.py``): the full B5's export and load take
    ~35 s here and check nothing more."""
    from sndepth_tpu_torch.cli.export_model import NormalsTest
    from sndepth_tpu_torch.models import nnet as nnet_lib
    from sndepth_tpu_torch.models.efficientnet import BlockSpec
    from sndepth_tpu_torch.train.nnet import NormalNet
    blocks = tuple(BlockSpec(*b) for b in (
        (16, 8, 3, 1, 1, 1), (8, 12, 3, 2, 6, 1), (12, 16, 5, 2, 6, 1),
        (16, 24, 3, 2, 6, 1), (24, 32, 5, 1, 6, 1), (32, 40, 5, 2, 6, 1),
        (40, 48, 3, 1, 6, 1)))
    gen = torch.Generator().manual_seed(0)
    net = NormalNet(torch.bfloat16, blocks=blocks, stem_ch=16, head_ch=64)
    nnet_lib.init_weights(net, gen)
    return NormalsTest(net), [torch.rand(1, 64, 64, 3, generator=gen) * 255]


@pytest.mark.parametrize("model", ["dispnet", "nnet", "raft3d"])
def test_exported_artifact_equals_eager_and_rejects_other_shapes(model,
                                                                 tmp_path):
    """DispNetS and RAFT3D through the export CLI, NormalNet (narrow)
    through ``save_artifact``. The loaded RAFT3D program calls each
    kernel's operator once an iteration, the others none."""
    from torch.profiler import ProfilerActivity, profile

    from sndepth_tpu_torch.cli import export_model
    from sndepth_tpu_torch.serving import export as sx
    if model == "nnet":
        module, inputs = _narrow_normal_net()
        art = sx.save_artifact(str(tmp_path / model), module, inputs, "cpu")
        module, inputs = _narrow_normal_net()
    else:
        art = export_model.main(["--model", model, "--device", "cpu",
                                 "--out_dir", str(tmp_path / model),
                                 "--img_height", "64", "--img_width", "64",
                                 "--iters", "1"])
        module, inputs = export_model.build(model, 1, 64, 64, iters=1)
    assert sorted(os.listdir(art)) == ["meta.json", "model.pt2"]
    fn, meta = sx.load_artifact(art)
    assert meta["device"] == "cpu"
    assert [s["shape"] for s in meta["inputs"]] == [list(x.shape)
                                                     for x in inputs]
    with torch.no_grad():
        want = module.eval()(*inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn(*inputs)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        fn(*[torch.zeros(2, *x.shape[1:]) for x in inputs])
    with pytest.raises(ValueError):
        fn(*inputs[:-1])
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith("sndepth::")}
    assert calls == ({"sndepth::warp_gather": 1, "sndepth::gn_build": 1}
                     if model == "raft3d" else {})


def test_custom_ops_keep_the_device_dispatch():
    """The operators' fake versions give the shapes ``torch.export``
    traces with; their CPU kernels are the plain versions (no launch
    counted); other devices raise as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from sndepth_tpu_torch.kernels import warp as K5
    from sndepth_tpu_torch.utils import tracing
    imgs, coords = torch.rand(2, 3, 8, 12), torch.rand(2, 2, 5, 7) * 8
    before = tracing.counts()
    torch.testing.assert_close(
        torch.ops.sndepth.warp_gather(imgs, coords, "zero_pad"),
        K5.warp_gather_reference(imgs, coords, "zero_pad"), rtol=0, atol=0)
    with FakeTensorMode() as mode:
        out = torch.ops.sndepth.warp_gather(mode.from_tensor(imgs),
                                            mode.from_tensor(coords),
                                            "edge_zero")
    assert out.shape == (2, 3, 5, 7)
    assert tracing.counts() == before
    with pytest.raises(ValueError):
        K5.warp_gather(imgs.to("meta"), coords.to("meta"), "zero_pad")


def _write_tree(root, n=3):
    import numpy as np
    from PIL import Image
    os.makedirs(os.path.join(root, "testing", "seq"))
    os.makedirs(os.path.join(root, "testing", "calib_cam_to_cam"))
    rng = np.random.RandomState(1)
    for i in range(n + 1):
        Image.fromarray(rng.randint(0, 255, (70, 90, 3), np.uint8)).save(
            os.path.join(root, "testing", "seq", f"{i:06d}.png"))
        with open(os.path.join(root, "testing", "calib_cam_to_cam",
                               f"{i:06d}.txt"), "w") as f:
            f.write(f"K_02: {50.0 + i} 0 32 0 {51.0 + i} 32 0 0 1\n")


def _submission_worker(rank, world, root):
    """The writer data-parallel over the group, then, on rank 0 at the same
    thread count, the one-process run."""
    import torch.distributed as dist

    from sndepth_tpu_torch.cli import kitti_submission
    args = ["--root", root, "--iters", "1", "--img_height", "64",
            "--img_width", "64", "--device", "cpu", "--max_frames", "3"]
    n = kitti_submission.main(args + ["--data_parallel", "--out_dir",
                                      os.path.join(root, "dp")])
    assert n == (2 if rank == 0 else 1), n
    dist.barrier()
    if rank == 0:
        assert kitti_submission.main(
            args + ["--out_dir", os.path.join(root, "one")]) == 3


def test_kitti_submission_data_parallel_writes_what_one_process_writes(
        tmp_path):
    from sndepth_tpu_torch.parallel.multihost import run_local_group
    root = str(tmp_path / "tree")
    _write_tree(root)
    run_local_group(_submission_worker, 2, str(tmp_path / "store"), root,
                    timeout_s=60.0)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    dp, one = os.path.join(root, "dp"), os.path.join(root, "one")
    assert files(dp) == files(one)
    assert len([f for f in files(one) if f.startswith("T")]) == 3
    for f in files(one):
        with open(os.path.join(dp, f), "rb") as a, \
                open(os.path.join(one, f), "rb") as b:
            assert a.read() == b.read(), f
