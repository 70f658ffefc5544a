"""The port's spans and launch counters (``utils/tracing.py``) and the
profile views that read them (``utils/profiling.py``), on the CPU: spans
record nothing with the profiler off; a stage-2 GeoNet step and a UniAD
frame record each of their spans as often as the program runs the phase (the
CPU path goes through the same kernel wrappers as the card's); a span's
device-side mirror adds no launch and no busy time."""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.prefetch import device_prefetch
from sndepth_tpu_torch.data.synthetic import synthetic_batches
from sndepth_tpu_torch.train import geonet
from sndepth_tpu_torch.utils import profiling, tracing
from sndepth_tpu_torch.utils.threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: beside the other test workers on the same cores,
    a wider pool only stretches every process."""
    with torch_threads(2):
        yield


def _profiled(fn):
    """Run ``fn()`` under the CPU profiler; the span table it left."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tracing.snapshot()


def _calls(table):
    return {name: calls for name, (calls, _) in table.items()}


@pytest.mark.parametrize("name", sorted(tracing.SPANS))
def test_every_span_name_holds_a_hash(name):
    layer, _, phase = name.partition("#")
    assert layer and phase and "#" not in phase


def test_spans_record_nothing_with_the_profiler_off():
    tracing.reset()
    off = tracing.span("geonet#step")
    assert tracing.span("geonet#step") is off
    with off:
        pass
    tracing.span("kernel#K1")(lambda: None)()
    assert tracing.snapshot() == {}
    with pytest.raises(KeyError):
        tracing.span("undeclared")


def test_a_span_on_another_thread_is_recorded():
    """Autograd's device thread runs the custom Functions' backward, and
    with it the sampler kernels' spans."""
    def work():
        def other():
            with tracing.span("kernel#K6"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with tracing.span("kernel#K6"):
            pass
    table = _profiled(work)
    assert _calls(table) == {"kernel#K6": 2}
    assert table["kernel#K6"][1] >= 0.0


def test_a_count_adds_to_its_kernel_alone():
    before = tracing.counts()
    assert tuple(before) == tracing.COUNTERS
    tracing.count("K5", 3)
    after = tracing.counts()
    assert after["K5"] == before["K5"] + 3
    assert {k: v for k, v in after.items() if k != "K5"} == {
        k: v for k, v in before.items() if k != "K5"}


# A stage-2 step's calls of each wrapper (PERF.md's launch table): K1 at
# scales 1-3, K2 at the 4 disparity and 8 flow smoothness calls, K3 at
# scale 0, K4 at 4 scales, K5b and K6 in the backward of the 10 gathers
# (K6 of the 8 whose images want a gradient), K7 forward and backward at
# the two scale-0 error maps.
FLOW_STEP = {"kernel#K1": 3, "kernel#K2": 12, "kernel#K3": 1,
             "kernel#K4": 4, "kernel#K5b": 10, "kernel#K6": 8,
             "kernel#K7": 2, "kernel#K7b": 2}
GEONET = ("geonet#step", "geonet#nets", "geonet#loss_tail",
          "geonet#backward", "geonet#finite_sync", "geonet#adam")


def test_a_stage2_step_records_each_span_as_often_as_it_runs():
    cfg = GeoNetConfig(batch_size=1, img_height=32, img_width=64,
                       compute_dtype=torch.float32, train_flow=True)
    state = geonet.create_train_state(cfg, "cpu")
    feed = device_prefetch(synthetic_batches(1, 32, 64),
                           torch.device("cpu"), size=1)

    def step():
        geonet.train_step(state, next(feed), cfg)
    table = _profiled(step)
    assert _calls(table) == {"input#to_device": 1,
                             **dict.fromkeys(GEONET, 1), **FLOW_STEP}
    total = table["geonet#step"][1]
    assert all(0.0 < s <= total for name, (_, s) in table.items()
               if name.startswith("geonet#"))
    assert state.step == 1


def test_a_uniad_frame_records_its_four_stages():
    from sndepth_tpu_torch.models import uniad_track
    from sndepth_tpu_torch.utils.uniad import surround_lidar2img
    model = uniad_track.UniADTrack(
        num_query=12, num_classes=3, embed_dims=32, bev_h=4, bev_w=4,
        num_cams=2, encoder_layers=1, decoder_layers=2,
        backbone_blocks=(1, 1, 1, 1), mem_len=2).eval()
    imgs = torch.rand(2, 1, 3, 32, 32, generator=torch.Generator()
                      .manual_seed(0))
    l2i = surround_lidar2img(32, 32, yaws=(0.0, 180.0))

    def frame():
        with torch.no_grad():
            model(imgs, l2i, model.init_state())
    table = _profiled(frame)
    assert _calls(table) == dict.fromkeys(
        ("uniad#frame", "uniad#backbone", "uniad#bev_encoder",
         "uniad#decoder", "uniad#tracker"), 1)


# Made-up profiler events for the profile views.


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    device_type: object
    time_range: Range
    id: int = 0

    @property
    def device_time(self):
        return self.time_range.end - self.time_range.start


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _profile(with_span: bool) -> list:
    """A step: an op launching two kernels, a sync, then an op launching a
    third, each launch a runtime call sharing its kernel's id; with
    ``with_span`` the step and its first part sit in spans, mirrored on the
    device."""
    events = [
        Event("aten::conv2d", CPU, Range(1, 10)),
        Event("cudaLaunchKernel", CPU, Range(2, 3), id=1),
        Event("cudaLaunchKernel", CPU, Range(4, 5), id=2),
        Event("cudaStreamSynchronize", CPU, Range(40, 70)),
        Event("aten::mul", CPU, Range(71, 75)),
        Event("cudaLaunchKernel", CPU, Range(72, 73), id=3),
        Event("gemm", CUDA, Range(5, 15), id=1),
        Event("fill", CUDA, Range(15, 20), id=2),
        Event("elementwise", CUDA, Range(80, 90), id=3)]
    if with_span:
        events += [Event("geonet#step", CPU, Range(0, 100)),
                   Event("geonet#nets", CPU, Range(0, 40)),
                   Event("geonet#step", CUDA, Range(5, 90)),
                   Event("geonet#nets", CUDA, Range(5, 20))]
    return events


def test_span_mirrors_add_no_launch_and_no_busy_time():
    plain, spanned = _profile(False), _profile(True)
    assert (profiling.device_kernels(Prof(spanned))
            == profiling.device_kernels(Prof(plain)))
    assert profiling.device_kernels(Prof(plain))[2] == 3
    assert profiling.busy_ms(spanned) == profiling.busy_ms(plain) == 0.025


def test_kernels_and_idle_gaps_by_span():
    events = _profile(True)
    copies = "elementwise and copies"
    assert profiling.by_span(events) == {
        "geonet#nets": {"ms": pytest.approx(0.015), "launches": 2,
                        "groups": {"convolutions": pytest.approx(0.010),
                                   copies: pytest.approx(0.005)}},
        "geonet#step": {"ms": pytest.approx(0.010), "launches": 1,
                        "groups": {copies: pytest.approx(0.010)}}}
    assert profiling.idle_by_span(events) == {
        "geonet#step / cudaStreamSynchronize": pytest.approx(0.060)}
    assert profiling.by_span(_profile(False))["(no span)"]["launches"] == 3


@pytest.mark.parametrize("name, group", [
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float>", "convolutions"),
    ("void internal::region_transform_ABC_val<int, 32>", "convolutions")])
def test_cudnn_fft_kernels_are_convolutions(name, group):
    assert profiling.group_of(name) == group
