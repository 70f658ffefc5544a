"""The port's tracing: named spans on the profiler's clock, and the kernel
launch counters.

**Spans.** ``with span("geonet#backward"):`` (or ``@span(name)`` on a
function) marks a phase of the program. A span is off unless
``torch.profiler`` is recording: it then costs one attribute read and a
shared no-op object. While the profiler records, a span enters
``torch.profiler.record_function(name)``, so that it is an event of the same
profile as the kernels it launches, and adds its call and its inclusive host
seconds to this module's table (:func:`snapshot`, :func:`reset`). The table
is safe to update from autograd's device thread, which runs the custom
Functions' backward.

Every span is declared in :data:`SPANS`, and every name holds a ``#``,
``<layer>#<phase>``: the profiler mirrors a host annotation on the device,
and the device-side readers (``utils/profiling.device_kernels``, the
benchmark's trace reduction) drop every device event whose name holds one.
A name without it would count as a launch and add its whole extent, idle
gaps included, to the device's busy time.

**Counters.** ``count("K5", n)`` adds the launches of a hand-written kernel
where the CUDA launch happens; always on (one integer add). ``counts()``
reads them. Between two calls of the port they only grow: a reader takes
the difference of two readings.
Three more count how ``train/geonet.train_step`` ran a step: captured as
CUDA graphs (``graph_captures``), replayed from them (``graph_replays``) or
issued op by op (``eager_steps``). A replay runs no Python: on a replayed
step the kernels' counts are copied from the capture (which launched
nothing, and takes back what it counted), not measured; a test on the card
holds them against a profile of the replay's device kernels.
"""

from __future__ import annotations

import functools
import threading
import time

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

# Every span of the port: name -> what it holds. The benchmark's readers and
# ``cli/profile_step.py`` read them by these names.
SPANS = {
    "input#to_device": "data/prefetch.to_device: contiguity, pinning and "
                       "the non-blocking copy of one batch",
    "geonet#step": "train/geonet.train_step, the whole step",
    "geonet#nets": "geonet_forward: DispNetS and PoseNet",
    "geonet#loss_tail": "geonet_loss_tail: the rigid losses, and in stage "
                        "2 FlowNet and the full-flow losses",
    "geonet#backward": "total.backward()",
    "geonet#finite_sync": "bool(finite): the host waits for the card",
    "geonet#adam": "optimizer.step(), or its graph's replay",
    "geonet#capture": "the capture of the step's or Adam's graph: their "
                      "Python runs and the card executes nothing",
    "geonet#replay": "the batch's copy into the graph's inputs and the "
                     "replay of the step's graph",
    "kernel#K1": "kernels/photo_loss.photo_pair_sums",
    "kernel#K2": "kernels/smooth_loss.smooth_sums",
    "kernel#K3": "kernels/photo_loss.photo_sums",
    "kernel#K4": "kernels/photo_loss.photo_pair_weighted_sums",
    "kernel#K5b": "kernels/warp.warp_coord_grad",
    "kernel#K6": "kernels/warp.warp_splat",
    "kernel#K7": "kernels/dssim.dssim_forward",
    "kernel#K7b": "kernels/dssim.dssim_backward",
    "kernel#K8b": "kernels/gn_build.gn_build_hg_bwd",
    "uniad#frame": "models/uniad_track.UniADTrack.forward, the whole frame",
    "uniad#backbone": "extract_img_feat: R101-DCN and FPN",
    "uniad#bev_encoder": "get_bev_features: the BEV encoder",
    "uniad#decoder": "get_detections: the detection decoder",
    "uniad#tracker": "tracker_update, the memory bank, QIM, nms_free_decode",
}

# The hand-written kernels' launch counters (K5's gather and K8 are the
# operators ``sndepth::warp_gather`` and ``sndepth::gn_build``: a profile
# names them already, so they are counted here and carry no span), then
# the GeoNet step's: graphs captured, steps replayed, steps run eagerly.
COUNTERS = ("K1", "K2", "K3", "K4", "K5", "K5b", "K6", "K7", "K7b", "K8",
            "K8b", "graph_captures", "graph_replays", "eager_steps")

_table: dict[str, list] = {}
_lock = threading.Lock()
_counts = dict.fromkeys(COUNTERS, 0)


class _Off:
    """A span while the profiler is off: one shared object a name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(self.name):
                return fn(*args, **kwargs)
        return spanned


class _Span(_Off):
    """A span while the profiler records."""

    __slots__ = ("_rf", "_t0")

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        with _lock:
            entry = _table.setdefault(self.name, [0, 0.0])
            entry[0] += 1
            entry[1] += seconds
        return False


_OFF = {name: _Off(name) for name in SPANS}


def span(name: str):
    """The span ``name`` (a key of :data:`SPANS`) as a context manager, or
    as a decorator of a function whose every call it holds."""
    off = _OFF[name]
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return off


def snapshot() -> dict:
    """{span: (calls, inclusive host seconds)} recorded since the last
    :func:`reset`, while the profiler recorded."""
    with _lock:
        return {name: (calls, seconds)
                for name, (calls, seconds) in _table.items()}


def reset() -> None:
    """Empty the span table."""
    with _lock:
        _table.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (in :data:`COUNTERS`)."""
    _counts[name] += n


def counts() -> dict:
    """{counter: its count since the process started}."""
    return dict(_counts)
