"""Host ms a traced step in the port's ``input#to_device`` span
(``data/prefetch.to_device``: contiguity, pinning and the non-blocking copy
of the batch the feed hands on): the program's own counterpart of
``input_wait_ms``. Read from the span table of
``sndepth_tpu_torch.utils.tracing``, which fills only while the profiler
records, over the traced steps: a program without that span gives
nothing."""


def read(r):
    if not r.trace:
        return None
    try:
        from sndepth_tpu_torch.utils.tracing import snapshot
    except ImportError:
        return None
    spans = snapshot()
    if "input#to_device" not in spans:
        return None
    return spans["input#to_device"][1] * 1e3 / r.trace["units"]
