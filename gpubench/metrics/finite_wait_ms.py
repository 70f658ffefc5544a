"""Host ms a traced step blocked in the port's ``geonet#finite_sync`` span
(``train/geonet.train_step``'s ``bool(finite)``, the step's one wait for
the card): how far the host's issue of the step runs ahead of the card;
near 0, the card waits on the host. Read from the span table of
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
    if "geonet#finite_sync" not in spans:
        return None
    return spans["geonet#finite_sync"][1] * 1e3 / r.trace["units"]
