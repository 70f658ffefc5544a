"""Host ms a traced unit that the port takes to hand the unit's work to
the card: a train step's ``geonet#step`` span less its
``geonet#finite_sync`` wait, or a frame's ``uniad#frame`` span. Read from
the span table of ``sndepth_tpu_torch.utils.tracing``, which fills only
while the profiler records, over the traced units: a program without
those spans gives nothing."""


def read(r):
    if not r.trace:
        return None
    try:
        from sndepth_tpu_torch.utils.tracing import snapshot
    except ImportError:
        return None
    spans = snapshot()
    if "uniad#frame" in spans:
        seconds = spans["uniad#frame"][1]
    elif "geonet#step" in spans:
        seconds = (spans["geonet#step"][1]
                   - spans.get("geonet#finite_sync", (0, 0.0))[1])
    else:
        return None
    return seconds * 1e3 / r.trace["units"]
