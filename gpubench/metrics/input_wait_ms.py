"""Host time the loop waits in next() on device_prefetch (the pinned copy
of each numpy batch to the card), the benchmark's own host span around each
step's call, mean over the window's steps, ms."""

from gpubench.readers import span_mean_ms


def read(r):
    return span_mean_ms(r, "input_wait")
