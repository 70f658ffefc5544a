"""Device operations (kernel launches, copies, fills) a train step, from
the trace of the traced steps."""

from gpubench.readers import launches_per_unit as read  # noqa: F401
