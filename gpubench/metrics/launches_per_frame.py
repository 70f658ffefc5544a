"""Device operations (kernel launches, copies, fills) a tracking frame,
from the trace of the traced frames."""

from gpubench.readers import launches_per_unit as read  # noqa: F401
