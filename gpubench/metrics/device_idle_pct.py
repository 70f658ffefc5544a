"""Share of a step or frame with no device operation running: the
device's busy time a unit in the trace against the untraced window's mean
unit time, %."""

from gpubench.readers import idle_pct as read  # noqa: F401
