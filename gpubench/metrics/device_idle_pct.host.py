"""device_idle_pct of a cell the host paces (the card idle over half the frame): the
same reading as ``device_idle_pct``, under the name whose cells report
``frame_ms.host``."""

from gpubench.metrics.device_idle_pct import read  # noqa: F401
