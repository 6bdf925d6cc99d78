"""device_ops_per_frame of a cell the host paces (the card idle over half the frame): the
same reading as ``device_ops_per_frame``, under the name whose cells report
``frame_ms.host``."""

from gpubench.metrics.device_ops_per_frame import read  # noqa: F401
