"""frame_mfu of a cell the host paces (the card idle over half the frame): the
same reading as ``frame_mfu``, under the name whose cells report
``frame_ms.host``."""

from gpubench.metrics.frame_mfu import read  # noqa: F401
