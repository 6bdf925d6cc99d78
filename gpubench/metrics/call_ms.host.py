"""call_ms of a cell the host paces (the card idle over half the frame): the
same reading as ``call_ms``, under the name whose cells report
``frame_ms.host``."""

from gpubench.metrics.call_ms import read  # noqa: F401
