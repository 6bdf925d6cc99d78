"""torch_ops_ms of a cell the host paces (the card idle over half the frame): the
same reading as ``torch_ops_ms``, under the name whose cells report
``frame_ms.host``."""

from gpubench.metrics.torch_ops_ms import read  # noqa: F401
