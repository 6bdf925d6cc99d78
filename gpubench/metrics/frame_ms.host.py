"""The time a frame of a cell the host paces (the card idle over half the
frame): the same reading as ``frame_ms``, bounded apart because the
host's speed spreads its runs several times wider."""

from gpubench.metrics.frame_ms import read  # noqa: F401
