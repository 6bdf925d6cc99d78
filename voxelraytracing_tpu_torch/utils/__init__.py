"""Profiling, tracing and logging of the port."""

from .profiling import FrameProfiler, device_memory_stats, device_trace, ray_stats

__all__ = ["FrameProfiler", "device_memory_stats", "device_trace", "ray_stats"]
