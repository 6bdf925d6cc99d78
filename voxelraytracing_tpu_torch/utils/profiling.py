"""Tracing & profiling utilities.

Port of ``voxelraytracing_tpu/utils/profiling.py``. The reference's
observability is an fps counter and a step-count heatmap (SURVEY §5). The
port adds: a ``torch.profiler`` trace of the card (a Chrome trace file),
per-section host timers, device memory stats, and ray statistics reduced
from trace results (mean/max march steps, the step-uniformity proxy for
wasted lanes, SURVEY §7).
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch


def trace_path(log_dir):
    """The Chrome trace file :func:`device_trace` writes into ``log_dir``."""
    return os.path.join(log_dir, "trace.json")


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace the host and, when a card is present, its kernels and copies
    with ``torch.profiler``; on exit write a Chrome trace (viewable in
    Perfetto or ``chrome://tracing``) to :func:`trace_path` of ``log_dir``
    (default: ``voxeltpu_torch_trace`` in the temporary directory). Yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "voxeltpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path(log_dir))


class FrameProfiler:
    """Named host-side section timers with rolling averages."""

    def __init__(self, window=120):
        self.window = window
        self.samples = {}

    @contextlib.contextmanager
    def section(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            buf = self.samples.setdefault(name, [])
            buf.append(dt)
            if len(buf) > self.window:
                del buf[: len(buf) - self.window]

    def summary(self):
        return {
            name: {
                "mean_ms": 1e3 * float(np.mean(buf)),
                "last_ms": 1e3 * buf[-1],
                "max_ms": 1e3 * float(np.max(buf)),
            }
            for name, buf in self.samples.items()
            if buf
        }


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ray_stats(trace_result):
    """March statistics of a TraceResult/WavefrontResult (tensors on any
    device, or arrays)."""
    steps = _host(trace_result.steps)
    hit = _host(trace_result.hit)
    return {
        "rays": int(steps.size),
        "hit_fraction": float(hit.mean()),
        "steps_mean": float(steps.mean()),
        "steps_max": int(steps.max()),
        "steps_p99": float(np.percentile(steps, 99)),
        # lane-waste proxy: mean/max step ratio — 1.0 means perfectly
        # uniform work per ray, small values mean divergence
        "step_uniformity": float(steps.mean() / max(int(steps.max()), 1)),
    }


def device_memory_stats():
    """Memory of each CUDA device (``torch.cuda.memory_stats`` for what
    torch holds, ``mem_get_info`` for the card's free and total bytes);
    without a card, one CPU entry with what torch can tell (nothing)."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_free": free,
            "bytes_limit": total,
        })
    return out
