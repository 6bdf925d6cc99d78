"""Reading a traced window: the device's kernels and copies, and the
harness's spans on the host, from ``torch.profiler`` (CUPTI).

The reading of raw events follows ``chip_smoke.py``'s ``device_events`` and
``device_work`` (commit 5046bbb1c27cf55a0e0985dd2724f80b90766057): the
profiler's kineto events, device events by ``DeviceType.CUDA``, their
summed durations as device time (one stream, so they do not overlap; the
busy time here is their union all the same).
"""

import re
from pathlib import Path

from .inputs import ROOT

SPANS = ("frame.call", "frame.wait")   # the harness's host spans


def port_kernels():
    """The names of the program's hand-written CUDA kernels (each
    ``__global__`` function of its ``csrc/``)."""
    names = set()
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__\w+__\s*(?:\([^)]*\))?\s*)*"
                     r"(?:void\s+)?(\w+)\s*\(", re.S)
    for src in sorted(Path(ROOT, "voxelraytracing_tpu_torch", "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    names.discard("void")
    return names


class Trace:
    """A traced window of ``frames`` frames: ``device`` [(name, start_ns,
    end_ns)] sorted by start, ``host`` the same of CPU events (the
    harness's spans and the ops inside them), ``t0``/``t1`` the window
    (the first frame's call to the last device event's end)."""

    def __init__(self, events, frames):
        from torch.autograd import DeviceType

        self.frames = frames
        self.device, self.host = [], []
        for e in events:
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if rec[0] not in SPANS:   # the spans' own marks on the device's timeline
                    self.device.append(rec)
            elif e.device_type() == DeviceType.CPU:
                self.host.append(rec)
        self.device.sort(key=lambda r: r[1])
        self.host.sort(key=lambda r: r[1])
        calls = [r for r in self.host if r[0] == SPANS[0]]
        self.t0 = calls[0][1] if calls else (self.device[0][1] if self.device else 0)
        self.t1 = max((r[2] for r in self.device), default=self.t0)
        self.device = [r for r in self.device if r[2] > self.t0]

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    def busy_s(self):
        """Seconds in which a kernel or copy ran (the union)."""
        busy, end = 0, self.t0
        for _, s, e in self.device:
            s = max(s, end)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e9

    def frame_ms(self, match, frames):
        """Device ms of the launches whose name holds ``match`` in each of
        ``frames`` (indices of the traced frames, each making the same
        number of them), or None where the trace does not hold them."""
        ev = [e - s for n, s, e in self.device if match in n]
        per, rest = divmod(len(ev), self.frames)
        if not per or rest:
            return None
        return [sum(ev[j * per:(j + 1) * per]) / 1e6 if j < self.frames else None
                for j in frames]

    def ops_ms(self, exclude):
        """Device ms of the events that are none of the kernels ``exclude``."""
        return sum(e - s for n, s, e in self.device
                   if not any(k in n for k in exclude)) / 1e6

    def top_ops(self, n=10):
        """The device operations that took most time: [[name, seconds]]."""
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """Idle time of the device, by what the host was doing when each gap
        began: the harness span (or none) and the innermost host op then
        running, summed; [[label, seconds]], the largest first."""
        by = {}
        hosts = self.host
        j = 0
        open_ = []
        prev_end = self.t0
        for _, s, e in self.device + [("", self.t1, self.t1)]:
            if s > prev_end:
                while j < len(hosts) and hosts[j][1] <= prev_end:
                    open_.append(hosts[j])
                    j += 1
                open_ = [h for h in open_ if h[2] > prev_end]
                span = next((h[0] for h in open_ if h[0] in SPANS), "harness")
                inner = [h for h in open_ if h[0] not in SPANS]
                label = span + (f"/{inner[-1][0]}" if inner else "")
                by[label] = by.get(label, 0) + (s - prev_end)
            prev_end = max(prev_end, e)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
