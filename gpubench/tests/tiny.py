"""Tiny cells for the CPU tests: each cell of ``BENCHMARK.json`` with its
configuration and mix cut to a size a CPU run holds (a window of 2 or 4
chunks, 64x32 frames, a walk of 24 poses), run through the harness on the
port's plain versions."""

import time

import torch

from gpubench import inputs, run, traffic

_worlds = {}


def shrink(kind, d):
    if kind == "configs":
        # the path tracers' camera stands 30 voxels above the land: a window
        # of 4 chunks from the ground holds it
        d["window_chunks"] = 2 if d["window"] == "player" else 4
        d["resolution"] = [64, 32]
    elif kind == "traffic":
        d["warm_frames"] = 2
        d["trace_frames"] = 3
        d["check_frames"] = min(d["check_frames"], 3)
        if d["camera_path"]["kind"] == "walk":
            d["camera_path"]["poses"] = 24
            d["camera_path"]["radius"] = 6.0
    return d


def patch(monkeypatch):
    """Make the harness load tiny cells and share each tiny world."""
    load = traffic.load
    monkeypatch.setattr(traffic, "load", lambda kind, name: shrink(kind, load(kind, name)))
    make = inputs.make_world

    def world(cfg, device):
        key = (repr(sorted(cfg.items())), str(device))
        if key not in _worlds:
            _worlds[key] = make(cfg, device)
        return _worlds[key]

    monkeypatch.setattr(run, "make_world", world)


def run_tiny(monkeypatch, cell, seed=2**31 + 11, seconds=1.0, trace=False):
    patch(monkeypatch)
    torch.set_num_threads(1)
    bench = run.benchmark()
    return run.run_cell(run.find_cell(bench, cell), seed, seconds, trace, "cpu",
                        time.perf_counter(), bench)
