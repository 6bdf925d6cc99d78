"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one or more CUDA devices. The cell names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``) in ``BENCHMARK.json``; the mix names the frame
entry (``entries/<entry>.py``), the metrics are readers in
``metrics/<metric>.py`` and the cell's limits are in ``cells/<cell>.json``.

A run makes the world from the configuration, hands its chunks to the
program's set-up, warms the mix's frames up and then, for ``--seconds``,
submits frames as fast as they complete with at most ``in_flight`` frames
in flight: before it submits frame N it waits only on the completion
event of frame N - in_flight. Once the window has closed it frees the
program, and the reference remakes a sample of the window's frames, drawn
from the seed, from the same inputs; ``correct`` says whether each frame's
number is within the cell's limit. With ``--trace 1`` the profiler records
the first ``trace_frames`` frames of the window and the result carries the
per-layer metrics instead of the end-to-end ones.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
# bytecode of every module this run imports is cached inside the checkout
sys.pycache_prefix = str(Path(__file__).resolve().parent.parent / "build" / "pycache")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import compare, traffic  # noqa: E402
from .inputs import ROOT, make_world, volume  # noqa: E402
from .reference import frames as ref_frames  # noqa: E402
from .reference.march import make_scene  # noqa: E402
from .trace import Trace, port_kernels  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "voxelraytracing_tpu")


def say(msg):
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(bench, cell, trace):
    """The (name, unit) of the metrics a run of ``cell`` reports."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append((m["name"], m["unit"]))
    return out


def reader(name):
    path = ROOT / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _HostEvent:
    """A completion mark on the CPU, where every op has finished when its
    call returns."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _mark(device):
    if torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return _HostEvent()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_frame(kind, draws, scene, world, cfg, frames, i, dtype=torch.float32):
    """The reference's frame ``i`` of the window and its work."""
    cam = frames.camera(i)
    common = dict(step_cap=cfg["step_cap"], sky_color=cfg["sky_color"],
                  sun_pos=frames.sun, sun_intensity=cfg["sun_intensity"],
                  dtype=dtype)
    if kind == "raster":
        return ref_frames.raster_frame(scene, cam, world.world_min,
                                       colors=world.materials.color, **common)
    if cfg["samples"] != 1:
        raise ValueError("the reference path tracer draws one sample a pixel")
    return ref_frames.path_frame(scene, cam, world.world_min,
                                 bounces=cfg["bounces"], key=frames.key(i),
                                 draws=draws, materials=world.materials, **common)


def run_cell(cell, seed, seconds, trace, device, t_start, bench):
    """One run of ``cell`` (a ``workloads`` entry) on ``device``; returns the
    result line's dict."""
    cfg = traffic.load("configs", cell["config"])
    mix = traffic.load("traffic", cell["traffic"])
    limits = traffic.load("cells", cell["name"])
    entry = importlib.import_module(f"gpubench.entries.{mix['entry']}")
    cuda = torch.device(device).type == "cuda"

    world = make_world(cfg, device)
    frames = traffic.Frames(mix, cfg, world, seed)
    say(f"world: {world.w}^3 chunks from {world.min_chunk.tolist()}, land "
        f"{world.land}, {world.n_features} features")
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = entry.setup(world, cfg, frames, device)
    _sync(device)
    say(f"program set up: {state.spans}")

    # the mix's own frames warm every shape the window uses
    warm = int(mix["warm_frames"])
    t_w = time.perf_counter()
    for i in range(warm):
        if i == warm // 2:
            _sync(device)
            t_w = time.perf_counter()
        out = entry.frame(state, frames.camera(i), frames.key(i))
    _sync(device)
    warm_ms = (time.perf_counter() - t_w) * 1e3 / (warm - warm // 2)
    n_safe = max(1, int(seconds * 1e3 / warm_ms / 2))
    k_trace = int(mix["trace_frames"]) if trace else 0
    if k_trace:
        # a traced run compares frames the profiler records, so that each
        # kernel's time and the work the reference finds are of one frame
        n_safe = min(n_safe, k_trace)
    sample = traffic.check_sample(mix, seed, n_safe)
    keep = {i: torch.empty_like(out) for i in sample}
    del out
    _sync(device)
    setup_s = time.perf_counter() - t_start
    say(f"warm frame {warm_ms:.3f} ms; set-up {setup_s:.2f} s; checking frames {sample}")

    # the set-up's objects leave the collector's generations, so its passes
    # in the window walk only what the window makes
    gc.collect()
    gc.freeze()
    in_flight = int(mix["in_flight"])
    prof, tr, span = None, None, (lambda name: contextlib.nullcontext())
    if k_trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.start()
        span = record_function
    marks, calls = [], []
    start = _mark(device)
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        if i >= in_flight:
            with span("frame.wait"):
                marks[i - in_flight].synchronize()
        c0 = time.perf_counter_ns()
        with span("frame.call"):
            out = entry.frame(state, frames.camera(i), frames.key(i))
        calls.append(time.perf_counter_ns() - c0)
        if i in keep:
            keep[i].copy_(out)
        marks.append(_mark(device))
        i += 1
        if prof is not None and i == k_trace:
            _sync(device)
            prof.stop()
            tr = Trace(prof.profiler.kineto_results.events(), i)
            prof = None
    marks[-1].synchronize()
    if prof is not None:
        _sync(device)
        prof.stop()
        tr = Trace(prof.profiler.kineto_results.events(), i)
    gc.unfreeze()
    n = len(marks)
    window_ms = start.elapsed_time(marks[-1])
    intervals = np.array([start.elapsed_time(marks[0])]
                         + [marks[j - 1].elapsed_time(marks[j]) for j in range(1, n)])
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    say(f"window: {n} frames in {window_ms:.1f} ms")

    spans = dict(state.spans)
    entry.free(state)
    del state, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    t_ref = time.perf_counter()
    scene = make_scene(volume(world, device), world.materials.is_liquid, world.v)
    kind = entry.REFERENCE
    draws = getattr(entry, "DRAWS", None)
    numbers, works = [], []
    for j in sample:
        if j >= n:
            continue
        ref, work = reference_frame(kind, draws, scene, world, cfg, frames, j)
        numbers.append(compare.off_pct(kind, keep[j], ref))
        work.frame = j
        works.append(work)
        del ref
    del scene
    say(f"reference: {len(numbers)} frames in {time.perf_counter() - t_ref:.1f} s")
    limit = float(limits["px_off_pct"]["limit"])
    worst = max(numbers) if numbers else float("nan")
    failed = sum(1 for x in numbers if not x <= limit)
    correct = bool(numbers) and failed == 0

    # the frames the profiler did not record; the first of them also waited
    # while the trace was read
    untraced = slice(k_trace + 1, n) if k_trace and n - k_trace > 10 else slice(0, n)
    ctx = SimpleNamespace(
        cell=cell, cfg=cfg, mix=mix, kind=kind, frames=n, window_ms=window_ms,
        intervals_ms=intervals, setup_s=setup_s, spans=spans,
        calls_ms=np.array(calls[untraced], dtype=np.float64) / 1e6,
        intervals_untraced_ms=intervals[untraced],
        frame_ms_untraced=float(np.mean(intervals[untraced])),
        trace=tr, works=works, kernels=port_kernels() if tr else set())
    metrics = {}
    for name, unit in metrics_of(bench, cell["name"], trace):
        v = reader(name)(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["compared"] = {"px_off_pct": {"value": worst, "limit": limit}}
    return result


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process with few threads: the frame loop's host work is the
    # program's, and runs on the same two cores in every run
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cores[1:3]) or set(cores))
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START, bench)
    found = loaded_forbidden()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
