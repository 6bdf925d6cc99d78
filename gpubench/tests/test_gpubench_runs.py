"""Tiny cells run end to end on the CPU through the port's plain versions:
the reference agrees with them, each planted fault and the control read
not correct, and the run loads neither JAX nor the JAX package."""

import json
import subprocess
import sys

import pytest
import torch

from gpubench import compare, inputs, run, traffic
from gpubench.inputs import ROOT
from gpubench.reference.march import make_scene

from .tiny import patch, run_tiny

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# the port function each entry calls, where a fault is planted
TIMED = {
    "raster_fused": ("voxelraytracing_tpu_torch.ops.wavefront4", "render_frame4"),
    "pathtrace_v4": ("voxelraytracing_tpu_torch.ops.pathtrace3", "path_trace3"),
    "pathtrace_fused": ("voxelraytracing_tpu_torch.ops.pathtrace4", "path_trace_fused4"),
}


def entry_of(cell):
    name = cell.split(".")[1]
    return json.loads((ROOT / "gpubench" / "traffic" / f"{name}.json").read_text())["entry"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_and_agrees_with_the_reference(monkeypatch, cell, trace):
    res = run_tiny(monkeypatch, cell, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "compared"
    assert res["compared"]["px_off_pct"]["value"] <= res["compared"]["px_off_pct"]["limit"]
    bench = run.benchmark()
    names = {n for n, _ in run.metrics_of(bench, cell, trace)}
    if trace:
        # the CPU has no device trace: only the host's metrics read
        got = set(res["metrics"])
        assert got <= names and {n.split(".")[0] for n in got} >= {"call_ms", "frame_mfu"}
    else:
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())


def _fault(kind, out, prev):
    img = out[0] if isinstance(out, tuple) else out
    if kind == "stale":          # the frame returned unchanged from the last call
        bad = img if prev[0] is None else prev[0]
        prev[0] = img
    elif kind == "half":         # half of the frame left out
        bad = img.clone()
        bad[img.shape[0] // 2:] = 0
    else:                        # the answer altered where it is produced
        bad = img.flip(-1) if img.dim() == 3 else (img ^ 0x00FF00FF)
    return (bad,) + out[1:] if isinstance(out, tuple) else bad


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_read_not_correct(monkeypatch, cell, fault):
    import importlib

    mod_name, fn_name = TIMED[entry_of(cell)]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, fn_name)
    prev = [None]

    def broken(*a, **k):
        return _fault(fault, real(*a, **k), prev)

    monkeypatch.setattr(mod, fn_name, broken)
    res = run_tiny(monkeypatch, cell, seconds=1.0)
    assert not res["correct"] and res["failed"] >= 1


def control_numbers(cell, seeds, device):
    """The control's number on each seed: the reference computed in
    bfloat16 (the precision below the configurations' float32) in the
    program's place, against the reference in float32, on the frames a run
    of that seed compares (at most two a seed)."""
    bench = run.benchmark()
    w = run.find_cell(bench, cell)
    cfg = traffic.load("configs", w["config"])
    mix = traffic.load("traffic", w["traffic"])
    entry = __import__(f"gpubench.entries.{mix['entry']}", fromlist=["x"])
    world = run.make_world(cfg, device)
    scene = make_scene(inputs.volume(world, device), world.materials.is_liquid, world.v)
    out = []
    for seed in seeds:
        frames = traffic.Frames(mix, cfg, world, seed)
        worst = 0.0
        for i in traffic.check_sample(mix, seed, 64)[:2]:
            args = (entry.REFERENCE, getattr(entry, "DRAWS", None), scene, world, cfg, frames, i)
            ref = run.reference_frame(*args)[0]
            low = run.reference_frame(*args, dtype=torch.bfloat16)[0]
            low = low.float() if low.is_floating_point() else low
            worst = max(worst, compare.off_pct(entry.REFERENCE, low, ref))
        out.append(worst)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct_at_test_size(monkeypatch, cell):
    patch(monkeypatch)
    limit = traffic.load("cells", cell)["px_off_pct"]["limit"]
    got = control_numbers(cell, [2**31 + 5, 3, 77], "cpu")
    print(f"{cell}: control px_off_pct {got} against limit {limit}")
    assert min(got) > limit


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct_at_cell_size(card, cell):
    limit = traffic.load("cells", cell)["px_off_pct"]["limit"]
    got = control_numbers(cell, [2**31 + 7, 12345, 987654321], "cuda")
    print(f"{cell}: control px_off_pct {got} against limit {limit}")
    assert min(got) > limit


_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, {root!r})
written = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        mode, flags = args[1] or "", args[2] or 0
        if any(c in str(mode) for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            written.append(os.path.abspath(os.fsdecode(args[0])))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove"):
        written.append(os.path.abspath(os.fsdecode(args[0])))
sys.addaudithook(hook)
import pytest
from gpubench.tests.tiny import run_tiny
mp = pytest.MonkeyPatch()
res = run_tiny(mp, {cell!r}, seconds=0.3)
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "modules": top, "written": written}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax_and_writes_only_its_own_places(tmp_path, cell):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path / "home"),
           "XDG_CACHE_HOME": str(tmp_path / "cache"), "TMPDIR": str(tmp_path / "tmp"),
           "OMP_NUM_THREADS": "1", "PYTHONPYCACHEPREFIX": str(tmp_path / "tmp" / "pyc")}
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        (tmp_path / env[k].rsplit("/", 1)[1]).mkdir()
    p = subprocess.run([sys.executable, "-c", _CHILD.format(root=str(ROOT), cell=cell)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not {"jax", "jaxlib", "flax", "voxelraytracing_tpu"} & set(got["modules"])
    allowed = (str(ROOT) + "/", str(tmp_path) + "/")
    assert [w for w in got["written"] if not w.startswith(allowed) and w != "/dev/null"] == []
    assert not any(w.startswith("/dev/shm") for w in got["written"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import gpubench.reference.frames, gpubench.reference.march, "
            "gpubench.compare, gpubench.inputs, gpubench.traffic, gpubench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not {"voxelraytracing_tpu_torch", "voxelraytracing_tpu", "jax"} & top


def test_reference_march_steps_agree_with_the_plain_semantics():
    """The reference's hit ids are the voxels at its hit points, and a camera
    outside the world traces nothing."""
    from gpubench.camera import camera
    from gpubench.reference import frames

    cfg = shrink_cfg()
    world = inputs.make_world(cfg, "cpu")
    scene = make_scene(inputs.volume(world, "cpu"), world.materials.is_liquid, world.v)
    x, h, z = world.land
    cam = camera((30.0, 45.0, 0.0), (x + 0.5, h + 6.0, z + 0.5), 70.0, (64, 32))
    o, d = frames.camera_rays(cam, world.world_min, torch.float32, "cpu")
    leg = frames.march(scene, o, d, frames.traced(cam, world.world_min, world.v, "cpu"), 500)
    assert bool(leg.hit.any())
    hi = torch.nonzero(leg.hit).squeeze(1)
    q = [torch.floor(o[k][hi] + d[k][hi] * leg.t[hi]).long() for k in range(3)]
    ids = scene.ids[q[0], q[1], q[2]]
    assert bool((ids.int() == leg.vox[hi]).all()) and bool((ids != 0).all())
    far = camera((0.0, 0.0, 0.0), (-1e4, 0.0, 0.0), 70.0, (64, 32))
    assert not bool(frames.traced(far, world.world_min, world.v, "cpu").any())


def shrink_cfg():
    from .tiny import shrink

    return shrink("configs", traffic.load("configs", "client30"))
