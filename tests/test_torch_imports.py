"""The PyTorch port stands without JAX, builds nothing at import, and its
chip smoke script refuses to run without a CUDA card."""

import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import voxelraytracing_tpu_torch
from voxelraytracing_tpu_torch import _build
from voxelraytracing_tpu_torch.ops import wavefront2 as t2
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            voxelraytracing_tpu_torch.__path__, "voxelraytracing_tpu_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax`` fails, every module of
    the port and ``chip_smoke.py`` import, and none of the JAX package is
    loaded; no import statement of ``chip_smoke.py`` names JAX or the JAX
    package."""
    mods = _port_modules()
    assert len(mods) >= 21, mods
    assert {"voxelraytracing_tpu_torch.ops.prng",
            "voxelraytracing_tpu_torch.ops.sky",
            "voxelraytracing_tpu_torch.ops.traverse",
            "voxelraytracing_tpu_torch.ops.wavefront2",
            "voxelraytracing_tpu_torch.ops.pathtrace3",
            "voxelraytracing_tpu_torch.ops.pathtrace4",
            "voxelraytracing_tpu_torch.ops.wavefront3",
            "voxelraytracing_tpu_torch.world.render_grid",
            "voxelraytracing_tpu_torch.experiments.v3_probe_prims",
            "voxelraytracing_tpu_torch.experiments.v3_probe_subgather",
            } <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'jaxlib', 'voxelraytracing_tpu')]\n"
        "print('loaded', len(sys.modules), 'bad', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|voxelraytracing_tpu)\b",
                         smoke, re.M)


def test_kernel_build_is_lazy_and_ieee():
    """Importing the port compiles nothing; every CUDA source builds with
    IEEE arithmetic (no FMA contraction, no fast math) for sm_90a, keyed
    on its source and the shared headers."""
    assert _build._libs == {}
    flags = " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in flags and "fast_math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    csrc = ROOT / "voxelraytracing_tpu_torch" / "csrc"
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(_build.KERNELS)
    assert set(_build.KERNELS) >= {"march2", "march3", "march4", "planes4",
                                   "shade4", "matfetch4", "pathtrace4",
                                   "probes3"}
    for name in _build.KERNELS:
        src, lib = _build.library_path(name)
        assert src.is_file() and lib.parent == ROOT / "build" / "kernels"
        # the march kernels share one header; the probes march nothing
        if name != "probes3":
            assert '#include "march4_common.cuh"' in src.read_text()
        for fn in _build._SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in src.read_text()
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()


def test_probes_import_without_jax():
    """The probe package imports in a fresh interpreter where ``import
    jax`` fails, builds nothing, names none of the JAX probe scripts'
    modules, and gives each of its six kernel wrappers a launch counter at
    0; its ``main()`` refuses to run without a card."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from voxelraytracing_tpu_torch import _build\n"
        "from voxelraytracing_tpu_torch.experiments import (\n"
        "    v3_probe_prims as pp, v3_probe_subgather as ps)\n"
        "ks = pp.KERNELS + ps.KERNELS\n"
        "assert [k.launches for k in ks] == [0] * 6, ks\n"
        "assert _build._libs == {}\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'voxelraytracing_tpu', 'experiments')]\n"
        "assert not bad, bad\n"
        "if not torch.cuda.is_available():\n"
        "    for main, argv in ((pp.main, ()), (ps.main, (['vec'],))):\n"
        "        try:\n"
        "            main(*argv)\n"
        "        except RuntimeError as e:\n"
        "            assert 'CUDA card' in str(e)\n"
        "        else:\n"
        "            sys.exit('main ran without a card')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_wrapper_refuses_other_devices():
    """Each wrapper runs its kernel on CUDA tensors, its plain version on
    CPU tensors, and raises on anything else."""
    meta = dict(device="meta")
    args = (torch.empty(43, **meta), torch.empty(2, 128, dtype=torch.int32, **meta),
            torch.empty(6, 128, **meta),
            torch.empty(64, 7, 128, dtype=torch.int32, **meta),
            torch.empty(1, 1, 128, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t4.march_fused4(*args, height=8, width=16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t4.march_planes4(args[0], args[1], *args[3:], height=8, width=16)
    plane = torch.empty(8, 16, **meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t4.shade4(args[0], args[2], plane, plane.int(), plane, plane, None)
    st = torch.empty(64, 128, **meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t3.march3(torch.empty(27, **meta),
                  torch.empty(1, t3.MC_ROWS, 128, dtype=torch.int32, **meta),
                  st, st.int(), st, st, nw=1, ns=4, nsx=1, sub_rounds=6)
    for sparse_ns in (0, 4):  # the sparse instantiations too
        with pytest.raises(ValueError, match="cuda or cpu"):
            t4.march_fused4(*args, height=8, width=16, sparse_ns=sparse_ns)
        with pytest.raises(ValueError, match="cuda or cpu"):
            t4.march_planes4(args[0], args[1], *args[3:], height=8, width=16,
                             sparse_ns=sparse_ns)


def test_entry_points_default_to_the_card():
    """Every entry point that builds or places data runs on the card
    unless the caller asks for the CPU (read from the signatures: a call
    here, without a card, would fail)."""
    import inspect

    from voxelraytracing_tpu_torch import convert
    from voxelraytracing_tpu_torch.ops import camera, wavefront, wavefront3
    from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

    for fn in (wavefront.build_render_grid_host, convert.render_grid_from_numpy,
               wavefront3.build_render_grid3_host,
               convert.render_grid3_from_numpy, convert.prepared_from_numpy,
               convert.prepared_sparse_from_numpy, camera.generate_rays_raw,
               camera.generate_rays, RenderGrid3Builder,
               wavefront3.empty_frame_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # helpers take the device of their caller's tensors
    tile_valid = inspect.signature(wavefront3._tile_valid).parameters
    assert tile_valid["device"].default is inspect.Parameter.empty


def test_v2_path_runs_on_its_grids_device():
    """The v2 march refuses devices other than CUDA and the CPU, and the
    v2 frame, the sky and the shade take the device of their inputs (no
    ``device`` argument that could default to the CPU)."""
    import inspect

    from voxelraytracing_tpu_torch.models import raytracer
    from voxelraytracing_tpu_torch.ops import sky

    meta = dict(device="meta")
    st = torch.empty(256, 128, **meta)
    cache = [torch.empty(1, 8, dtype=torch.int32, **meta),
             torch.empty(1, 8, 128, dtype=torch.int32, **meta),
             torch.empty(1, 8, 128, dtype=torch.int32, **meta),
             torch.empty(1, 64, dtype=torch.int32, **meta),
             torch.empty(1, 8, 128, dtype=torch.int32, **meta)]
    row = torch.empty(1, 128, dtype=torch.int32, **meta)
    state = [st.int() if k not in t2._FLOAT_PLANES else st for k in t2.STATE]
    with pytest.raises(ValueError, match="cuda or cpu"):
        t2.march2(torch.empty(8, **meta), st, st, st, row, row, *cache,
                  *state, sub_rounds=2, nb=2, bg_side=32)
    for fn in (t2.trace_wavefront2, sky.ray_sky, raytracer.shade_hits,
               raytracer.WavefrontRenderer.render):
        assert "device" not in inspect.signature(fn).parameters, fn


def test_chip_smoke_fails_without_the_port_or_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when it is
    alone in a directory, and, on a machine with no CUDA card, from the
    repository root too."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [tmp_path]
    if not torch.cuda.is_available():
        runs.append(ROOT)
    for cwd in runs:
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0, (cwd, r.stdout, r.stderr)
        assert '"ok"' not in r.stdout, (cwd, r.stdout)
