"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` (beside the package; listed in ``.gitignore``), keyed on
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
and loaded with ``ctypes``. Nothing is compiled when the package is
imported, so the CPU tests import every module on machines without
``nvcc``.

The flags keep IEEE arithmetic: ``--fmad=false`` stops ``a*b+c`` from
contracting into an FMA, so every multiply and add rounds on its own as
in the plain PyTorch versions; ``--use_fast_math`` is never passed.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (restype, argtypes); pointers and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
_SIGNATURES = {
    "march2": {
        "march2_launch": (_I, [_P] * 34 + [_I] * 4 + [_P]),
    },
    "march3": {
        "march3_launch": (_I, [_P] * 13 + [_I] * 7 + [_P]),
    },
    "march4": {
        "march_fused4_launch": (_I, [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
    },
    "planes4": {
        "touched4_launch": (_I, [_P] * 5 + [_I] * 2 + [_P]),
        "march_planes4_launch": (_I, [_P] * 12 + [_I] * 6 + [_P]),
    },
    "shade4": {
        "shade4_launch": (_I, [_P] * 8 + [_I] * 3 + [_F, _P]),
    },
    "matfetch4": {
        "matfetch4_launch": (_I, [_P] * 3 + [_I, _P]),
    },
    "pathtrace4": {
        "pt4_launch": (_I, [_P] * 6 + [_I] * 7 + [_F, _P]),
    },
    "probes3": {
        "gather_rows_smem_launch": (_I, [_P] * 3 + [_I, _P]),
        "gather_rows_async_launch": (_I, [_P] * 3 + [_I] * 2 + [_P]),
        "extract_sum_launch": (_I, [_P] * 3),
        "pass7_launch": (_I, [_P] * 14 + [_I, _P]),
        "col_gather_launch": (_I, [_P] * 3 + [_I, _P]),
        "row_loop_launch": (_I, [_P] * 3 + [_I, _P]),
        "empty_launch": (_I, [_P]),
    },
}
KERNELS = tuple(_SIGNATURES)

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin, then PATH, then the default
    toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, keyed on its source, the shared
    headers and the flags."""
    src = _PKG / "csrc" / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. The compiler's output (``-Xptxas -v``: registers, spills)
    is kept beside it as ``.log``."""
    src, out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stdout}{r.stderr}")
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def build_log(name):
    """The compiler output kept by :func:`build` ("" before a build)."""
    log = library_path(name)[1].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
