"""ctypes bindings for the native host runtime (``native/svo_core.cpp``).

Port of ``voxelraytracing_tpu/core/native.py``. The port keeps its own
copy of the C++ source in its package (``voxelraytracing_tpu_torch/native/``)
and builds it at first use with the system toolchain (g++) into
``build/native/`` beside the package (listed in ``.gitignore``), keyed on a
hash of the source and the flags. The build writes a temporary file and
``os.replace``s it into place while it holds a file lock, so a process
never loads a half-written library, and two processes (test workers) never
build the same library at once. The JAX package's ``native/libsvo_core.so``
is never touched.

When g++ is missing the callers take the NumPy twins, as the JAX package
does (``available()`` is False); behaviour is identical.

API:
  available() -> bool
  NativeAlloc(used_end, end)           — group-of-8 free-list allocator
  set_node(nodes, alloc, pos, voxel, depth) -> bool (False = OOM)
  get_voxel(nodes, pos) -> int
  svo_to_dense(nodes) -> uint16[32,32,32]
  dense_to_svo(grid, cap) -> (int32[n], n) — word for word the device
    builder's layout (ops/svo_build.py)
  dense_to_svo_batch(grids, cap) -> (int32[B,cap], int64[B])
  hist256_u8(ids) -> int32[R,256]
  sw_rows_build(rg_rows, n_liquid, to_pack) -> dict (world/render_grid.py)
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .constants import CHUNK_DEPTH, CHUNK_SIZE, NODES_PER_CHUNK

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "svo_core.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """Where the port's copy of ``svo_core.cpp`` builds to, keyed on its
    source and the flags."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsvo_core-{key.hexdigest()[:16]}.so"


def build():
    """Compile the library unless it exists; returns its path. Holds an
    exclusive lock on ``build/native/lock`` while it checks and builds;
    the compiler writes a name of this process's own, renamed into place
    when complete."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                                str(SOURCE)], check=True, capture_output=True)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError):
            return None

        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

        lib.svo_alloc_new.restype = ctypes.c_void_p
        lib.svo_alloc_new.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.svo_alloc_delete.restype = None
        lib.svo_alloc_delete.argtypes = [ctypes.c_void_p]
        lib.svo_alloc_last_used.restype = ctypes.c_int64
        lib.svo_alloc_last_used.argtypes = [ctypes.c_void_p]
        lib.svo_alloc_total_free.restype = ctypes.c_int64
        lib.svo_alloc_total_free.argtypes = [ctypes.c_void_p]
        lib.svo_set_node.restype = ctypes.c_int
        lib.svo_set_node.argtypes = [
            i32p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int32, ctypes.c_int,
        ]
        lib.svo_get_voxel.restype = ctypes.c_int32
        lib.svo_get_voxel.argtypes = [i32p, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float]
        lib.svo_to_dense.restype = None
        lib.svo_to_dense.argtypes = [i32p, u16p]
        lib.dense_to_svo.restype = ctypes.c_int64
        lib.dense_to_svo.argtypes = [u16p, i32p, ctypes.c_int64]
        lib.dense_to_svo_batch.restype = None
        lib.dense_to_svo_batch.argtypes = [
            u16p, ctypes.c_int64, i32p, ctypes.c_int64, i64p,
        ]
        lib.hist256_u8.restype = None
        lib.hist256_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.sw_rows_build.restype = None
        lib.sw_rows_build.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, i32p,
            u32p, u32p, u32p, u32p, u8p, u8p, u8p, i32p,
        ]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native svo_core unavailable (g++ failed)")
    return lib


class NativeAlloc:
    """Native group-of-8 free-list allocator (NodeAlloc semantics)."""

    def __init__(self, used_end, end):
        self._lib = _require()
        self._h = self._lib.svo_alloc_new(int(used_end), int(end))

    @property
    def last_used_addr(self):
        return int(self._lib.svo_alloc_last_used(self._h))

    def total_free_mem(self):
        return int(self._lib.svo_alloc_total_free(self._h))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h is not None:
            lib.svo_alloc_delete(h)
            self._h = None


def set_node(nodes, alloc: NativeAlloc, pos, voxel, depth=CHUNK_DEPTH):
    """In-place SVO write into ``nodes`` (int32, C-contiguous); returns
    False on out-of-memory."""
    lib = _require()
    rc = lib.svo_set_node(
        nodes, alloc._h, float(pos[0]), float(pos[1]), float(pos[2]),
        int(voxel), int(depth),
    )
    return rc == 0


def get_voxel(nodes, pos):
    lib = _require()
    nodes = np.ascontiguousarray(nodes, dtype=np.int32)
    return int(lib.svo_get_voxel(nodes, float(pos[0]), float(pos[1]),
                                 float(pos[2])))


def svo_to_dense(nodes):
    lib = _require()
    nodes = np.ascontiguousarray(nodes, dtype=np.int32)
    out = np.empty((CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE), dtype=np.uint16)
    lib.svo_to_dense(nodes, out)
    return out


def _grids_u16(grids, shape):
    grids = np.ascontiguousarray(grids, dtype=np.uint16)
    if grids.shape[-3:] != (CHUNK_SIZE,) * 3 or grids.ndim != len(shape):
        raise ValueError(f"grid shape {grids.shape}, want {shape}")
    return grids


def dense_to_svo(grid, cap=NODES_PER_CHUNK):
    lib = _require()
    grid = _grids_u16(grid, (CHUNK_SIZE,) * 3)
    out = np.zeros(cap, dtype=np.int32)
    n = int(lib.dense_to_svo(grid, out, cap))
    if n < 0:
        raise MemoryError("chunk exceeds node capacity")
    return out[:n], n


def dense_to_svo_batch(grids, cap=NODES_PER_CHUNK):
    """``uint16[B,32,32,32] -> (int32[B,cap], int64[B])`` — the host batch
    builder."""
    lib = _require()
    grids = _grids_u16(grids, (None,) + (CHUNK_SIZE,) * 3)
    b = grids.shape[0]
    out = np.zeros((b, cap), dtype=np.int32)
    counts = np.zeros(b, dtype=np.int64)
    lib.dense_to_svo_batch(grids.reshape(b, -1), b, out.reshape(-1), cap,
                           counts)
    if (counts < 0).any():
        raise MemoryError("chunk exceeds node capacity")
    return out, counts


def hist256_u8(ids):
    """``uint8[R, L] -> int32[R, 256]`` per-row histogram (the palette
    pass's count step; ``ops/wavefront3.build_sw_palettes``)."""
    lib = _require()
    ids = np.ascontiguousarray(ids, dtype=np.uint8)
    r, length = ids.shape
    out = np.empty((r, 256), dtype=np.int32)
    lib.hist256_u8(ids.reshape(-1), r, length, out.reshape(-1))
    return out


def sw_rows_build(rg_rows, n_liquid, to_pack):
    """Per-subwindow render data for ``uint8[R, 4096]`` rows of render ids
    — the streaming builder's rows at memory speed. Returns the same dict
    as the NumPy twin ``world/render_grid.chunk_batch_sw_data``. Each call
    adds one to ``sw_rows_build.calls``."""
    lib = _require()
    rg_rows = np.ascontiguousarray(rg_rows, dtype=np.uint8)
    r = rg_rows.shape[0]
    if rg_rows.shape != (r, 4096):
        raise ValueError(f"rows shape {rg_rows.shape}, want [R, 4096]")
    tp = np.zeros(256, np.int32)
    tpa = np.asarray(to_pack, np.int32)
    tp[: len(tpa)] = tpa[:256]
    sw_solid = np.empty((r, 128), np.uint32)
    sw_liq = np.empty((r, 128), np.uint32)
    sw_meta = np.empty((r, 8), np.uint32)
    sw_pid = np.empty((r, 4, 128), np.uint32)
    any_solid = np.empty(r, np.uint8)
    all_liq = np.empty(r, np.uint8)
    any_liq = np.empty(r, np.uint8)
    ok = np.zeros(1, np.int32)
    lib.sw_rows_build(
        rg_rows.reshape(-1), r, int(n_liquid), tp,
        sw_solid.reshape(-1), sw_liq.reshape(-1), sw_meta.reshape(-1),
        sw_pid.reshape(-1), any_solid, all_liq, any_liq, ok,
    )
    sw_rows_build.calls += 1
    return dict(
        sw_solid=sw_solid, sw_liq=sw_liq, sw_meta=sw_meta, sw_pid=sw_pid,
        any_solid=any_solid.astype(bool), all_liq=all_liq.astype(bool),
        any_liq=any_liq.astype(bool), palettes_ok=bool(ok[0]),
    )


sw_rows_build.calls = 0  # calls since the last reset
