"""Where the time of the v3 and v2 march kernels goes on the card.

No hardware profiler runs where the port is measured, so this script
builds copies of ``csrc/march3.cu`` and ``csrc/march2.cu`` that stamp the
card's global timer and SM id at the phase boundaries of each block
(after a block barrier), into ``build/kernels/profile/``, and calls them
through the port's wrappers on the 1080p bench camera's launches. For each
launch it prints the kernel's span, the blocks' mean and longest time in
each phase, when the blocks started (the waves) and how many ran at
once. It also splits the device time of a v2 trace (CUDA graph) into its
``march2`` calls, its service (``march2`` replaced by the recorded
outputs) and the rest. Needs one CUDA card:

    python3 chip_profile.py

``ab`` mode compares the kernels of several source trees (directories
holding ``voxelraytracing_tpu_torch/csrc``, such as an unpacked ``git
archive`` of a parent commit, and ``.``) in turns: the trees in the order
given, then in reverse. Each turn loads that tree's kernels (built where
its sources differ from this checkout's) in place of this checkout's and
runs ``chip_smoke.py``'s checks and timing of the shadowed frame's
launches at 1080p (phases 7 and 10: the fused kernel, the marks, the
planes, the shade) and of the probes (phase 29); any mismatch with a
plain version fails:

    python3 chip_profile.py ab PARENT_TREE .
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

STAMP = r'''
__device__ unsigned long long g_prof[1 << 20];
__device__ __forceinline__ unsigned long long prof_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned prof_sm() {
  unsigned s;
  asm volatile("mov.u32 %0, %smid;" : "=r"(s));
  return s;
}
#define PROF(n) { __syncthreads(); if (threadIdx.x == 0) { \
  g_prof[blockIdx.x * 8 + (n)] = prof_now(); g_prof[blockIdx.x * 8 + 7] = prof_sm(); } }
extern "C" int prof_read(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, n * 8ull);
}
extern "C" int prof_clear() {
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_prof);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_prof)));
}
'''

# the phase boundaries, stamps 0-6: each after its text in the source, or
# before it for the texts in BEFORE (comments that open a section)
MARKS = {
    "march3": ["const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
               "  __pipeline_wait_prior(0);\n",
               "  // the tile's subwindow for the next sub-round, and whether any ray of\n",
               "  bool go = boundary();\n",
               "  // wants, then the flags word",
               "  const int wm = __reduce_min_sync(kFull, wmin);\n",
               "    for (int d = 0; d < 3; ++d) wr[5 + d] = none_of(dm[d]);\n  }\n"],
    "march2": ["const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
               "  // the brick-id hash: each id's last slot, inserted in parallel\n",
               "  cl.sync();  // the hash in place, and every block of the cluster started\n",
               "  bool go = boundary();\n",
               "  // the tile's wants (:372-405)",
               "  // the planes, once; a tile with an active ray",
               "    out.stp[o] = sm.stp[i];\n  }\n"],
}
PHASES = {
    "march3": ["copies and ray terms", "cluster start, pass-through test",
               "first boundary", "sub-rounds", "walks and plane stores",
               "want reductions"],
    "march2": ["copies", "hash, cluster start", "first boundary",
               "sub-rounds", "wants", "stores"],
}
BEFORE = {"  // the tile's subwindow for the next sub-round, and whether any ray of\n",
          "  // the brick-id hash: each id's last slot, inserted in parallel\n",
          "  // wants, then the flags word", "  // the tile's wants (:372-405)",
          "  // the planes, once; a tile with an active ray",
          "  const int wm = __reduce_min_sync(kFull, wmin);\n"}


def instrumented(name):
    """The library of ``csrc/<name>.cu`` with the stamps, loaded."""
    from voxelraytracing_tpu_torch import _build

    src = (_build._PKG / "csrc" / f"{name}.cu").read_text()
    src = src.replace('#include "march4_common.cuh"',
                      '#include "march4_common.cuh"\n' + STAMP, 1)
    for n, text in enumerate(MARKS[name]):
        if src.count(text) != 1:
            raise RuntimeError(f"{name}.cu: phase mark {n} not found once")
        stamp = f"PROF({n})\n"
        src = src.replace(text, stamp + text if text in BEFORE else text + stamp)
    out = _build.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}_profile.cu", out / f"lib{name}_profile.so"
    cu.write_text(src)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        str(_build._PKG / "csrc"), "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, (restype, argtypes) in _build._SIGNATURES[name].items():
        getattr(dll, fn).restype = restype
        getattr(dll, fn).argtypes = argtypes
    dll.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.prof_clear.restype = ctypes.c_int
    return dll


def report(name, dll, tag, call):
    """Run ``call`` (one launch) and print its blocks' phases."""
    from voxelraytracing_tpu_torch import _build

    lib = _build.load(name)
    cs.check(dll.prof_clear() == 0, "prof_clear failed")
    _build._libs[name] = dll
    try:
        call()
        torch.cuda.synchronize()
    finally:
        _build._libs[name] = lib
    buf = np.zeros(1 << 20, np.uint64)
    cs.check(dll.prof_read(buf.ctypes.data, 1 << 20) == 0, "prof_read failed")
    p = buf.reshape(-1, 8).astype(np.float64)
    p = p[p[:, 0] > 0]
    ran = p[p[:, 6] > 0]  # blocks that did not pass their program through
    t0 = p[:, 0].min()
    span = (p[:, 1:7].max() - t0) / 1e3
    ph = np.diff(ran[:, :7], axis=1) / 1e3
    dur = (ran[:, 6] - ran[:, 0]) / 1e3
    start = (p[:, 0] - t0) / 1e3
    end = (np.maximum(p[:, 6], p[:, 2]) - t0) / 1e3
    busy = [int(((start <= s) & (end > s)).sum()) for s in np.sort(start)]
    waves = np.unique(np.round(np.sort(start) / 2.0) * 2.0)
    print(f"[{tag}] {len(p)} blocks ({len(ran)} ran every phase), span "
          f"{span:.1f} us, block mean {dur.mean():.1f} us, longest "
          f"{dur.max():.1f} us; blocks running at once: at most {max(busy)}, "
          f"{len(set(p[:, 7].astype(int)))} SMs used", flush=True)
    print(f"[{tag}] phase mean / longest (us): " + "; ".join(
        f"{k} {m:.2f} / {x:.2f}" for k, m, x in
        zip(PHASES[name], ph.mean(axis=0), ph.max(axis=0))), flush=True)
    print(f"[{tag}] block starts (us, to 2 us): "
          + ", ".join(f"{w:.0f}" for w in waves[:24])
          + (" ..." if len(waves) > 24 else ""), flush=True)


def v2_trace_split(rg1, static):
    """Device ms of a v2 trace (CUDA graph) and of its parts, twice."""
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops.camera import generate_rays

    origin, dirs = generate_rays(static, np.zeros(3, np.int32))
    real = t2.march2
    calls, outs = [], []

    def rec(*a, **k):
        calls.append((a, k))
        outs.append(real(*a, **k))
        return outs[-1]

    def stub(*a, **k):
        stub.i += 1
        return outs[(stub.i - 1) % len(outs)]

    def trace(i):
        t2.trace_wavefront2(rg1, origin, dirs, width=cs.WIDTH,
                            height=cs.HEIGHT, rounds=cs.V2_BUDGET[0],
                            steps_per_round=cs.V2_BUDGET[1])

    # the wrapper counts through its module name: the stand-ins count too
    for f in (rec, stub):
        f.launches = f.cuda_launches = 0
    stub.i = 0
    try:
        t2.march2 = rec
        trace(0)
        for rep in range(2):
            t2.march2 = real
            full = cs.graph_ms(trace, 1)
            t2.march2 = stub
            service = cs.graph_ms(trace, 1)
            t2.march2 = real
            m2 = cs.graph_ms(lambda i: [real(*a, **k) for a, k in calls], 1)
            print(f"[v2 trace] {rep}: whole {full:.4f} ms, service alone "
                  f"{service:.4f}, the {len(calls)} march2 calls alone "
                  f"{m2:.4f}, the rest {full - service - m2:.4f}", flush=True)
    finally:
        t2.march2 = real


def tree_libs(trees):
    """For each source tree, {name: library} of its ``csrc/<name>.cu``
    files whose sources (the file or a shared header) differ from this
    checkout's, built into ``build/kernels/ab/<i>/``, one nvcc each, all
    at once. The trees' C entry points must take this checkout's
    arguments (``_build._SIGNATURES``)."""
    from voxelraytracing_tpu_torch import _build

    def sources(root):
        d = Path(root) / "voxelraytracing_tpu_torch" / "csrc"
        return {f.name: f.read_bytes() for f in d.glob("*.cu*")}

    mine = sources(_build._PKG.parent)
    jobs = []
    for i, tree in enumerate(trees):
        src = sources(tree)
        same_headers = all(src.get(k) == b for k, b in mine.items()
                           if k.endswith(".cuh"))
        jobs += [(i, tree, n) for n in _build.KERNELS
                 if not same_headers or src[f"{n}.cu"] != mine[f"{n}.cu"]]

    def build(job):
        i, tree, name = job
        out = _build.BUILD_DIR / "ab" / str(i) / f"lib{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        src = Path(tree) / "voxelraytracing_tpu_torch" / "csrc" / f"{name}.cu"
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            str(out), str(src)], capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        for ln in cs.ptxas_lines(r.stdout + r.stderr):
            print(f"[ab] {tree}: {name}.cu {ln}", flush=True)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in _build._SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return lib

    per = [{} for _ in trees]
    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        for (i, _, name), lib in zip(jobs, pool.map(build, jobs)):
            per[i][name] = lib
    return per


def ab(trees):
    """chip_smoke.py's kernel timing of each tree, in turns: its checks of
    the shadowed frame's launches against their plain versions (phase 7,
    bench camera), its timing of each of them (phase 10, 1080p) and its
    probes (phase 29), with the tree's kernels loaded in place of this
    checkout's."""
    from voxelraytracing_tpu_torch import _build
    from voxelraytracing_tpu_torch.ops.wavefront3 import color_lut_rows
    from voxelraytracing_tpu_torch.ops.wavefront4 import prepare_grid4

    per = tree_libs(trees)
    own = {n: _build.load(n) for n in _build.KERNELS}
    rg, mats, v = cs.build_world(8)
    prep = prepare_grid4(rg)
    lut = color_lut_rows(mats.color).to("cuda")
    static = cs.bench_cams(v, cs.WIDTH, cs.HEIGHT)[0]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    for i in order:
        _build._libs.update({**own, **per[i]})
        tag = f"ab {trees[i]}"
        cs.compare_shadows(rg, prep, lut, [static], tag)
        out = cs.time_shadows(rg, prep, lut, v, (cs.WIDTH, cs.HEIGHT), tag)
        cs.say(tag, "device ms: " + ", ".join(
            f"{k[:-4]} {out[k]:.5f}" for k in out if k.endswith("_dev"))
            + f"; launch floor {cs.launch_floor():.5f}")
        cs.phase_probes(tag)
    _build._libs.update(own)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if sys.argv[1:2] == ["ab"]:
        return ab(sys.argv[2:])
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3
    from voxelraytracing_tpu_torch.ops.wavefront3 import color_lut_rows

    rg, mats, v = cs.build_world(8)
    lut = color_lut_rows(mats.color).to("cuda")
    static, _ = cs.bench_cams(v, cs.WIDTH, cs.HEIGHT)
    with cs.Launches("wavefront3", "march3", compare=False) as cold:
        tok = cs.v3_frame(rg, lut, static)[2]
    with cs.Launches("wavefront3", "march3", compare=False) as warm:
        cs.v3_frame(rg, lut, static, tok)
    rg1 = cs.build_world1(8)
    with cs.Launches("wavefront2", "march2", compare=False) as v2:
        cs.v2_trace(rg1, static, *cs.V2_BUDGET)
    m3, m2 = instrumented("march3"), instrumented("march2")
    for tag, (a, k) in (("march3 cold round 0", cold.inputs[0]),
                        ("march3 warm round 0", warm.inputs[0]),
                        ("march3 warm round 5", warm.inputs[5])):
        report("march3", m3, tag, lambda: t3.march3(*a, **k))
    for r in (0, 1, 10, 40):
        a, k = v2.inputs[r]
        report("march2", m2, f"march2 round {r}", lambda: t2.march2(*a, **k))
    v2_trace_split(rg1, static)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.PhaseError as e:
        print(f"chip_profile: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
