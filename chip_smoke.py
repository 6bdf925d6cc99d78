"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's paths on the demo worlds of bench.py, on a streamed
strip of demo terrain and on config2/config3's preset world (device
worldgen), through the entry points a user calls
(``render_frame4``, ``trace_wavefront4_rays``, ``render_frame3``,
``trace_wavefront3``, ``WavefrontRenderer.render_packed`` and
``.render``, ``trace_wavefront``, ``trace_wavefront2``, ``path_trace3``,
``path_trace_fused4``, ``RenderGrid3Builder``,
``WorldGen.generate_chunks``, ``ServerWorld``, the probe scripts'
``main``, the SVO tracer ``trace_rays``, ``RayTracer``,
``PathTracer``, ``build_render_grid``, a served world through
``ServerState`` and ``GameState``, the band-sharded frames of
``parallel/``, an ``EngineApp`` session, ``graft_entry`` and
``utils.profiling``), after building the hand-written CUDA kernels
from ``voxelraytracing_tpu_torch/csrc`` (one nvcc per source, all at once)
and the port's native host library (``native/svo_core.cpp``, g++):

  1. the card's name and power limit (exits non-zero without a CUDA card);
  2. build the kernels and the native library; print registers, shared
     memory and spills of each ``__global__`` (the four
     ``march_fused4_kernel`` instantiations among them);
  3. the 8-chunk world (256³ voxels), built straight onto the card;
  4. the fused primary frame at 1920x1080, bench camera + 4 orbit
     cameras (one a quadrant of bench.py's 48): kernel vs plain PyTorch
     version on the card, flags and packed words exactly equal;
  5. 320x180, card vs the plain version on the CPU (the one the CPU tests
     hold to the JAX package): the cross-platform bar of
     TPU_CORRECTNESS.json, 0 hit and voxel mismatches, every pixel within
     2/255;
  6. 10 frames through ``render_packed``'s v4 route (``tracer="v4"``,
     the split frame): marks, planes and shade once a frame, the fused
     kernel never; 10 frames through ``render_frame4(fused=True)``: the
     fused kernel once a frame;
  7. the shadowed frame (config2's sun, 500-step cap) at 1920x1080 and
     1280x720, bench camera + 4 orbit cameras: fused kernel vs its plain
     version exactly equal; split frame == fused frame, with and without
     shadows; each launch of the split frame vs its plain version on the
     same inputs, exactly equal: start marks and state planes of the
     camera rays and of the shadow bundle, the shade with and without
     shadows; ``trace_wavefront4_rays`` on the shadow bundle vs the result
     of the plain planes, every field; shadowed pixels counted (fail if
     none); a camera with no basis (every direction NaN) at 1920x1080: the
     fused kernel with and without shadows and the split frame's launches
     (planes, shade) vs their plain versions, exactly equal, every pixel
     packed 0xFF000000 (a NaN sky is byte 0, as in JAX's frame); the
     camera marks (``touched4``) at the edges of their design, each bit
     for bit against the plain version: a camera outside the world, one
     0.0004 voxels outside a face and a step cap of 0 (the launch's
     uniform exits), the camera with no
     basis, a 1000x500 frame (partial last tile row and column), and a
     camera 0.0004 voxels inside a world face, many of whose tiles their
     representative ray does not decide;
  8. 320x180 with shadows, card vs CPU: 0 hit, voxel and shadow-bit
     mismatches, every pixel within 2/255;
  9. as 6 with shadows: 10 shadowed frames through ``render_packed``
     (marks and planes twice a frame, shade once) and through
     ``render_frame4(fused=True)`` (the fused kernel once a frame);
 10. timing with CUDA events, median of 5 windows: the primary frame and
     kernel (1080p), the fused and split shadowed frames, each kernel
     alone and the plain versions (1080p and 720p), with the step counts
     the bounds need; each kernel both as back-to-back wrapper calls and
     as the device time of the same calls replayed from a CUDA graph; the
     SIMT efficiency of the timed static frames (one thread a pixel, warps
     of 16x2 and of 8x4 pixels, from the step counts in the flags);
     ``touched4``'s camera and bundle modes apart, each beside its least
     time and the launch floor (an empty kernel's device ms), camera
     mode also with the rays its kernel's order evaluates (from the
     plain version's start flags) and the least time of those, which is
     the one the kernels line carries (the every-ray formula is printed
     beside it, to compare with earlier runs);
 11. phases 4 and 10's primary timing and SIMT efficiency on the 16-chunk
     world (512³ voxels, 117 MB of tables), bench camera + 4 orbit
     cameras (timing: 12);
 12. the path tracers on the 8-chunk world at 1920x1080 (config3's frame:
     config2's sun, 500-step cap), bench camera + 1 orbit camera, on the
     demo materials and on the mirror table of tests/test_pathtrace4.py
     (scatter 0: nothing drawn): the one-launch kernel ``pt4`` vs its
     plain version with 0, 1 and 2 bounces (bit for bit where nothing is
     drawn, else the path-tracing bar: 99% of pixels within 2/255);
     ``path_trace_fused4`` vs ``path_trace3`` where nothing is drawn, bit
     for bit; ``matfetch4`` vs its plain version on the flags of both
     legs of the one-bounce frame, bit for bit;
 13. both path tracers with one bounce at 320x180, card vs the plain
     versions on the CPU: the path-tracing bar;
 14. 10 config3 frames through ``path_trace3`` (two march and two fetch
     launches a frame) and 10 through ``path_trace_fused4`` (one ``pt4``
     launch a frame), counted; the last frames finite, the fused one
     within the bar of its plain version, the routes' mean radiance
     within 5%;
 15. timing: both routes' frames (static, 12-camera orbit), ``matfetch4``
     and ``pt4`` alone and the bounce leg's ``march_planes4`` (wrapper
     calls and CUDA-graph device time), the plain versions, and the steps
     the bounds need; the SIMT efficiency of the static frame's camera
     and bounce legs (warps of 16x2 and 8x4 pixels, and the bounce leg's
     live paths compacted into whole warps a tile, as ``pt4`` marches
     them);
 16. the strip world (config4ck's layout, benchmarks/run.py:586-633: 32 x
     3 x 8 chunks of demo terrain) in a 40-chunk window (20 windows a
     side, super-cells of 2): dense and sparse builders with the same 21
     streamed columns; the sparse tables consistent; on 13 fly-through
     cameras at 1920x1080 the fused, fused-shadowed and split-shadowed
     frames of the sparse token equal the dense token's, flags and
     packed words; each sparse kernel (fused, fused shadow, planes of
     camera rays and of the shadow bundle) equals its plain version;
     launches counted through 10 sparse fused-shadowed and 10 sparse
     split-shadowed frames;
 17. the strip in an 80-chunk window (the reference's largest, 40
     windows a side, super-cells of 4), sparse: 8 columns prefilled, then
     23 streamed with 4 fused frames each (config4ck's loop), the 3-row
     token carried; every 8th frame the kernel equals its plain version;
     one fused launch a frame; at the end the same installs into a CPU
     builder (tables equal word for word) and card vs CPU at 320x180
     against the bar of phase 5, and the other sparse kernels against
     their plain versions; phase 7's camera with no basis on the sparse
     tables;
 18. timing: the streaming step (set_chunks + prepared of 128 chunks,
     config4b) at 30 chunks dense and 80 sparse; the 80-chunk fly-through
     (frames/s, ms/frame, its builder and frame shares); the sparse
     kernels on a static 80-chunk frame with their least times, the rows
     they read and the frame's SIMT efficiency; the sparse tables' size;
 19. the v3 round-serviced march (``render_frame3``, the renderer's
     default route) on the 8-chunk world: ``march3`` vs ``march3_ref`` on
     the inputs of every launch of whole frames, states, flags and wants
     word for word: bench.py's v3 route (14 rounds, 500-step cap, warm
     tokens) at 1920x1080 on the static and 3 orbit cameras, config2's
     720p shadowed frame (per-ray mode), a 1080p trace whose round loop
     compacts (tile map) and one with ``lookahead=2``;
 20. ``render_frame3`` at 320x180 with and without shadows on the bench
     camera and one orbit camera, card vs the plain versions on the CPU:
     the bar of phase 5;
 21. ``render_frame3`` at a converged budget (64 rounds) equals the split
     v4 frame word for word, shadows on;
 22. launches a frame (``march3`` launches are rounds used, plus
     ``shade4``), counted over 10 orbit frames each: render_packed's
     default route with and without shadows, bench.py's v3 route and
     config2's route;
 23. timing: ``march3`` alone (the round-0 launch of the static 1080p
     frame: wrapper calls and CUDA-graph device time), its plain version,
     its least time and its time a counted step; the device time of all
     the launches of a warm static frame, and of each alone with its
     sub-round budget, counted steps and least time; ms/frame of the
     three routes, static and orbit, warm;
 24. the v2 march (``WavefrontRenderer.render`` on a v1 RenderGrid, its
     default tracer) on the 8-chunk world: the v1 tables built on the card
     and on the CPU, equal word for word (their brick tables the v3
     grid's), with their MB;
 25. ``march2`` vs ``march2_ref`` on the inputs of every round of whole
     1080p frames, states and wants word for word: the renderer's budget
     (48 rounds of 24 steps) on the static and one orbit camera,
     ``trace_wavefront2``'s default (12 of 48) on the static one;
 26. ``render`` (v2) at 320x176, card vs the plain versions on the CPU:
     0 hit and voxel mismatches, every pixel's sRGB8 within 2/255;
 27. the share of rays still marching after the renderer's 48 rounds
     (drawn as misses), the first round after which none is, and v2 at
     that budget vs the split v4 trace at 1080p on the same rays: hit
     masks at most 0.2% apart, voxel ids equal where both hit
     (tools/tpu_correctness.py:188-190); against v4's own camera rays
     (an ulp apart on some pixels) the hit bar, voxel ids counted;
 28. launches a frame (``march2`` calls and the CUDA launches inside
     them) over 10 orbit frames of ``render`` (v2); timing: ``march2``
     round 0 (wrapper calls and CUDA-graph device time, its time a
     counted step), the device time of a frame's calls, together and each
     alone with its counted steps, and of its whole trace, the plain
     version, the least time, and ms/frame of ``render`` (v2), static and
     orbit, with the device idle share (their tables stay for 45);
 29. the primitive probes (``voxelraytracing_tpu_torch.experiments``, the
     port of the TPU probe scripts under ``experiments/``): each script's
     main path at the JAX shapes, launches counted; each of the six probe
     kernels vs its plain version on random inputs at those shapes, bit
     for bit; device ms of each kernel, its plain version and its
     yardstick library call, and its least time, beside the launch floor:
     the device ms of an empty kernel, timed as the probes are;
 30. device worldgen: one 128-chunk batch of config2/3's preset window
     (terra datapack, Continents, seed 20260816, 8^3 chunks around
     ``find_land_near(0, 0)``, benchmarks/run.py:183-212) through
     ``WorldGen.generate_chunks`` on the card and on the CPU: grids, the
     aux maps (height, biome, peak, veg_prob) and the features exactly
     equal; chunks/s on the card;
 31. the SVO build of that batch on the card (``build_chunk_svo_batch``,
     ``ServerWorld.build_nodes``) vs the native ``dense_to_svo_batch``,
     word for word; config4a's rebuild step (run.py:443-474: 128 chunks
     through ``ServerWorld.generate_chunks`` + ``build_nodes``) in
     chunks/s;
 32. the 512-chunk preset world (generated on the card in batches of 128,
     features merged, tables built): the fused 1080p primary frame,
     config2's 720p fused shadowed frame (and its split launches, as in
     phase 7) and config3's 1080p one-bounce ``pt4`` frame, each kernel vs
     its plain version exactly on the config camera + 3 orbit cameras;
     320x180 card vs CPU at the bars of phases 5/8 and 13; launches on
     the three paths, each counted from 0; ms/frame of each (static
     camera, median of 5 windows);
 33. the native library built from the port's own copy and the streaming
     builder took its row path (``sw_rows_build`` calls counted in the
     phase 17 fly-through);
 34. the SVO worlds: ``make_demo_world(7, 8)`` on the card and on the CPU,
     nodes and roots word for word; the 512-chunk preset world of phase 32
     through ``assemble_world_slice`` (fixed slots, SVOs built on the card)
     and through ``build_world_slice`` (the host pool): the pools differ,
     their 1080p ``trace_rays`` results are equal, and ``packed()`` traces
     equal to the widened pool;
 35. the SVO tracer against the v4 kernels: ``trace_rays`` and
     ``trace_wavefront4_rays`` (``touched4`` + ``march_planes4``, counted)
     on the same ``generate_rays`` bundle at 1080p, on the demo and preset
     worlds at their camera and two orbit cameras: hit masks, and voxel
     ids on common hits, at most 0.2% apart (tools/tpu_correctness.py:188's
     hit bar), the counts printed;
 36. 320x180 on the demo world, card vs CPU: ``trace_rays`` (hit, voxel,
     normal, steps exact, the largest position and water gap printed and
     held to 1e-3), ``RayTracer`` plain, shadowed and as the step heatmap
     with each ``composite_crosshair`` style (the bar of phases 5/8), the
     ``PathTracer`` with 3 bounces and 1 sample (the PT bar);
 37. SVO frame times beside the card's name and power limit: ``RayTracer``
     at 1080p on the demo and preset worlds, plain and shadowed (median of
     5, CUDA events), the ``PathTracer`` at 1080p (3 bounces, 1 sample,
     median of 3), config1's frame (benchmarks/run.py:74-98) in Mrays/s,
     and the device's busy share of a plain ``RayTracer`` frame
     (torch.profiler);
 38. the v1 device builder: ``build_render_grid`` on the card equals
     ``build_render_grid_host`` word for word on the 8-chunk demo world,
     and the v2 frame drawn from its tables equals the one from the host
     tables bit for bit;
 39. a served world: the port's ``ServerState`` on localhost in this
     process (terra, Continents, seed 20260816, chunk generation and
     ``build_nodes`` on the card, its ticks in a thread whose exceptions
     fail the run); a ``GameState`` with a ``ClientWorld`` of window 8
     streams until its 512 chunks are populated (chunks/s); a
     ``WorldSlice`` of the client's pool and ``chunk_roots()`` draws a
     1080p ``RayTracer`` frame equal bit for bit to one of
     ``build_world_slice`` of the server's nodes; a second client streams
     the window, the first one's ``set_voxel`` echoes to it, and after the
     edit both clients' frames equal the server's;
 40. the band-sharded frames (``parallel/``) at 1280x720 on the 8-chunk
     world, config2's sun, shadows on: ``sharded_render_frame3`` (32
     rounds, converged: the unsharded frame equals its 64-round one) and
     ``sharded_render_frame4`` on meshes of 1, 2 and 6 bands of cuda:0
     (with more cards, of each, and one band a card): every ``march3``,
     ``touched4``, ``march_planes4`` and ``shade4`` launch of every band
     (rows y0 > 0 among them) equals its plain version, the stitched
     frames equal the unsharded ones word for word; ``ShardedRayTracer``
     equals ``RayTracer`` and ``sharded_accumulate_step`` (2 samples x 2
     bands) the host average within 1e-6, on the 4-chunk SVO demo world;
 41. an engine session at the engine's defaults (1280x720, a window of
     30 chunks, the client's pool at its first size of 2^24 nodes, which
     doubles as it fills): ``EngineApp.host_singleplayer`` on a copy of the
     bundled "Demo World" (terra, Continents, seed 20260816), its server a
     child process on the card; the window streams in (chunks/s), the
     player lands; frames on the fused v4 path (one launch each; plain,
     shadowed, heatmap, after a break and a place) equal
     ``march_fused4_ref`` on the builder's tables, the v3 path's launches
     equal their plain versions, the SVO path draws; at 320x176 the card's
     frame meets phase 5's bar against a CPU session on the same game
     state; ``resize_world(40)`` keeps the 27,000 chunks and draws on
     sparse tables, equal to the plain version, with its hit share beside
     the dense frame's at the same camera; warm ms of each route and the
     device's idle share of the v4 route;
 42. ``graft_entry.entry()`` against its plain version, and
     ``dryrun_multichip`` on every card;
 43. ``utils.profiling``: ``device_trace`` writes a Chrome trace naming
     the ``march_fused4`` launch, ``device_memory_stats`` reports the card;
 44. the script's total seconds and each phase's (the seconds from the
     line before a phase's line to it); each group of phases prints its
     own.
 45. (run after 43, so that its profiler session of ~131,000 kernel
     records comes after every other phase's profiler use) the v1 tracer
     (``trace_wavefront``, plain PyTorch on the card; JAX's is XLA, no
     Pallas kernel) on phase 24's v1 tables
     at the renderer's 48 x 12 budget: ``WavefrontRenderer(
     tracer="v1").render`` at 1920x1080, counted from 0 and profiled (no
     hand-written kernel launched, the rounds its loop ran, its device
     launches and busy time from the profiler's raw CUPTI events), a
     finite image with hits, warm ms/frame (median of 3) and the busy
     share beside the card's name and power limit; at 320x176 on the
     static and two orbit cameras, card vs the CPU on the same rays,
     every product word for word.

Prints one line per phase, the kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

    python3 chip_smoke.py
"""

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
SIZES = ((1920, 1080), (1280, 720))
# render_frame4 keywords of bench.py's frame (bench.py:171-175)
BENCH_KW = dict(rounds=64, step_cap=500, steps_per_round=256, fused=True,
                s_seg=4)
N_ORBIT = 48
N_ORBIT_16 = 12
# phases 4, 5, 7 and 8 hold the kernels to their plain versions on the
# static camera and every CMP_STEP-th orbit camera: one a quadrant (phase
# 20 on the static camera and the CMP_STEP-th)
CMP_STEP = N_ORBIT // 4
WINDOWS = 5
# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s, FP32 op/s
HBM_BPS = 3.35e12
FP32_OPS = 67e12
# FP32 operations of one march step (march4_common.cuh march_step: 6 for
# the position, 3 floors, 7 per axis for the DDA exit, 2 mins, 2 for the t
# update, 2 for the water interval, 1 cell inverse); integer work and
# loads are not counted, so the bound stays a least time
STEP_OPS = 37
# FP32 operations of one pixel outside the march (camera ray 24, ray
# constants 21, shade epilogue 55 counting powf as 20)
PIXEL_OPS = 100
ROW_BYTES = 7 * 128 * 4  # one subwindow's sw_cont row
# FP32 operations of one ray's start mark: its camera ray (24, camera
# rays only), ray constants (21) and the first step's position (6)
MARK_OPS_CAMERA = 51
MARK_OPS_RAYS = 27


class PhaseError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


# seconds of each phase: the time from the line printed before a phase's
# line to it goes to that phase
PHASE_S = {}
_LAST_SAY = [time.perf_counter()]


def say(phase, msg):
    now = time.perf_counter()
    PHASE_S[phase] = PHASE_S.get(phase, 0.0) + now - _LAST_SAY[0]
    _LAST_SAY[0] = now
    print(f"[{phase}] {msg}", flush=True)


def bench_cams(v, w, h, n_orbit=N_ORBIT):
    """bench.py's static camera and its orbit (bench.py:114-145)."""
    from voxelraytracing_tpu_torch.ops.camera import CamData

    static = CamData.create((35.0, 45.0, 0.0), (v * 0.5, v * 0.75, v * 0.5),
                            70.0, (w, h))
    orbit = []
    for i in range(n_orbit):
        a = 360.0 * i / n_orbit
        r = v * 0.35
        eye = (v * 0.5 + r * np.cos(np.deg2rad(a)), v * 0.72,
               v * 0.5 + r * np.sin(np.deg2rad(a)))
        orbit.append(CamData.create((30.0, (a + 180.0) % 360.0, 0.0), eye,
                                    70.0, (w, h)))
    return static, orbit


def sun_of(cam):
    """config2's sun for a camera (benchmarks/run.py:313)."""
    return (float(cam.pos[0]) + 900.0, 2500.0, float(cam.pos[2]) + 300.0)


def build_world(w_chunks, device="cuda", mats=None):
    """bench.py's demo world: (RenderGrid3 on ``device``, materials, edge
    in voxels); ``mats`` replaces the demo materials."""
    from voxelraytracing_tpu_torch.ops import noise
    from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
    from voxelraytracing_tpu_torch.world.demo import (
        demo_chunk_grids_host, demo_materials)

    perm = noise.make_permutation(7)
    grids, cells = demo_chunk_grids_host(
        perm, np.zeros(3, np.int64), w_chunks,
        w_chunks * 32 * 0.45, int(w_chunks * 32 * 0.28))
    mats = demo_materials() if mats is None else mats
    rg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32),
                                 w_chunks, mats, device=device)
    return rg, mats, w_chunks * 32


def channel_diff(a, b):
    """Max per-channel difference of two packed RGBA8 images, per pixel."""
    d = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for sh in (0, 8, 16):
        d = torch.maximum(d, (((a >> sh) & 255) - ((b >> sh) & 255)).abs())
    return d


def demangle(sym):
    """``name_kernel<flags>`` of a mangled kernel symbol
    (``_ZN<len><ns><len><name>[I(Lb<flag>E)+E]...``), else the symbol."""
    pos = 3 if sym.startswith("_ZN") else len(sym)
    while pos < len(sym):
        m = re.match(r"\d+", sym[pos:])
        if not m:
            break
        start = pos + m.end()
        pos = start + int(m.group())
        if sym[start:pos].endswith("_kernel"):
            m = re.match(r"I((?:Lb[01]E)+)E", sym[pos:])
            if not m:
                return sym[start:pos]
            flags = re.findall(r"Lb([01])E", m.group(1))
            return sym[start:pos] + "<" + ", ".join(
                "true" if f == "1" else "false" for f in flags) + ">"
    return sym


def ptxas_report(name):
    """Registers, shared memory and spills of each __global__ in the
    compiler output of ``csrc/<name>.cu``."""
    from voxelraytracing_tpu_torch import _build

    return ptxas_lines(_build.build_log(name))


def ptxas_lines(log):
    """Registers, shared memory and spills of each __global__ in the
    ``-Xptxas -v`` output ``log``."""
    out, fn, spill = [], None, "spills ?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{fn}: {m.group(1)} regs, "
                       f"{smem.group(1) if smem else 0} B smem, {spill}")
            fn, spill = None, "spills ?"
    return out


def frame_inputs(rg, prep, cam, lut, shadows=True):
    """``frame_args`` of a bench frame with config2's sun."""
    from voxelraytracing_tpu_torch.ops.wavefront4 import frame_args

    return frame_args(rg, cam, lut, prepared=prep, sun_pos=sun_of(cam),
                      shadows=shadows, rounds=BENCH_KW["rounds"],
                      steps_per_round=BENCH_KW["steps_per_round"],
                      step_cap=BENCH_KW["step_cap"])


def split_parts(args, kw):
    """The three launches of a split shadowed frame, as render_frame4
    makes them: camera planes, shadow-bundle planes, shade."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    scal, gw2, lut, swc, wmp = args
    dims = dict(height=kw["height"], width=kw["width"])
    mdims = dict(dims, sparse_ns=kw["sparse_ns"])  # the march's keywords
    row = scal.cpu().numpy()
    srow = torch.from_numpy(t4._split_shade_row(row)).to(scal.device)
    planes = t4.march_planes4(scal, gw2, swc, wmp, **mdims)
    bundle = t4._shadow_prep4(planes[0], planes[1], row)
    shadow = t4.march_planes4(scal, gw2, swc, wmp, *bundle, **mdims)
    sh = (shadow[1] >> 1) & 1
    return dict(scal=scal, srow=srow, gw2=gw2, lut=lut, swc=swc, wmp=wmp,
                dims=dims, mdims=mdims, planes=planes, bundle=bundle,
                shadow=shadow, sh=sh, kw=kw)


def hit_rows(sw_cont, origins, dirs, t, hit, ns):
    """Distinct sw_cont rows (subwindows) that hold the hit points."""
    p = origins + dirs * t[..., None]
    v = torch.floor(p[hit]).to(torch.int64) >> 4
    sid = v[:, 0] + v[:, 1] * ns + v[:, 2] * ns * ns
    return torch.unique(sid)


def compare_on_card(rg, prep, lut, cams, phase):
    """Fused primary kernel (through render_frame4) vs plain version."""
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        frame_args, march_fused4_ref, render_frame4)

    fl_bad = pk_bad = hits = 0
    worst = 0
    for cam in cams:
        img, fl = render_frame4(rg, cam, lut, prepared=prep, with_flags=True,
                                **BENCH_KW)
        args, kw = frame_args(rg, cam, lut, prepared=prep,
                              rounds=BENCH_KW["rounds"],
                              steps_per_round=BENCH_KW["steps_per_round"],
                              step_cap=BENCH_KW["step_cap"])
        rimg, rfl = march_fused4_ref(*args, **kw)
        check(img.shape == (HEIGHT, WIDTH), f"frame shape {tuple(img.shape)}")
        fl_bad += int((fl != rfl).sum())
        pk_bad += int((img != rimg).sum())
        hits += int(((fl >> 1) & 1).sum())
        worst = max(worst, int(channel_diff(img, rimg).max()))
    say(phase, f"{len(cams)} cameras at {WIDTH}x{HEIGHT}: flag mismatches "
        f"{fl_bad}, packed-word mismatches {pk_bad}, max channel diff "
        f"{worst}/255, hit pixels {hits}")
    check(fl_bad == 0 and pk_bad == 0,
          "kernel and plain version disagree on the card")
    return worst / 255.0


def compare_on_cpu(rg_cpu, rg, mats, v, phase, shadows=False, cams=None):
    """Kernel on the card vs the plain version on the CPU at 320x180; with
    shadows the shadow bits (the split path's shadow-leg hits) too.
    ``cams`` replaces bench.py's cameras in a world of edge ``v``."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    if cams is None:
        static, orbit = bench_cams(v, 320, 180)
        cams = [static] + orbit[::CMP_STEP]
    hit_bad = vox_bad = sh_bad = fl_bad = pk_bad = 0
    within = total = shadowed = 0
    for cam in cams:
        kw = dict(prepared=None, with_flags=True, shadows=shadows,
                  **{**BENCH_KW, "fused": True})
        if shadows:
            kw["sun_pos"] = sun_of(cam)
        img, fl = t4.render_frame4(rg, cam, mats.color, **kw)
        rimg, rfl = t4.render_frame4(rg_cpu, cam, mats.color, **kw)
        img, fl = img.cpu(), fl.cpu()
        hit, rhit = (fl >> 1) & 1, (rfl >> 1) & 1
        hit_bad += int((hit != rhit).sum())
        both = (hit & rhit) != 0
        vox_bad += int((((fl >> 17) & 255) != ((rfl >> 17) & 255))[both].sum())
        fl_bad += int((fl != rfl).sum())
        pk_bad += int((img != rimg).sum())
        within += int((channel_diff(img, rimg) <= 2).sum())
        total += img.numel()
        if shadows:
            sh = [split_parts(*frame_inputs(g, t4.prepare_grid4(g), cam,
                                            mats.color))["sh"].cpu()
                  for g in (rg, rg_cpu)]
            sh_bad += int((sh[0] != sh[1])[both].sum())
            shadowed += int((sh[0] & hit).sum())
    frac = within / total
    say(phase, f"{len(cams)} cameras at 320x180{' with shadows' * shadows}, "
        f"card vs CPU: hit mismatches {hit_bad}, voxel mismatches {vox_bad}"
        + (f", shadow-bit mismatches {sh_bad} (shadowed hits {shadowed})"
           if shadows else "")
        + f", pixels within 2/255 {frac:.6f} (flag words differing {fl_bad},"
        f" packed {pk_bad})")
    check(hit_bad == 0 and vox_bad == 0 and sh_bad == 0 and frac == 1.0,
          "kernel misses the cross-platform bar against the CPU")


def words_differ(a, b):
    """Count of elements whose bits differ (floats compared as words)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def compare_shadows(rg, prep, lut, cams, phase):
    """Shadowed frames at one size: fused kernel vs plain version; split
    == fused with and without shadows; each launch of the split frame vs
    its plain version on the same inputs (start marks and planes of the
    camera rays and of the shadow bundle; the shade with and without
    shadows); the shadow bundle through trace_wavefront4_rays vs the
    result of the plain planes. Returns the largest differences of the
    fused frame, the planes, the shade and the marks."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    bad = dict(fused=0, split=0, split_noshadow=0, marks=0, planes=0,
               shade=0, rays=0)
    worst = dict(fused=0, marks=0, planes=0.0, shade=0)
    shadowed = hits = 0
    w, h = cams[0].proj_size
    for cam in cams:
        kw = dict(prepared=prep, with_flags=True, sun_pos=sun_of(cam),
                  **{**BENCH_KW, "fused": True})
        img, fl = t4.render_frame4(rg, cam, lut, shadows=True, **kw)
        args, fkw = frame_inputs(rg, prep, cam, lut)
        rimg, rfl = t4.march_fused4_ref(*args, **fkw)
        bad["fused"] += int((fl != rfl).sum()) + int((img != rimg).sum())
        worst["fused"] = max(worst["fused"], int(channel_diff(img, rimg).max()))
        simg, sfl = t4.render_frame4(rg, cam, lut, shadows=True,
                                     **{**kw, "fused": False})
        bad["split"] += int((simg != img).sum()) + int((sfl != fl).sum())
        a = t4.render_frame4(rg, cam, lut, **kw)
        b = t4.render_frame4(rg, cam, lut, **{**kw, "fused": False})
        bad["split_noshadow"] += int((a[0] != b[0]).sum()) \
            + int((a[1] != b[1]).sum())

        p = split_parts(args, fkw)
        sc, dims = p["scal"], p["dims"]
        tables = (sc, p["gw2"], p["swc"], p["wmp"])
        for rays, got in (((), p["planes"]), (p["bundle"], p["shadow"])):
            ref = t4.march_planes4_ref(*tables, *rays, **dims)
            bad["planes"] += sum(words_differ(x, y) for x, y in zip(got, ref))
            worst["planes"] = max(worst["planes"], max(
                float((got[k] - ref[k]).abs().max()) for k in (0, 2, 3)))
            m = t4.touched4(sc, *rays, **dims).int()
            rm = t4.touched4_ref(sc, *rays, **dims).int()
            bad["marks"] += int((m != rm).sum())
            worst["marks"] = max(worst["marks"], int((m - rm).abs().max()))
        for shadows in (False, True):
            skw = dict(show_steps=False, shadows=shadows,
                       max_steps=fkw["max_steps"])
            sargs = (p["srow"], p["lut"], *p["planes"], p["sh"])
            a, b = t4.shade4(*sargs, **skw), t4.shade4_ref(*sargs, **skw)
            bad["shade"] += int((a != b).sum())
            worst["shade"] = max(worst["shade"], int(channel_diff(a, b).max()))

        ot, dt3, hitm = p["bundle"]
        res = t4.trace_wavefront4_rays(rg, ot, dt3, hitm, width=w, height=h,
                                       step_cap=BENCH_KW["step_cap"])
        rres = t4._trace_result(*t4.march_planes4_ref(*tables, ot, dt3, hitm,
                                                      **dims))
        bad["rays"] += sum(words_differ(x, y) for x, y in zip(res, rres))
        shadowed += int(p["sh"].sum())
        hits += int(((fl >> 1) & 1).sum())
    say(phase, f"{len(cams)} cameras at {w}x{h}, shadows: fused kernel vs "
        f"plain mismatching words {bad['fused']} (max channel diff "
        f"{worst['fused']}/255); split vs fused {bad['split']}, unshadowed "
        f"{bad['split_noshadow']}; split launches vs plain (camera rays and "
        f"shadow bundle): marks {bad['marks']}, planes {bad['planes']} (max "
        f"abs diff {worst['planes']}), shade with and without shadows "
        f"{bad['shade']} (max channel diff {worst['shade']}/255); "
        f"trace_wavefront4_rays vs plain planes {bad['rays']}; hit pixels "
        f"{hits}, shadowed {shadowed}")
    check(not any(bad.values()), "shadowed frames disagree")
    check(shadowed > 0, "no pixel is shadowed")
    return dict(fused=worst["fused"] / 255.0, planes=worst["planes"],
                shade=worst["shade"] / 255.0, marks=float(worst["marks"]))


def no_basis(cam):
    """``cam`` with its basis zeroed: every camera ray's direction is 0/0."""
    iv = cam.inv_view.copy()
    iv[:3, :3] = 0.0
    return dataclasses.replace(cam, inv_view=iv)


def compare_nan_direction(rg, prep, lut, cam, phase):
    """``cam`` with no basis, so every direction is NaN: the fused kernel
    with and without shadows, and the split frame (``render_frame4`` and
    its launches: planes of the camera rays and of the shadow bundle, the
    shade) against their plain versions on the card, word for word; every
    pixel must pack to 0xFF000000, as in JAX's frame."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    cam = no_basis(cam)
    bad, sky = {}, True
    for shadows in (False, True):
        args, fkw = frame_inputs(rg, prep, cam, lut, shadows)
        got = t4.march_fused4(*args, **fkw)
        want = t4.march_fused4_ref(*args, **fkw)
        bad["fused", shadows] = sum(words_differ(a, b)
                                    for a, b in zip(got, want))
        scal, gw2, _, swc, wmp = args
        p = split_parts(args, fkw)
        ref = t4.march_planes4_ref(scal, gw2, swc, wmp, **p["mdims"])
        rays = t4._shadow_prep4(ref[0], ref[1], scal.cpu().numpy())
        rsh = (t4.march_planes4_ref(scal, gw2, swc, wmp, *rays,
                                    **p["mdims"])[1] >> 1) & 1
        skw = dict(shadows=shadows, max_steps=fkw["max_steps"])
        img = t4.shade4(p["srow"], p["lut"], *p["planes"], p["sh"], **skw)
        rimg = t4.shade4_ref(p["srow"], p["lut"], *ref, rsh, **skw)
        frame = t4.render_frame4(rg, cam, lut, prepared=prep, shadows=shadows,
                                 sun_pos=sun_of(cam),
                                 **{**BENCH_KW, "fused": False})
        bad["split", shadows] = (
            sum(words_differ(a, b) for a, b in zip(p["planes"], ref))
            + words_differ(p["sh"], rsh) + words_differ(img, rimg)
            + words_differ(frame, rimg))
        sky &= bool((want[0] == -0x1000000).all()) \
            and bool((rimg == -0x1000000).all())
    say(phase, f"camera with no basis (NaN directions) at "
        f"{cam.proj_size[0]}x{cam.proj_size[1]}: words differing from the "
        f"plain versions: "
        + ", ".join(f"{k} shadows={sh} {n}" for (k, sh), n in bad.items())
        + f"; every pixel 0xFF000000: {sky}")
    check(not any(bad.values()), "a NaN-direction frame disagrees with its "
          "plain version")
    check(sky, "a NaN-direction pixel is not 0xFF000000")


def mark_order():
    """int64[129]: the in-tile pixels (y * 16 + x) of a 16x8 tile in the
    order ``touched4``'s camera kernel (``csrc/planes4.cu``
    ``touched4_camera_kernel``) evaluates them, which stops at the first
    ray that starts: the tile's representative (its centre, 8, 4), alone;
    then four passes of a warp, lane l of pass j at pixel (2 (l % 8) +
    j % 2, 2 (l // 8) + j // 2), each pass whole."""
    j, lane = torch.meshgrid(torch.arange(4), torch.arange(32), indexing="ij")
    passes = (2 * (lane // 8) + j // 2) * 16 + 2 * (lane % 8) + j % 2
    return torch.cat([torch.tensor([4 * 16 + 8]), passes.reshape(-1)])


def mark_rays(scal, height, width):
    """i64[ty, tx]: the rays ``touched4``'s camera kernel
    (``csrc/planes4.cu`` ``touched4_camera_kernel``) evaluates in each
    tile, from the plain version's start flags: the tile's representative
    ray, then, if that one does not start, 32 rays a pass up to the first
    pass in which a ray starts (4 passes when none does); none in an
    invalid tile or in a launch whose camera is not strictly inside the
    world or whose step cap is 0."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    sf = [float(x) for x in scal.cpu().numpy()]
    ty, tx = -(-height // 8), -(-width // 16)
    act = t4.start_flags(scal, height=height, width=width).reshape(
        height, width).to(torch.int32)
    a = torch.nn.functional.pad(act, (0, tx * 16 - width, 0, ty * 8 - height))
    a = a.reshape(ty, 8, tx, 16).permute(0, 2, 1, 3).reshape(ty, tx, 128)
    a = a[..., mark_order().to(a.device)]
    by_pass = a[..., 1:].reshape(ty, tx, 4, 32).amax(-1)
    passes = torch.where(by_pass.any(-1), by_pass.argmax(-1) + 1, 4)
    rays = torch.where(a[..., 0] != 0, 1, 1 + 32 * passes)
    live = (all(0.0 < c < sf[3] for c in sf[:3])
            and t4._step_cap(sf) > 0)
    valid = ((torch.arange(tx, device=a.device) < sf[25])[None, :]
             & (torch.arange(ty, device=a.device) < sf[26])[:, None])
    return rays * valid * live


def compare_mark_edges(rg, prep, lut, v, phase):
    """``touched4``'s camera marks vs the plain version, bit for bit, at
    the edges of the kernel's design: its uniform exits (a camera outside
    the world, one 0.0004 voxels outside a face, a step cap of 0), a
    camera with no basis, a frame of partial tiles and a camera 0.0004
    voxels inside a world face."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4
    from voxelraytracing_tpu_torch.ops.camera import CamData

    static = bench_cams(v, WIDTH, HEIGHT)[0]
    cams = {
        "outside": CamData.create((30.0, 45.0, 0.0), (-50.0, 150.0, 128.0),
                                  70.0, (WIDTH, HEIGHT)),
        "cap 0": static,
        "no basis": no_basis(static),
        "1000x500": bench_cams(v, 1000, 500)[0],
        "face": CamData.create((0.0, 60.0, 0.0), (0.0004, 150.0, 128.0),
                               70.0, (WIDTH, HEIGHT)),
        "outside a face": CamData.create((0.0, 180.0, 0.0),
                                         (-0.0004, 150.0, 128.0), 70.0,
                                         (WIDTH, HEIGHT)),
    }
    bad, info = {}, []
    for name, cam in cams.items():
        args, kw = frame_inputs(rg, prep, cam, lut)
        scal = args[0]
        if name == "cap 0":
            scal = scal.clone()
            scal[23] = 0.75  # truncates to a cap of 0
        dims = dict(height=kw["height"], width=kw["width"])
        got = t4.touched4(scal, **dims)
        want = t4.touched4_ref(scal, **dims)
        bad[name] = words_differ(got, want)
        info.append(f"{name} {dims['width']}x{dims['height']}: "
                    f"{int(want.sum())} of {want.numel()} tiles marked, "
                    f"rays evaluated {int(mark_rays(scal, **dims).sum())}")
    say(phase, "camera marks at the edges, bytes differing from the plain "
        "version: " + ", ".join(f"{k} {n}" for k, n in bad.items())
        + "; " + "; ".join(info))
    check(not any(bad.values()), "touched4 camera marks disagree at an edge")


def event_ms(fn, n):
    """Milliseconds per call of ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def median_windows(fn, n):
    fn(0)
    fn(1)
    torch.cuda.synchronize()
    return statistics.median(event_ms(fn, n) for _ in range(WINDOWS))


def graph_ms(fn, n):
    """Device milliseconds per call of ``n`` calls captured in one CUDA
    graph, median of replays: the kernels' time with no host work (the
    wrapper's checks and allocation, the ctypes call) between launches."""
    fn(0)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    return statistics.median(event_ms(lambda i: g.replay(), 1) / n
                             for _ in range(WINDOWS))


def time_kernel(out, key, fn):
    """``out[key]``: ms per wrapper call, back to back (host included);
    ``out[key + "_dev"]``: the same calls' device ms (:func:`graph_ms`)."""
    out[key] = median_windows(fn, N_ORBIT)
    out[key + "_dev"] = graph_ms(fn, N_ORBIT)


def launch_floor():
    """Device ms of an empty kernel (one block of 32 threads), timed as
    the kernels are: N_ORBIT launches in one CUDA graph."""
    from voxelraytracing_tpu_torch import _build

    empty = _build.load("probes3").empty_launch
    return graph_ms(lambda i: empty(torch.cuda.current_stream().cuda_stream),
                    N_ORBIT)


def plain_ms(fn):
    return statistics.median(event_ms(lambda i: fn(), 1) for _ in range(3))


def time_primary(rg, prep, lut, mats, v, phase, n_orbit=N_ORBIT):
    """ms/frame of the unshadowed frame (fused, and render_packed's v4
    route, the split frame), the kernel alone and the plain version at
    1080p, and the primary steps of the static frame (the default route,
    the v3 frame, is timed in phase 23)."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        frame_args, march_fused4, march_fused4_ref, render_frame4)

    static, orbit = bench_cams(v, WIDTH, HEIGHT, n_orbit)
    tok = [None]

    def frame(cam):
        _, tok[0] = render_frame4(rg, cam, lut, prepared=prep, cache=tok[0],
                                  return_cache=True, **BENCH_KW)

    def args_of(cam):
        return frame_args(rg, cam, lut, prepared=prep,
                          rounds=BENCH_KW["rounds"],
                          steps_per_round=BENCH_KW["steps_per_round"],
                          step_cap=BENCH_KW["step_cap"])

    out = {}
    out["frame_static"] = median_windows(lambda i: frame(static), N_ORBIT)
    out["frame_orbit"] = median_windows(lambda i: frame(orbit[i % n_orbit]),
                                        N_ORBIT)
    # the renderer's v4 route (the split frame)
    renderer = WavefrontRenderer(mats, tracer="v4")
    settings = RenderSettings(sun_pos=sun_of(static))
    out["packed_static"] = median_windows(
        lambda i: renderer.render_packed(rg, static, settings), N_ORBIT)
    sa, skw = args_of(static)
    time_kernel(out, "kernel_static", lambda i: march_fused4(*sa, **skw))
    oargs = [args_of(c) for c in orbit]
    time_kernel(out, "kernel_orbit", lambda i: march_fused4(
        *oargs[i % n_orbit][0], **oargs[i % n_orbit][1]))
    out["plain_static"] = plain_ms(lambda: march_fused4_ref(*sa, **skw))
    out["plain_orbit"] = statistics.median(
        event_ms(lambda i, c=c: march_fused4_ref(*oargs[c][0], **oargs[c][1]),
                 1) for c in (0, n_orbit // 3, 2 * n_orbit // 3))
    fl = march_fused4(*sa, **skw)[1]
    out["steps"] = int(((fl >> 5) & 0xFFF).sum())
    say_simt(phase, f"{v}^3 world, static {WIDTH}x{HEIGHT} primary",
             (fl >> 5) & 0xFFF)
    out["rows"] = int(hit_rows_of(rg, sa, skw, fl).numel())
    rays = WIDTH * HEIGHT
    for k in ("static", "orbit"):
        say(phase, f"{k}: frame {out['frame_' + k]:.4f} ms "
            f"({rays / out['frame_' + k] / 1e3:.3f} Mrays/s), kernel "
            f"{out['kernel_' + k]:.4f} ms a call, "
            f"{out['kernel_' + k + '_dev']:.4f} ms on the device "
            f"({rays / out['kernel_' + k + '_dev'] / 1e3:.3f} Mrays/s), plain "
            f"{out['plain_' + k]:.2f} ms "
            f"({rays / out['plain_' + k] / 1e3:.3f} Mrays/s)")
    say(phase, f"static steps {out['steps']}, hit subwindow rows "
        f"{out['rows']}")
    say(phase, f"static: render_packed (v4 route, split frame) "
        f"{out['packed_static']:.4f} ms a frame "
        f"({rays / out['packed_static'] / 1e3:.3f} Mrays/s)")
    return out


def hit_rows_of(rg, args, kw, fl):
    """Distinct subwindow rows holding a primary frame's hit points."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    h, w = kw["height"], kw["width"]
    ts = t4.march_planes4(args[0], args[1], args[3], args[4], height=h,
                          width=w)[0]
    sf = [float(x) for x in args[0].cpu().numpy()]
    rays = t4._camera_rays(sf, *t4._pixels(h, w, ts.device))
    o = torch.stack(rays[:3], -1).reshape(h, w, 3)
    d = torch.stack(rays[3:], -1).reshape(h, w, 3)
    ns = t4._world_dims(args[3], args[4])[1]
    return hit_rows(args[3], o, d, ts, ((fl >> 1) & 1) != 0, ns)


def time_shadows(rg, prep, lut, v, size, phase):
    """ms of the fused and split shadowed frames, each kernel alone and
    the plain versions, plus the step and row counts of the static
    frame."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    w, h = size
    static, orbit = bench_cams(v, w, h)
    out = {}

    def frame(cam, fused):
        t4.render_frame4(rg, cam, lut, prepared=prep, shadows=True,
                         sun_pos=sun_of(cam), **{**BENCH_KW, "fused": fused})

    for fused, name in ((True, "fused"), (False, "split")):
        out[f"{name}_frame_static"] = median_windows(
            lambda i: frame(static, fused), N_ORBIT)
        out[f"{name}_frame_orbit"] = median_windows(
            lambda i: frame(orbit[i % N_ORBIT], fused), N_ORBIT)
    sa, skw = frame_inputs(rg, prep, static, lut)
    oargs = [frame_inputs(rg, prep, c, lut) for c in orbit]
    time_kernel(out, "fused_kernel_static",
                lambda i: t4.march_fused4(*sa, **skw))
    time_kernel(out, "fused_kernel_orbit", lambda i: t4.march_fused4(
        *oargs[i % N_ORBIT][0], **oargs[i % N_ORBIT][1]))
    p = split_parts(sa, skw)
    sc, g, swc, wmp, dims = p["scal"], p["gw2"], p["swc"], p["wmp"], p["dims"]
    bundle = p["bundle"]
    ts, fl, wa, we = p["planes"]
    skw2 = dict(show_steps=False, shadows=True, max_steps=skw["max_steps"])
    time_kernel(out, "touched_camera", lambda i: t4.touched4(sc, **dims))
    time_kernel(out, "touched_rays",
                lambda i: t4.touched4(sc, *bundle, **dims))
    time_kernel(out, "planes_camera",
                lambda i: t4.march_planes4(sc, g, swc, wmp, **dims))
    time_kernel(out, "planes_rays",
                lambda i: t4.march_planes4(sc, g, swc, wmp, *bundle, **dims))
    time_kernel(out, "shade", lambda i: t4.shade4(
        p["srow"], p["lut"], ts, fl, wa, we, p["sh"], **skw2))
    out["plain_fused"] = plain_ms(lambda: t4.march_fused4_ref(*sa, **skw))
    out["mark_rays_camera"] = int(mark_rays(sc, **dims).sum())
    out["plain_touched_camera"] = plain_ms(
        lambda: t4.touched4_ref(sc, **dims))
    out["plain_touched_rays"] = plain_ms(
        lambda: t4.touched4_ref(sc, *bundle, **dims))
    out["plain_planes_camera"] = plain_ms(
        lambda: t4.march_planes4_ref(sc, g, swc, wmp, **dims))
    out["plain_planes_rays"] = plain_ms(
        lambda: t4.march_planes4_ref(sc, g, swc, wmp, *bundle, **dims))
    out["plain_shade"] = plain_ms(
        lambda: t4.shade4_ref(p["srow"], p["lut"], ts, fl, wa, we, p["sh"],
                              **skw2))
    # what the bounds need: steps of both legs, rows holding hit points
    out["steps_primary"] = int(((fl >> 5) & 0xFFF).sum())
    sfl = p["shadow"][1]
    out["steps_shadow"] = int(((sfl >> 5) & 0xFFF).sum())
    say_simt(phase, f"{w}x{h} static, both legs a pixel",
             ((fl >> 5) & 0xFFF) + ((sfl >> 5) & 0xFFF))
    ns = t4._world_dims(swc, wmp)[1]
    prim = hit_rows_of(rg, sa, skw, fl)
    shad = hit_rows(swc, bundle[0], bundle[1], p["shadow"][0],
                    ((sfl >> 1) & 1) != 0, ns)
    out["rows_primary"] = int(prim.numel())
    out["rows_shadow"] = int(shad.numel())
    out["rows_both"] = int(torch.unique(torch.cat([prim, shad])).numel())
    out["pixels"] = w * h
    rays2 = 2 * w * h
    for name in ("fused", "split"):
        for k in ("static", "orbit"):
            t = out[f"{name}_frame_{k}"]
            say(phase, f"{w}x{h} {name} shadowed frame {k}: {t:.4f} ms "
                f"({rays2 / t / 1e3:.3f} Mrays/s at 2 rays/pixel)")
    for k in ("fused_kernel_static", "fused_kernel_orbit", "touched_camera",
              "touched_rays", "planes_camera", "planes_rays", "shade"):
        say(phase, f"{w}x{h} {k}: {out[k]:.4f} ms a call, "
            f"{out[k + '_dev']:.4f} ms on the device")
    say(phase, f"{w}x{h} (planes_* is one march_planes4 call: the marks and "
        f"the march)")
    say(phase, f"{w}x{h} plain static: fused {out['plain_fused']:.2f} ms, "
        f"touched camera {out['plain_touched_camera']:.2f} ms, touched rays "
        f"{out['plain_touched_rays']:.2f} ms, planes camera "
        f"{out['plain_planes_camera']:.2f} ms, planes rays "
        f"{out['plain_planes_rays']:.2f} ms, shade "
        f"{out['plain_shade']:.2f} ms")
    say(phase, f"{w}x{h} static steps: primary {out['steps_primary']}, "
        f"shadow {out['steps_shadow']}, all "
        f"{out['steps_primary'] + out['steps_shadow']}; hit subwindow rows: "
        f"primary {out['rows_primary']}, shadow {out['rows_shadow']}")
    return out


def bound(bytes_moved, ops):
    """(least ms, what bounds it) for ``bytes_moved`` at the HBM rate and
    ``ops`` at the FP32 rate."""
    t_b, t_o = bytes_moved / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# warp footprints (pixels wide x high) whose SIMT efficiency phases 10, 11,
# 15 and 18 print: 16x2 (a warp of a 16x8 tile, row-major) and 8x4 (the
# v4 kernels')
FOOTPRINTS = ((16, 2), (8, 4))


def simt_efficiency(steps, fw, fh):
    """SIMT efficiency of one thread a pixel with ``fw`` x ``fh`` pixels a
    warp, from each pixel's march steps: the mean over warps that step of
    (sum of the steps) / (32 x the warp's largest), and the step-weighted
    (sum of all steps) / (sum of 32 x each warp's largest)."""
    h, w = steps.shape
    s = steps[:h - h % fh, :w - w % fw].double().reshape(
        h // fh, fh, w // fw, fw).permute(0, 2, 1, 3).reshape(-1, fw * fh)
    mx, tot = s.max(1).values, s.sum(1)
    m = mx > 0
    return (float((tot[m] / (32 * mx[m])).mean()),
            float(tot.sum() / (32 * mx.sum())))


def say_simt(phase, what, steps):
    """Print the SIMT efficiency of a frame's per-pixel steps for each of
    :data:`FOOTPRINTS`."""
    eff = {f: simt_efficiency(steps, *f) for f in FOOTPRINTS}
    say(phase, f"{what}: SIMT efficiency of one thread a pixel (mean over "
        f"warps; step-weighted) " + ", ".join(
            f"{fw}x{fh} {m:.4f}; {wt:.4f}" for (fw, fh), (m, wt)
            in eff.items()))


def simt_compacted(steps, live):
    """SIMT efficiency of a bounce leg as ``pt4`` marches it: in each
    16x8 tile the live rays, in the order of the tile's four 8x4 groups
    (2x2, each row-major), packed into as few warps as they need; mean
    over warps that step, and step-weighted, as :func:`simt_efficiency`."""
    h, w = steps.shape
    h8, w16 = h - h % 8, w - w % 16

    def tiles(x):
        return x[:h8, :w16].reshape(h8 // 8, 2, 4, w16 // 16, 2, 8).permute(
            0, 3, 1, 4, 2, 5).reshape(-1, 128)

    s, lv = tiles(steps.double()), tiles(live)
    order = torch.sort((~lv).to(torch.int8), dim=1, stable=True).indices
    s = (torch.gather(s, 1, order) * torch.gather(lv, 1, order)).reshape(-1, 32)
    mx, tot = s.max(1).values, s.sum(1)
    m = mx > 0
    return (float((tot[m] / (32 * mx[m])).mean()),
            float(tot.sum() / (32 * mx.sum())))


def shadow_bounds(sh):
    """Least times of the shadowed frame's kernels on the static camera:
    tables as the rows holding hit points, read once; inputs read once and
    outputs written once; the march steps both legs took."""
    px = sh["pixels"]
    return {
        "fused_kernel_static": bound(
            sh["rows_both"] * ROW_BYTES + 8 * px,
            (sh["steps_primary"] + sh["steps_shadow"]) * STEP_OPS
            + px * PIXEL_OPS),
        # start marks: one byte a 128-ray tile out; bundles in for rays
        "touched_camera": bound(px / 128, px * MARK_OPS_CAMERA),
        # the same on the rays the camera kernel's order evaluates
        "touched_camera_evaluated": bound(
            px / 128, sh["mark_rays_camera"] * MARK_OPS_CAMERA),
        "touched_rays": bound(25 * px + px / 128, px * MARK_OPS_RAYS),
        # camera planes: 4 planes out; camera ray + ray constants a pixel
        "planes_camera": bound(sh["rows_primary"] * ROW_BYTES + 16 * px,
                               sh["steps_primary"] * STEP_OPS + px * 45),
        # bundle planes: origins, directions and the active byte in too
        "planes_rays": bound(sh["rows_shadow"] * ROW_BYTES + 41 * px,
                             sh["steps_shadow"] * STEP_OPS + px * 21),
        # shade: 5 planes in, packed word out
        "shade": bound(24 * px, px * PIXEL_OPS),
    }


def count_main_path(rg, mats, v):
    """The main paths, each driven with the counts set to 0 just before
    and read just after: 10 frames through render_packed's v4 route
    (``tracer="v4"``: the split frame; its default route, the v3 frame, is
    counted in phase 22) and 10 through render_frame4(fused=True),
    unshadowed (phase 6) and shadowed (phase 9)."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        STEP_CAP, STEPS_PER_ROUND, RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    counters = (t4.march_fused4, t4.march_planes4, t4.touched4, t4.shade4)
    _, orbit = bench_cams(v, WIDTH, HEIGHT)
    prep = t4.prepare_grid4(rg)
    counts = {}
    renderer = WavefrontRenderer(mats, tracer="v4")
    for shadows, phase in ((False, 6), (True, 9)):
        for c in counters:
            c.launches = 0
        for cam in orbit[:10]:
            settings = RenderSettings(sun_pos=sun_of(cam), shadows=shadows)
            img = renderer.render_packed(rg, cam, settings)
        torch.cuda.synchronize()
        counts["packed", shadows] = [c.launches for c in counters]
        args, kw = t4.frame_args(
            rg, orbit[9], mats.color, sun_pos=settings.sun_pos,
            shadows=shadows, steps_per_round=STEPS_PER_ROUND,
            step_cap=STEP_CAP, prepared=prep)
        rimg, _ = t4.march_fused4_ref(*args, **kw)
        alpha_ok = bool(((img >> 24) & 255 == 255).all())
        say(phase, f"render_packed(v4) x10 shadows={shadows}: launches "
            f"fused/planes/touched/shade {counts['packed', shadows]}, frame "
            f"{tuple(img.shape)} {img.dtype}, alpha ok {alpha_ok}, last "
            f"frame == plain version: {bool((img == rimg).all())}")
        legs = 2 if shadows else 1
        check(counts["packed", shadows] == [0, 10 * legs, 10 * legs, 10],
              "render_packed did not draw the split frame once per frame")
        check(alpha_ok and bool((img == rimg).all()),
              "render_packed frame disagrees with the plain version")
        for c in counters:
            c.launches = 0
        for cam in orbit[:10]:
            t4.render_frame4(rg, cam, mats.color, prepared=prep,
                             shadows=shadows, sun_pos=sun_of(cam),
                             **BENCH_KW)
        torch.cuda.synchronize()
        counts["fused", shadows] = [c.launches for c in counters]
        say(phase, f"render_frame4(fused=True) x10 shadows={shadows}: "
            f"launches fused/planes/touched/shade "
            f"{counts['fused', shadows]}")
        check(counts["fused", shadows] == [10, 0, 0, 0],
              "the fused frame did not launch the fused kernel once a frame")
    return counts


# ------------------------------------------------------------ path tracing

# config3's frame (benchmarks/run.py:354-415): one bounce, one sample, a
# 500-step cap; the sun of sun_of
PT_KW = dict(bounces=1, samples=1, step_cap=500)
N_ORBIT_PT = 12
# the mirror table of tests/test_pathtrace4.py:53-66: scatter 0 for every
# material, so no bounce draws a random number; voxel 1 emits
MIRROR = {
    1: {"color": (0.55, 0.55, 0.55), "state": "solid", "scatter": 0.0,
        "emission": 0.5},
    2: {"color": (0.55, 0.35, 0.15), "state": "solid", "scatter": 0.0},
    3: {"color": (0.30, 0.68, 0.24), "state": "solid", "scatter": 0.0},
    4: {"color": (0.12, 0.30, 0.85), "state": "liquid", "scatter": 0.0},
}
# FP32 operations of a path outside its march steps: its camera ray and
# ray constants once a sample (45); at each leg end the water (3),
# absorption, emission and albedo (12) and the next leg's ray constants
# (21). The sky, Box-Muller and every transcendental are not counted, so
# the bound stays a least time.
PT_SAMPLE_OPS = 45
PT_LEG_OPS = 36
PT_BAR = 0.99  # share of pixels within 2/255 (tools/tpu_correctness.py:190)


def pt_bar(a, b):
    """Share of pixels of two radiance frames whose every channel is
    within 2/255."""
    return float(((a - b).abs().amax(dim=-1) <= 2.0 / 255.0).float().mean())


def pt_args(rg, mats, cam, prepared=None):
    """``pt4``'s arguments of a config3 frame, and its (height, width)."""
    from voxelraytracing_tpu_torch.ops.pathtrace3 import pt_inputs

    return pt_inputs(rg, cam, mats, sun_pos=sun_of(cam),
                     step_cap=PT_KW["step_cap"], prepared=prepared)


def pt_frame(fn, rg, mats, cam, **kw):
    """A config3 frame through the entry point ``fn``."""
    return fn(rg, cam, mats, sun_pos=sun_of(cam), **{**PT_KW, **kw})


def pt_bounce_bundle(args, dims, full_size):
    """The camera leg's planes of a one-bounce frame on the v4 route and
    the bounce bundle path_trace3 makes from them (default key)."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import prng
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    scal, gw2, mlut, swc, wmp = args
    h, w = dims
    sf = [float(x) for x in scal.cpu().numpy()]
    pxi, pyi = t4._pixels(h, w, scal.device)
    planes = t4.march_planes4(scal, gw2, swc, wmp, height=h, width=w)
    ts, fl = planes[0].reshape(-1), planes[1].reshape(-1)
    mat = p3.matfetch4_ref(fl, mlut)
    base = p3._sample_base(prng.fold_in(prng.split(None, 1)[0], 0))
    rays = p3._bounce_rays(t4._camera_rays(sf, pxi, pyi), ts, (fl >> 2) & 7,
                           mat.scatter, p3.ray_ids(pxi, pyi, *full_size),
                           base)
    return planes, p3._bundle(rays, ((fl >> 1) & 1) != 0, h, w)


def pt_leg_flags(args, dims, full_size):
    """The flags planes of both legs of a one-bounce frame on the v4
    route."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    scal, gw2, _, swc, wmp = args
    planes, bundle = pt_bounce_bundle(args, dims, full_size)
    return planes[1], t4.march_planes4(scal, gw2, swc, wmp, *bundle,
                                       height=dims[0], width=dims[1])[1]


def compare_pt(worlds, cams, phase):
    """pt4 vs pt4_ref with 0, 1 and 2 bounces on both tables; the two
    routes against each other where nothing is drawn; matfetch4 vs
    matfetch4_ref on the flags of both legs of the one-bounce frame.
    Returns the largest differences of pt4 and matfetch4."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4

    bad = dict(exact=0, routes=0, mat=0, finite=0)
    diffuse_words = frames = 0
    worst_bar, err, mat_err = 1.0, 0.0, 0.0
    for cam in cams:
        for name, (rg, mats) in worlds.items():
            args, (h, w) = pt_args(rg, mats, cam)
            for bounces in (0, 1, 2):
                kw = dict(height=h, width=w, bounces=bounces, samples=1)
                got = p4.pt4(*args, **kw)
                ref = p4.pt4_ref(*args, **kw)
                frames += 1
                bad["finite"] += int((~torch.isfinite(got)).sum())
                err = max(err, float((got - ref).abs().max()))
                if name == "mirror" or bounces == 0:
                    bad["exact"] += words_differ(got, ref)
                    v4 = pt_frame(p3.path_trace3, rg, mats, cam,
                                  bounces=bounces, v4=True)
                    bad["routes"] += words_differ(v4, got)
                else:
                    diffuse_words += words_differ(got, ref)
                    worst_bar = min(worst_bar, pt_bar(got, ref))
            if name == "demo":
                for fl in pt_leg_flags(args, (h, w), cam.proj_size):
                    a = p3.matfetch4(fl, args[2])
                    b = p3.matfetch4_ref(fl, args[2])
                    bad["mat"] += sum(words_differ(x, y) for x, y in zip(a, b))
                    mat_err = max(mat_err, max(float((x - y).abs().max())
                                               for x, y in zip(a, b)))
    w, h = cams[0].proj_size
    say(phase, f"{len(cams)} cameras at {w}x{h}, {frames} pt4 frames "
        f"(bounces 0-2, demo and mirror tables): pt4 vs plain differing "
        f"words where nothing is drawn {bad['exact']}, on diffuse bounces "
        f"{diffuse_words} (worst share within 2/255 {worst_bar:.6f}, max abs "
        f"diff {err}); fused vs path_trace3 where nothing is drawn "
        f"{bad['routes']}; matfetch4 vs plain on both legs' flags "
        f"{bad['mat']}; non-finite {bad['finite']}")
    check(bad["exact"] == 0 and bad["routes"] == 0 and bad["mat"] == 0
          and bad["finite"] == 0, "path tracers disagree on the card")
    check(worst_bar >= PT_BAR, "pt4 misses the path-tracing bar")
    return err, mat_err


def compare_pt_cpu(cpu_worlds, worlds, v, phase):
    """Both routes with one bounce on the card vs the plain versions on
    the CPU at 320x180: the path-tracing bar."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4

    static, orbit = bench_cams(v, 320, 180, N_ORBIT_PT)
    worst, words, n = 1.0, 0, 0
    for cam in [static, orbit[N_ORBIT_PT // 3]]:
        for name in worlds:
            for fn, kw in ((p3.path_trace3, dict(v4=True)),
                           (p4.path_trace_fused4, {})):
                a = pt_frame(fn, *worlds[name], cam, **kw).cpu()
                b = pt_frame(fn, *cpu_worlds[name], cam, **kw)
                worst = min(worst, pt_bar(a, b))
                words += words_differ(a, b)
                n += 1
    say(phase, f"{n} one-bounce frames at 320x180 (both routes, demo and "
        f"mirror tables), card vs CPU: worst share of pixels within 2/255 "
        f"{worst:.6f} (differing words {words})")
    check(worst >= PT_BAR, "path tracers miss the bar against the CPU")


def count_pt_main_path(rg, mats, cams, phase):
    """The two path-tracing paths, each driven with the counts set to 0
    just before and read just after: config3 frames through path_trace3
    (v4 route) and through path_trace_fused4. The last fused frame is
    held against the plain version, the routes' mean radiance against
    each other (their draws differ: within 5%, as
    tests/test_pathtrace4.py:93-104 holds them)."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    counters = (p3.matfetch4, t4.march_planes4, t4.touched4, p4.pt4,
                t4.march_fused4, t4.shade4)
    prep = t4.prepare_grid4(rg)
    counts, last = {}, {}
    for route, fn, kw in (("path_trace3", p3.path_trace3, dict(v4=True)),
                          ("fused", p4.path_trace_fused4, {})):
        for c in counters:
            c.launches = 0
        for cam in cams:
            img = pt_frame(fn, rg, mats, cam, prepared=prep, **kw)
        torch.cuda.synchronize()
        counts[route] = [c.launches for c in counters]
        last[route] = img
    args, (h, w) = pt_args(rg, mats, cams[-1], prep)
    ref = p4.pt4_ref(*args, height=h, width=w, bounces=PT_KW["bounces"],
                     samples=PT_KW["samples"])
    bar = pt_bar(last["fused"], ref)
    means = [float(last[r].mean()) for r in ("path_trace3", "fused")]
    ok = all(tuple(x.shape) == (HEIGHT, WIDTH, 3)
             and bool(torch.isfinite(x).all()) and bool((x >= 0).all())
             for x in last.values())
    n = len(cams)
    for route in ("path_trace3", "fused"):
        say(phase, f"{route} x{n} config3 frames: launches matfetch4/planes/"
            f"touched/pt4/fused/shade {counts[route]}")
    say(phase, f"last frames {tuple(last['fused'].shape)} finite and "
        f"non-negative {ok}; fused vs plain within 2/255 {bar:.6f}; mean "
        f"radiance path_trace3 {means[0]:.6f}, fused {means[1]:.6f}")
    check(counts["path_trace3"] == [2 * n, 2 * n, 2 * n, 0, 0, 0],
          "path_trace3 did not launch the march and the fetch twice a frame")
    check(counts["fused"] == [0, 0, 0, n, 0, 0],
          "path_trace_fused4 did not launch pt4 once a frame")
    check(ok and bar >= PT_BAR, "path-traced frames are wrong")
    check(abs(means[0] - means[1]) <= 0.05 * means[1],
          "the two routes' mean radiance differs by more than 5%")
    return counts


def time_pt(rg, mats, static, orbit, phase):
    """ms a config3 frame of both routes (static, orbit), matfetch4 and
    pt4 alone (wrapper calls and CUDA-graph device time) and their plain
    versions, and what the bounds need, on the static camera."""
    from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    prep = t4.prepare_grid4(rg)
    n = len(orbit)
    out = {}
    for route, fn, kw in (("path_trace3", p3.path_trace3, dict(v4=True)),
                          ("fused", p4.path_trace_fused4, {})):
        out[route + "_static"] = median_windows(lambda i: pt_frame(
            fn, rg, mats, static, prepared=prep, **kw), n)
        out[route + "_orbit"] = median_windows(lambda i: pt_frame(
            fn, rg, mats, orbit[i % n], prepared=prep, **kw), n)
    args, (h, w) = pt_args(rg, mats, static, prep)
    pkw = dict(height=h, width=w, bounces=PT_KW["bounces"],
               samples=PT_KW["samples"])
    fl = t4.march_planes4(args[0], args[1], args[3], args[4], height=h,
                          width=w)[1]
    time_kernel(out, "matfetch4", lambda i: p3.matfetch4(fl, args[2]))
    bundle = pt_bounce_bundle(args, (h, w), static.proj_size)[1]
    time_kernel(out, "planes_bounce", lambda i: t4.march_planes4(
        args[0], args[1], args[3], args[4], *bundle, height=h, width=w))
    time_kernel(out, "pt4", lambda i: p4.pt4(*args, **pkw))
    out["plain_matfetch4"] = plain_ms(lambda: p3.matfetch4_ref(fl, args[2]))
    out["plain_pt4"] = plain_ms(lambda: p4.pt4_ref(*args, **pkw))
    _, out["steps"], out["legs"] = p4.pt4_run(*args, **pkw)
    out["pixels"] = h * w
    # the bounce bundle's steps and the rows holding its hit points
    bts, bfl = t4.march_planes4(args[0], args[1], args[3], args[4], *bundle,
                                height=h, width=w)[:2]
    out["steps_bounce"] = int(((bfl >> 5) & 0xFFF).sum())
    say_simt(phase, f"{w}x{h} static config3 frame, camera leg",
             (fl >> 5) & 0xFFF)
    say_simt(phase, f"{w}x{h} static config3 frame, bounce leg (a lane "
             f"for every pixel)", (bfl >> 5) & 0xFFF)
    out["simt_bounce_compacted"] = simt_compacted((bfl >> 5) & 0xFFF,
                                                  bundle[2])
    say(phase, f"{w}x{h} static config3 frame, bounce leg with each "
        f"tile's live paths compacted into whole warps (pt4's bounce legs):"
        f" SIMT efficiency (mean over warps; step-weighted) "
        f"{out['simt_bounce_compacted'][0]:.4f}; "
        f"{out['simt_bounce_compacted'][1]:.4f}; live paths "
        f"{int(bundle[2].sum())} of {h * w}")
    out["rows_bounce"] = int(hit_rows(
        args[3], bundle[0], bundle[1], bts, ((bfl >> 1) & 1) != 0,
        t4._world_dims(args[3], args[4])[1]).numel())
    rays2 = 2 * h * w
    for route in ("path_trace3", "fused"):
        for k in ("static", "orbit"):
            t = out[f"{route}_{k}"]
            say(phase, f"{w}x{h} {route} config3 frame {k}: {t:.4f} ms "
                f"({rays2 / t / 1e3:.3f} Mrays/s at 2 rays/pixel)")
    for k in ("matfetch4", "pt4", "planes_bounce"):
        say(phase, f"{w}x{h} {k}: {out[k]:.4f} ms a call, "
            f"{out[k + '_dev']:.4f} ms on the device"
            + (f", plain {out['plain_' + k]:.2f} ms"
               if "plain_" + k in out else ""))
    say(phase, f"{w}x{h} (planes_bounce is the bounce leg of path_trace3: "
        f"marks and march of its bundle)")
    say(phase, f"{w}x{h} static pt4 legs: {out['legs']} rays marched, "
        f"{out['steps']} steps; the bounce bundle: {out['steps_bounce']} "
        f"steps, hit subwindow rows {out['rows_bounce']}")
    return out


def pt_bounds(tp):
    """Least times on the static camera: matfetch4 moves 24 B a pixel
    (flags in, five planes out); pt4 writes 12 B a pixel and does the
    steps its legs took plus the per-sample and per-leg work; the bounce
    bundle's planes, as the shadow bundle's (shadow_bounds)."""
    px = tp["pixels"]
    return {
        "matfetch4": bound(24 * px, 0),
        "planes_bounce": bound(tp["rows_bounce"] * ROW_BYTES + 41 * px,
                               tp["steps_bounce"] * STEP_OPS + px * 21),
        "pt4": bound(12 * px + 10 * 128 * 4,
                     tp["steps"] * STEP_OPS + px * PT_KW["samples"]
                     * PT_SAMPLE_OPS + tp["legs"] * PT_LEG_OPS),
    }


# --------------------------------------------------- streaming world, sparse

# config4ck's strip (benchmarks/run.py:586-633): NX x NY x NZ chunks at
# window cells (i, j, k + (W - NZ) // 2), streamed column by column
NX, NY, NZ = 32, 3, 8
STRIP_SEED = 7
N_PREFILL = 8
N_STREAM = 23          # columns streamed after the prefill (config4ck)
FRAMES_PER_COL = 4
W40_COLS = 21          # columns installed at W=40: the last window half full
N_STRIP_CAMS = 13
CHECK_EVERY = 8        # streamed frames between kernel-vs-plain checks
STEP_CHUNKS = 128      # chunks a streaming step installs (config4b)
N_STEPS = 8
MIN_HIT = 0.10         # share of a fly-through frame's pixels that must hit
STATIC_FX = 8.0        # the static W=80 frame's camera, in chunks along x


def strip_grids():
    """Demo terrain of the strip (seed 7, height scale 80, sea level 40),
    generated in 8x8x8-chunk blocks along x, keeping the NY lowest chunk
    layers: {(i, j, k): pack-id grid}."""
    from voxelraytracing_tpu_torch.ops import noise
    from voxelraytracing_tpu_torch.world.demo import demo_chunk_grids_host

    perm = noise.make_permutation(STRIP_SEED)
    out = {}
    for bx in range(NX // 8):
        grids, cells = demo_chunk_grids_host(perm, (bx * 8, 0, 0), 8, 80, 40)
        for g, c in zip(grids, cells):
            i, j, k = int(c % 8), int((c // 8) % 8), int(c // 64)
            if j < NY:
                out[bx * 8 + i, j, k] = g
    return out


def col_cells(strip, i, w):
    """Strip column ``i`` -> (window-local cells, grids)."""
    keys = [(i, j, k) for j in range(NY) for k in range(NZ)]
    return ([(i, j, k + (w - NZ) // 2) for i, j, k in keys],
            np.stack([strip[key] for key in keys]))


def strip_builder(strip, w, cols, sparse, device="cuda"):
    from voxelraytracing_tpu_torch.world.demo import demo_materials
    from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

    b = RenderGrid3Builder(w, demo_materials(), sparse=sparse, device=device)
    for i in range(cols):
        b.set_chunks(*col_cells(strip, i, w))
    return b


def strip_cam(fx, w, size=(WIDTH, HEIGHT)):
    """A fly-through camera (the role of config4ck's cam_at): above the
    strip's centre line at y=110, x = fx*32, 20 degrees down, looking
    along +x."""
    from voxelraytracing_tpu_torch.ops.camera import CamData

    z = ((w - NZ) // 2 + NZ // 2) * 32.0
    return CamData.create((20.0, 270.0, 0.0), (fx * 32.0, 110.0, z), 70.0,
                          size)


def sparse_consistent(b, prep):
    """Rows named by the window rows carry their subwindow's id or the
    canonical stamp; a -1 lane is an empty subwindow. Returns the count of
    bad lanes."""
    from voxelraytracing_tpu_torch.world.render_grid import _CANON_STAMP

    ns, nw = b.ns, b.nw
    wm = prep.wmeta_pad[:, 0].cpu().numpy().view(np.uint32)
    stamp = prep.sw_cont[:, 6, 8].cpu().numpy().view(np.uint32)
    empty = ~b.s_any_solid & (b.s_all_liq | ~b.s_any_liq)
    l = np.arange(64)
    w = np.arange(nw ** 3)[:, None]
    sids = ((w % nw * 4 + (l & 3)) + ((w // nw) % nw * 4 + ((l >> 2) & 3)) * ns
            + (w // (nw * nw) * 4 + (l >> 4)) * ns * ns)
    rows = wm[:, 64:]
    has = rows != 0xFFFFFFFF
    st = stamp[np.where(has, rows, 0).astype(np.int64)]
    bad = has & (st != sids) & (st != _CANON_STAMP)
    bad |= ~has & ~empty[sids]
    return int(bad.sum()) + int((wm[:, 8:64] != 0).sum())


def frame_kw(prep, cam, shadows, fused):
    return dict(prepared=prep, with_flags=True, sun_pos=sun_of(cam),
                shadows=shadows, **{**BENCH_KW, "fused": fused})


def sparse_plain_check(rg, prep, lut, cam):
    """Each sparse kernel on one frame vs its plain version: the fused
    frame with and without the shadow leg, the state planes of the camera
    rays and of the shadow bundle. Returns (differing words, largest
    difference: fused channel / 255, planes)."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    bad, worst_f, worst_p = 0, 0, 0.0
    for shadows in (False, True):
        args, kw = frame_inputs(rg, prep, cam, lut, shadows=shadows)
        img, fl = t4.march_fused4(*args, **kw)
        rimg, rfl = t4.march_fused4_ref(*args, **kw)
        bad += words_differ(img, rimg) + words_differ(fl, rfl)
        worst_f = max(worst_f, int(channel_diff(img, rimg).max()))
    p = split_parts(args, kw)
    tables = (p["scal"], p["gw2"], p["swc"], p["wmp"])
    for rays, got in (((), p["planes"]), (p["bundle"], p["shadow"])):
        ref = t4.march_planes4_ref(*tables, *rays, **p["mdims"])
        bad += sum(words_differ(x, y) for x, y in zip(got, ref))
        worst_p = max(worst_p, max(float((got[k] - ref[k]).abs().max())
                                   for k in (0, 2, 3)))
    return bad, worst_f / 255.0, worst_p


def phase_w40(strip, lut, phase):
    """Sparse vs dense at W=40 (gs=1): same 21 columns in both builders."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    w = 40
    t0 = time.perf_counter()
    dense = strip_builder(strip, w, W40_COLS, sparse=False)
    sparse = strip_builder(strip, w, W40_COLS, sparse=True)
    pd, ps = dense.prepared(), sparse.prepared()
    gd, gsp = dense.grid(), sparse.grid()
    torch.cuda.synchronize()
    gs = t4._world_dims(ps.sw_cont, ps.wmeta_pad, ps.ns)[2]
    bad_lanes = sparse_consistent(sparse, ps)
    say(phase, f"W={w} strip, {W40_COLS} columns ({W40_COLS * NY * NZ} "
        f"chunks), nw={sparse.nw}, gs={gs}: both builders "
        f"{time.perf_counter() - t0:.1f} s; dense sw_cont "
        f"{pd.sw_cont.numel() * 4 / 1e6:.1f} MB, sparse tables "
        f"{sparse.sparse_tables_mb():.1f} MB ({ps.sw_cont.shape[0]} rows, "
        f"{int((sparse._sp_row >= 0).sum())} subwindows with a row); "
        f"inconsistent index lanes {bad_lanes}")
    check(gs == 1 and bad_lanes == 0, "W=40 sparse tables inconsistent")
    cams = [strip_cam(1 + i, w) for i in range(N_STRIP_CAMS)]
    bad = dict(fused=0, fused_shadow=0, split_shadow=0)
    low_hit = []
    for n, cam in enumerate(cams):
        for name, shadows, fused in (("fused", False, True),
                                     ("fused_shadow", True, True),
                                     ("split_shadow", True, False)):
            a = t4.render_frame4(gd, cam, lut, **frame_kw(pd, cam, shadows,
                                                          fused))
            c = t4.render_frame4(gsp, cam, lut, **frame_kw(ps, cam, shadows,
                                                           fused))
            bad[name] += words_differ(a[0], c[0]) + words_differ(a[1], c[1])
        hit = float(((c[1] >> 1) & 1).float().mean())
        if hit < MIN_HIT:
            low_hit.append((n, hit))
    say(phase, f"{len(cams)} cameras at {WIDTH}x{HEIGHT}, sparse vs dense "
        f"token, differing words (flags + packed): {bad}; frames under "
        f"{MIN_HIT:.0%} hit pixels: {low_hit}")
    check(not any(bad.values()), "sparse frames differ from dense ones")
    check(not low_hit, "a fly-through frame hits too little")
    plain_bad, worst_f, worst_p = 0, 0.0, 0.0
    for cam in (cams[0], cams[len(cams) // 2], cams[-1]):
        b_, wf, wp = sparse_plain_check(gsp, ps, lut, cam)
        plain_bad += b_
        worst_f, worst_p = max(worst_f, wf), max(worst_p, wp)
    say(phase, f"sparse kernels vs plain versions (fused, fused shadow, "
        f"camera and bundle planes) on 3 cameras: differing words "
        f"{plain_bad}")
    check(plain_bad == 0, "a sparse kernel disagrees with its plain version")
    counters = (t4.march_fused4, t4.march_planes4, t4.touched4, t4.shade4)
    counts = {}
    for fused in (True, False):
        for c in counters:
            c.launches = 0
        for cam in cams[:10]:
            t4.render_frame4(gsp, cam, lut, **frame_kw(ps, cam, True, fused))
        torch.cuda.synchronize()
        counts[fused] = [c.launches for c in counters]
    say(phase, f"10 sparse shadowed frames: launches fused/planes/touched/"
        f"shade, fused {counts[True]}, split {counts[False]}")
    check(counts[True] == [10, 0, 0, 0] and counts[False] == [0, 20, 20, 10],
          "sparse shadowed frames launched the wrong kernels")
    # the same fused frame from both tokens, device time in turns: what the
    # sparse mode's extra dependent load costs against the dense table
    cam = cams[len(cams) // 2]
    times = {}
    for name, g, p in (("dense", gd, pd), ("sparse", gsp, ps),
                       ("sparse ", gsp, ps), ("dense ", gd, pd)):
        args, kw = frame_inputs(g, p, cam, lut, shadows=False)
        times[name] = graph_ms(lambda i: t4.march_fused4(*args, **kw),
                               N_ORBIT)
    say(phase, f"fused kernel at {WIDTH}x{HEIGHT} on camera "
        f"{len(cams) // 2}, device ms in turns (dense, sparse, sparse, "
        f"dense): {[round(t, 4) for t in times.values()]}")
    del dense, pd, gd
    torch.cuda.empty_cache()
    return dict(counts=counts, err_fused=worst_f, err_planes=worst_p,
                times=times)


def stream_window(strip, w, lut, check_every=0, phase=None):
    """config4ck's loop on a fresh sparse builder: prefill, then stream
    N_STREAM columns with FRAMES_PER_COL fused frames each, the token
    carried. With ``check_every``, every so many frames the kernel is
    held against its plain version (outside the timed sums). Returns the
    builder, a summary and the host seconds of the builder and of the
    frames."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    b = strip_builder(strip, w, N_PREFILL, sparse=True)
    b.prepared()
    torch.cuda.synchronize()
    out = dict(frames=0, chunks=0, bad=0, checked=0, worst=0, low_hit=[],
               builder_s=0.0, frames_s=0.0)
    tok = None
    fx = 1.0
    for col in range(N_PREFILL, N_PREFILL + N_STREAM):
        t0 = time.perf_counter()
        cells, grids = col_cells(strip, col, w)
        b.set_chunks(cells, grids)
        b.prepared()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["chunks"] += len(cells)
        out["builder_s"] += t1 - t0
        for _ in range(FRAMES_PER_COL):
            fx += 0.25
            cam = strip_cam(fx, w)
            t2 = time.perf_counter()
            rg, prep = b.grid(), b.prepared()
            img, fl, tok = t4.render_frame4(
                rg, cam, lut, rounds=64, step_cap=500, steps_per_round=256,
                prepared=prep, cache=tok, return_cache=True, fused=True,
                with_flags=True)
            torch.cuda.synchronize()
            out["frames_s"] += time.perf_counter() - t2
            out["frames"] += 1
            if check_every and out["frames"] % check_every == 0:
                args, kw = t4.frame_args(rg, cam, lut, prepared=prep,
                                         rounds=64, steps_per_round=256,
                                         step_cap=500)
                rimg, rfl = t4.march_fused4_ref(*args, **kw)
                out["bad"] += words_differ(img, rimg) + words_differ(fl, rfl)
                out["worst"] = max(out["worst"],
                                   int(channel_diff(img, rimg).max()))
                out["checked"] += 1
            hit = float(((fl >> 1) & 1).float().mean())
            if hit < MIN_HIT:
                out["low_hit"].append((out["frames"], hit))
    out["token_rows"] = int(tok[0].shape[1])
    return b, out


def phase_w80(strip, mats, lut, phase):
    """The 80-chunk fly-through, checked: launches, kernel vs plain every
    8th frame, then the CPU builder and card vs CPU, and the other sparse
    kernels vs their plain versions."""
    from voxelraytracing_tpu_torch.core import native
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    w = 80
    counters = (t4.march_fused4, t4.march_planes4, t4.touched4, t4.shade4)
    for c in counters:
        c.launches = 0
    native.sw_rows_build.calls = 0
    b, s = stream_window(strip, w, lut, check_every=CHECK_EVERY)
    counts = [c.launches for c in counters]
    rows_calls = native.sw_rows_build.calls
    prep = b.prepared()
    gs = t4._world_dims(prep.sw_cont, prep.wmeta_pad, prep.ns)[2]
    say(phase, f"W={w} sparse (nw={b.nw}, gs={gs}): {N_PREFILL} columns "
        f"prefilled, {N_STREAM} streamed ({s['chunks']} chunks), "
        f"{s['frames']} fused frames at {WIDTH}x{HEIGHT}, token rows "
        f"{s['token_rows']}; launches fused/planes/touched/shade {counts}; "
        f"kernel vs plain on {s['checked']} frames: differing words "
        f"{s['bad']}; frames under {MIN_HIT:.0%} hit pixels: {s['low_hit']}; "
        f"sparse tables {b.sparse_tables_mb():.1f} MB")
    check(gs == 2 and s["token_rows"] == 3, "W=80 world or token shape")
    check(counts == [s["frames"], 0, 0, 0],
          "the fly-through did not launch the fused kernel once a frame")
    check(s["bad"] == 0 and s["checked"] > 0,
          "the sparse kernel disagrees with its plain version at W=80")
    check(not s["low_hit"], "a fly-through frame hits too little")
    check(sparse_consistent(b, prep) == 0, "W=80 sparse tables inconsistent")

    cpu = strip_builder(strip, w, N_PREFILL, sparse=True, device="cpu")
    cpu.prepared()
    for col in range(N_PREFILL, N_PREFILL + N_STREAM):
        cpu.set_chunks(*col_cells(strip, col, w))
        cpu.prepared()  # as often as the card's builder: same row order
    cprep = cpu.prepared()
    same = (torch.equal(cprep.sw_cont, prep.sw_cont.cpu())
            and torch.equal(cprep.wmeta_pad, prep.wmeta_pad.cpu()))
    hit_bad = vox_bad = within = total = words = 0
    for fx in (2.0, 9.0, 16.0, 23.0):
        cam = strip_cam(fx, w, (320, 180))
        kw = dict(rounds=64, steps_per_round=256, step_cap=500,
                  with_flags=True, fused=True, sun_pos=sun_of(cam))
        img, fl = t4.render_frame4(b.grid(), cam, mats.color, prepared=prep,
                                   **kw)
        rimg, rfl = t4.render_frame4(cpu.grid(), cam, mats.color,
                                     prepared=cprep, **kw)
        img, fl = img.cpu(), fl.cpu()
        hit, rhit = (fl >> 1) & 1, (rfl >> 1) & 1
        hit_bad += int((hit != rhit).sum())
        both = (hit & rhit) != 0
        vox_bad += int((((fl >> 17) & 255) != ((rfl >> 17) & 255))[both].sum())
        within += int((channel_diff(img, rimg) <= 2).sum())
        total += img.numel()
        words += words_differ(img, rimg) + words_differ(fl, rfl)
    say(phase, f"the same installs in a CPU builder: tables equal {same}; "
        f"4 cameras at 320x180, card vs CPU: hit mismatches {hit_bad}, "
        f"voxel mismatches {vox_bad}, pixels within 2/255 "
        f"{within / total:.6f} (differing words {words})")
    check(same and hit_bad == 0 and vox_bad == 0 and within == total,
          "W=80 card vs CPU misses the cross-platform bar")
    plain_bad, worst_f, worst_p = sparse_plain_check(
        b.grid(), prep, lut, strip_cam(STATIC_FX, w))
    say(phase, f"sparse kernels vs plain versions (fused, fused shadow, "
        f"camera and bundle planes) on a W={w} frame: differing words "
        f"{plain_bad}")
    check(plain_bad == 0, "a sparse kernel disagrees at W=80")
    return b, dict(launches=counts[0], err=max(s["worst"] / 255.0, worst_f),
                   err_planes=worst_p, rows_calls=rows_calls)


def time_streaming_step(strip, w, sparse):
    """Median seconds of one streaming step (set_chunks + prepared of
    STEP_CHUNKS chunks, config4b's cells) after 2 settling steps."""
    from voxelraytracing_tpu_torch.world.demo import demo_materials
    from voxelraytracing_tpu_torch.world.render_grid import RenderGrid3Builder

    grids = np.stack([strip[i, 1, k] for i in range(16) for k in range(8)])
    b = RenderGrid3Builder(w, demo_materials(), sparse=sparse)

    def step(col):
        cells = [((col + i) % w, 1, k % w) for i in range(16)
                 for k in range(8)]
        b.set_chunks(cells, grids)
        b.prepared()
        torch.cuda.synchronize()

    step(0)
    for n in range(2):
        step(2 + 2 * n)
    times = []
    col = 6
    for _ in range(N_STEPS):
        col = (col + 2) % (w - 2)
        t0 = time.perf_counter()
        step(col)
        times.append(time.perf_counter() - t0)
    mb = (b.sparse_tables_mb() if sparse else
          sum(t.numel() for t in b.prepared()) * 4 / 1e6)
    return statistics.median(times), mb


def sparse_hit_rows(prep, origins, dirs, t, hit):
    """Distinct content rows and window rows (sparse tables) holding the
    hit points ``origins + dirs * t`` of the rays where ``hit``."""
    v = torch.floor((origins + dirs * t[..., None])[hit]).to(torch.int64)
    nw = round(prep.wmeta_pad.shape[0] ** (1 / 3))
    win = (v[:, 0] >> 6) + (v[:, 1] >> 6) * nw + (v[:, 2] >> 6) * nw * nw
    s_loc = (((v[:, 0] >> 4) & 3) + ((v[:, 1] >> 4) & 3) * 4
             + ((v[:, 2] >> 4) & 3) * 16)
    rows = prep.wmeta_pad[win, 0, 64 + s_loc]
    return int(torch.unique(rows).numel()), int(torch.unique(win).numel())


def time_sparse(strip, b, lut, phase):
    """Phase 18: streaming steps, the fly-through, the sparse kernels on a
    static W=80 frame (device time, plain version, least time, rows)."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    out = {}
    for w, sparse in ((30, False), (80, True)):
        dt, mb = time_streaming_step(strip, w, sparse)
        out[f"step_{w}"] = dt
        say(phase, f"streaming step W={w} {'sparse' if sparse else 'dense'}: "
            f"set_chunks + prepared of {STEP_CHUNKS} chunks, median of "
            f"{N_STEPS}: {dt * 1e3:.3f} ms ({STEP_CHUNKS / dt:.1f} chunks/s); "
            f"tables {mb:.1f} MB")
        torch.cuda.empty_cache()
    wins = []
    for _ in range(WINDOWS):
        _, s = stream_window(strip, 80, lut)
        wins.append(s)
    tot = [s["builder_s"] + s["frames_s"] for s in wins]
    k = sorted(range(WINDOWS), key=lambda i: tot[i])[WINDOWS // 2]
    s = wins[k]
    out["fly_fps"] = s["frames"] / tot[k]
    out["fly_ms"] = 1e3 * tot[k] / s["frames"]
    say(phase, f"W=80 fly-through ({s['frames']} frames at {WIDTH}x{HEIGHT}, "
        f"{s['chunks']} chunks streamed), median of {WINDOWS} windows: "
        f"{out['fly_fps']:.3f} frames/s, {out['fly_ms']:.3f} ms/frame; of "
        f"it builder (set_chunks + prepared) {1e3 * s['builder_s'] / s['frames']:.3f}"
        f" ms/frame, frames (render_frame4, host clock to synchronize) "
        f"{1e3 * s['frames_s'] / s['frames']:.3f} ms/frame; windows "
        f"{[round(x, 3) for x in tot]} s")

    prep = b.prepared()
    rg = b.grid()
    cam = strip_cam(STATIC_FX, 80)
    for shadows, key in ((False, "fused"), (True, "fused_shadow")):
        args, kw = frame_inputs(rg, prep, cam, lut, shadows=shadows)
        time_kernel(out, key, lambda i: t4.march_fused4(*args, **kw))
        out["plain_" + key] = plain_ms(lambda: t4.march_fused4_ref(*args,
                                                                   **kw))
    fl = t4.march_fused4(*args, **{**kw, "shadows": False})[1]
    p = split_parts(args, kw)
    sc, g, swc, wmp, dims = p["scal"], p["gw2"], p["swc"], p["wmp"], p["mdims"]
    time_kernel(out, "planes_camera",
                lambda i: t4.march_planes4(sc, g, swc, wmp, **dims))
    time_kernel(out, "planes_rays", lambda i: t4.march_planes4(
        sc, g, swc, wmp, *p["bundle"], **dims))
    out["plain_planes"] = plain_ms(
        lambda: t4.march_planes4_ref(sc, g, swc, wmp, **dims)) + plain_ms(
        lambda: t4.march_planes4_ref(sc, g, swc, wmp, *p["bundle"], **dims))
    px = WIDTH * HEIGHT
    stp_p, stp_s = ((p[k][1] >> 5) & 0xFFF for k in ("planes", "shadow"))
    steps_p, steps_s = int(stp_p.sum()), int(stp_s.sum())
    say_simt(phase, "static W=80 frame, primary", stp_p)
    say_simt(phase, "static W=80 frame, both legs a pixel", stp_p + stp_s)
    sf = [float(x) for x in sc.cpu().numpy()]
    rays = t4._camera_rays(sf, *t4._pixels(p["dims"]["height"],
                                           p["dims"]["width"], sc.device))
    shape = p["planes"][0].shape + (3,)
    rows, wins_ = sparse_hit_rows(
        prep, torch.stack(rays[:3], -1).reshape(shape),
        torch.stack(rays[3:], -1).reshape(shape), p["planes"][0],
        ((fl >> 1) & 1) != 0)
    srows, swins = sparse_hit_rows(prep, p["bundle"][0], p["bundle"][1],
                                   p["shadow"][0],
                                   ((p["shadow"][1] >> 1) & 1) != 0)
    wrow = 128 * 4
    out["bounds"] = {
        "fused": bound(rows * ROW_BYTES + wins_ * wrow + 8 * px,
                       steps_p * STEP_OPS + px * PIXEL_OPS),
        "fused_shadow": bound((rows + srows) * ROW_BYTES
                              + (wins_ + swins) * wrow + 8 * px,
                              (steps_p + steps_s) * STEP_OPS
                              + px * PIXEL_OPS),
        "planes": bound((rows + srows) * ROW_BYTES + (wins_ + swins) * wrow
                        + 16 * px + 41 * px,
                        (steps_p + steps_s) * STEP_OPS + px * (45 + 21)),
    }
    out["rows"] = (rows, wins_, srows, swins)
    out["steps"] = (steps_p, steps_s)
    out["tables_mb"] = b.sparse_tables_mb()
    say(phase, f"static W=80 frame (x={STATIC_FX * 32:.0f}, 31 columns): "
        f"primary steps "
        f"{steps_p}, shadow steps {steps_s}; rows holding hit points: "
        f"content {rows}, window {wins_} (shadow leg {srows}, {swins}); "
        f"sparse tables {out['tables_mb']:.1f} MB")
    for k_, dev_keys in (("fused", ("fused",)),
                         ("fused_shadow", ("fused_shadow",)),
                         ("planes", ("planes_camera", "planes_rays"))):
        ms = sum(out[x + "_dev"] for x in dev_keys)
        plain = out["plain_" + k_]
        bms, by = out["bounds"][k_]
        say(phase, f"W=80 sparse {k_}: {ms:.4f} ms on the device "
            f"({' + '.join(f'{out[x]:.4f}' for x in dev_keys)} ms a wrapper "
            f"call), plain {plain:.2f} ms, least {bms:.5f} ms, bound by {by}")
    return out


# ------------------------------------------------------------- the v3 march

# bench.py's and config2's non-v4 route (bench.py:176-181,
# benchmarks/run.py:340-346): 14 service rounds, a 500-step cap, each
# frame warm from the last one's token
V3_KW = dict(rounds=14, step_cap=500)
N_ORBIT_V3 = 12
# FP32 operations of a ray in one v3 launch outside its march steps: its
# camera ray (24, recomputed each sub-round, counted once) and ray
# constants (21)
V3_RAY_OPS = 45


def flat_outputs(out):
    """The tensors of a wrapper's output, nested tuples flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in flat_outputs(o)]


class Launches:
    """Stand-in for the wrapper ``name`` of the port's ``ops.<module>``
    while active: calls the real wrapper (the kernel), records each call's
    ``(args, kw)`` in ``inputs`` and, with ``compare``, holds the call
    against the plain version ``<name>_ref`` on the same inputs, every
    output word for word. The wrapper counts through its module name,
    which the stand-in holds while active: its counts stay the real
    wrapper's."""

    COUNTS = ("launches", "cuda_launches")

    def __init__(self, module, name, compare=True):
        import importlib

        self.mod = importlib.import_module(
            f"voxelraytracing_tpu_torch.ops.{module}")
        self.name, self.compare = name, compare
        self.kernel = getattr(self.mod, name)
        self.ref = getattr(self.mod, name + "_ref")
        self.n = self.bad = 0
        self.err = 0.0
        self.inputs = []

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        self.n += 1
        self.inputs.append((args, dict(kw)))
        if self.compare:
            pairs = list(zip(flat_outputs(out),
                             flat_outputs(self.ref(*args, **kw))))
            self.bad += sum(words_differ(a, b) for a, b in pairs)
            for a, b in pairs:
                if a.dtype.is_floating_point:
                    self.err = max(self.err, float((a - b).abs().max()))
        return out

    def __getattr__(self, k):
        if k not in self.COUNTS:
            raise AttributeError(k)
        return getattr(self.kernel, k)

    def __setattr__(self, k, n):
        if k in self.COUNTS:
            setattr(self.kernel, k, n)
        else:
            super().__setattr__(k, n)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.kernel)


def v3_modes(rec):
    """The modes of the recorded march3 calls (camera rays or a bundle,
    tile map, lookahead)."""
    modes = set()
    for (_, _, _, _, _, _, rays, tile_map), kw in rec.inputs:
        modes.add(("rays" if rays is not None else "camera")
                  + ("+tile_map" if tile_map is not None else "")
                  + (f"+lookahead{kw['lookahead']}"
                     if kw.get("lookahead", 1) > 1 else ""))
    return modes


def v3_frame(rg, lut, cam, tok=None, size=None, **kw):
    """bench.py's v3 frame of ``cam`` (config2's with ``shadows=True``):
    ``(packed, flags, token)``."""
    from voxelraytracing_tpu_torch.ops.wavefront3 import render_frame3

    return render_frame3(rg, cam, lut, sun_pos=sun_of(cam), **V3_KW,
                         with_flags=True, cache=tok, return_cache=True, **kw)


def compare_march3(rg, lut, v, phase):
    """Every launch of whole frames, kernel vs plain version (phase 19)."""
    from voxelraytracing_tpu_torch.ops.camera import CamData
    from voxelraytracing_tpu_torch.ops.wavefront3 import trace_wavefront3

    static, orbit = bench_cams(v, WIDTH, HEIGHT)
    s720, _ = bench_cams(v, 1280, 720)
    frames = 0
    with Launches("wavefront3", "march3") as rec:
        tok = None
        for cam in [static] + orbit[::16]:
            _, _, tok = v3_frame(rg, lut, cam, tok)
            frames += 1
        v3_frame(rg, lut, s720, shadows=True)
        # a trace whose round loop compacts: its survivors must fit a
        # smaller grid before they finish, which depends on the camera;
        # the last candidate looks across the world from a low corner,
        # where far rays keep a long tail
        across = CamData.create((8.0, 225.0, 0.0), (v * 0.1, v * 0.4, v * 0.1),
                                70.0, (WIDTH, HEIGHT))
        for cam in [static] + orbit[::12] + [across]:
            trace_wavefront3(rg, np.asarray(cam.pos, np.float32), cam=cam,
                             compact=(2, 8), **V3_KW)
            if any("tile_map" in m for m in v3_modes(rec)):
                break
        trace_wavefront3(rg, np.asarray(static.pos, np.float32), cam=static,
                         lookahead=2, **V3_KW)
        torch.cuda.synchronize()
    say(phase, f"march3 vs march3_ref, launch by launch: {rec.n} launches "
        f"({frames} 1080p bench-route frames, config2's 720p shadowed "
        f"frame, a compacting 1080p trace, lookahead=2), modes "
        f"{sorted(v3_modes(rec))}, differing words {rec.bad}, max abs "
        f"float error {rec.err}")
    check(rec.bad == 0, "march3 disagrees with march3_ref")
    check({"camera", "rays", "camera+tile_map", "camera+lookahead2"}
          <= v3_modes(rec), f"a mode of march3 was not driven: "
          f"{v3_modes(rec)}")
    return rec.err


def compare_v3_cpu(rg_cpu, rg, mats, v, phase):
    """render_frame3 on the card vs the plain versions on the CPU at
    320x180, with and without shadows, under the bar of phase 5."""
    from voxelraytracing_tpu_torch.ops.wavefront3 import render_frame3

    static, orbit = bench_cams(v, 320, 180)
    cams = [static, orbit[CMP_STEP]]
    hit_bad = vox_bad = fl_bad = pk_bad = within = total = 0
    for shadows in (False, True):
        for cam in cams:
            kw = dict(sun_pos=sun_of(cam), shadows=shadows, with_flags=True,
                      **V3_KW)
            img, fl = render_frame3(rg, cam, mats.color, **kw)
            rimg, rfl = render_frame3(rg_cpu, cam, mats.color, **kw)
            img, fl = img.cpu(), fl.cpu()
            hit, rhit = (fl >> 1) & 1, (rfl >> 1) & 1
            hit_bad += int((hit != rhit).sum())
            both = (hit & rhit) != 0
            vox_bad += int((((fl >> 17) & 255)
                            != ((rfl >> 17) & 255))[both].sum())
            fl_bad += int((fl != rfl).sum())
            pk_bad += int((img != rimg).sum())
            within += int((channel_diff(img, rimg) <= 2).sum())
            total += img.numel()
    frac = within / total
    say(phase, f"render_frame3 at 320x180, {len(cams)} cameras with and "
        f"without shadows, card vs CPU: hit mismatches {hit_bad}, voxel "
        f"mismatches {vox_bad}, pixels within 2/255 {frac:.6f} (flag words "
        f"differing {fl_bad}, packed {pk_bad})")
    check(hit_bad == 0 and vox_bad == 0 and frac == 1.0,
          "render_frame3 misses the cross-platform bar against the CPU")


def compare_v3_converged(rg, prep, lut, v, phase):
    """At a converged budget (rounds=64, step_cap=500) render_frame3 equals
    the split v4 frame, shadows on, as JAX pins it
    (tests/test_wavefront4.py:134-149); the round loop must end before
    its budget."""
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    static, orbit = bench_cams(v, WIDTH, HEIGHT)
    s720, _ = bench_cams(v, 1280, 720)
    bad = 0
    used = []
    for cam in (static, orbit[7], s720):
        kw = dict(sun_pos=sun_of(cam), shadows=True, step_cap=500,
                  rounds=64, with_flags=True)
        n0 = t3.march3.launches
        a = t3.render_frame3(rg, cam, lut, **kw)
        used.append(t3.march3.launches - n0)
        b = t4.render_frame4(rg, cam, lut, prepared=prep, **kw)
        bad += sum(words_differ(x, y) for x, y in zip(a, b))
    say(phase, f"render_frame3(rounds=64) vs the split v4 frame, shadows on, "
        f"1080p static and orbit, 720p static: differing words {bad}; "
        f"launches a frame (both traces) {used}")
    check(bad == 0, "the converged v3 frame differs from the split v4 frame")


def count_v3_routes(rg, mats, lut, v, phase):
    """march3 and shade4 launches a frame, each route driven with the
    counts set to 0 just before and read just after: render_packed's
    default route (10 orbit frames, with and without shadows), bench.py's
    v3 route (1080p, 10 orbit frames, warm) and config2's (720p, shadows,
    10 orbit frames, warm)."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    counters = (t3.march3, t4.shade4, t4.march_planes4, t4.touched4,
                t4.march_fused4)
    _, orbit = bench_cams(v, WIDTH, HEIGHT)
    _, o720 = bench_cams(v, 1280, 720)
    counts = {}

    def run(key, frames):
        for c in counters:
            c.launches = 0
        img = frames()
        torch.cuda.synchronize()
        counts[key] = [c.launches for c in counters]
        check(counts[key][1] == 10 and counts[key][2:] == [0, 0, 0],
              f"{key}: not one shade4 launch a frame and no v4 march")
        check(counts[key][0] >= 10, f"{key}: march3 never launched")
        return img

    for shadows in (False, True):
        renderer = WavefrontRenderer(mats)

        def packed():
            for cam in orbit[:10]:
                img = renderer.render_packed(
                    rg, cam, RenderSettings(sun_pos=sun_of(cam),
                                            shadows=shadows))
            return img

        img = run(("packed", shadows), packed)
        check(bool(((img >> 24) & 255 == 255).all()), "alpha lost")

    def route(cams, **kw):
        def frames():
            tok = None
            for cam in cams:
                img, _, tok = v3_frame(rg, lut, cam, tok, **kw)
            check(bool(torch.isfinite(img.float()).all()), "frame not finite")
            return img
        return frames

    run("bench", route(orbit[:10]))
    run("config2", route(o720[:10], shadows=True))
    for key, c in counts.items():
        say(phase, f"{key}: launches march3/shade4/planes4/touched4/fused4 "
            f"over 10 frames {c} ({c[0] / 10:.1f} march3 launches a frame)")
    return counts


def v3_launch_bound(inputs, out):
    """(least ms, what bounds it) of one march3 launch from its inputs:
    the cache blocks and the state read once, the state and wants written
    once, per-ray bundles read once; the march steps it took."""
    mc, ts, fl, rays = inputs[1], inputs[2], inputs[3], inputs[6]
    n = ts.numel()
    steps = int((((out[1] >> 5) & 0xFFF) - ((fl >> 5) & 0xFFF))
                .clamp_min(0).sum())
    b = mc.numel() * 4 + 32 * n + ts.shape[0] * 32
    if rays is not None:
        b += 24 * n
    return bound(b, steps * STEP_OPS + n * V3_RAY_OPS), steps


def time_v3(rg, mats, lut, v, phase):
    """march3 alone (the round-0 launch of the static 1080p bench-route
    frame, and its plain version), the device time of all the march3
    launches of a warm static frame, and the frames of the three v3
    routes, static and orbit, each frame warm from the last."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3

    static, orbit = bench_cams(v, WIDTH, HEIGHT, N_ORBIT_V3)
    s720, o720 = bench_cams(v, 1280, 720, N_ORBIT_V3)
    with Launches("wavefront3", "march3") as rec:
        tok = v3_frame(rg, lut, static)[2]
    args, kw = rec.inputs[0]
    with Launches("wavefront3", "march3") as warm:
        v3_frame(rg, lut, static, tok)
    out = {"frame_launches": len(warm.inputs)}

    def all_launches(i):
        for a, k in warm.inputs:
            t3.march3(*a, **k)

    out["march3_frame_dev"] = graph_ms(all_launches, 4)
    # each launch of the warm frame alone: device ms, sub-round budget,
    # steps and least ms
    out["frame_each"] = []
    for a, k in warm.inputs:
        ms = graph_ms(lambda i, a=a, k=k: t3.march3(*a, **k), 4)
        (bms, _), stp = v3_launch_bound(a, t3.march3(*a, **k)[0])
        out["frame_each"].append((ms, int(a[0][22]), stp, bms))

    def one(i):
        return t3.march3(*args, **kw)

    time_kernel(out, "march3", one)
    out["plain_march3"] = plain_ms(lambda: t3.march3_ref(*args, **kw))
    out["bound"], out["steps"] = v3_launch_bound(args, one(0)[0])

    def frames(cams, **kw):
        tok = [None]

        def fn(i):
            tok[0] = v3_frame(rg, lut, cams[i % len(cams)], tok[0], **kw)[2]
        return fn

    out["bench_static"] = median_windows(frames([static]), 8)
    out["bench_orbit"] = median_windows(frames(orbit), len(orbit))
    out["config2_static"] = median_windows(frames([s720], shadows=True), 8)
    out["config2_orbit"] = median_windows(frames(o720, shadows=True),
                                          len(o720))
    renderer = WavefrontRenderer(mats)

    def packed(cams):
        def fn(i):
            cam = cams[i % len(cams)]
            renderer.render_packed(rg, cam, RenderSettings(sun_pos=sun_of(cam)))
        return fn

    out["packed_static"] = median_windows(packed([static]), 8)
    out["packed_orbit"] = median_windows(packed(orbit), len(orbit))
    say(phase, f"{WIDTH}x{HEIGHT} march3 round-0 launch: "
        f"{out['march3']:.4f} ms a wrapper call, {out['march3_dev']:.4f} ms "
        f"on the device (CUDA graph), plain version "
        f"{out['plain_march3']:.2f} ms; {out['steps']} steps, least "
        f"{out['bound'][0]:.5f} ms, bound by {out['bound'][1]}")
    say(phase, f"{WIDTH}x{HEIGHT} the {out['frame_launches']} march3 launches "
        f"of a warm static bench-route frame: {out['march3_frame_dev']:.4f} "
        f"ms on the device (CUDA graph); round-0 launch "
        f"{out['march3_dev'] / max(out['steps'], 1) * 1e9:.1f} ps a counted "
        f"step")
    each = out["frame_each"]
    say(phase, "the warm frame's launches alone, device ms (sub-round budget, "
        "counted steps, least ms): " + "; ".join(
            f"{ms:.4f} ({srd}, {stp}, {bms:.5f})" for ms, srd, stp, bms in each)
        + f"; sum {sum(e[0] for e in each):.4f} ms, least "
        f"{sum(e[3] for e in each):.5f} ms")
    say(phase, "ms/frame, warm tokens: bench route 1080p static "
        f"{out['bench_static']:.3f}, orbit {out['bench_orbit']:.3f}; "
        f"config2 720p shadows static {out['config2_static']:.3f}, orbit "
        f"{out['config2_orbit']:.3f}; render_packed default 1080p static "
        f"{out['packed_static']:.3f}, orbit {out['packed_orbit']:.3f}")
    return out

# the v2 march: WavefrontRenderer.render on a v1 RenderGrid (its default
# tracer "v2", models/raytracer.py:340-355) marches 48 rounds of 24 steps
# (2 sub-rounds of 12); trace_wavefront2's own default is 12 rounds of 48
# (4 sub-rounds)
V2_BUDGET = (48, 24)
V2_TRACE_BUDGET = (12, 48)
N_ORBIT_V2 = 12
V2_ROUNDS_MAX = 4096    # the search for a budget that leaves no ray active
V2_HIT_BAR = 0.002      # hit masks apart (tools/tpu_correctness.py:188)
# share of the pixels both hit whose voxel ids differ between converged v2
# and v4's own camera rays, which lie an ulp from v2's on some pixels, so
# a ray grazing a voxel edge may end in its neighbour (measured: 10, 6 and
# 2 of 348,582, 388,129 and 371,757 hits on the three cameras, at most
# 2.9e-5; the bar is ~35x that)
V2_OWN_VOX_BAR = 1e-3
# FP32 operations of a ray in one march2 call outside its march steps:
# inverse directions and slab exit (21), recomputed each launch, counted
# once
V2_RAY_OPS = 21


def build_world1(w_chunks, device="cuda"):
    """bench.py's demo world as v1 tables (``build_render_grid_host``)."""
    from voxelraytracing_tpu_torch.ops import noise
    from voxelraytracing_tpu_torch.ops.wavefront import build_render_grid_host
    from voxelraytracing_tpu_torch.world.demo import (
        demo_chunk_grids_host, demo_materials)

    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), w_chunks,
        w_chunks * 32 * 0.45, int(w_chunks * 32 * 0.28))
    return build_render_grid_host(grids, cells, np.zeros(3, np.int32),
                                  w_chunks, demo_materials(), device=device)


def v2_trace(rg1, cam, rounds, spr):
    """``trace_wavefront2`` of ``cam``'s rays."""
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops.camera import generate_rays

    w, h = cam.proj_size
    origin, dirs = generate_rays(cam, np.zeros(3, np.int32),
                                 device=rg1.bwin.device)
    return t2.trace_wavefront2(rg1, origin, dirs, width=w, height=h,
                               rounds=rounds, steps_per_round=spr)


def v2_active_by_round(rg1, cam, spr):
    """Rays of ``cam``'s v2 frame after each round of the round loop of
    ``trace_wavefront2`` (read each round): ``(active, live)``, live ones
    still short of their slab exit. The loop stops at the first round
    that leaves no live ray, or at ``V2_ROUNDS_MAX``. A ray that left the
    world through a low face can stay active past its exit for good: its
    window id is negative, a want the service drops (wavefront2.py:630);
    its result is final (the finish closes it at its exit)."""
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops.camera import generate_rays
    from voxelraytracing_tpu_torch.ops.wavefront3 import _inv_dir, _slab_exit

    w, h = cam.proj_size
    origin, dirs = generate_rays(cam, np.zeros(3, np.int32),
                                 device=rg1.bwin.device)
    f, c = t2._frame_inputs(rg1, origin, dirs, w, h)
    o = f["origin"]
    t_exit = _slab_exit(float(rg1.size_voxels), o[0], o[1], o[2],
                        [_inv_dir(f[k]) for k in ("dx", "dy", "dz")])
    active, live = [], []
    for c in t2._rounds(rg1, f, c, V2_ROUNDS_MAX, max(spr // 12, 1)):
        a = c["state"]["active"] != 0
        active.append(int(a.sum()))
        live.append(int((a & (c["state"]["t"] < t_exit)).sum()))
        if live[-1] == 0:
            break
    return active, live


def v2_tables(rg3, phase):
    """The 8-chunk world's v1 tables built onto the card and on the CPU:
    equal word for word; their brick tables are the v3 grid's."""
    t0 = time.perf_counter()
    rg1, v = build_world1(8), 8 * 32
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    rg1_cpu = build_world1(8, "cpu")
    fields = ("bwin", "lwin", "brick_dir", "bricks", "world_min", "to_pack")
    same = all(torch.equal(getattr(rg1, f).cpu(), getattr(rg1_cpu, f))
               for f in fields)
    same = same and (rg1.n_liquid, rg1.size_voxels) == (
        rg1_cpu.n_liquid, rg1_cpu.size_voxels) == (rg3.n_liquid, v)
    shared = all(torch.equal(getattr(rg1, f), getattr(rg3, f))
                 for f in ("brick_dir", "bricks"))
    mb = {f: getattr(rg1, f).numel() * 4 / 1e6 for f in fields[:4]}
    say(phase, f"8-chunk world v1 tables: host build onto the card "
        f"{t_card:.1f} s; card == CPU word for word {same}; brick tables "
        f"== the v3 grid's {shared}; MB " + ", ".join(
            f"{f} {m:.2f}" for f, m in mb.items())
        + f" ({sum(mb.values()):.2f} total)")
    check(same and shared, "the v1 tables differ between card and CPU")
    return rg1, rg1_cpu


def compare_march2(rg1, v, phase):
    """Every round of whole 1080p frames, kernel vs plain version: the
    renderer's budget on the static and one orbit camera,
    trace_wavefront2's default on the static one."""
    static, orbit = bench_cams(v, WIDTH, HEIGHT)
    with Launches("wavefront2", "march2") as rec:
        for cam in (static, orbit[16]):
            v2_trace(rg1, cam, *V2_BUDGET)
        v2_trace(rg1, static, *V2_TRACE_BUDGET)
        torch.cuda.synchronize()
    n = 2 * V2_BUDGET[0] + V2_TRACE_BUDGET[0]
    subs = sorted({k["sub_rounds"] for _, k in rec.inputs})
    say(phase, f"march2 vs march2_ref, round by round: {rec.n} calls (2 "
        f"1080p frames at {V2_BUDGET[0]}x{V2_BUDGET[1]}, one at "
        f"{V2_TRACE_BUDGET[0]}x{V2_TRACE_BUDGET[1]}; sub-rounds "
        f"{subs}), differing words {rec.bad}, max abs float error "
        f"{rec.err}")
    check(rec.n == n, f"{rec.n} march2 calls, want {n}")
    check(rec.bad == 0, "march2 disagrees with march2_ref")
    return rec.err


def compare_v2_cpu(rg1_cpu, rg1, mats, v, phase):
    """``render`` (v2) on the card vs the plain versions on the CPU at
    320x176 (v2 frames are whole 16x8 tiles, so not 320x180): 0 hit and
    voxel mismatches, every pixel's sRGB8 within 2/255."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer, to_srgb8)

    static, orbit = bench_cams(v, 320, 176)
    cams = [static, orbit[24]]
    hit_bad = vox_bad = within = total = 0
    worst = 0
    for cam in cams:
        s = RenderSettings(sun_pos=sun_of(cam))
        img, wf = WavefrontRenderer(mats).render(rg1, cam, s)
        rimg, rwf = WavefrontRenderer(mats).render(rg1_cpu, cam, s)
        hit, rhit = wf.hit.cpu(), rwf.hit
        hit_bad += int((hit != rhit).sum())
        vox_bad += int((wf.voxel.cpu() != rwf.voxel)[hit & rhit].sum())
        d = np.abs(to_srgb8(img).astype(int) - to_srgb8(rimg).astype(int))
        d = d.max(axis=-1)
        worst = max(worst, int(d.max()))
        within += int((d <= 2).sum())
        total += d.size
    frac = within / total
    say(phase, f"render (v2) at 320x176, {len(cams)} cameras, card vs CPU: "
        f"hit mismatches {hit_bad}, voxel mismatches {vox_bad}, pixels "
        f"within 2/255 {frac:.6f} (worst channel {worst}/255)")
    check(hit_bad == 0 and vox_bad == 0 and frac == 1.0,
          "render (v2) misses the cross-platform bar against the CPU")


def compare_v2_converged(rg1, rg3, prep, v, phase):
    """The rays still marching after the renderer's budget (drawn as
    misses); the first round after which none is; v2 at that budget vs the
    split v4 trace: on the same rays (``trace_wavefront4_rays`` of v2's
    directions) hit masks within the bar and voxel ids equal where both
    hit; on v4's own camera rays (made in its kernel, an ulp apart on
    some pixels) the hit bar and the voxel ids within their bar."""
    from voxelraytracing_tpu_torch.ops.camera import generate_rays
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        trace_wavefront4, trace_wavefront4_rays)

    static, orbit = bench_cams(v, WIDTH, HEIGHT)
    px = WIDTH * HEIGHT
    out = {}
    for name, cam in (("static", static), ("orbit0", orbit[0]),
                      ("orbit24", orbit[24])):
        active, live = v2_active_by_round(rg1, cam, V2_BUDGET[1])
        check(live[-1] == 0, f"{name}: rays still marching after "
              f"{V2_ROUNDS_MAX} rounds")
        r_conv = len(live)
        # the loop stops at the first round that leaves no live ray
        k = V2_BUDGET[0] - 1
        left = (live[k], active[k]) if r_conv > k else (0, active[-1])
        res2 = v2_trace(rg1, cam, r_conv, V2_BUDGET[1])
        origin, dirs = generate_rays(cam, np.zeros(3, np.int32),
                                     device=rg1.bwin.device)
        same = trace_wavefront4_rays(
            rg3, origin.expand(HEIGHT, WIDTH, 3), dirs,
            torch.ones((HEIGHT, WIDTH), dtype=torch.bool, device=dirs.device),
            width=WIDTH, height=HEIGHT)
        own = trace_wavefront4(rg3, np.asarray(cam.pos, np.float32), cam=cam,
                               prepared=prep)
        o = dict(share=left[0] / px, rounds=r_conv, past_exit=active[-1],
                 hits=int(res2.hit.sum()))
        for key, r4 in (("same", same), ("own", own)):
            both = res2.hit & r4.hit
            o[key] = (float((res2.hit != r4.hit).float().mean()),
                      int((res2.voxel != r4.voxel)[both].sum()),
                      int(both.sum()))
        out[name] = o
        say(phase, f"{name}: after {V2_BUDGET[0]} rounds {left[0]} rays "
            f"still marching ({o['share']:.6%}, drawn as misses), "
            f"{left[1]} active; none marching after round {r_conv} "
            f"({o['past_exit']} stay active past their exit); v2 at "
            f"{r_conv}x{V2_BUDGET[1]} ({o['hits']} hits) vs the split v4 "
            f"trace: same rays: hit masks {o['same'][0]:.6%} apart, voxel "
            f"ids differing where both hit {o['same'][1]}; v4's own camera "
            f"rays: {o['own'][0]:.6%} apart, {o['own'][1]} voxel ids of "
            f"{o['own'][2]} ({o['own'][1] / max(o['own'][2], 1):.3e}, bar "
            f"{V2_OWN_VOX_BAR})")
        check(o["same"][0] <= V2_HIT_BAR and o["same"][1] == 0,
              f"{name}: converged v2 differs from v4 beyond the bar")
        check(o["own"][0] <= V2_HIT_BAR
              and o["own"][1] <= V2_OWN_VOX_BAR * o["own"][2],
              f"{name}: converged v2 and v4's camera frame apart beyond "
              f"the bars")
    return out


def count_v2_main_path(rg1, mats, v, phase):
    """The main path of this slice, driven with the counts set to 0 just
    before and read just after: 10 orbit frames through
    ``WavefrontRenderer.render`` on the v1 grid at 1080p; march2 once a
    round (48 a frame), the v3 and v4 kernels never."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    others = (t3.march3, t4.shade4, t4.march_planes4, t4.touched4,
              t4.march_fused4)
    _, orbit = bench_cams(v, WIDTH, HEIGHT)
    renderer = WavefrontRenderer(mats)
    for c in (t2.march2,) + others:
        c.launches = 0
    t2.march2.cuda_launches = 0
    for cam in orbit[:10]:
        img, wf = renderer.render(rg1, cam, RenderSettings(sun_pos=sun_of(cam)))
    torch.cuda.synchronize()
    counts = [t2.march2.launches, t2.march2.cuda_launches] + [
        c.launches for c in others]
    say(phase, f"render (v2) x10 at {WIDTH}x{HEIGHT}: march2 calls "
        f"{counts[0]} ({counts[0] / 10:.1f} a frame), CUDA launches inside "
        f"them {counts[1]} ({counts[1] / 10:.1f} a frame); march3/shade4/"
        f"planes4/touched4/fused4 {counts[2:]}; last image "
        f"{tuple(img.shape)}, {int(wf.hit.sum())} hits")
    check(counts[0] == 10 * V2_BUDGET[0], "march2 not once a round")
    check(counts[1] == counts[0], "march2 did not launch one kernel a call")
    check(counts[2:] == [0] * len(others), "a v3/v4 kernel ran on the v2 path")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (
        HEIGHT, WIDTH, 3), "the v2 frame is not a finite image")
    return counts


def v2_call_bound(args, out):
    """(least ms, what bounds it) of one march2 call: directions, state
    in and out, caches and wants once each; the march steps it took."""
    n = args[1].numel()
    steps = int((out[9] - args[20]).clamp_min(0).sum())
    caches = sum(x.numel() * 4 for x in args[4:11])
    b = 12 * n + 40 * n + 40 * n + caches + args[1].shape[0] * 17 * 4
    return bound(b, steps * STEP_OPS + n * V2_RAY_OPS), steps


def time_v2(rg1, mats, v, phase):
    """march2 alone (round 0 of the static 1080p frame at the renderer's
    budget: wrapper calls and CUDA-graph device time, and the plain
    version), the device time of a frame's 48 calls and of its whole
    trace (service included), and ms/frame of ``render`` (v2), static and
    the 12-camera orbit, with the device idle share."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops.camera import generate_rays

    static, orbit = bench_cams(v, WIDTH, HEIGHT, N_ORBIT_V2)
    with Launches("wavefront2", "march2", compare=False) as rec:
        v2_trace(rg1, static, *V2_BUDGET)
    args, kw = rec.inputs[0]
    out = {"frame_calls": len(rec.inputs)}

    def all_calls(i):
        for a, k in rec.inputs:
            t2.march2(*a, **k)

    out["march2_frame_dev"] = graph_ms(all_calls, 1)
    # each call alone: device ms and counted steps
    out["frame_each"] = []
    for a, k in rec.inputs:
        ms = graph_ms(lambda i, a=a, k=k: t2.march2(*a, **k), 4)
        out["frame_each"].append((ms, v2_call_bound(a, t2.march2(*a, **k))[1]))

    def one(i):
        return t2.march2(*args, **kw)

    time_kernel(out, "march2", one)
    out["plain_march2"] = plain_ms(lambda: t2.march2_ref(*args, **kw))
    out["bound"], out["steps"] = v2_call_bound(args, one(0))
    origin, dirs = generate_rays(static, np.zeros(3, np.int32))

    def trace(i):
        t2.trace_wavefront2(rg1, origin, dirs, width=WIDTH, height=HEIGHT,
                            rounds=V2_BUDGET[0], steps_per_round=V2_BUDGET[1])

    out["trace_dev"] = graph_ms(trace, 1)
    renderer = WavefrontRenderer(mats)

    def frames(cams):
        def fn(i):
            cam = cams[i % len(cams)]
            renderer.render(rg1, cam, RenderSettings(sun_pos=sun_of(cam)))
        return fn

    out["static"] = median_windows(frames([static]), 8)
    out["orbit"] = median_windows(frames(orbit), len(orbit))
    out["idle_static"] = 1.0 - out["trace_dev"] / out["static"]
    say(phase, f"{WIDTH}x{HEIGHT} march2, round 0 of the static frame "
        f"({kw['sub_rounds']} sub-rounds, one CUDA launch): "
        f"{out['march2']:.4f} ms a wrapper call, "
        f"{out['march2_dev']:.4f} ms on the device (CUDA graph), plain "
        f"version {out['plain_march2']:.2f} ms; {out['steps']} steps, least "
        f"{out['bound'][0]:.5f} ms, bound by {out['bound'][1]}")
    say(phase, f"{WIDTH}x{HEIGHT} the {out['frame_calls']} march2 calls of "
        f"the static frame: {out['march2_frame_dev']:.4f} ms on the device; "
        f"the whole trace (service included) {out['trace_dev']:.4f} ms on "
        f"the device (CUDA graph); round 0 "
        f"{out['march2_dev'] / max(out['steps'], 1) * 1e9:.1f} ps a counted "
        f"step (the kernel does not count the steps it executes)")
    each = out["frame_each"]
    say(phase, "the static frame's calls alone, device ms (counted steps): "
        + "; ".join(f"{ms:.4f} ({stp})" for ms, stp in each)
        + f"; sum {sum(e[0] for e in each):.4f} ms, "
        f"{sum(e[1] for e in each)} steps")
    say(phase, f"ms/frame, render (v2) {WIDTH}x{HEIGHT}: static "
        f"{out['static']:.3f}, {N_ORBIT_V2}-camera orbit "
        f"{out['orbit']:.3f}; device idle share of the static frame "
        f"{out['idle_static']:.4f} (1 - trace device ms / frame ms)")
    return out


V1_SMALL = (320, 176)  # whole 16x8 tiles (320x180 is not)
V1_FRAMES = 3  # warm 1080p frames timed, one at a time


def device_work(fn):
    """``(kernels, copies and sets, device ms)`` of the CUDA work of
    ``fn()``, from the profiler's raw events (CUPTI; no Python event
    tree, which takes seconds a 10^5 launches to build); None when the
    profiler sees no device time."""
    from torch.autograd import (
        DeviceType, ProfilerActivity, ProfilerConfig, ProfilerState,
        _disable_profiler, _enable_profiler, _prepare_profiler)
    from torch._C._profiler import _ExperimentalConfig

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CUDA}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        res = _disable_profiler()
    kernels = copies = 0
    ns = 0
    for e in res.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ns += e.duration_ns()
        name = e.name().lower()
        if "memcpy" in name or "memset" in name:
            copies += 1
        else:
            kernels += 1
    return (kernels, copies, ns / 1e6) if ns else None


def v1_tracer(rg1, rg1_cpu, mats, v, smi, phase):
    """The v1 tracer (``trace_wavefront``: plain PyTorch ops on the card,
    as JAX's is XLA with no Pallas kernel) on phase 24's v1 tables, at the
    renderer's budget (48 rounds of 12 steps). First the main path,
    ``WavefrontRenderer(tracer="v1").render`` at 1920x1080 on the static
    camera, counted from 0 and profiled: no hand-written kernel launched,
    the rounds its loop ran, its device launches and busy time (the
    profiler's raw events), a finite image with hits; then its warm
    ms/frame (median of 3 frames, CUDA events). Then at 320x176 card vs
    the CPU session on the same rays (static and two orbit cameras), every
    product word for word; the CPU traces run on one intra-op thread (on
    the card's host more threads ran these small ops slower)."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import wavefront as t1
    from voxelraytracing_tpu_torch.ops import wavefront2 as t2
    from voxelraytracing_tpu_torch.ops import wavefront3 as t3
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4
    from voxelraytracing_tpu_torch.ops.camera import generate_rays

    renderer = WavefrontRenderer(mats, tracer="v1")
    static, _ = bench_cams(v, WIDTH, HEIGHT, 0)
    s = RenderSettings(sun_pos=sun_of(static))
    kernels = (t2.march2, t3.march3, t4.shade4, t4.march_planes4,
               t4.touched4, t4.march_fused4)
    saved = [k.launches for k in kernels]
    refetch, rounds, out = t1._refetch, [0], []

    def counted(*a, **k):
        rounds[0] += 1
        return refetch(*a, **k)

    # the main path, counted from 0
    for k in kernels:
        k.launches = 0
    t1._refetch = counted
    try:
        work = device_work(lambda: out.append(renderer.render(rg1, static,
                                                              s)))
    finally:
        t1._refetch = refetch
    launched = [k.launches for k in kernels]
    for k, n in zip(kernels, saved):
        k.launches = n
    img, wf = out[0]
    check(launched == [0] * len(kernels),
          f"a hand-written kernel ran on the v1 path: {launched}")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (
        HEIGHT, WIDTH, 3) and bool(wf.hit.any()),
          "the v1 frame is not a finite image with hits")
    ms = statistics.median(
        event_ms(lambda i: renderer.render(rg1, static, s), 1)
        for _ in range(V1_FRAMES))
    say(phase, f"render (v1) {WIDTH}x{HEIGHT}, static camera, "
        f"{renderer.max_rounds} x {renderer.inner_steps} budget: "
        f"{rounds[0]} rounds ran, {int(wf.hit.sum())} hits; hand-written "
        f"kernels launched {sum(launched)}; {ms:.3f} ms/frame warm (median "
        f"of {V1_FRAMES}, CUDA events; {smi})")
    if work is None:
        say(phase, "render (v1) device launches and busy share: not "
            "measured (the profiler saw no device time)")
    else:
        n_k, n_c, dev_ms = work
        say(phase, f"render (v1) {WIDTH}x{HEIGHT} on the device: {n_k} "
            f"kernels and {n_c} copies/sets a frame, {dev_ms:.3f} ms busy "
            f"(profiler, CUPTI), busy share {dev_ms / ms:.4f} of "
            f"{ms:.3f} ms/frame, {dev_ms / max(n_k + n_c, 1) * 1e3:.2f} us "
            f"a launch ({smi})")

    t0 = time.perf_counter()
    budget = dict(max_rounds=renderer.max_rounds,
                  inner_steps=renderer.inner_steps)
    w, h = V1_SMALL
    small, orbit = bench_cams(v, w, h)
    differ = dict.fromkeys(t1.WavefrontResult._fields, 0)
    hits = 0
    n_threads = torch.get_num_threads()
    for cam in (small, orbit[0], orbit[N_ORBIT // 2]):
        origin, dirs = generate_rays(cam, np.zeros(3, np.int32),
                                     device=rg1.bwin.device)
        a = t1.trace_wavefront(rg1, origin, dirs, width=w, height=h,
                               **budget)
        torch.set_num_threads(1)
        try:
            b = t1.trace_wavefront(rg1_cpu, origin.cpu(), dirs.cpu(),
                                   width=w, height=h, **budget)
        finally:
            torch.set_num_threads(n_threads)
        for f in differ:
            differ[f] += words_differ(getattr(a, f).cpu(), getattr(b, f))
        hits += int(b.hit.sum())
    say(phase, f"trace_wavefront (v1) at {w}x{h}, 3 cameras, "
        f"{budget['max_rounds']} x {budget['inner_steps']}, card vs CPU on "
        f"the same rays: words differing " + ", ".join(
            f"{f} {n}" for f, n in differ.items()) + f"; {hits} hits "
        f"({time.perf_counter() - t0:.1f} s)")
    check(not any(differ.values()) and hits > 0,
          "the v1 trace differs between card and CPU")


# ------------------------------------------------------------ the probes

PROBE_SRC = "voxelraytracing_tpu_torch/csrc/probes3.cu"


def phase_probes(phase):
    """The primitive probes (``voxelraytracing_tpu_torch.experiments``):
    their scripts' main paths driven with the counts set to 0 just before
    and read just after; each kernel vs its plain version at the JAX
    shapes on random inputs, bit for bit (``gather_rows_async`` in both
    modes); device ms of each kernel (CUDA graph), its plain version, its
    yardstick library call and its least time. Returns the probes' entries
    of the kernels line."""
    from voxelraytracing_tpu_torch.experiments import v3_probe_prims as pp
    from voxelraytracing_tpu_torch.experiments import v3_probe_subgather as ps

    kernels = pp.KERNELS + ps.KERNELS
    for k in kernels:
        k.launches = 0
    pp.main()
    for which in ("vec", "loop"):
        ps.main([which])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    say(phase, f"probe scripts' main paths: launches {launches}")
    check(all(launches.values()), "a probe kernel was not launched")

    # random full-range inputs at the scripts' shapes
    g = torch.Generator(device="cuda").manual_seed(STRIP_SEED)

    def bits(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             device="cuda", dtype=torch.int64).int()

    tab = bits(pp.NROWS, pp.ROW)
    ids = torch.randint(0, pp.NROWS, (pp.NB, pp.IDS), generator=g,
                        device="cuda", dtype=torch.int32)
    idx = torch.randint(0, pp.NROWS, (ps.BLK, pp.ROW), generator=g,
                        device="cuda", dtype=torch.int32)
    idx64 = idx.long()
    planes = tuple(bits(pp.T, pp.ROW).view(torch.float32) for _ in range(7))
    outs = tuple(torch.empty_like(x) for x in planes)
    v = tab[:pp.BLK]
    rows = (int(torch.unique(ids).numel()),
            int(torch.unique(idx[:, 0]).numel()),
            int(torch.unique(idx * pp.ROW
                             + torch.arange(pp.ROW, device="cuda")).numel()))
    row_b = pp.ROW * 4
    gather_b = ids.numel() * (4 + row_b) + rows[0] * row_b
    pr, sg = "experiments/v3_probe_prims.py:", "experiments/v3_probe_subgather.py:"
    probes = [
        # name, replaces, kernel, plain, library call, (bytes, ops)
        ("gather_rows_smem", pr + "31", lambda: pp.gather_rows_smem(ids, tab),
         lambda: pp.gather_rows_ref(ids, tab),
         lambda: tab.index_select(0, ids.reshape(-1)), (gather_b, 0)),
        ("gather_rows_async", pr + "55",
         lambda: pp.gather_rows_async(ids, tab),
         lambda: pp.gather_rows_ref(ids, tab),
         lambda: tab.index_select(0, ids.reshape(-1)), (gather_b, 0)),
        ("extract_sum", pr + "77", lambda: pp.extract_sum(v),
         lambda: pp.extract_sum_ref(v),
         lambda: v[:, 0].sum(dtype=torch.int32), (pp.BLK * 4 + 8 * row_b,
                                                  pp.BLK - 1)),
        ("pass7", pr + "103", lambda: pp.pass7(planes),
         lambda: pp.pass7_ref(planes),
         lambda: [o.copy_(x) for o, x in zip(outs, planes)],
         (2 * 7 * pp.T * row_b, 0)),
        ("col_gather", sg + "25", lambda: ps.col_gather(tab, idx),
         lambda: ps.col_gather_ref(tab, idx),
         lambda: torch.gather(tab, 0, idx64),
         (2 * idx.numel() * 4 + rows[2] * 4, 0)),
        ("row_loop", sg + "25", lambda: ps.row_loop(tab, idx),
         lambda: ps.row_loop_ref(tab, idx),
         lambda: tab.index_select(0, idx[:, 0]),
         (ps.BLK * 4 + rows[1] * row_b + idx.numel() * 4, 0)),
    ]
    floor = launch_floor()
    say(phase, f"launch floor: an empty kernel {floor:.5f} ms on the device "
        f"(one block of 32 threads, {N_ORBIT} launches in a CUDA graph, as "
        f"each probe below is timed)")
    entries, bad = [], {}
    for name, rep, kern, ref, lib, (nb, ops) in probes:
        got, want = flat_outputs(kern()), flat_outputs(ref())
        bad[name] = sum(words_differ(a, b) for a, b in zip(got, want))
        err = max(float((a.view(torch.int32).double()
                         - b.view(torch.int32).double()).abs().max())
                  for a, b in zip(got, want))  # of the words' values
        ms = graph_ms(lambda i: kern(), N_ORBIT)
        lib_ms = graph_ms(lambda i: lib(), N_ORBIT)
        p_ms = plain_ms(ref)
        bms, by = bound(nb, ops)
        entries.append(dict(name=name, source=PROBE_SRC, replaces=rep,
                            launches=launches[name], max_abs_err=err, ms=ms,
                            plain_ms=p_ms, bound=(bms, by), library_ms=lib_ms))
        say(phase, f"{name}: {ms:.5f} ms on the device, plain {p_ms:.3f} ms, "
            f"library call {lib_ms:.5f} ms, least {bms:.6f} ms, bound by "
            f"{by}, launch floor {floor:.5f} ms; words differing from "
            f"plain {bad[name]}")
    def serial():
        return pp.gather_rows_async(ids, tab, pipelined=False)

    bad["gather_rows_async serial"] = words_differ(
        serial(), pp.gather_rows_ref(ids, tab))
    ser = graph_ms(lambda i: serial(), N_ORBIT)
    say(phase, f"gather_rows_async serial (TMA bulk, each row waited): "
        f"{ser:.5f} ms on the device, launch floor {floor:.5f} ms; words "
        f"differing from plain {bad['gather_rows_async serial']}; the "
        f"default above keeps 16 rows in flight; distinct rows gathered "
        f"{rows[0]} of {ids.numel()}")
    check(not any(bad.values()), "a probe kernel disagrees with its plain "
          "version")
    return entries


# ------------------------------------------------------------ the preset world

# config2/config3's world (benchmarks/run.py:183-212, :283-307): the terra
# datapack's first preset (Continents), this seed, an 8^3-chunk window
# around find_land_near(0, 0), generated in device batches of 128
# (run.py:268), features merged
PRESET_SEED = 20260816
PRESET_W = 8
GEN_BATCH = 128
CONFIG4A_SEED = 1      # config4a's generator (run.py:455)
N_ORBIT_PRESET = 3


def preset_packs():
    from voxelraytracing_tpu_torch.resources.packs import (
        Resources, builtin_respack_path)

    res = Resources.load_from(builtin_respack_path())
    return res.datapacks["terra"], res.stylepacks["terra"]


def preset_window(gen):
    """The window of benchmarks/run.py:_preset_grids_host: chunk positions
    in its x-major order, the min chunk and the camera's eye."""
    x, h, z = gen.find_land_near(0, 0) or (0, 80, 0)
    mn = (x // 32 - PRESET_W // 2, 0, z // 32 - PRESET_W // 2)
    r = range(PRESET_W)
    pos = [(mn[0] + i, j, mn[2] + k) for i in r for j in r for k in r]
    return pos, mn, (float(x + 20), float(h + 30), float(z + 20))


def preset_cams(mn, eye, size, n_orbit=N_ORBIT_PRESET):
    """config2/3's camera (run.py:313, :360) and an orbit around the
    window's centre, 30 degrees down, at 0.72 of its height."""
    from voxelraytracing_tpu_torch.ops.camera import CamData

    v = PRESET_W * 32
    c = np.asarray(mn, np.float64) * 32 + v * 0.5
    cams = [CamData.create((30.0, 45.0, 0.0), eye, 70.0, size)]
    for i in range(n_orbit):
        a = 360.0 * (i + 0.5) / n_orbit
        e = (c[0] + v * 0.35 * np.cos(np.deg2rad(a)), mn[1] * 32 + v * 0.72,
             c[2] + v * 0.35 * np.sin(np.deg2rad(a)))
        cams.append(CamData.create((30.0, (a + 180.0) % 360.0, 0.0), e, 70.0,
                                   size))
    return cams


def same_features(a, b):
    """Two generate_chunks feature lists hold the same voxel clouds."""
    return ([len(f) for f in a] == [len(f) for f in b]
            and all(x.voxels == y.voxels for fa, fb in zip(a, b)
                    for x, y in zip(fa, fb)))


def host_s(fn, n=WINDOWS):
    """Median host seconds of ``fn()`` (which ends in a device sync)."""
    fn()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def phase_worldgen(phase):
    """The preset window generated on the card in batches of 128; the
    batch with the most features also on the CPU: grids, every aux map
    and the features equal; chunks/s on the card. Returns the card's
    generator, the packs, the window, that batch, its card grids and the
    card's ``generate_chunks`` results of every batch."""
    from voxelraytracing_tpu_torch.worldgen import WorldGen

    dp, sp = preset_packs()
    gen = WorldGen.from_datapack(dp, PRESET_SEED)
    cpu = WorldGen.from_datapack(dp, PRESET_SEED, device="cpu")
    pos, mn, eye = preset_window(gen)
    land = (gen.find_land_near(0, 0), cpu.find_land_near(0, 0))
    batches = [pos[o:o + GEN_BATCH] for o in range(0, len(pos), GEN_BATCH)]
    out = [gen.generate_chunks(b) for b in batches]
    k = max(range(len(out)), key=lambda i: sum(len(f) for f in out[i][1]))
    batch, (grids, feats) = batches[k], out[k]
    cgrids, cfeats = cpu.generate_chunks(batch)
    _, aux = gen.terrain.generate_grids(batch)
    _, caux = cpu.terrain.generate_grids(batch)
    bad = {k: int((aux[k].cpu() != caux[k]).sum()) for k in caux}
    bad["grids"] = int((grids.cpu() != cgrids).sum())
    feats_ok = same_features(feats, cfeats)
    n_feats = sum(len(f) for f in feats)
    t_gen = host_s(lambda: gen.generate_chunks(batch))
    t_dev = median_windows(lambda i: gen.terrain.generate_grids(batch), 4)
    say(phase, f"preset window (terra, Continents, seed {PRESET_SEED}, land "
        f"{land[0]}, min chunk {mn}): batch {k} of {len(batch)} chunks, card vs "
        f"CPU differing grid voxels and aux map entries {bad}, features "
        f"equal {feats_ok} ({n_feats}); generate_chunks on the card "
        f"{t_gen * 1e3:.2f} ms = {len(batch) / t_gen:.1f} chunks/s (host "
        f"features included), the terrain pass alone {t_dev:.3f} ms = "
        f"{len(batch) / t_dev * 1e3:.1f} chunks/s (CUDA events)")
    check(land[0] == land[1], "find_land_near differs between card and CPU")
    check(not any(bad.values()) and feats_ok,
          "worldgen on the card differs from the CPU")
    return gen, dp, sp, pos, mn, eye, batch, grids, out


def phase_svo_build(gen, dp, batch, grids, phase):
    """The batch's SVO build on the card (build_chunk_svo_batch, and
    ServerWorld.build_nodes after its generate_chunks) against the port's
    native dense_to_svo_batch, word for word; config4a's rebuild step
    (run.py:443-474: 16x8 chunks at y=1 of a seed-1 generator, a new
    offset each step) as chunks/s of ServerWorld.generate_chunks +
    build_nodes on the card."""
    from voxelraytracing_tpu_torch.core import native
    from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo_batch
    from voxelraytracing_tpu_torch.server import ServerWorld
    from voxelraytracing_tpu_torch.worldgen import WorldGen

    nodes, counts = build_chunk_svo_batch(grids)
    host = grids.cpu().numpy()
    nn, nc = native.dense_to_svo_batch(host)
    bad = words_differ(nodes.cpu(), torch.from_numpy(nn)) + int(
        (counts.cpu().numpy() != nc).sum())
    sw = ServerWorld(gen)
    sw.generate_chunks(batch)
    built = sw.build_nodes(batch)
    bad_sw = 0  # chunks whose trimmed uint16 nodes differ
    for i, p in enumerate(batch):
        want = nn[i, :nc[i]].astype(np.uint16)
        bad_sw += int(built[p].shape != want.shape
                      or bool((built[p] != want).any()))
    t_build = median_windows(lambda i: build_chunk_svo_batch(grids), 4)

    gen1 = WorldGen.from_datapack(dp, CONFIG4A_SEED)
    off = [0]

    def step():
        off[0] += 1
        pos = [(off[0] + i, 1, j) for i in range(16) for j in range(8)]
        w = ServerWorld(gen1)
        w.generate_chunks(pos)
        w.build_nodes(pos)

    t_step = host_s(step)
    say(phase, f"SVO build of the batch on the card vs the native builder: "
        f"differing node words and counts {bad} (nodes {int(counts.sum())}, "
        f"{int(counts.max())} the most in a chunk), ServerWorld.build_nodes "
        f"{bad_sw}; build_chunk_svo_batch {t_build:.3f} ms = "
        f"{len(batch) / t_build * 1e3:.1f} chunks/s (CUDA events); config4a's "
        f"rebuild step (generate_chunks + build_nodes, 128 chunks) "
        f"{t_step * 1e3:.2f} ms = {GEN_BATCH / t_step:.1f} chunks/s (host "
        f"clock)")
    check(bad == 0 and bad_sw == 0,
          "the SVO build on the card differs from the native builder")


def preset_grids(generated, pos):
    """The 512-chunk window's grids from its batches' ``generate_chunks``
    results, features stamped as benchmarks/run.py:_preset_grids_host does,
    and their window cells."""
    g = np.concatenate([grids.cpu().numpy() for grids, _ in generated])
    idx = {p: i for i, p in enumerate(pos)}
    for _, fb in generated:
        for fl in fb:
            for f in fl:
                for (vx, vy, vz), v in f.voxels.items():
                    i = idx.get((vx // 32, vy // 32, vz // 32))
                    if i is not None:
                        g[i, vx % 32, vy % 32, vz % 32] = v
    w = PRESET_W
    r = range(w)
    cells = np.asarray([i + j * w + k * w * w for i in r for j in r for k in r],
                       np.int32)
    return g, cells


def preset_world(generated, dp, sp, pos, mn):
    """The 512-chunk window from its batches' ``generate_chunks`` results,
    features stamped as benchmarks/run.py:_preset_grids_host does, built
    into RenderGrid3 tables on the card and on the CPU."""
    from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host

    g, cells = preset_grids(generated, pos)
    feats = [f for _, fb in generated for f in fb]
    w = PRESET_W
    mats = sp.material_table(dp.voxels)
    wmin = np.asarray(mn, np.int32) * 32
    rg = build_render_grid3_host(g, cells, wmin, w, mats)
    rg_cpu = build_render_grid3_host(g, cells, wmin, w, mats, device="cpu")
    return rg, rg_cpu, mats, sum(len(f) for f in feats)


def phase_preset_frames(generated, dp, sp, pos, mn, eye, smi, phase):
    """config2/3's preset world on the card: the fused 1080p primary frame,
    config2's 720p fused shadowed frame and config3's 1080p one-bounce
    path_trace_fused4 frame. Each kernel vs its plain version on the card,
    exactly; card vs CPU at 320x180 (the bars of phases 5/8 and 13);
    launches on the three paths, each counted from 0; ms/frame beside
    ``smi``, the card's name and power limit."""
    from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4
    from voxelraytracing_tpu_torch.ops.wavefront3 import color_lut_rows

    t0 = time.perf_counter()
    rg, rg_cpu, mats, n_feats = preset_world(generated, dp, sp, pos, mn)
    prep = t4.prepare_grid4(rg)
    torch.cuda.synchronize()
    lut = color_lut_rows(mats.color).to(rg.sw_solid.device)
    say(phase, f"preset world: {len(pos)} chunks generated on the card in "
        f"batches of {GEN_BATCH} (phase 30), {n_feats} features merged, "
        f"tables built on the card and on the CPU, "
        f"{time.perf_counter() - t0:.1f} s; sw_cont "
        f"{prep.sw_cont.numel() * 4 / 1e6:.1f} MB, palettes ok "
        f"{rg.palettes_ok}")
    c1080 = preset_cams(mn, eye, (WIDTH, HEIGHT))
    c720 = preset_cams(mn, eye, SIZES[1])
    compare_on_card(rg, prep, lut, c1080, phase)
    compare_shadows(rg, prep, lut, c720, phase)
    pt_bad = 0
    for cam in c1080:
        args, (h, w) = pt_args(rg, mats, cam, prep)
        kw = dict(height=h, width=w, bounces=PT_KW["bounces"],
                  samples=PT_KW["samples"])
        pt_bad += words_differ(p4.pt4(*args, **kw), p4.pt4_ref(*args, **kw))
    say(phase, f"{len(c1080)} cameras at {WIDTH}x{HEIGHT}, config3's "
        f"one-bounce frame: pt4 vs plain differing words {pt_bad}")
    check(pt_bad == 0, "pt4 disagrees with its plain version on the preset "
          "world")

    small = preset_cams(mn, eye, (320, 180))
    compare_on_cpu(rg_cpu, rg, mats, None, phase, cams=small)
    compare_on_cpu(rg_cpu, rg, mats, None, phase, shadows=True, cams=small)
    worst = 1.0
    for cam in small:
        a = pt_frame(p4.path_trace_fused4, rg, mats, cam).cpu()
        b = pt_frame(p4.path_trace_fused4, rg_cpu, mats, cam)
        worst = min(worst, pt_bar(a, b))
    say(phase, f"{len(small)} one-bounce path_trace_fused4 frames at "
        f"320x180, card vs CPU: worst share of pixels within 2/255 "
        f"{worst:.6f}")
    check(worst >= PT_BAR, "the preset path-traced frame misses the bar "
          "against the CPU")

    paths = {
        "primary 1080p": lambda cam=c1080[0]: t4.render_frame4(
            rg, cam, lut, prepared=prep, **BENCH_KW),
        "config2 720p shadowed": lambda cam=c720[0]: t4.render_frame4(
            rg, cam, lut, prepared=prep, shadows=True, sun_pos=sun_of(cam),
            **BENCH_KW),
        "config3 1080p path-traced": lambda cam=c1080[0]: pt_frame(
            p4.path_trace_fused4, rg, mats, cam, prepared=prep),
    }
    counters = (t4.march_fused4, t4.march_planes4, t4.touched4, t4.shade4,
                p4.pt4)
    want = {"primary 1080p": [3, 0, 0, 0, 0],
            "config2 720p shadowed": [3, 0, 0, 0, 0],
            "config3 1080p path-traced": [0, 0, 0, 0, 3]}
    counts, ms = {}, {}
    for name, fn in paths.items():
        for c in counters:
            c.launches = 0
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        counts[name] = [c.launches for c in counters]
        ms[name] = median_windows(lambda i: fn(), 8)
    for name in paths:
        say(phase, f"{name} x3: launches fused/planes/touched/shade/pt4 "
            f"{counts[name]}; static camera {ms[name]:.4f} ms/frame (median "
            f"of {WINDOWS} windows, CUDA events; {smi})")
    check(counts == want, "a preset frame did not run its kernel once a frame")
    return rg, mats


def phase_native(calls, phase):
    """The port's native library built from its own copy of
    ``svo_core.cpp``, and the streaming builder took its row path
    (``sw_rows_build``) in the fly-through (phase 17), not the NumPy
    twin."""
    from voxelraytracing_tpu_torch.core import native

    say(phase, f"native library {native.library_path()} built "
        f"{native.available()} (from {native.SOURCE}); sw_rows_build calls "
        f"in the W=80 fly-through {calls}")
    check(native.available(), "the port's native library did not build")
    check(calls >= N_STREAM, "the streaming builder did not take the native "
          "row path")


# ------------------------------------------------------------ the SVO path

# hit masks and voxel ids on common hits of two tracers at most this share
# apart (tools/tpu_correctness.py:188's hit bar; that harness asks exact
# ids of one tracer on two devices, these are two tracers)
SVO_V4_BAR = 0.002
N_ORBIT_SVO = 2
SVO_SMALL = (320, 180)
PT_SVO = dict(max_bounces=3)
# card vs CPU, trace_rays' positions and water distances (the scalar
# oracle's tolerance, tests/test_tracer.py:84-90); hit, voxel, normal and
# steps exact
SVO_GAP = 1e-3
SERVE_W = 8
SERVE_MAX_NODES = 1 << 25


def svo_worlds(generated, pos, mn, eye, dp, sp, phase):
    """The SVO worlds: ``make_demo_world(7, 8)`` on the card and on the CPU
    (nodes and roots word for word), and the 512-chunk preset world
    through ``assemble_world_slice`` (fixed slots, built on the card) and
    through ``build_world_slice`` (the host pool): the pools differ, so
    their ``trace_rays`` results must be equal; ``packed()`` traces equal
    to the widened pool."""
    from voxelraytracing_tpu_torch.ops.camera import generate_rays
    from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo_batch
    from voxelraytracing_tpu_torch.ops.traverse import trace_rays
    from voxelraytracing_tpu_torch.world import (
        assemble_world_slice, build_world_slice)
    from voxelraytracing_tpu_torch.world.demo import (
        demo_materials, make_demo_world)

    t0 = time.perf_counter()
    demo = make_demo_world(7, 8)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    demo_cpu = make_demo_world(7, 8, device="cpu")
    bad_demo = sum(words_differ(getattr(demo, f).cpu(), getattr(demo_cpu, f))
                   for f in demo._fields)
    g, cells = preset_grids(generated, pos)
    wmin = np.asarray(mn, np.int32) * 32
    t0 = time.perf_counter()
    nodes, counts = build_chunk_svo_batch(g)
    fixed = assemble_world_slice(nodes, cells, wmin, PRESET_W)
    torch.cuda.synchronize()
    t_fixed = time.perf_counter() - t0
    host_n, host_c = nodes.cpu().numpy(), counts.cpu().numpy()
    chunks = {p: host_n[i, :host_c[i]] for i, p in enumerate(pos)}
    t0 = time.perf_counter()
    pooled, _ = build_world_slice(chunks, mn, PRESET_W)
    torch.cuda.synchronize()
    t_pool = time.perf_counter() - t0
    mats = sp.material_table(dp.voxels)
    cam = preset_cams(mn, eye, (WIDTH, HEIGHT), 0)[0]
    origin, dirs = generate_rays(cam, wmin)
    runs = [trace_rays(w, mats.is_liquid, origin, dirs)
            for w in (fixed, pooled, fixed.packed(), pooled.packed())]
    bad_trace = [sum(words_differ(a, b) for a, b in zip(runs[0], r))
                 for r in runs[1:]]
    say(phase, f"make_demo_world(7, 8) on the card ({t_card:.2f} s, "
        f"{demo.nodes.numel()} pool words) vs the CPU: differing words "
        f"{bad_demo}; preset world ({len(pos)} chunks, "
        f"{int(counts.sum())} nodes): assemble_world_slice "
        f"{fixed.nodes.numel()} words in {t_fixed:.2f} s, build_world_slice "
        f"{pooled.nodes.numel()} words in {t_pool:.2f} s; {WIDTH}x{HEIGHT} "
        f"trace_rays at the config camera ({int(runs[0].hit.sum())} hits, "
        f"{int(runs[0].steps.max())} steps at most), words differing from "
        f"the fixed slots: host pool {bad_trace[0]}, packed fixed "
        f"{bad_trace[1]}, packed host pool {bad_trace[2]}")
    check(bad_demo == 0, "make_demo_world differs between card and CPU")
    check(not any(bad_trace), "the preset world's slices trace differently")
    return demo, demo_cpu, fixed, mats


def svo_vs_v4(worlds, phase):
    """``trace_rays`` against ``trace_wavefront4_rays`` (the ``touched4`` +
    ``march_planes4`` bundle path) on the same ``generate_rays`` bundle at
    1080p: hit masks and voxel ids on common hits at most
    :data:`SVO_V4_BAR` apart. ``worlds``: name -> (WorldSlice, RenderGrid3,
    materials, cameras). Launches of both kernels counted from 0."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4
    from voxelraytracing_tpu_torch.ops.camera import generate_rays
    from voxelraytracing_tpu_torch.ops.traverse import trace_rays

    worst = 0.0
    for name, (world, rg, mats, cams) in worlds.items():
        wmin = world.world_min.cpu().numpy()
        for i, cam in enumerate(cams):
            w, h = cam.proj_size
            origin, dirs = generate_rays(cam, wmin)
            ref = trace_rays(world, mats.is_liquid, origin, dirs)
            for c in (t4.touched4, t4.march_planes4):
                c.launches = 0
            wf = t4.trace_wavefront4_rays(
                rg, origin.expand(h, w, 3), dirs,
                torch.ones(h, w, dtype=torch.bool, device=dirs.device),
                width=w, height=h, step_cap=500)
            torch.cuda.synchronize()
            launches = (t4.touched4.launches, t4.march_planes4.launches)
            both = ref.hit & wf.hit
            hit_mm = int((ref.hit != wf.hit).sum())
            vox_mm = int((ref.voxel != wf.voxel)[both].sum())
            n_both = max(int(both.sum()), 1)
            share = max(hit_mm / (w * h), vox_mm / n_both)
            worst = max(worst, share)
            say(phase, f"{name} camera {i} {w}x{h}: SVO trace_rays vs "
                f"trace_wavefront4_rays, hit mismatches {hit_mm} of {w * h}, "
                f"voxel mismatches {vox_mm} of {n_both} common hits; "
                f"touched4/march_planes4 launches {launches}")
            check(min(launches) >= 1, "the v4 bundle trace did not launch "
                  "touched4 and march_planes4")
    check(worst <= SVO_V4_BAR, "the SVO tracer and the v4 kernels disagree "
          "past the bar")
    return worst


def trace_gap(a, b):
    """(words differing in hit, voxel, norm, steps; largest gap in pos and
    water_dist) of two TraceResults."""
    exact = sum(words_differ(getattr(a, f), getattr(b, f))
                for f in ("hit", "voxel", "norm", "steps"))
    gap = max(float((getattr(a, f) - getattr(b, f)).abs().max())
              for f in ("pos", "water_dist"))
    return exact, gap


def svo_card_vs_cpu(demo, demo_cpu, mats, phase):
    """At 320x180 on the demo world, card vs CPU: ``trace_rays`` (hit,
    voxel, norm, steps exact; pos and water word for word, the largest
    gap printed), ``RayTracer`` plain, shadowed and as the heatmap and
    ``composite_crosshair`` (0 hit and voxel mismatches, every pixel's
    sRGB8 within 2/255), ``PathTracer`` with 3 bounces, 1 sample (the PT
    bar)."""
    from voxelraytracing_tpu_torch.models import (
        PathTracer, RayTracer, RenderSettings, composite_crosshair, to_srgb8)
    from voxelraytracing_tpu_torch.ops.camera import generate_rays
    from voxelraytracing_tpu_torch.ops.traverse import trace_rays

    v = 8 * 32
    static, orbit = bench_cams(v, *SVO_SMALL, n_orbit=N_ORBIT_SVO)
    cams = [static] + orbit[:1]
    exact = 0
    gap = 0.0
    for cam in cams:
        origin, dirs = generate_rays(cam, np.zeros(3, np.int32))
        a = trace_rays(demo, mats.is_liquid, origin, dirs)
        b = trace_rays(demo_cpu, mats.is_liquid, origin.cpu(), dirs.cpu())
        e, g = trace_gap(type(a)(*(x.cpu() for x in a)), b)
        exact, gap = exact + e, max(gap, g)
    say(phase, f"{len(cams)} cameras at {SVO_SMALL[0]}x{SVO_SMALL[1]}, "
        f"trace_rays card vs CPU: hit/voxel/norm/steps words differing "
        f"{exact}, largest pos/water gap {gap:g} (bar {SVO_GAP:g})")
    check(exact == 0 and gap <= SVO_GAP, "trace_rays differs between card "
          "and CPU")
    hit_bad = vox_bad = 0
    within = total = 0
    for mode in ("plain", "shadows", "heatmap"):
        tracer = RayTracer(mats, show_step_count=mode == "heatmap",
                           shadows=mode == "shadows")
        for cam in cams:
            s = RenderSettings(sun_pos=sun_of(cam))
            img, rs = tracer.render(demo, cam, s)
            rimg, rrs = tracer.render(demo_cpu, cam, s)
            hit_bad += int((rs.hit.cpu() != rrs.hit).sum())
            both = rs.hit.cpu() & rrs.hit
            vox_bad += int((rs.voxel.cpu() != rrs.voxel)[both].sum())
            for style in ("off", "dot", "cross"):
                x = to_srgb8(composite_crosshair(img, style)).astype(int)
                y = to_srgb8(composite_crosshair(rimg, style)).astype(int)
                within += int((np.abs(x - y).max(axis=-1) <= 2).sum())
                total += x.shape[0] * x.shape[1]
    say(phase, f"RayTracer plain, shadowed and heatmap x {len(cams)} "
        f"cameras, each with the three crosshair styles, card vs CPU: hit "
        f"mismatches {hit_bad}, voxel mismatches {vox_bad}, pixels within "
        f"2/255 {within / total:.6f}")
    check(hit_bad == 0 and vox_bad == 0 and within == total,
          "the SVO ray tracer misses the bar against the CPU")
    worst = 1.0
    pt = PathTracer(mats, **PT_SVO)
    for cam in cams[:1]:
        s = RenderSettings(sun_pos=sun_of(cam))
        a = pt.render(demo, cam, s, key=np.asarray([0, 7], np.uint32)).cpu()
        b = pt.render(demo_cpu, cam, s, key=np.asarray([0, 7], np.uint32))
        worst = min(worst, pt_bar(a, b))
        check(bool(torch.isfinite(a).all()), "a PathTracer frame is not "
              "finite")
    say(phase, f"PathTracer (3 bounces, 1 sample), bench camera at "
        f"{SVO_SMALL[0]}x{SVO_SMALL[1]}, card vs CPU: worst share of pixels "
        f"within 2/255 {worst:.6f}")
    check(worst >= PT_BAR, "the SVO path tracer misses the bar against the "
          "CPU")


def busy_share(fn, frame_ms):
    """Device share of one call of ``fn``: the summed device time of the
    kernels and copies it ran (torch.profiler, CUPTI; one stream, so they
    do not overlap) over ``frame_ms``, and how many there were; None when
    the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(0)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    if not dev_us:
        return None, 0.0, 0
    return dev_us / 1e3 / frame_ms, dev_us / 1e3, len(dev)


def config1_world():
    """benchmarks/run.py:74-98: a flat 32³ chunk (stone below y=12, grass
    at 12), its camera at 256x256 and sun."""
    from voxelraytracing_tpu_torch.ops.camera import CamData
    from voxelraytracing_tpu_torch.ops.materials import make_material_table
    from voxelraytracing_tpu_torch.ops.svo_build import build_chunk_svo
    from voxelraytracing_tpu_torch.world import build_world_slice

    g = np.zeros((32,) * 3, np.int32)
    g[:, :12, :] = 1
    g[:, 12, :] = 2
    nodes, n = build_chunk_svo(g)
    world, _ = build_world_slice(
        {(0, 0, 0): nodes[:int(n)].cpu().numpy()}, (0, 0, 0), 1)
    mats = make_material_table(4, {1: {"color": (0.5,) * 3, "state": "solid"},
                                   2: {"color": (0.2, 0.6, 0.2),
                                       "state": "solid"}})
    cam = CamData.create((30.0, 30.0, 0.0), (16.0, 20.0, 16.0), 70.0,
                         (256, 256))
    return world, mats, cam, (100.0, 400.0, 50.0)


def svo_times(demo, demo_mats, preset, preset_cam, preset_mats, smi, phase):
    """ms/frame (CUDA events, median of 5 windows) of the SVO ``RayTracer``
    at 1080p on the demo and preset worlds, plain and shadowed; the
    ``PathTracer`` at 1080p, 3 bounces, 1 sample (median of 3); config1's
    frame in Mrays/s as run.py:98 counts it; the device's busy share of a
    plain demo frame."""
    from voxelraytracing_tpu_torch.models import (
        PathTracer, RayTracer, RenderSettings)

    v = 8 * 32
    static, _ = bench_cams(v, WIDTH, HEIGHT, 0)
    out = {}
    for name, world, mats, cam in (("demo", demo, demo_mats, static),
                                   ("preset", preset, preset_mats,
                                    preset_cam)):
        for shadows in (False, True):
            tr = RayTracer(mats, shadows=shadows)
            s = RenderSettings(sun_pos=sun_of(cam))
            out[name, shadows] = median_windows(
                lambda i: tr.render(world, cam, s), 1)
    tr = RayTracer(demo_mats)
    s = RenderSettings(sun_pos=sun_of(static))
    share, dev_ms, n_dev = busy_share(lambda i: tr.render(demo, static, s),
                                      out["demo", False])
    pt = PathTracer(demo_mats, **PT_SVO)
    s = RenderSettings(sun_pos=sun_of(static))
    pt.render(demo, static, s)
    out["pt"] = statistics.median(
        event_ms(lambda i: pt.render(demo, static, s), 1) for _ in range(3))
    w1, m1, c1, sun1 = config1_world()
    t1 = RayTracer(m1)
    s1 = RenderSettings(sun_pos=sun1)
    out["config1"] = median_windows(lambda i: t1.render(w1, c1, s1), 1)
    for name in ("demo", "preset"):
        say(phase, f"RayTracer {name} world {WIDTH}x{HEIGHT}: plain "
            f"{out[name, False]:.3f} ms/frame, shadowed "
            f"{out[name, True]:.3f} ms/frame (median of {WINDOWS} windows, "
            f"CUDA events; {smi})")
    say(phase, f"PathTracer demo world {WIDTH}x{HEIGHT}, 3 bounces, 1 "
        f"sample: {out['pt']:.3f} ms/frame (median of 3; {smi})")
    say(phase, f"config1 (flat 32^3 chunk, 256x256, run.py:74-98): "
        f"{out['config1']:.3f} ms/frame = "
        f"{256 * 256 / out['config1'] / 1e3:.3f} Mrays/s ({smi})")
    if share is None:
        say(phase, "device busy share of a plain demo RayTracer frame: not "
            "measured (torch.profiler saw no device time)")
    else:
        say(phase, f"device busy share of a plain demo RayTracer frame: "
            f"{share:.4f} ({n_dev} kernels and copies, {dev_ms:.3f} ms on the "
            f"device, torch.profiler, over {out['demo', False]:.3f} ms/frame; "
            f"{dev_ms / max(n_dev, 1) * 1e3:.1f} us each; {smi})")
    out["busy"] = share
    return out


def v1_device_builder(phase):
    """``build_render_grid`` on the card == ``build_render_grid_host`` word
    for word on the 8-chunk demo world, and the v2 frame (``render`` on a
    v1 grid) drawn from the device tables == the frame from the host
    tables, bit for bit."""
    from voxelraytracing_tpu_torch.models.raytracer import (
        RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops import noise
    from voxelraytracing_tpu_torch.ops.wavefront import build_render_grid
    from voxelraytracing_tpu_torch.world.demo import (
        demo_chunk_grids_host, demo_materials)

    grids, cells = demo_chunk_grids_host(
        noise.make_permutation(7), np.zeros(3, np.int64), 8, 8 * 32 * 0.45,
        int(8 * 32 * 0.28))
    mats = demo_materials()
    t0 = time.perf_counter()
    dev = build_render_grid(grids, cells, np.zeros(3, np.int32), 8, mats)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    host = build_world1(8)
    fields = ("bwin", "lwin", "brick_dir", "bricks", "world_min", "to_pack")
    bad = sum(words_differ(getattr(dev, f), getattr(host, f)) for f in fields)
    same = (dev.n_liquid, dev.size_voxels) == (host.n_liquid,
                                                host.size_voxels)
    static, _ = bench_cams(8 * 32, WIDTH, HEIGHT, 0)
    s = RenderSettings(sun_pos=sun_of(static))
    r = WavefrontRenderer(mats)
    a, wa = r.render(dev, static, s)
    b, wb = r.render(host, static, s)
    frame_bad = words_differ(a, b) + sum(
        words_differ(x, y) for x, y in zip(wa, wb))
    say(phase, f"build_render_grid on the card ({t_dev:.2f} s) vs "
        f"build_render_grid_host: differing words {bad}, n_liquid and size "
        f"equal {same}; the v2 {WIDTH}x{HEIGHT} frame from each: differing "
        f"image and trace words {frame_bad}")
    check(bad == 0 and same and frame_bad == 0,
          "the v1 device builder differs from the host builder")


class ServerLoop:
    """The port's ``ServerState`` ticking in a thread of this process (the
    server CLI's loop); :meth:`stop` re-raises what the thread raised."""

    def __init__(self, state):
        import threading

        self.state = state
        self.error = None
        self.halt = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self.halt.is_set():
                self.state.handle_clients()
                self.state.update()
                self.state.update_world()
                time.sleep(0.001)
        except BaseException as e:  # handed to the main thread by stop()
            self.error = e

    def stop(self):
        self.halt.set()
        self.thread.join()
        if self.error is not None:
            raise self.error


def serve_client(port, name):
    from voxelraytracing_tpu_torch.client import (
        ClientWorld, GameState, ServerConn)

    conn = ServerConn.establish(("127.0.0.1", port), name)
    center = np.floor_divide(np.asarray(conn.player_pos, np.int64), 32)
    return GameState(name, ClientWorld(center, SERVE_MAX_NODES, SERVE_W), conn)


def pump_until(game, loop, done, what, quiet_s=0.0, limit_s=120.0):
    """Pump ``game``'s commands until ``done()`` holds and no chunk has
    arrived for ``quiet_s`` seconds; fails after ``limit_s``."""
    t0 = last = time.perf_counter()
    while True:
        rs = game.process_cmds_timeout(0.02)
        now = time.perf_counter()
        if rs.updated_chunks:
            last = now
        if loop.error is not None:
            loop.stop()
        if done() and now - last >= quiet_s:
            return now - t0
        check(now - t0 < limit_s, f"the served world did not {what} in "
              f"{limit_s:.0f} s")
        time.sleep(0.002)


def client_slice(game):
    from voxelraytracing_tpu_torch.world.pool import world_slice

    w = game.world
    return world_slice(w.nodes, w.chunk_roots(), w.min_voxel)


def served_world(dp, sp, phase):
    """A served world end to end: the port's ``ServerState`` on localhost in
    this process (terra, Continents, seed 20260816, spawn at
    ``find_land_near(0, 0)``; generation and ``build_nodes`` on the card),
    a ``GameState`` with a window of 8 streaming until its 512 chunks are
    populated (chunks/s); its ``WorldSlice`` (``nodes`` + ``chunk_roots()``)
    draws a 1080p ``RayTracer`` frame equal bit for bit to one drawn from
    ``build_world_slice`` of the server's chunk nodes; a second client
    connects, the first one's ``set_voxel`` echoes to it, and after the
    edit both clients' frames equal the server's."""
    from voxelraytracing_tpu_torch.models import RayTracer, RenderSettings
    from voxelraytracing_tpu_torch.server import ServerState, ServerWorld
    from voxelraytracing_tpu_torch.world import build_world_slice
    from voxelraytracing_tpu_torch.worldgen import WorldGen

    gen = WorldGen.from_datapack(dp, PRESET_SEED)
    state = ServerState(ServerWorld(gen), voxel_pack=dp.voxels)
    port = state.start()
    mats = sp.material_table(dp.voxels)
    n = SERVE_W ** 3
    try:
        loop = ServerLoop(state)
        a = serve_client(port, "first")
        a.request_missing_chunks()
        t_stream = pump_until(a, loop, lambda: a.world.populated_count() >= n,
                              "stream")
        t_quiet = pump_until(
            a, loop, lambda: not state.chunks_to_build
            and not state.dirty_chunks, "settle", quiet_s=1.0)
        loop.stop()
        a.process_cmds_timeout(0.2)
        x, y, z = (int(np.floor(c)) for c in a.player.pos)
        cam_eye = (x + 20.0, y + 30.0, z + 20.0)
        from voxelraytracing_tpu_torch.ops.camera import CamData

        cam = CamData.create((30.0, 45.0, 0.0), cam_eye, 70.0, (WIDTH, HEIGHT))
        s = RenderSettings(sun_pos=sun_of(cam))
        tracer = RayTracer(mats)
        mn = tuple(int(c) for c in a.world.min_chunk)
        keys = sorted(a.world.chunks)

        def server_frame():
            nodes = state.world.build_nodes(keys)
            ws, _ = build_world_slice(nodes, mn, SERVE_W)
            return tracer.render(ws, cam, s)

        def frame_words(f, g):
            return words_differ(f[0], g[0]) + sum(
                words_differ(p, q) for p, q in zip(f[1], g[1]))

        fa, fs = tracer.render(client_slice(a), cam, s), server_frame()
        bad_first = frame_words(fa, fs)
        n_nodes = sum(len(v) for v in state.world.build_nodes(keys).values())
        say(phase, f"served world (terra, Continents, seed {PRESET_SEED}, "
            f"spawn {tuple(round(c, 1) for c in state.spawn)}): {n} chunks "
            f"streamed to a window of {SERVE_W} in {t_stream:.2f} s = "
            f"{n / t_stream:.1f} chunks/s (generation and SVO build on the "
            f"card, localhost TCP), settled (features placed, resent) "
            f"{t_quiet:.2f} s later; {n_nodes} server nodes; {WIDTH}x{HEIGHT} "
            f"RayTracer frame of the client's pool vs build_world_slice of "
            f"the server's nodes: differing words {bad_first} "
            f"({int(fa[1].hit.sum())} hits)")
        check(bad_first == 0, "the client's frame differs from the server's")
        check(keys == sorted(state.world.build_nodes(keys)),
              "the client holds chunks the server does not")

        loop = ServerLoop(state)
        b = serve_client(port, "second")
        b.request_missing_chunks()
        t_b = pump_until(b, loop, lambda: b.world.populated_count() >= n,
                         "stream to the second client")
        # the edit: stone in the air voxel in front of the hit nearest the
        # frame's centre on its middle row
        rs = fa[1]
        row = rs.hit[HEIGHT // 2].nonzero().flatten().cpu()
        check(len(row) > 0, "the served world's frame has no hit on its "
              "middle row")
        px = int(row[(row - WIDTH // 2).abs().argmin()])
        hp = rs.pos[HEIGHT // 2, px] + rs.norm[HEIGHT // 2, px] * 0.5
        edit = tuple(int(v) for v in (torch.floor(hp).cpu().numpy()
                                      + a.world.min_voxel))
        stone = a.voxels.by_name("stone")
        before = (a.world.get_voxel(edit), b.world.get_voxel(edit))
        a.set_voxel(edit, stone)
        pump_until(b, loop, lambda: b.world.get_voxel(edit) == stone,
                   "echo the edit")
        pump_until(a, loop, lambda: state.world.get_voxel(edit) == stone
                   and not state.dirty_chunks, "apply the edit")
        loop.stop()
        for g in (a, b):
            g.process_cmds_timeout(0.2)
        fs2 = server_frame()
        fa2 = tracer.render(client_slice(a), cam, s)
        fb2 = tracer.render(client_slice(b), cam, s)
        bad = (frame_words(fa2, fs2), frame_words(fb2, fs2))
        changed = words_differ(fs2[0], fs[0])
        say(phase, f"second client streamed {n} chunks in {t_b:.2f} s = "
            f"{n / t_b:.1f} chunks/s (each built on the server already); the "
            f"first client set "
            f"{edit} from {before[0]} to stone ({stone}), echoed to the "
            f"second (was {before[1]}); after the edit, differing frame words "
            f"first client vs server {bad[0]}, second client vs server "
            f"{bad[1]}; image words the edit changed {changed}")
        check(bad == (0, 0), "a client's frame differs from the server's "
              "after the edit")
        check(changed > 0, "the edit did not show in the frame")
        for g in (a, b):
            g.disconnect()
        return n / t_stream
    finally:
        state.stop()


# ------------------------------------------- bands, engine, entry, profiling

BAND_SIZE = (1280, 720)
BAND_MESHES = (1, 2, 6)  # bands of the frame on cuda:0
V3_BAND_ROUNDS = 32      # converged at 720p (the stitched frame says so)
ENGINE_W = 30            # the engine's default window, 27,000 chunks
ENGINE_STREAM_LIMIT_S = 150.0
ENGINE_SMALL = (320, 176)


def band_launches():
    """Stand-ins holding every launch of the band frames' kernels against
    their plain versions: ``march3``, ``touched4``, ``march_planes4`` and
    ``shade4``."""
    return [Launches("wavefront3", "march3"), Launches("wavefront4", "touched4"),
            Launches("wavefront4", "march_planes4"),
            Launches("wavefront4", "shade4")]


def band_frames(phase, devices=("cuda:0",)):
    """The band-sharded frames at 1280x720 on the 8-chunk world, config2's
    sun, shadows on: ``sharded_render_frame3`` (32 rounds) and
    ``sharded_render_frame4`` on meshes of 1, 2 and 6 bands of each device
    in ``devices`` (and, with more than one, one band a device); every
    launch of every band equals its plain version, the bands at y0 > 0
    among them, and the stitched frames equal the unsharded ones word for
    word. Then ``ShardedRayTracer`` against ``RayTracer`` (word for word)
    and ``sharded_accumulate_step`` (2 samples x 2 bands) against the host
    average of its samples (1e-6) on the 4-chunk SVO demo world. Returns
    the ms of the stitched frames."""
    from voxelraytracing_tpu_torch.models import RayTracer, RenderSettings
    from voxelraytracing_tpu_torch.ops.camera import CamData
    from voxelraytracing_tpu_torch.ops.wavefront3 import render_frame3
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        prepare_grid4, render_frame4)
    from voxelraytracing_tpu_torch.parallel import (
        ShardedRayTracer, make_mesh, sharded_accumulate_step,
        sharded_render_frame3, sharded_render_frame4)
    from voxelraytracing_tpu_torch.world.demo import make_demo_world

    rg, mats, v = build_world(8)
    static, _ = bench_cams(v, *BAND_SIZE, 0)
    s = RenderSettings(sun_pos=sun_of(static), shadows=True)
    kw = dict(sun_pos=s.sun_pos, shadows=True)
    full3 = render_frame3(rg, static, mats.color, rounds=V3_BAND_ROUNDS,
                          steps_per_round=128, **kw)
    full3_more = render_frame3(rg, static, mats.color,
                               rounds=2 * V3_BAND_ROUNDS, steps_per_round=128,
                               **kw)
    check(torch.equal(full3, full3_more), f"the unsharded v3 frame has not "
          f"converged at {V3_BAND_ROUNDS} rounds")
    full4 = render_frame4(rg, static, mats.color, prepared=prepare_grid4(rg),
                          **kw)
    meshes = [(f"{n} x {d}", [d] * n) for d in devices for n in BAND_MESHES]
    if len(devices) > 1:
        meshes.append((f"one band on each of {len(devices)} cards",
                       list(devices)))
    out = {}
    for name, devs in meshes:
        mesh = make_mesh(n_samples=1, n_rays=len(devs), devices=devs)
        for tracer, fn, full in (("v3", sharded_render_frame3, full3),
                                 ("v4", sharded_render_frame4, full4)):
            recs = band_launches()
            extra = dict(rounds=V3_BAND_ROUNDS) if tracer == "v3" else {}
            for r in recs:
                r.__enter__()
            try:
                img = fn(mesh, rg, static, mats.color, s, **extra)
                torch.cuda.synchronize()
            finally:
                for r in recs:
                    r.__exit__()
            ran = {r.name: r.n for r in recs}
            y0s = sorted({float(a[0][21]) for r in recs for a, _ in r.inputs
                          if r.name in ("march3", "touched4",
                                        "march_planes4")})
            bad = sum(r.bad for r in recs)
            stitched = words_differ(img.to(full.device), full)
            t = statistics.median(
                event_ms(lambda i: fn(mesh, rg, static, mats.color, s,
                                      **extra), 1) for _ in range(3))
            out[name, tracer] = t
            say(phase, f"{tracer} bands, {name}, {BAND_SIZE[0]}x"
                f"{BAND_SIZE[1]} shadowed: launches {ran}, band rows y0 "
                f"{y0s}, words differing from the plain versions {bad}; "
                f"stitched vs unsharded frame: differing words {stitched}; "
                f"{t:.3f} ms a frame (median of 3)")
            want = {"march3"} if tracer == "v3" else {
                "touched4", "march_planes4"}
            check(all(ran[k] >= len(devs) for k in want)
                  and ran["shade4"] == len(devs),
                  f"a {tracer} band launched none of its kernels")
            check(bad == 0, f"a {tracer} band launch disagrees with its "
                  f"plain version")
            check(len(devs) == 1 or max(y0s) > 0, "no band at y0 > 0 ran")
            check(stitched == 0, f"the stitched {tracer} frame differs from "
                  f"the unsharded one")

    world = make_demo_world(7, 4)
    w, h = BAND_SIZE
    cam = CamData.create((30.0, 45.0, 0.0), (64.0, 75.0, 64.0), 70.0, (w, h))
    ss = RenderSettings(sun_pos=sun_of(cam))
    ref, _ = RayTracer(mats).render(world, cam, ss)
    for name, devs in meshes:
        mesh = make_mesh(n_samples=1, n_rays=len(devs), devices=devs)
        got = ShardedRayTracer(mats, mesh).render(world, cam, ss)
        bad = words_differ(got.to(ref.device), ref)
        say(phase, f"ShardedRayTracer, {name}, {w}x{h}: words differing "
            f"from RayTracer's frame {bad}")
        check(bad == 0, "the sharded SVO frame differs from RayTracer's")
    devs4 = list(devices) * 4 if len(devices) < 4 else list(devices[:4])
    mesh = make_mesh(n_samples=2, n_rays=2, devices=devs4)
    step = sharded_accumulate_step(mesh, mats, width=w, band_height=h // 2,
                                   max_steps=64)
    acc = step(world.nodes, world.chunk_roots, world.world_min,
               cam.inv_view, cam.inv_proj, cam.pos, np.float32(0.05))
    tr = RayTracer(mats, max_steps=64)
    frames = []
    for sid in range(2):
        # the step's shifted origin, in f32 as it computes it
        eps = np.float32(sid) / np.float32(2) * np.float32(0.05)
        e = np.asarray(cam.pos, np.float32) + eps
        cs = CamData.create((30.0, 45.0, 0.0), tuple(e), 70.0, (w, h))
        frames.append(tr.render(world, cs, RenderSettings())[0])
    host = torch.stack(frames).mean(dim=0)
    gap = float((acc.to(host.device) - host).abs().max())
    say(phase, f"sharded_accumulate_step, 2 samples x 2 bands on "
        f"{sorted(set(devs4))}, {w}x{h}: max gap to the host average "
        f"{gap:.3g} (bar 1e-6), finite {bool(torch.isfinite(acc).all())}")
    check(gap <= 1e-6 and bool(torch.isfinite(acc).all()),
          "the accumulated frame misses the host average")
    return out


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def engine_frame_check(app, what):
    """The fast-path frame just drawn against the plain version on the
    builder's tables on the card: ``march_fused4_ref`` (dense or sparse)
    for the v4 route; differing words of the packed frame."""
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    b = app._fast_builder()
    s = app.settings
    args, kw = t4.frame_args(
        b.grid(), app.camera(), app.materials.color, sky_color=s.sky_color,
        sun_pos=s.sun_pos, sun_intensity=s.sun_intensity,
        shadow_ambient=s.shadow_ambient, show_steps=s.show_step_count,
        shadows=s.shadows, prepared=b.prepared())
    packed, _ = t4.march_fused4_ref(*args, **kw)
    return words_differ(app._last_trace.packed, packed)


def engine_session(smi, phase):
    """An engine session at the engine's defaults (1280x720, a window of
    30 chunks, the client's pool at its first size, doubling as it fills):
    ``EngineApp.host_singleplayer`` on the bundled respack's
    "Demo World" (terra, Continents, seed 20260816; a copy in a temporary
    directory, where the server saves), its server a child process on the
    card. The window streams in, the player falls to the ground, then
    frames on the fused v4 path (plain, shadowed, heatmap), the v3 path and
    the SVO path; a voxel broken and placed, redrawn; card vs a CPU session
    at 320x176; ``resize_world(40)`` keeping the streamed window, on sparse
    tables. Each fast-path
    frame equals its plain version on the builder's tables; warm ms of each
    route and the device's idle share of the v4 route."""
    import dataclasses as dc
    import shutil
    import tempfile

    from voxelraytracing_tpu_torch.client import PlayerInput
    from voxelraytracing_tpu_torch.engine import EngineApp
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4
    from voxelraytracing_tpu_torch.resources.packs import builtin_respack_path

    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    root = shutil.copytree(builtin_respack_path(), f"{tmp}/res")
    n = ENGINE_W ** 3
    t0 = time.perf_counter()
    app = EngineApp.host_singleplayer(root, "Demo World", port=free_port())
    try:
        t_up = time.perf_counter() - t0
        check(app.fast_path and app.device.type == "cuda"
              and app.resolution == (1280, 720)
              and app.game.world.size_in_chunks == ENGINE_W,
              "the engine on the card is not on its fast path at its "
              "defaults")
        pool0 = app.game.world.max_nodes
        t0 = time.perf_counter()
        while app.game.world.populated_count() < n:
            check(time.perf_counter() - t0 < ENGINE_STREAM_LIMIT_S,
                  f"the window did not stream in {ENGINE_STREAM_LIMIT_S} s "
                  f"({app.game.world.populated_count()} of {n} chunks)")
            app.update(net_budget_s=0.05)
            app.update_game()
        t_stream = time.perf_counter() - t0
        for _ in range(600):
            app.update_input(PlayerInput())
            if app.game.player.on_ground:
                break
        check(app.game.player.on_ground, "the player did not land")
        app.update_game()
        t0 = time.perf_counter()
        app.draw_frame()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        b = app._fast_builder()
        free, total = app.game.world.node_space_status()
        say(phase, f"engine session: server child up in {t_up:.1f} s; "
            f"{n} chunks (window of {ENGINE_W}; {total - free} of the "
            f"client pool's {total} nodes, grown from {pool0}) streamed in "
            f"{t_stream:.1f} s "
            f"= {n / t_stream:.1f} chunks/s (generation and SVO builds on the "
            f"card in the child, localhost TCP, the client's pool on the "
            f"host); player on the ground at "
            f"{tuple(round(float(c), 1) for c in app.game.player.pos)}; first "
            f"frame (builder filled: {n} chunks, tables "
            f"{'sparse' if b.sparse else 'dense'}) {t_first:.1f} s")
        counters = (t4.march_fused4, t4.march_planes4, t4.touched4,
                    t4.shade4)

        def v4_frame(what):
            for c in counters:
                c.launches = 0
            app.draw_frame()
            torch.cuda.synchronize()
            ran = [c.launches for c in counters]
            bad = engine_frame_check(app, what)
            hits = float(app._last_trace.hit.float().mean())
            say(phase, f"v4 {what} frame {app.resolution}: launches "
                f"fused/planes/touched/shade {ran}, words differing from "
                f"march_fused4_ref on the builder's tables {bad}, hit share "
                f"{hits:.4f}")
            check(ran == [1, 0, 0, 0], "the engine's v4 frame is not one "
                  "fused launch")
            check(bad == 0, f"the engine's v4 {what} frame differs from "
                  f"the plain version")
            return hits

        rot0 = app.game.player.rot.copy()
        check(v4_frame("plain") > 0.05, "the engine's frame shows no ground")
        times = {}
        times["v4"] = median_windows(lambda i: app.draw_frame(), 20)
        share, dev_ms, n_dev = busy_share(lambda i: app.draw_frame(),
                                          times["v4"])
        app.settings = dc.replace(app.settings, shadows=True)
        v4_frame("shadowed")
        times["v4 shadowed"] = median_windows(lambda i: app.draw_frame(), 20)
        app.settings = dc.replace(app.settings, shadows=False)
        app.toggle_step_heatmap()
        v4_frame("heatmap")
        app.toggle_step_heatmap()

        app.fast_tracer = "v3"
        recs = [Launches("wavefront3", "march3"),
                Launches("wavefront4", "shade4")]
        for r in recs:
            r.__enter__()
        try:
            app.draw_frame()
            torch.cuda.synchronize()
        finally:
            for r in recs:
                r.__exit__()
        say(phase, f"v3 frame {app.resolution}: march3 launches {recs[0].n}, "
            f"shade4 {recs[1].n}, words differing from the plain versions "
            f"launch by launch {recs[0].bad + recs[1].bad}")
        check(recs[0].n >= 1 and recs[1].n == 1 and not recs[0].bad
              and not recs[1].bad, "the engine's v3 frame disagrees with its "
              "plain route")
        times["v3"] = median_windows(lambda i: app.draw_frame(), 3)
        app.fast_tracer = "v4"

        app.fast_path = False
        img = app.draw_frame()
        torch.cuda.synchronize()
        svo_hits = float(app._last_trace.hit.float().mean())
        times["svo"] = median_windows(lambda i: app.draw_frame(), 1)
        say(phase, f"SVO frame {app.resolution} (RayTracer on the device "
            f"pool, {app._dev_nodes.numel()} node words): hit share "
            f"{svo_hits:.4f}, finite {bool(torch.isfinite(img).all())}")
        check(bool(torch.isfinite(img).all()) and svo_hits > 0.05,
              "the engine's SVO frame is wrong")
        app.fast_path = True

        app.game.player.rot = np.asarray([60.0, 30.0, 0.0], np.float32)
        hit = app.pick()
        check(hit is not None, "nothing in reach below the player")
        before = app.game.world.get_voxel(hit[0])
        check(app.break_voxel(), "break_voxel failed")
        v4_frame("after break")
        stone = app.game.voxels.by_name("stone")
        check(app.place_voxel(stone), "place_voxel failed")
        v4_frame("after place")
        say(phase, f"broke {tuple(int(c) for c in hit[0])} (was {before}), "
            f"placed stone at {tuple(int(c) for c in hit[0] + hit[1])}")

        app.set_resolution(*ENGINE_SMALL)
        app.draw_frame()
        card = app._last_trace
        cpu = EngineApp(app.game, styles=app._styles,
                        resolution=ENGINE_SMALL, world_size_chunks=ENGINE_W,
                        fast_path=True, device="cpu")
        t0 = time.perf_counter()
        cpu.draw_frame()
        t_cpu = time.perf_counter() - t0
        ref = cpu._last_trace
        hit_bad = int((card.hit.cpu() != ref.hit).sum())
        both = card.hit.cpu() & ref.hit
        vox_bad = int((card.voxel.cpu() != ref.voxel)[both].sum())
        frac = float((channel_diff(card.packed.cpu(), ref.packed) <= 2)
                     .float().mean())
        say(phase, f"{ENGINE_SMALL[0]}x{ENGINE_SMALL[1]}, card vs a CPU "
            f"session on the same game state: hit mismatches {hit_bad}, "
            f"voxel mismatches {vox_bad}, pixels within 2/255 {frac:.6f}, "
            f"packed words differing {words_differ(card.packed.cpu(), ref.packed)} "
            f"(the CPU session's first frame, its builder filled, "
            f"{t_cpu:.1f} s)")
        check(hit_bad == 0 and vox_bad == 0 and frac == 1.0,
              "the engine's card frame misses the bar against the CPU's")
        del cpu
        app.set_resolution(1280, 720)

        # the 40-chunk window keeps the streamed 30-chunk one and requests
        # nothing more: the sparse tables hold the 27,000 chunks
        app.game.player.rot = rot0
        dense_hits = v4_frame("dense, before the resize")
        real_req = app.game.request_missing_chunks
        app.game.request_missing_chunks = lambda: None
        app.resize_world(40)
        app.game.request_missing_chunks = real_req
        sp = t4.march_fused4.launches
        t0 = time.perf_counter()
        app.draw_frame()
        torch.cuda.synchronize()
        t_sparse = time.perf_counter() - t0
        bad = engine_frame_check(app, "sparse")
        sparse_hits = float(app._last_trace.hit.float().mean())
        sb = app._fast_builder()
        kept = app.game.world.populated_count()
        say(phase, f"resize_world(40): sparse tables {sb.sparse} "
            f"({sb.sparse_tables_mb():.1f} MB, {kept} chunks kept; first "
            f"frame, the builder filled, {t_sparse:.1f} s), fused launches "
            f"{t4.march_fused4.launches - sp}, words differing from "
            f"march_fused4_ref (sparse) {bad}, hit share {sparse_hits:.4f} "
            f"(the dense frame's at the same camera {dense_hits:.4f})")
        check(sb.sparse and kept == n and bad == 0
              and t4.march_fused4.launches - sp == 1 and sparse_hits > 0.05,
              "the engine's sparse frame is wrong")
        say(phase, "warm frame ms at 1280x720 (CUDA events, median of "
            "windows): " + ", ".join(f"{k} {t:.3f}" for k, t in times.items())
            + (f"; device idle share of the v4 route "
               f"{1.0 - share:.4f} ({n_dev} kernels and copies, "
               f"{dev_ms:.3f} ms on the device, torch.profiler)"
               if share is not None else "; device idle share not measured "
               "(torch.profiler saw no device time)") + f"; {smi}")
        return dict(times, stream_s=t_stream, chunks=n,
                    idle=None if share is None else 1.0 - share)
    finally:
        app.close()
        shutil.rmtree(tmp, ignore_errors=True)


def plain_route(module, names):
    """While active, the wrappers ``names`` of the port's ``ops.<module>``
    are their plain versions (``<name>_ref``)."""
    import contextlib
    import importlib

    mod = importlib.import_module(f"voxelraytracing_tpu_torch.ops.{module}")

    @contextlib.contextmanager
    def swap():
        real = {k: getattr(mod, k) for k in names}
        for k in names:
            setattr(mod, k, getattr(mod, k + "_ref"))
        try:
            yield
        finally:
            for k, f in real.items():
                setattr(mod, k, f)

    return swap()


def entry_points(phase):
    """``graft_entry.entry()`` on the card against its plain version (the
    same frame with the plain ``march_planes4``/``shade4``, every launch
    also held alone), and ``dryrun_multichip`` on every card."""
    from voxelraytracing_tpu_torch import graft_entry
    from voxelraytracing_tpu_torch.ops import wavefront4 as t4

    fn, args = graft_entry.entry()
    recs = [Launches("wavefront4", k)
            for k in ("touched4", "march_planes4", "shade4")]
    for r in recs:
        r.__enter__()
    try:
        out = fn(*args)
        torch.cuda.synchronize()
    finally:
        for r in recs:
            r.__exit__()
    with plain_route("wavefront4", ("march_planes4", "shade4")):
        ref = fn(*args)
    bad = words_differ(out, ref)
    say(phase, f"entry(): {tuple(out.shape)} {out.dtype} on {out.device}, "
        f"mean {float(out.mean()):.6f}; launches "
        f"{ {r.name: r.n for r in recs} }, each vs its plain version "
        f"{sum(r.bad for r in recs)} words differ; vs the plain frame "
        f"{bad} words differ")
    check(out.shape == (128, 128) and out.device.type == "cuda"
          and all(r.n == 1 for r in recs) and bad == 0
          and not sum(r.bad for r in recs), "entry() is wrong on the card")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    img, img3, img4 = graft_entry.dryrun_multichip(n)
    torch.cuda.synchronize()
    say(phase, f"dryrun_multichip({n}): accumulated {tuple(img.shape)}, v3 "
        f"bands {tuple(img3.shape)}, v4 bands {tuple(img4.shape)} on "
        f"{img.device}, all finite "
        f"{bool(torch.isfinite(img).all())}, {time.perf_counter() - t0:.1f} s")
    check(bool(torch.isfinite(img).all()), "dryrun_multichip's frame is not "
          "finite")


def profiling(phase):
    """``device_trace`` around a fused frame writes a Chrome trace naming
    the ``march_fused4`` launch; ``device_memory_stats`` reports the
    card."""
    import tempfile

    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        prepare_grid4, render_frame4)
    from voxelraytracing_tpu_torch.utils.profiling import (
        device_memory_stats, device_trace, trace_path)

    rg, mats, v = build_world(4)
    static, _ = bench_cams(v, WIDTH, HEIGHT, 0)
    prep = prepare_grid4(rg)
    render_frame4(rg, static, mats.color, prepared=prep, fused=True)
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            render_frame4(rg, static, mats.color, prepared=prep, fused=True)
        events = json.load(open(trace_path(d)))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    fused = [e["name"] for e in kernels if "march_fused4" in e["name"]]
    mem = device_memory_stats()
    say(phase, f"device_trace: {len(events)} events, {len(kernels)} "
        f"kernels, the march_fused4 launches named: {fused}")
    say(phase, f"device_memory_stats: {mem}")
    check(len(fused) == 1, "the trace does not name the march_fused4 launch")
    check(len(mem) == torch.cuda.device_count() and mem[0]["bytes_limit"] > 0
          and mem[0]["bytes_in_use"] > 0, "device_memory_stats does not "
          "report the card")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from voxelraytracing_tpu_torch import _build
    from voxelraytracing_tpu_torch.core import native
    from voxelraytracing_tpu_torch.ops.materials import make_material_table
    from voxelraytracing_tpu_torch.ops.wavefront3 import color_lut_rows
    from voxelraytracing_tpu_torch.ops.wavefront4 import prepare_grid4

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "unavailable"
    say(1, f"nvidia-smi: {card}")
    say(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS) + 1) as pool:
        lib = pool.submit(native.build)
        list(pool.map(_build.build, _build.KERNELS))
    say(2, f"built {', '.join(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel), "
        f"the native library {lib.result()} (g++, beside them)")
    check(native.available(), "the port's native library does not load")
    for name in _build.KERNELS:
        _build.load(name)
        for ln in ptxas_report(name):
            say(2, f"{name}.cu {ln}")

    t_group = time.perf_counter()
    t0 = time.perf_counter()
    rg, mats, v = build_world(8)
    prep = prepare_grid4(rg)
    torch.cuda.synchronize()
    say(3, f"8-chunk world ({v}^3 voxels): host build onto the card "
        f"{time.perf_counter() - t0:.1f} s, sw_cont "
        f"{prep.sw_cont.numel() * 4 / 1e6:.1f} MB")
    lut = color_lut_rows(mats.color).to(rg.sw_solid.device)
    static, orbit = bench_cams(v, WIDTH, HEIGHT)
    err = compare_on_card(rg, prep, lut, [static] + orbit[::CMP_STEP], 4)
    rg_cpu = build_world(8, device="cpu")[0]
    compare_on_cpu(rg_cpu, rg, mats, v, 5)
    errs = {}
    for size in SIZES:
        s, o = bench_cams(v, *size)
        errs[size] = compare_shadows(rg, prep, lut, [s] + o[::CMP_STEP], 7)
    compare_nan_direction(rg, prep, lut, static, 7)
    compare_mark_edges(rg, prep, lut, v, 7)
    compare_on_cpu(rg_cpu, rg, mats, v, 8, shadows=True)
    counts = count_main_path(rg, mats, v)
    t8 = time_primary(rg, prep, lut, mats, v, 10)
    ts = {size: time_shadows(rg, prep, lut, v, size, 10) for size in SIZES}

    t0 = time.perf_counter()
    rg16, _, v16 = build_world(16)
    prep16 = prepare_grid4(rg16)
    torch.cuda.synchronize()
    say(3, f"16-chunk world ({v16}^3 voxels): host build onto the card "
        f"{time.perf_counter() - t0:.1f} s, sw_cont "
        f"{prep16.sw_cont.numel() * 4 / 1e6:.1f} MB")
    s16, o16 = bench_cams(v16, WIDTH, HEIGHT, N_ORBIT_16)
    err = max(err, compare_on_card(
        rg16, prep16, lut, [s16] + o16[::N_ORBIT_16 // 4], 4))
    time_primary(rg16, prep16, lut, mats, v16, 11, N_ORBIT_16)
    del rg16, prep16
    torch.cuda.empty_cache()
    say(11, f"phases 3-11 took {time.perf_counter() - t_group:.1f} s")
    t_group = time.perf_counter()

    # the path tracers on the 8-chunk world, demo and mirror tables
    mirror = make_material_table(256, MIRROR)
    worlds = {"demo": (rg, mats),
              "mirror": (build_world(8, mats=mirror)[0], mirror)}
    cpu_worlds = {"demo": (rg_cpu, mats),
                  "mirror": (build_world(8, "cpu", mirror)[0], mirror)}
    static, orbit = bench_cams(v, WIDTH, HEIGHT, N_ORBIT_PT)
    pt_err, mat_err = compare_pt(worlds, [static, orbit[N_ORBIT_PT // 3]],
                                 12)
    compare_pt_cpu(cpu_worlds, worlds, v, 13)
    pt_counts = count_pt_main_path(rg, mats, orbit[:10], 14)
    tp = time_pt(rg, mats, static, orbit, 15)
    say(15, f"phases 12-15 took {time.perf_counter() - t_group:.1f} s")
    t_group = time.perf_counter()

    # the v3 march on the 8-chunk world
    v3_err = compare_march3(rg, lut, v, 19)
    compare_v3_cpu(rg_cpu, rg, mats, v, 20)
    compare_v3_converged(rg, prep, lut, v, 21)
    v3_counts = count_v3_routes(rg, mats, lut, v, 22)
    tv3 = time_v3(rg, mats, lut, v, 23)
    say(23, f"phases 19-23 took {time.perf_counter() - t_group:.1f} s")

    # the v2 march on the 8-chunk world's v1 tables
    t_v2 = time.perf_counter()
    rg1, rg1_cpu = v2_tables(rg, 24)
    v2_err = compare_march2(rg1, v, 25)
    compare_v2_cpu(rg1_cpu, rg1, mats, v, 26)
    compare_v2_converged(rg1, rg, prep, v, 27)
    v2_counts = count_v2_main_path(rg1, mats, v, 28)
    tv2 = time_v2(rg1, mats, v, 28)
    say(28, f"phases 24-28 took {time.perf_counter() - t_v2:.1f} s")
    # phase 24's v1 tables stay for phase 45, which runs last
    del worlds, cpu_worlds, rg, prep, rg_cpu
    torch.cuda.empty_cache()

    # the streamed strip: sparse vs dense at W=40, the W=80 fly-through
    t0 = time.perf_counter()
    strip = strip_grids()
    say(16, f"strip terrain: {len(strip)} chunks in "
        f"{time.perf_counter() - t0:.1f} s")
    w40 = phase_w40(strip, lut, 16)
    b80, w80 = phase_w80(strip, mats, lut, 17)
    compare_nan_direction(b80.grid(), b80.prepared(), lut,
                          strip_cam(STATIC_FX, 80), 17)
    tsp = time_sparse(strip, b80, lut, 18)
    del b80
    torch.cuda.empty_cache()
    say(18, f"phases 16-18 took {time.perf_counter() - t0:.1f} s")

    # the primitive probes at the JAX scripts' shapes
    t0 = time.perf_counter()
    probe_entries = phase_probes(29)
    say(29, f"phase 29 took {time.perf_counter() - t0:.1f} s")

    # config2/config3's preset world: device worldgen, the SVO build and
    # the three frames on it; the native library
    t_preset = time.perf_counter()
    gen, dp, sp, pos, mn, eye, batch, grids, generated = phase_worldgen(30)
    phase_svo_build(gen, dp, batch, grids, 31)
    rg_p, mats_p = phase_preset_frames(generated, dp, sp, pos, mn, eye, card,
                                       32)
    phase_native(w80["rows_calls"], 33)
    say(33, f"phases 30-33 took {time.perf_counter() - t_preset:.1f} s")
    torch.cuda.empty_cache()

    # the SVO render path: worlds, the tracer against the v4 kernels, card
    # vs CPU, frame times, the v1 device builder, a served world
    t_svo = time.perf_counter()
    demo, demo_cpu, fixed, mats_svo = svo_worlds(generated, pos, mn, eye, dp,
                                                 sp, 34)
    rg8, mats8, v8 = build_world(8)
    s8, o8 = bench_cams(v8, WIDTH, HEIGHT, N_ORBIT_SVO)
    p_cams = preset_cams(mn, eye, (WIDTH, HEIGHT), N_ORBIT_SVO)
    svo_vs_v4({"demo": (demo, rg8, mats8, [s8] + o8),
               "preset": (fixed, rg_p, mats_svo, p_cams)}, 35)
    del rg8, rg_p
    svo_card_vs_cpu(demo, demo_cpu, mats8, 36)
    svo_times(demo, mats8, fixed, p_cams[0], mats_svo, card, 37)
    del demo, demo_cpu, fixed
    torch.cuda.empty_cache()
    v1_device_builder(38)
    served_world(dp, sp, 39)
    say(39, f"phases 34-39 took {time.perf_counter() - t_svo:.1f} s")
    torch.cuda.empty_cache()

    # the band-sharded frames, an engine session, the entry points and
    # the profiling tools
    t_new = time.perf_counter()
    band_frames(40)
    if torch.cuda.device_count() > 1:
        band_frames(40, tuple(f"cuda:{i}"
                              for i in range(torch.cuda.device_count())))
    torch.cuda.empty_cache()
    engine_session(card, 41)
    torch.cuda.empty_cache()
    entry_points(42)
    profiling(43)
    say(43, f"phases 40-43 took {time.perf_counter() - t_new:.1f} s")

    # the v1 tracer on phase 24's tables, last: its profiler session of
    # ~131,000 kernel records comes after every other phase's profiler use
    t_v1 = time.perf_counter()
    v1_tracer(rg1, rg1_cpu, mats, v, card, 45)
    say(45, f"phase 45 took {time.perf_counter() - t_v1:.1f} s")
    del rg1, rg1_cpu

    px = WIDTH * HEIGHT
    b_primary = bound(t8["rows"] * ROW_BYTES + 8 * px,
                      t8["steps"] * STEP_OPS + px * PIXEL_OPS)
    say(10, f"{WIDTH}x{HEIGHT} march_fused4 (primary): "
        f"{t8['kernel_static_dev']:.4f} ms on the device, least "
        f"{b_primary[0]:.5f} ms, bound by {b_primary[1]}")
    floor = launch_floor()
    for size in SIZES:
        b = shadow_bounds(ts[size])
        tsz = ts[size]
        for k, (bms, by) in b.items():
            if k.startswith("touched"):
                continue
            say(10, f"{size[0]}x{size[1]} {k}: {tsz[k + '_dev']:.4f} ms "
                f"on the device, least "
                f"{bms:.5f} ms, bound by {by}")
        (bc, byc), (be, bye), (bb, byb) = (
            b["touched_camera"], b["touched_camera_evaluated"],
            b["touched_rays"])
        say(10, f"{size[0]}x{size[1]} touched4 camera mode: "
            f"{tsz['touched_camera_dev']:.5f} ms on the device, least "
            f"{bc:.6f} ms (every ray, bound by {byc}), launch floor "
            f"{floor:.5f} ms; rays its order evaluates "
            f"{tsz['mark_rays_camera']} of {tsz['pixels']}, least on those "
            f"{be:.6f} ms (bound by {bye}; the kernels line's bound)")
        say(10, f"{size[0]}x{size[1]} touched4 bundle mode: "
            f"{tsz['touched_rays_dev']:.5f} ms on the device, least "
            f"{bb:.6f} ms (bound by {byb}), launch floor {floor:.5f} ms")
    sh = ts[(WIDTH, HEIGHT)]
    b = shadow_bounds(sh)
    b_fused, b_cam, b_rays, b_shade = (
        b["fused_kernel_static"], b["planes_camera"], b["planes_rays"],
        b["shade"])
    # the camera marks' least time on the rays this run's data needs them
    # to evaluate (phase 10 prints the every-ray formula beside it)
    b_tcam, b_trays = b["touched_camera_evaluated"], b["touched_rays"]
    bp = pt_bounds(tp)
    for k in ("matfetch4", "pt4", "planes_bounce"):
        say(15, f"{WIDTH}x{HEIGHT} {k}: {tp[k + '_dev']:.4f} ms on the "
            f"device, least {bp[k][0]:.5f} ms, bound by {bp[k][1]}")
    src = "voxelraytracing_tpu_torch/csrc/"
    kernels = [
        dict(name="march_fused4", source=src + "march4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront4.py:185",
             launches=counts["fused", False][0], max_abs_err=err,
             ms=t8["kernel_static_dev"], plain_ms=t8["plain_static"],
             bound=b_primary),
        dict(name="march_fused4_shadow", source=src + "march4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront4.py:1280",
             launches=counts["fused", True][0],
             max_abs_err=max(e["fused"] for e in errs.values()),
             ms=sh["fused_kernel_static_dev"], plain_ms=sh["plain_fused"],
             bound=b_fused),
        dict(name="march_planes4", source=src + "planes4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront4.py:1399",
             launches=counts["packed", True][1],
             max_abs_err=max(e["planes"] for e in errs.values()),
             ms=sh["planes_camera_dev"] + sh["planes_rays_dev"],
             plain_ms=sh["plain_planes_camera"] + sh["plain_planes_rays"],
             bound=(b_cam[0] + b_rays[0],
                    max(b_cam, b_rays)[1])),
        dict(name="touched4", source=src + "planes4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront4.py:892",
             launches=counts["packed", True][2],
             max_abs_err=max(e["marks"] for e in errs.values()),
             ms=sh["touched_camera_dev"] + sh["touched_rays_dev"],
             plain_ms=sh["plain_touched_camera"] + sh["plain_touched_rays"],
             bound=(b_tcam[0] + b_trays[0], max(b_tcam, b_trays)[1])),
        dict(name="shade4", source=src + "shade4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront3.py:1909",
             launches=counts["packed", True][3],
             max_abs_err=max(e["shade"] for e in errs.values()),
             ms=sh["shade_dev"], plain_ms=sh["plain_shade"], bound=b_shade),
        dict(name="matfetch4", source=src + "matfetch4.cu",
             replaces="voxelraytracing_tpu/ops/wavefront3.py:2306",
             launches=pt_counts["path_trace3"][0], max_abs_err=mat_err,
             ms=tp["matfetch4_dev"], plain_ms=tp["plain_matfetch4"],
             bound=bp["matfetch4"]),
        dict(name="pt4", source=src + "pathtrace4.cu",
             replaces="voxelraytracing_tpu/ops/pathtrace4.py:101",
             launches=pt_counts["fused"][3], max_abs_err=pt_err,
             ms=tp["pt4_dev"], plain_ms=tp["plain_pt4"], bound=bp["pt4"]),
    ]
    rep = "voxelraytracing_tpu/ops/wavefront4.py:747"
    kernels += [
        dict(name="march_fused4_sparse", source=src + "march4.cu",
             replaces=rep, launches=w80["launches"], max_abs_err=w80["err"],
             ms=tsp["fused_dev"], plain_ms=tsp["plain_fused"],
             bound=tsp["bounds"]["fused"]),
        dict(name="march_fused4_shadow_sparse", source=src + "march4.cu",
             replaces=rep, launches=w40["counts"][True][0],
             max_abs_err=w40["err_fused"], ms=tsp["fused_shadow_dev"],
             plain_ms=tsp["plain_fused_shadow"],
             bound=tsp["bounds"]["fused_shadow"]),
        dict(name="march_planes4_sparse", source=src + "planes4.cu",
             replaces=rep, launches=w40["counts"][False][1],
             max_abs_err=max(w40["err_planes"], w80["err_planes"]),
             ms=tsp["planes_camera_dev"] + tsp["planes_rays_dev"],
             plain_ms=tsp["plain_planes"], bound=tsp["bounds"]["planes"]),
    ]
    kernels.append(dict(
        name="march3", source=src + "march3.cu",
        replaces="voxelraytracing_tpu/ops/wavefront3.py:483",
        launches=v3_counts["packed", False][0], max_abs_err=v3_err,
        ms=tv3["march3_dev"], plain_ms=tv3["plain_march3"],
        bound=tv3["bound"]))
    kernels.append(dict(
        name="march2", source=src + "march2.cu",
        replaces="voxelraytracing_tpu/ops/wavefront2.py:88",
        launches=v2_counts[0], max_abs_err=v2_err, ms=tv2["march2_dev"],
        plain_ms=tv2["plain_march2"], bound=tv2["bound"]))
    kernels += probe_entries
    line = []
    for k in kernels:
        (bms, by) = k.pop("bound")
        line.append(dict(name=k["name"], route="cuda", source=k["source"],
                         replaces=k["replaces"], launches=k["launches"],
                         max_abs_err=k["max_abs_err"], ms=k["ms"],
                         plain_ms=k["plain_ms"], bound_ms=bms, bound_by=by,
                         library_ms=k.get("library_ms")))
    print(json.dumps({"kernels": line}))
    say(44, f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    say(44, "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(PHASE_S.items())))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
