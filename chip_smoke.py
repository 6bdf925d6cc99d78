"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path — the fused v4 primary frame — on the demo
worlds of bench.py at 1920x1080, through the entry points a user calls
(``render_frame4`` and ``WavefrontRenderer.render_packed``), after building
the hand-written CUDA kernel from ``voxelraytracing_tpu_torch/csrc``:

  1. the card's name and power limit (exits non-zero without a CUDA card);
  2. build ``march4.cu``, print its registers and spills;
  3. the 8-chunk world (256³ voxels), built on the host and moved to the card;
  4. the bench camera + 48 orbit cameras: kernel vs plain PyTorch version on
     the card, flags and packed words exactly equal;
  5. 320x180 on the CPU: kernel vs the plain version there (the one the CPU
     tests hold to the JAX package), with the cross-platform bar of
     TPU_CORRECTNESS.json: 0 hit and voxel mismatches, every pixel within 2/255;
  6. 10 frames through ``WavefrontRenderer.render_packed``: the launch count
     rises by exactly 10;
  7. timing with CUDA events: median of 5 windows, static and orbit, frame and
     kernel alone, beside the plain version;
  8. phases 4 and 7 on the 16-chunk world (512³ voxels, 117 MB of tables).

Prints one line per phase, the kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

    python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
# render_frame4 keywords of bench.py's frame (bench.py:171-175)
BENCH_KW = dict(rounds=64, step_cap=500, steps_per_round=256, fused=True,
                s_seg=4)
N_ORBIT = 48
WINDOWS = 5


class PhaseError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bench_cams(v, w, h):
    """bench.py's static camera and its 48-step orbit (bench.py:114-145)."""
    from voxelraytracing_tpu_torch.ops.camera import CamData

    static = CamData.create((35.0, 45.0, 0.0), (v * 0.5, v * 0.75, v * 0.5),
                            70.0, (w, h))
    orbit = []
    for i in range(N_ORBIT):
        a = 360.0 * i / N_ORBIT
        r = v * 0.35
        eye = (v * 0.5 + r * np.cos(np.deg2rad(a)), v * 0.72,
               v * 0.5 + r * np.sin(np.deg2rad(a)))
        orbit.append(CamData.create((30.0, (a + 180.0) % 360.0, 0.0), eye,
                                    70.0, (w, h)))
    return static, orbit


def build_world(w_chunks):
    """bench.py's demo world, built on the host: (RenderGrid3 on the CPU,
    materials, edge in voxels)."""
    from voxelraytracing_tpu_torch.ops import noise
    from voxelraytracing_tpu_torch.ops.wavefront3 import build_render_grid3_host
    from voxelraytracing_tpu_torch.world.demo import (
        demo_chunk_grids_host, demo_materials)

    perm = noise.make_permutation(7)
    grids, cells = demo_chunk_grids_host(
        perm, np.zeros(3, np.int64), w_chunks,
        w_chunks * 32 * 0.45, int(w_chunks * 32 * 0.28))
    mats = demo_materials()
    rg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32),
                                 w_chunks, mats)
    return rg, mats, w_chunks * 32


def to_device(rg, dev):
    return rg._replace(**{f: getattr(rg, f).to(dev) for f in (
        "gw_jump", "gw_liq", "wmeta", "sw_meta", "sw_solid", "sw_liq",
        "sw_pid", "world_min", "to_pack")})


def channel_diff(a, b):
    """Max per-channel difference of two packed RGBA8 images, per pixel."""
    d = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for sh in (0, 8, 16):
        d = torch.maximum(d, (((a >> sh) & 255) - ((b >> sh) & 255)).abs())
    return d


def compare_on_card(rg, prep, lut, cams, phase):
    """Kernel (through render_frame4) vs plain version on the card."""
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


def compare_on_cpu(rg_cpu, rg, mats, v, phase):
    """Kernel on the card vs the plain version on the CPU at 320x180."""
    from voxelraytracing_tpu_torch.ops.wavefront4 import render_frame4

    static, orbit = bench_cams(v, 320, 180)
    cams = [static] + orbit[::4]
    hit_bad = vox_bad = fl_bad = pk_bad = 0
    within = total = 0
    for cam in cams:
        kw = dict(prepared=None, with_flags=True, **BENCH_KW)
        img, fl = render_frame4(rg, cam, mats.color, **kw)
        rimg, rfl = render_frame4(rg_cpu, cam, mats.color, **kw)
        img, fl = img.cpu(), fl.cpu()
        hit, rhit = (fl >> 1) & 1, (rfl >> 1) & 1
        hit_bad += int((hit != rhit).sum())
        both = (hit & rhit) != 0
        vox_bad += int((((fl >> 17) & 255) != ((rfl >> 17) & 255))[both].sum())
        fl_bad += int((fl != rfl).sum())
        pk_bad += int((img != rimg).sum())
        within += int((channel_diff(img, rimg) <= 2).sum())
        total += img.numel()
    frac = within / total
    say(phase, f"{len(cams)} cameras at 320x180, card vs CPU: hit mismatches "
        f"{hit_bad}, voxel mismatches {vox_bad}, pixels within 2/255 "
        f"{frac:.6f} (flag words differing {fl_bad}, packed {pk_bad})")
    check(hit_bad == 0 and vox_bad == 0 and frac == 1.0,
          "kernel misses the cross-platform bar against the CPU")


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


def time_world(rg, prep, lut, v, phase):
    """ms/frame of the frame, the kernel alone and the plain version."""
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        frame_args, march_fused4, march_fused4_ref, render_frame4)

    static, orbit = bench_cams(v, WIDTH, HEIGHT)
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
    out["frame_orbit"] = median_windows(lambda i: frame(orbit[i % N_ORBIT]),
                                        N_ORBIT)
    sa, skw = args_of(static)
    out["kernel_static"] = median_windows(
        lambda i: march_fused4(*sa, **skw), N_ORBIT)
    oargs = [args_of(c) for c in orbit]
    out["kernel_orbit"] = median_windows(
        lambda i: march_fused4(*oargs[i % N_ORBIT][0], **oargs[i % N_ORBIT][1]),
        N_ORBIT)
    plain = [event_ms(lambda i: march_fused4_ref(*sa, **skw), 1)
             for _ in range(3)]
    out["plain_static"] = statistics.median(plain)
    plain = [event_ms(lambda i, c=c: march_fused4_ref(*oargs[c][0],
                                                      **oargs[c][1]), 1)
             for c in (0, 16, 32)]
    out["plain_orbit"] = statistics.median(plain)
    rays = WIDTH * HEIGHT
    for k in ("static", "orbit"):
        say(phase, f"{k}: frame {out['frame_' + k]:.4f} ms "
            f"({rays / out['frame_' + k] / 1e3:.3f} Mrays/s), kernel "
            f"{out['kernel_' + k]:.4f} ms "
            f"({rays / out['kernel_' + k] / 1e3:.3f} Mrays/s), plain "
            f"{out['plain_' + k]:.2f} ms "
            f"({rays / out['plain_' + k] / 1e3:.3f} Mrays/s)")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from voxelraytracing_tpu_torch import _build
    from voxelraytracing_tpu_torch.models.raytracer import (
        STEP_CAP, STEPS_PER_ROUND, RenderSettings, WavefrontRenderer)
    from voxelraytracing_tpu_torch.ops.wavefront3 import color_lut_rows
    from voxelraytracing_tpu_torch.ops.wavefront4 import (
        frame_args, march_fused4, march_fused4_ref, prepare_grid4)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    say(1, f"nvidia-smi: {smi.splitlines()[0] if smi else 'unavailable'}")
    say(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.load("march4")
    ptxas = [ln.strip() for ln in _build.build_log("march4").splitlines()
             if "registers" in ln or "spill" in ln]
    say(2, f"built march4.cu in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(ptxas))

    results = {}
    for w_chunks in (8, 16):
        t0 = time.perf_counter()
        rg_cpu, mats, v = build_world(w_chunks)
        rg = to_device(rg_cpu, dev)
        prep = prepare_grid4(rg)
        torch.cuda.synchronize()
        mb = prep.sw_cont.numel() * 4 / 1e6
        say(3, f"{w_chunks}-chunk world ({v}^3 voxels): host build + upload "
            f"{time.perf_counter() - t0:.1f} s, sw_cont {mb:.1f} MB")
        lut = color_lut_rows(mats.color).to(dev)
        static, orbit = bench_cams(v, WIDTH, HEIGHT)
        err = compare_on_card(rg, prep, lut, [static] + orbit, 4)
        if w_chunks == 8:
            compare_on_cpu(rg_cpu, rg, mats, v, 5)

            renderer = WavefrontRenderer(mats)
            settings = RenderSettings(sun_pos=(0.0, 10_000.0, 0.0))
            march_fused4.launches = 0
            for cam in orbit[:10]:
                img = renderer.render_packed(rg, cam, settings)
            torch.cuda.synchronize()
            launches = march_fused4.launches
            args, kw = frame_args(
                rg, orbit[9], mats.color, sun_pos=settings.sun_pos,
                steps_per_round=STEPS_PER_ROUND, step_cap=STEP_CAP,
                prepared=prepare_grid4(rg))
            rimg, _ = march_fused4_ref(*args, **kw)
            alpha_ok = bool(((img >> 24) & 255 == 255).all())
            say(6, f"render_packed x10: march_fused4 launches {launches}, "
                f"frame {tuple(img.shape)} {img.dtype}, alpha ok {alpha_ok}, "
                f"last frame == plain version: {bool((img == rimg).all())}")
            check(launches == 10, "render_packed did not launch the kernel "
                  "once per frame")
            check(alpha_ok and bool((img == rimg).all()),
                  "render_packed frame disagrees with the plain version")
        results[w_chunks] = (time_world(rg, prep, lut, v, 7 if w_chunks == 8
                                        else 8), err)
        del rg, prep
        torch.cuda.empty_cache()

    t8, err8 = results[8]
    err = max(err8, results[16][1])
    print(json.dumps({"kernels": [{
        "name": "march_fused4", "route": "cuda",
        "source": "voxelraytracing_tpu_torch/csrc/march4.cu",
        "replaces": "voxelraytracing_tpu/ops/wavefront4.py:185",
        "launches": launches, "max_abs_err": err,
        "ms": t8["kernel_static"], "plain_ms": t8["plain_static"],
    }]}))
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
