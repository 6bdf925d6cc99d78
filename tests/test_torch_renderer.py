"""The port's ``WavefrontRenderer.render_packed`` routes frames as the JAX
renderer does.

JAX's default tracer (``"v2"``) draws a RenderGrid3 through
``render_frame3`` at ``v3_rounds=16``; ``tracer="v4"`` through the split
``render_frame4`` at 64 rounds. Two cases tell those routes from the
fused v4 frame: a camera outside the world (the split frames shade the
untouched zero planes, so they differ from the fused frame on every
pixel) and the step heatmap (its scale is ``rounds * 48``: 768 on the v3
route, 3072 on the v4 one). A third tells the v3 route from the split v4
frame: at ``v3_rounds=1`` most rays run out of service rounds and are sky.
The port's renderer must equal JAX's on both routes: packed words exact,
except that a sky channel may differ by 1/255 (the two libms may round
``** 0.35`` apart). The v3 route's warm token steers its service, so a
second frame of the same renderer is held against JAX's second frame.
``render`` on a RenderGrid3 returns that packed frame and its f32 unpack.
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.models.raytracer import (
    RenderSettings as JRenderSettings,
    WavefrontRenderer as JWavefrontRenderer,
)
from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront3 import build_render_grid3_host
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu.world.demo import demo_chunk_grids_host, demo_materials
from voxelraytracing_tpu_torch.convert import render_grid3_from_numpy
from voxelraytracing_tpu_torch.models.raytracer import (
    RenderSettings,
    WavefrontRenderer,
)
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import RenderGrid3
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

SIZE = (64, 32)
SUN = (1000.0, 2500.0, 500.0)
CASES = {
    # camera outside the world, looking further away from it
    "outside": (((-20.0, 45.0, 0.0), (-60.0, 200.0, -60.0)), False),
    # step heatmap, camera inside the world
    "steps": (((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)), True),
}
TRACERS = ("v2", "v4")


@pytest.fixture(scope="module")
def world():
    """The 4-chunk demo world in both packages, and the JAX renderers'
    frames of each case and tracer (plus the fused JAX frame)."""
    w = 4
    grids, cells = demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), w,
        w * 32 * 0.45, int(w * 32 * 0.28))
    mats = demo_materials()
    jrg = build_render_grid3_host(grids, cells, np.zeros(3, np.int32), w, mats)
    trg = render_grid3_from_numpy(
        *[np.asarray(getattr(jrg, f)) for f in RenderGrid3._fields],
        device="cpu")
    gold = {}
    for name, (cfg, steps) in CASES.items():
        cam = JCamData.create(cfg[0], cfg[1], 70.0, SIZE)
        for tracer in TRACERS:
            r = JWavefrontRenderer(mats, show_step_count=steps, tracer=tracer)
            gold[name, tracer] = np.asarray(
                r.render_packed(jrg, cam, JRenderSettings(sun_pos=SUN)))
            if tracer == "v2" and name == "steps":
                # the warm second frame (the outside camera marches nothing,
                # so its token cannot change a pixel)
                gold[name, tracer, "warm"] = np.asarray(
                    r.render_packed(jrg, cam, JRenderSettings(sun_pos=SUN)))
        gold[name, "fused"] = np.asarray(j_render_frame4(
            jrg, cam, mats.color, sun_pos=SUN, show_steps=steps,
            steps_per_round=48, step_cap=500, fused=True))
    cfg = CASES["steps"][0]
    # render() on a RenderGrid3: render_packed's cold frame, unpacked
    gold["render"] = [np.asarray(x) for x in JWavefrontRenderer(
        mats, show_step_count=True).render(
            jrg, JCamData.create(cfg[0], cfg[1], 70.0, SIZE),
            JRenderSettings(sun_pos=SUN))]
    r = JWavefrontRenderer(mats, v3_rounds=1)
    gold["one_round"] = np.asarray(r.render_packed(
        jrg, JCamData.create(cfg[0], cfg[1], 70.0, SIZE),
        JRenderSettings(sun_pos=SUN)))
    return trg, mats, gold


def test_jax_routes_differ_from_the_fused_frame(world):
    """What the cases pin in the reference: outside the world both JAX
    routes agree and differ from the fused frame on every pixel; the
    heatmap tells the v3 route from the v4 one."""
    _, _, gold = world
    np.testing.assert_array_equal(gold["outside", "v2"], gold["outside", "v4"])
    assert (gold["outside", "v4"] != gold["outside", "fused"]).all()
    assert (gold["steps", "v2"] != gold["steps", "v4"]).mean() > 0.1
    np.testing.assert_array_equal(gold["steps", "v4"], gold["steps", "fused"])


@pytest.mark.parametrize("tracer", TRACERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_packed_routes_match_jax(world, case, tracer):
    trg, mats, gold = world
    cfg, steps = CASES[case]
    cam = CamData.create(cfg[0], cfg[1], 70.0, SIZE)
    # the default renderer takes the v3 route
    kw = {} if tracer == "v2" else dict(tracer=tracer)
    r = WavefrontRenderer(mats, show_step_count=steps, **kw)
    img = r.render_packed(trg, cam, RenderSettings(sun_pos=SUN))
    assert img.dtype == torch.int32 and tuple(img.shape) == SIZE[::-1]
    img = img.numpy().view(np.uint32)
    ref = gold[case, tracer]
    # the split frame's flags say which pixels are sky
    _, fl = t4.render_frame4(
        trg, cam, mats.color, sun_pos=SUN, with_flags=True, show_steps=steps,
        rounds=64 if tracer == "v4" else 16, steps_per_round=48,
        step_cap=500)
    sky = ((fl.numpy() >> 1) & 1) == 0
    differ = img != ref
    assert not (differ & ~sky).any(), "a hit pixel's color differs"
    for sh in (0, 8, 16):
        ch = np.abs(((img >> sh) & 255).astype(int)
                    - ((ref >> sh) & 255).astype(int))
        assert ch.max() <= 1, "a sky channel differs by more than 1/255"
    # the token is keyed as JAX keys it; a second frame reuses it, which on
    # the v3 route steers the service as JAX's does
    key = (("v4",) if tracer == "v4" else ()) + SIZE
    assert r._cache_size == key
    again = r.render_packed(trg, cam, RenderSettings(sun_pos=SUN))
    np.testing.assert_array_equal(again.numpy().view(np.uint32),
                                  gold.get((case, tracer, "warm"), img))


def test_render_on_a_render_grid3_matches_jax(world):
    """``render`` on a RenderGrid3 draws ``render_packed``'s frame and
    unpacks it to f32 (each channel / 255), as JAX's does."""
    trg, mats, gold = world
    cfg = CASES["steps"][0]
    img, packed = WavefrontRenderer(mats, show_step_count=True).render(
        trg, CamData.create(cfg[0], cfg[1], 70.0, SIZE),
        RenderSettings(sun_pos=SUN))
    jimg, jpacked = gold["render"]
    np.testing.assert_array_equal(jpacked, gold["steps", "v2"])
    packed = packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(packed, jpacked)
    assert img.dtype == torch.float32 and tuple(img.shape) == SIZE[::-1] + (3,)
    np.testing.assert_array_equal(img.numpy(), jimg)


def test_default_route_at_one_round_matches_jax(world):
    """At ``v3_rounds=1`` the v3 route is not the converged v4 frame: it
    equals JAX's ``render_frame3``, and the split v4 frame at the same
    rounds (the stand-in before the v3 march was ported) differs."""
    trg, mats, gold = world
    cfg = CASES["steps"][0]
    cam = CamData.create(cfg[0], cfg[1], 70.0, SIZE)
    img = WavefrontRenderer(mats, v3_rounds=1).render_packed(
        trg, cam, RenderSettings(sun_pos=SUN))
    np.testing.assert_array_equal(img.numpy().view(np.uint32),
                                  gold["one_round"])
    split = t4.render_frame4(trg, cam, mats.color, sun_pos=SUN, rounds=1,
                             steps_per_round=48, step_cap=500)
    assert (split.numpy().view(np.uint32) != gold["one_round"]).mean() > 0.1


def test_renderer_signature_and_tracer_check():
    mats = demo_materials()
    r = WavefrontRenderer(mats)
    j = JWavefrontRenderer(mats)
    for attr in ("show_step_count", "max_rounds", "inner_steps", "tracer",
                 "v3_rounds", "v3_steps_per_round", "v3_step_cap"):
        assert getattr(r, attr) == getattr(j, attr), attr
    with pytest.raises(ValueError, match="unknown tracer"):
        WavefrontRenderer(mats, tracer="v3")
