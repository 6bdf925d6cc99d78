"""The port's ``render_frame3`` and the v3 round loop's tail compaction
against the JAX package on the CPU.

``render_frame3``: without shadows, with hard shadows (the per-ray shadow
bundle at ``max(rounds // 2, 4)`` rounds) and with the step heatmap, at a
starved budget on the four cameras; a warm frame from the (primary,
shadow) token pair; at a converged budget the frame equals the split v4
frame, as JAX pins it (tests/test_wavefront4.py:134-149). Compaction: a
256x128 frame whose round loop moves its surviving tiles into smaller
grids (``compact=True`` and ``(2, 8)``), tokens included. JAX runs its
Pallas kernels in interpret mode; each golden is computed once, in a
module fixture. Scene, cameras and tolerances: tests/torch_v3_scene.py;
packed RGBA8 words and flags agree exactly.
"""

import numpy as np
import pytest

from torch_v3_scene import (
    CAMS,
    SIZE,
    SUN,
    assert_result,
    assert_token,
    scene,
)
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)
from voxelraytracing_tpu.ops import wavefront3 as j3
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.camera import generate_rays as j_generate_rays
from voxelraytracing_tpu_torch.ops import wavefront3 as t3
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData

ROUNDS = 4
MODES = {
    "plain": dict(),
    "shadows": dict(shadows=True, return_cache=True),
    "steps": dict(show_steps=True),
}
BIG = (256, 128)
COMPACT = {"quarter": True, "two_levels": (2, 8)}


@pytest.fixture(scope="module")
def world():
    jrg, trg, mats = scene()
    gold = {}
    kw = dict(sun_pos=SUN, rounds=ROUNDS, step_cap=500, with_flags=True)
    for i, (rot, eye) in enumerate(CAMS):
        cam = JCamData.create(rot, eye, 70.0, SIZE)
        for mode, extra in MODES.items():
            gold[mode, i] = j3.render_frame3(jrg, cam, mats.color, **kw,
                                             **extra)
    # a warm shadowed frame of camera 0 from camera 3's token pair
    cam = JCamData.create(*CAMS[0], 70.0, SIZE)
    gold["warm"] = j3.render_frame3(jrg, cam, mats.color, **kw,
                                    shadows=True, return_cache=True,
                                    cache=gold["shadows", 3][2])
    cam = JCamData.create(*CAMS[0], 70.0, BIG)
    origin, _ = j_generate_rays(cam, np.zeros(3, np.int32))
    for name, compact in COMPACT.items():
        gold[name] = j3.trace_wavefront3(jrg, origin, cam=cam, rounds=8,
                                         step_cap=500, compact=compact,
                                         return_cache=True)
    return trg, mats, gold


def _render(trg, mats, i, **kw):
    cam = CamData.create(*CAMS[i], 70.0, SIZE)
    return t3.render_frame3(trg, cam, mats.color, sun_pos=SUN, rounds=ROUNDS,
                            step_cap=500, with_flags=True, **kw)


def _assert_frame(got, want):
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_render_frame3_matches_jax(world, cam, mode):
    trg, mats, gold = world
    got = _render(trg, mats, cam, **MODES[mode])
    _assert_frame(got, gold[mode, cam])
    if mode == "shadows":
        for tok, want in zip(got[2], gold[mode, cam][2]):
            assert_token(tok, want)


def test_warm_token_pair_matches_jax(world):
    """The shadowed frame's (primary, shadow) token pair warm-starts both
    traces of the next frame."""
    trg, mats, gold = world
    pair = _render(trg, mats, 3, shadows=True, return_cache=True)[2]
    got = _render(trg, mats, 0, shadows=True, return_cache=True, cache=pair)
    _assert_frame(got, gold["warm"])
    for tok, want in zip(got[2], gold["warm"][2]):
        assert_token(tok, want)


def test_converged_frame_equals_split_v4(world):
    """At a converged budget (``rounds=64``, ``step_cap=500``) the v3 frame
    with shadows is the split v4 frame, word for word."""
    trg, mats, _ = world
    cam = CamData.create(*CAMS[0], 70.0, SIZE)
    kw = dict(sun_pos=SUN, shadows=True, step_cap=500, with_flags=True)
    a = t3.render_frame3(trg, cam, mats.color, rounds=64, **kw)
    b = t4.render_frame4(trg, cam, mats.color, rounds=64, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("name", sorted(COMPACT))
def test_compacted_frame_matches_jax(world, name):
    """The round loop moves the surviving tiles into a grid of a quarter
    (or a half, then an eighth) of the frame's tiles, marches them there
    with twice the round budget and a tile map, and writes the states,
    cache ids and history back; all of it as JAX does."""
    trg, _, gold = world
    sizes = []
    ref = t3.march3_ref

    def rec(scal, mc, ts, *a, **kw):
        sizes.append(ts.shape[0])
        return ref(scal, mc, ts, *a, **kw)

    cam = CamData.create(*CAMS[0], 70.0, BIG)
    t3.march3_ref = rec
    try:
        res, tok = t3.trace_wavefront3(
            trg, np.asarray(cam.pos, np.float32), cam=cam, rounds=8,
            step_cap=500, compact=COMPACT[name], return_cache=True)
    finally:
        t3.march3_ref = ref
    assert_result(res, gold[name][0])
    assert_token(tok, gold[name][1])
    assert sizes[0] == 256 and min(sizes) == 64, sizes
    if name == "two_levels":
        assert 128 in sizes
