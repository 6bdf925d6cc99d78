"""The port's frames from sparse tables against the JAX package's.

Worlds are built by the streaming builders of both packages
(``RenderGrid3Builder``); the JAX frames run their Pallas kernel in
interpret mode on the CPU, the port's their plain PyTorch versions on CPU
tensors, each with its own builder's token (the two tokens are equal word
for word: tests/test_torch_streaming.py).

Tolerances (ROADMAP queue 3): flags exact; packed RGBA8 exact on hit
pixels, a sky channel within 1/255 (the two libms may round ``** 0.35``
apart); against JAX's trace, hits, ids, steps and normals exact, ``t``
within 2e-6 relative (1e-5 on the long rays of the 34-chunk scene) and
the water length within 1e-4 (XLA contracts ``a*b+c`` into FMAs inside
the interpret-mode kernel). The port's sparse frame equals its dense
frame exactly.
"""

import numpy as np
import pytest
import torch

from voxelraytracing_tpu.ops import noise as j_noise
from voxelraytracing_tpu.ops.camera import CamData as JCamData
from voxelraytracing_tpu.ops.wavefront4 import render_frame4 as j_render_frame4
from voxelraytracing_tpu.ops.wavefront4 import trace_wavefront4 as j_trace4
from voxelraytracing_tpu.world import demo as j_demo
from voxelraytracing_tpu.world import render_grid as jr
from voxelraytracing_tpu_torch.ops import pathtrace3 as p3
from voxelraytracing_tpu_torch.ops import pathtrace4 as p4
from voxelraytracing_tpu_torch.ops import wavefront4 as t4
from voxelraytracing_tpu_torch.ops.camera import CamData
from voxelraytracing_tpu_torch.ops.wavefront3 import _sb_dims
from voxelraytracing_tpu_torch.world import demo
from voxelraytracing_tpu_torch.world import render_grid as tr
from torch_one_thread import torch_one_thread  # noqa: F401 (autouse)

W = 4
SUN = (1000.0, 2500.0, 500.0)
SIZE = (64, 32)
# tests/test_sparse.py:40-44
CAMS = [
    ((30.0, 45.0, 0.0), (64.0, 75.0, 64.0)),
    ((5.0, 120.0, 0.0), (20.0, 40.0, 100.0)),
    ((-20.0, 300.0, 0.0), (64.0, 20.0, 64.0)),  # underwater, looking up
]
MODES = {
    "fused": dict(fused=True),
    "fused_shadow": dict(fused=True, shadows=True),
    "split": dict(fused=False),
}
KW = dict(sun_pos=SUN, rounds=64, step_cap=500, with_flags=True)

# tests/test_supercell.py:139-177: a 34-chunk window (17 windows a side,
# super-cell shift 1) with terrain islands at opposite corners and a
# floating water cube
W34 = 34
W34_CELLS = [(0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1), (32, 0, 32),
             (33, 0, 33), (16, 8, 16)]
W34_CAMS = [
    ((35.0, 45.0, 0.0), (20.0, 60.0, 20.0)),
    ((14.5, 225.0, 0.0), (10.0, 400.0, 10.0)),
    ((70.0, 10.0, 0.0), (528.0, 400.0, 500.0)),
    ((4.2, 45.0, 0.0), (1080.0, 120.0, 1080.0)),
]


def _w34_grids():
    terrain = np.zeros((32, 32, 32), np.int32)
    terrain[:, :12, :] = demo.STONE
    terrain[:, 12:14, :] = demo.EARTH
    terrain[:, 14, :] = demo.GRASS
    water = np.full((32, 32, 32), demo.WATER, np.int32)
    return np.stack([terrain] * 6 + [water])


def _builders(w, cells, grids, sparse_only=False):
    """JAX and port builders of one world: sparse, and (unless
    ``sparse_only``) dense."""
    out = {}
    for sparse in (True,) if sparse_only else (True, False):
        jb = jr.RenderGrid3Builder(w, j_demo.demo_materials(), sparse=sparse)
        tb = tr.RenderGrid3Builder(w, demo.demo_materials(), sparse=sparse,
                                   device="cpu")
        for b in (jb, tb):
            b.set_chunks(cells, grids)
        out[sparse] = (jb, tb)
    return out


def _jax_frame(jb, cam_cfg, mode):
    cam = JCamData.create(cam_cfg[0], cam_cfg[1], 70.0, SIZE)
    img, fl = j_render_frame4(jb.grid(), cam, j_demo.demo_materials().color,
                              prepared=jb.prepared(), **KW, **MODES[mode])
    return np.asarray(img), np.asarray(fl)


def _port_frame(tb, cam_cfg, mode, **kw):
    cam = CamData.create(cam_cfg[0], cam_cfg[1], 70.0, SIZE)
    out = t4.render_frame4(tb.grid(), cam, demo.demo_materials().color,
                           prepared=tb.prepared(), **KW, **MODES[mode], **kw)
    return (out[0].numpy().view(np.uint32), out[1].numpy()) + tuple(out[2:])


@pytest.fixture(scope="module")
def world():
    """The W=4 demo world in sparse and dense builders of both packages,
    JAX's sparse frames of every camera and mode, and the W=34 scene's
    sparse builders with JAX's traces of its cameras."""
    grids, cells = j_demo.demo_chunk_grids_host(
        j_noise.make_permutation(7), np.zeros(3, np.int64), W,
        W * 32 * 0.45, int(W * 32 * 0.28))
    cell_xyz = [(int(c % W), int((c // W) % W), int(c // (W * W)))
                for c in cells]
    b = _builders(W, cell_xyz, grids)
    gold = {(i, m): _jax_frame(b[True][0], c, m)
            for i, c in enumerate(CAMS) for m in MODES}
    big = _builders(W34, W34_CELLS, _w34_grids(), sparse_only=True)[True]
    jbig = big[0]
    jp = jbig.prepared()
    for i, (rot, eye) in enumerate(W34_CAMS):
        kw = dict(rounds=96, step_cap=2000,
                  cam=JCamData.create(rot, eye, 70.0, SIZE))
        eye = np.asarray(eye, np.float32)
        gold["trace", i] = j_trace4(jbig.grid(), eye,
                                    prepared=_with_window_metas(jbig), **kw)
        if i == 3:
            gold["trace_own", i] = j_trace4(jbig.grid(), eye, prepared=jp,
                                            **kw)
    return b, big[1], grids, cell_xyz, gold, jbig


def _with_window_metas(jb):
    """JAX's sparse token of builder ``jb`` with the interleaved meta of
    EVERY window in lanes 0-7. JAX's builder writes a window's row only
    once a chunk of it was installed or evicted, so the rows of windows
    never touched keep zero metas; past 32 chunks (super-cells of several
    windows) rays read those zeros, and JAX's kernel stalls on their
    subwindows, which have no content row. Its dense trace is the frame
    the sparse one should equal, and this token gives it."""
    import jax.numpy as jnp

    jp = jb.prepared()
    wm = np.array(jp.wmeta_pad)
    wm[:, 0, :8] = jr._interleave_meta_np(jb.wmeta)
    return jp._replace(wmeta_pad=jnp.asarray(wm))


def _assert_matches_jax(port, gold):
    (img, fl), (jimg, jfl) = port, gold
    np.testing.assert_array_equal(fl, jfl)
    sky = ((jfl >> 1) & 1) == 0
    assert not ((img != jimg) & ~sky).any(), "a hit pixel's color differs"
    for sh in (0, 8, 16):
        ch = np.abs(((img >> sh) & 255).astype(int)
                    - ((jimg >> sh) & 255).astype(int))
        assert ch.max() <= 1, "a sky channel differs by more than 1/255"


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("i", range(len(CAMS)))
def test_sparse_frame_matches_jax_and_dense(world, i, mode):
    b, _, _, _, gold, _ = world
    tsp, tdn = b[True][1], b[False][1]
    port = _port_frame(tsp, CAMS[i], mode)
    _assert_matches_jax(port, gold[i, mode])
    dense = _port_frame(tdn, CAMS[i], mode)
    np.testing.assert_array_equal(port[0], dense[0])
    np.testing.assert_array_equal(port[1], dense[1])
    assert ((port[1] >> 1) & 1).any()


def test_sparse_token_and_edit(world):
    """The sparse frame's token is i32[nB,3,128] (JAX's row count); a
    frame after an edit under a live token equals the dense frame of the
    edited world (tests/test_sparse.py:71-103)."""
    b, _, grids, cell_xyz, _, _ = world
    tsp, tdn = b[True][1], b[False][1]
    img, fl, tok = _port_frame(tsp, CAMS[0], "split", return_cache=True,
                               shadows=True)
    nsx, nsy, _ = _sb_dims(SIZE[0] // 16, SIZE[1] // 8)
    for t in tok:  # primary and shadow tokens
        assert tuple(t.shape) == (nsx * nsy, 3, 128)
        assert t.dtype == torch.int32 and bool((t == -1).all())
    assert tuple(_port_frame(b[False][1], CAMS[0], "fused",
                             return_cache=True)[2][0].shape)[1] == 2
    warm = _port_frame(tsp, CAMS[0], "split", cache=tok, shadows=True)
    np.testing.assert_array_equal(warm[0], img)
    edited = np.array(grids[:1])
    edited[0] = 0
    try:
        for tb in (tsp, tdn):
            tb.set_chunks(cell_xyz[:1], edited)
        for mode in MODES:
            after = _port_frame(tsp, CAMS[0], mode, cache=tok)
            dense = _port_frame(tdn, CAMS[0], mode)
            np.testing.assert_array_equal(after[0], dense[0])
            np.testing.assert_array_equal(after[1], dense[1])
        assert (after[0] != img).any()  # the edit shows
    finally:
        for tb in (tsp, tdn):
            tb.set_chunks(cell_xyz[:1], grids[:1])


@pytest.mark.parametrize("i", range(len(W34_CAMS)))
def test_trace_past_32_chunks_matches_jax(world, i):
    """trace_wavefront4 on the W=34 scene (gs=1: super-cell jumps) with
    sparse tables in both packages, against JAX at rounds=96 and a
    2000-step cap on its token with every window's meta (see
    :func:`_with_window_metas`); the port's own token equals JAX's
    builder's word for word."""
    _, tbig, _, _, gold, _ = world
    rot, eye = W34_CAMS[i]
    ref = gold["trace", i]
    res = t4.trace_wavefront4(
        tbig.grid(), np.asarray(eye, np.float32), rounds=96, step_cap=2000,
        prepared=tbig.prepared(), cam=CamData.create(rot, eye, 70.0, SIZE))
    assert t4._world_dims(tbig.prepared().sw_cont, tbig.prepared().wmeta_pad,
                          tbig.ns)[2] == 1
    for f in ("hit", "voxel", "steps", "norm"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    # these rays run to 2000 steps and t past 1000, so the FMA difference
    # of the interpret-mode kernel adds up past the W=4 bound of 2e-6:
    # measured <= 3.5e-6 relative (64x32, four cameras)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(res.water_dist.numpy(),
                               np.asarray(ref.water_dist), rtol=0, atol=1e-4)
    if i in (0, 1, 3):
        assert res.hit.any()


def test_jax_sparse_builder_leaves_untouched_windows_blank(world):
    """A fact of the reference, and why the port reads a -1 row as an
    empty subwindow. At W=34 JAX's sparse token keeps zero metas in the
    windows no chunk was installed in (3 of the 4913 windows hold chunks):
    their subwindows do not read as jumps and have no content row. Every
    -1 lane of the token is an empty subwindow. JAX's kernel stalls on
    them, so its trace on its own token differs from the one with every
    window's meta; the port's trace on the same token equals the latter."""
    _, tbig, _, _, gold, jbig = world
    tp = tbig.prepared()
    wm = u32 = tp.wmeta_pad[:, 0].numpy().view(np.uint32)
    full = jr._interleave_meta_np(jbig.wmeta)
    blank = (wm[:, :8] == 0).all(axis=1)
    assert int(blank.sum()) == 4910
    assert not (full[blank] == 0).all(axis=1).any()
    np.testing.assert_array_equal(wm[~blank, :8], full[~blank])
    empty = ~tbig.s_any_solid & (tbig.s_all_liq | ~tbig.s_any_liq)
    ns, nw = tbig.ns, tbig.nw
    l = np.arange(64)
    w = np.arange(nw ** 3)[:, None]
    sids = ((w % nw * 4 + (l & 3)) + ((w // nw) % nw * 4 + ((l >> 2) & 3)) * ns
            + (w // (nw * nw) * 4 + (l >> 4)) * ns * ns)
    assert empty[sids[u32[:, 64:] == 0xFFFFFFFF]].all()
    own, fixed = gold["trace_own", 3], gold["trace", 3]
    assert (np.asarray(own.steps) != np.asarray(fixed.steps)).sum() > 1000


def test_missing_rows_read_as_empty(world):
    """With every row index -1, every subwindow reads as empty: the frame
    has no hit and the plain march reads no content row."""
    b, _, _, _, _, _ = world
    tsp = b[True][1]
    prep = tsp.prepared()
    wm = prep.wmeta_pad.clone()
    wm[:, 0, 64:] = -1
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, SIZE)
    args, kw = t4.frame_args(tsp.grid(), cam, demo.demo_materials().color,
                             prepared=prep._replace(wmeta_pad=wm))
    _, fl = t4.march_fused4_ref(*args, **kw)
    assert not ((fl >> 1) & 1).any()
    _, dense_fl = t4.march_fused4_ref(*t4.frame_args(
        tsp.grid(), cam, demo.demo_materials().color, prepared=prep)[0],
        **kw)
    assert ((dense_fl >> 1) & 1).any()


def test_path_tracers_refuse_sparse_tables(world):
    b, _, _, _, _, _ = world
    tsp = b[True][1]
    cam = CamData.create(CAMS[0][0], CAMS[0][1], 70.0, SIZE)
    mats = demo.demo_materials()
    for fn in (p3.path_trace3, p3.path_trace4, p4.path_trace_fused4):
        with pytest.raises(ValueError, match="dense tables only"):
            fn(tsp.grid(), cam, mats, sun_pos=SUN, prepared=tsp.prepared())


def test_sparse_tables_need_their_ns(world):
    """Sparse tables cannot be read as dense ones: their row count gives
    no world size, and a wrong ``ns`` does not fit the window rows."""
    b, _, _, _, _, _ = world
    prep = b[True][1].prepared()
    with pytest.raises(ValueError, match="cube|subwindows"):
        t4._world_dims(prep.sw_cont, prep.wmeta_pad)
    with pytest.raises(ValueError, match="subwindows"):
        t4._world_dims(prep.sw_cont, prep.wmeta_pad, prep.ns * 2)
