"""Incrementally maintained RenderGrid3 for a streaming chunk window.

Port of ``voxelraytracing_tpu/world/render_grid.py``. The builder keeps
host (NumPy, uint32) copies of the bit-plane tables of a scrolling chunk
window and re-derives only what a chunk arrival, edit or eviction touches:
a 32³ chunk covers exactly eight 16³ subwindows and one eighth of a 64³
window, so an update rewrites 8 subwindow rows, one window's meta and at
most one global-plane bit.

Uploads are incremental too: the device tables are int32 tensors updated
in place (``index_copy_`` of the dirty rows), so a steady-state frame
moves a few KB. ``prepared()`` keeps the v4 packed tables the same way,
dense (:class:`~..ops.wavefront4.PreparedGrid4`) or sparse
(:class:`~..ops.wavefront4.PreparedGrid4Sparse`: content rows only for
non-jump subwindows, all-solid rows shared), row for row equal to the JAX
builder's tables. A chunk's rows come from the port's native row builder
(``core/native.sw_rows_build``, host C++) when it builds, as in the JAX
builder, else from its NumPy twin ``chunk_batch_sw_data``.
"""

import logging

import numpy as np
import torch

from ..core import native
from ..core.constants import CHUNK_SIZE
from ..ops.wavefront import render_id_maps
from ..ops.wavefront3 import (
    SW,
    WIN,
    RenderGrid3,
    _gs_for,
    _i32,
    _pack_bits_np,
    _super_gplanes_np,
    build_sw_palettes,
)

_log = logging.getLogger(__name__)

_CANON_STAMP = 0xFFFFFFFE  # sid stamp of shared canonical rows: never a
#                            real sid, so a warm restore skips them
_MAX_CANON = 4096          # canonical (all-solid) rows kept at most


def _spread16_np(v):
    v = v.astype(np.uint32) & np.uint32(0xFFFF)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    return (v | (v << 1)) & np.uint32(0x55555555)


def _interleave_meta_np(m):
    """NumPy twin of ``ops.wavefront4._interleave_meta``: meta words 0-1
    (jump bits) and 2-3 (liquid bits) -> words 0-3 with bit 2i = jump_i,
    2i+1 = liq_i; words 4+ pass through."""
    j, l = m[:, 0:2], m[:, 2:4]
    out = np.stack(
        [
            _spread16_np(j[:, 0]) | (_spread16_np(l[:, 0]) << 1),
            _spread16_np(j[:, 0] >> 16) | (_spread16_np(l[:, 0] >> 16) << 1),
            _spread16_np(j[:, 1]) | (_spread16_np(l[:, 1]) << 1),
            _spread16_np(j[:, 1] >> 16) | (_spread16_np(l[:, 1] >> 16) << 1),
        ],
        axis=1,
    )
    return np.concatenate([out, m[:, 4:]], axis=1)


def _pack_rows_np(solid, liq, pid, meta):
    """Packed v4 content rows u32[N,7,128] (``prepare_grid4``'s layout:
    solid | liquid | pid×4 | interleaved meta padded to 128) of raw rows."""
    n = solid.shape[0]
    rows = np.zeros((n, 7, 128), np.uint32)
    rows[:, 0] = solid
    rows[:, 1] = liq
    rows[:, 2:6] = pid
    rows[:, 6, :8] = _interleave_meta_np(meta)
    return rows


def chunk_sw_rows(m):
    """[B,32,32,32] per-voxel array -> [B*8, 4096] subwindow rows,
    chunk-major with local subwindow index ``sz*4 + sy*2 + sx``, each row
    in (z, y, x) voxel order."""
    b = m.shape[0]
    t = m.reshape(b, 2, SW, 2, SW, 2, SW)        # (B, X,xl, Y,yl, Z,zl)
    t = t.transpose(0, 5, 3, 1, 6, 4, 2)         # (B, Z,Y,X, zl,yl,xl)
    return t.reshape(b * 8, SW * SW * SW)


def chunk_batch_sw_data(rgrids, n_liquid, to_pack):
    """Per-subwindow data of a batch of chunks: the NumPy twin of the
    native ``core/native.sw_rows_build`` (which the builder takes when the
    native library is available, as the JAX builder does).

    ``rgrids``: int array [B,32,32,32] of *render* ids (see
    ``render_id_maps``). Returns a dict of arrays over the B*8 subwindows,
    chunk-major with local subwindow index ``sz*4 + sy*2 + sx``: the
    solid, liquid, meta and palette-index rows, the per-subwindow flags
    the window meta needs, and ``palettes_ok``. ``_planes_from_masks_np``
    at chunk scale.
    """
    rg = np.asarray(rgrids)
    b = rg.shape[0]
    sw_rows = chunk_sw_rows

    solid = rg > n_liquid
    liq = (rg >= 1) & (rg <= n_liquid)

    solid_rows = sw_rows(solid)
    sw_solid = _pack_bits_np(solid_rows)
    sw_liq = _pack_bits_np(sw_rows(liq))

    def brick_reduce(m, op):
        t = m.reshape(b, 2, 4, 4, 2, 4, 4, 2, 4, 4)
        # (B, X,bx,vx, Y,by,vy, Z,bz,vz) -> any/all over voxel dims
        r = op(t, (3, 6, 9))                         # (B, X,bx, Y,by, Z,bz)
        r = r.transpose(0, 5, 3, 1, 6, 4, 2)         # (B, Z,Y,X, bz,by,bx)
        return r.reshape(b * 8, 64)

    b_any_solid = brick_reduce(solid, np.ndarray.any)
    b_all_liq = brick_reduce(liq, np.ndarray.all)
    b_any_liq = brick_reduce(liq, np.ndarray.any)
    b_jump = ~b_any_solid & (b_all_liq | ~b_any_liq)

    sw_meta = np.zeros((b * 8, 8), np.uint32)
    sw_meta[:, 0:2] = _pack_bits_np(b_jump)
    sw_meta[:, 2:4] = _pack_bits_np(b_all_liq)

    # palettes + palette-index planes: shared with the one-shot builder so
    # the overflow policy cannot drift
    pal_words, sw_pid, pal_ok = build_sw_palettes(
        sw_rows(rg), solid_rows, to_pack
    )
    sw_meta[:, 4:8] = pal_words

    return dict(
        sw_solid=sw_solid, sw_liq=sw_liq, sw_meta=sw_meta, sw_pid=sw_pid,
        any_solid=b_any_solid.any(axis=1), all_liq=b_all_liq.all(axis=1),
        any_liq=b_any_liq.any(axis=1), palettes_ok=pal_ok,
    )


class RenderGrid3Builder:
    """Host-side RenderGrid3 with incremental chunk updates and uploads.

    ``sparse``: keep the v4 packed tables sparse (content rows only for
    non-jump subwindows, all-solid rows deduplicated) instead of dense.
    On by itself past 64 chunks, where the dense tables (~15 GB at the
    reference's 80-chunk window, ui.rs:165) fit no card; callers that
    render only through :meth:`prepared` (the engine) ask for it from 33
    chunks. Sparse mode never uploads the dense planes: :meth:`grid`
    returns placeholder raw planes, so only ``render_frame4`` and
    ``trace_wavefront4`` with ``prepared=`` render it. Tables live on
    ``device``: the card unless the caller asks for the CPU.
    """

    def __init__(self, size_in_chunks, materials, world_min=(0, 0, 0),
                 sparse=None, device="cuda"):
        self.w = int(size_in_chunks)
        v = self.w * CHUNK_SIZE
        self.v = v
        vpad = -(-v // WIN) * WIN
        self.ns = vpad // SW
        self.nw = vpad // WIN
        _gs_for(self.nw)  # raises past the supported 128³ windows
        self.device = torch.device(device)
        ns3, nw3 = self.ns ** 3, self.nw ** 3
        self.sw_solid = np.zeros((ns3, 128), np.uint32)
        self.sw_liq = np.zeros((ns3, 128), np.uint32)
        self.sw_meta = np.zeros((ns3, 8), np.uint32)
        self.sw_pid = np.zeros((ns3, 4, 128), np.uint32)
        self.s_any_solid = np.zeros(ns3, bool)
        self.s_all_liq = np.zeros(ns3, bool)
        self.s_any_liq = np.zeros(ns3, bool)
        self.wmeta = np.zeros((nw3, 8), np.uint32)
        self._rebuild_all_windows = True
        self.world_min = np.asarray(world_min, np.int64)

        self.to_render, self.to_pack, self.n_liquid = render_id_maps(
            np.asarray(materials.is_liquid))
        self._dirty_sw = set()
        self._dirty_w = set()
        self._dev = None        # device planes
        self._cached_rg = None  # identity-stable RenderGrid3 while clean
        self.palettes_ok = True
        # the dense packed twin (prepare_grid4's layout), kept by
        # prepared(); its own dirty sets, since grid() clears the raw ones
        self._dirty_sw_pack = set()
        self._dirty_w_pack = set()
        self._prep = None
        # the sparse twin (see the class docstring)
        self.sparse = (self.w > 64) if sparse is None else bool(sparse)
        self._sp_row = np.full(ns3, -1, np.int64)   # sid -> content row
        self._sp_own = np.zeros(ns3, bool)          # row owned (not canon)
        self._sp_free = []
        self._sp_next = 0
        self._sp_cap = 0
        self._sp_host = None                        # u32[cap,7,128] mirror
        self._sp_canon = {}                         # row bytes -> row
        self._sp_dirty_rows = set()
        self._sp_dirty_sids = set()
        self._sp_dirty_w = set()
        self._sp_widx = np.zeros((nw3, 128), np.uint32)
        self._sp_widx[:, 64:] = 0xFFFFFFFF
        self._sp_dev = None
        self._sp_wdev = None

    # ------------------------------------------------------------ updates

    def _sw_ids_for_cell(self, cell):
        """Global subwindow ids of a chunk cell, in chunk-major (sz,sy,sx)
        order as :func:`chunk_batch_sw_data` returns them."""
        cx, cy, cz = cell
        ns = self.ns
        return [(cx * 2 + sx) + (cy * 2 + sy) * ns + (cz * 2 + sz) * ns * ns
                for sz in range(2) for sy in range(2) for sx in range(2)]

    def _window_of(self, cell):
        cx, cy, cz = cell
        return (cx // 2) + (cy // 2) * self.nw + (cz // 2) * self.nw ** 2

    def _window_sids(self, wids):
        """[len(wids), 64] subwindow ids of windows ``wids`` (int64), in
        local order ``sx + sy*4 + sz*16``."""
        ns, nw = self.ns, self.nw
        l = np.arange(64)
        wx, wy, wz = wids % nw, (wids // nw) % nw, wids // (nw * nw)
        return ((wx[:, None] * 4 + (l & 3))
                + (wy[:, None] * 4 + ((l >> 2) & 3)) * ns
                + (wz[:, None] * 4 + (l >> 4)) * ns * ns)

    def set_chunks(self, cells, grids_packids):
        """Install or replace chunk contents. ``cells``: [(cx,cy,cz)]
        window-local chunk coordinates; ``grids_packids``: [B,32,32,32]
        pack ids."""
        if not len(cells):
            return
        rg = self.to_render[np.asarray(grids_packids, np.int64)]
        if native.available():
            # one native pass over the rows: bit packing, brick metas,
            # palettes and pid planes (world/render_grid.py:133-139 of the
            # JAX package; equal to the twin, tests/test_torch_native.py)
            data = native.sw_rows_build(chunk_sw_rows(rg), self.n_liquid,
                                        self.to_pack)
        else:
            data = chunk_batch_sw_data(rg, self.n_liquid, self.to_pack)
        if not data["palettes_ok"]:
            self.palettes_ok = False
            _log.warning(
                "subwindow palette overflow (>16 solid ids in a 16^3 "
                "region): overflow voxels render with the most-frequent "
                "palette entry")
        sids = np.asarray([self._sw_ids_for_cell(c) for c in cells],
                          np.int64).ravel()          # [B*8] row-aligned
        self.sw_solid[sids] = data["sw_solid"]
        self.sw_liq[sids] = data["sw_liq"]
        self.sw_meta[sids] = data["sw_meta"]
        self.sw_pid[sids] = data["sw_pid"]
        self.s_any_solid[sids] = data["any_solid"]
        self.s_all_liq[sids] = data["all_liq"]
        self.s_any_liq[sids] = data["any_liq"]
        for dirty in (self._dirty_sw, self._dirty_sw_pack,
                      self._sp_dirty_sids):
            dirty.update(sids.tolist())
        for cell in cells:
            w = self._window_of(cell)
            for dirty in (self._dirty_w, self._dirty_w_pack,
                          self._sp_dirty_w):
                dirty.add(w)

    def clear_cells(self, cells):
        """Evicted chunks become air."""
        for cell in cells:
            sids = self._sw_ids_for_cell(cell)
            for a in (self.sw_solid, self.sw_liq, self.sw_meta, self.sw_pid,
                      self.s_any_solid, self.s_all_liq, self.s_any_liq):
                a[sids] = 0
            w = self._window_of(cell)
            for dirty in (self._dirty_sw, self._dirty_sw_pack,
                          self._sp_dirty_sids):
                dirty.update(sids)
            for dirty in (self._dirty_w, self._dirty_w_pack,
                          self._sp_dirty_w):
                dirty.add(w)

    # ------------------------------------------------------------ windows

    def _window_meta(self, wids):
        """Recompute the meta rows of windows ``wids`` from their
        subwindows' flags."""
        wids = np.asarray(wids, np.int64)
        if not wids.size:
            return
        sids = self._window_sids(wids)
        a_sol = self.s_any_solid[sids]
        a_all = self.s_all_liq[sids]
        a_any = self.s_any_liq[sids]
        s_jump = ~a_sol & (a_all | ~a_any)
        self.wmeta[wids, 0:2] = _pack_bits_np(s_jump)
        self.wmeta[wids, 2:4] = _pack_bits_np(a_all)

    def _global_planes(self):
        ns, nw = self.ns, self.nw

        def win_flags(sflags, op):
            # sid = X + Y*ns + Z*ns², so the reshape is (Z,Y,X); reduce
            # each window's 4³ subwindows, flatten to wid = X + Y*nw +
            # Z*nw² the same way
            t = sflags.reshape(nw, 4, nw, 4, nw, 4)    # (Z,sz, Y,sy, X,sx)
            return op(t, (1, 3, 5)).reshape(-1)

        w_any_solid = win_flags(self.s_any_solid, np.ndarray.any)
        w_all_liq = win_flags(self.s_all_liq, np.ndarray.all)
        w_any_liq = win_flags(self.s_any_liq, np.ndarray.any)
        w_jump = ~w_any_solid & (w_all_liq | ~w_any_liq)
        # the super-cell reduction of the one-shot builder, so the two
        # cannot drift on worlds past 32 chunks
        return _super_gplanes_np(w_jump, w_jump & w_all_liq, nw)

    # ------------------------------------------------------------- upload

    def grid(self) -> RenderGrid3:
        """The current RenderGrid3 on the builder's device; uploads only
        dirty rows.

        Identity-stable: calls with no edit in between return the SAME
        object, so callers can key derived tables on grid identity. In
        sparse mode the raw planes are 1-row placeholders (never the
        dense tables)."""
        if (self._cached_rg is not None and not self._dirty_sw
                and not self._dirty_w and not self._rebuild_all_windows):
            return self._cached_rg
        if self._dirty_w or self._rebuild_all_windows:
            wids = (range(self.nw ** 3) if self._rebuild_all_windows
                    else sorted(self._dirty_w))
            self._window_meta(wids)
            self._rebuild_all_windows = False
        gw_jump, gw_liq = self._global_planes()
        dev = self.device

        if self.sparse:
            self._dirty_sw.clear()
            self._dirty_w.clear()
            planes = dict(
                wmeta=np.zeros((1, 8), np.uint32),
                sw_meta=np.zeros((1, 8), np.uint32),
                sw_solid=np.zeros((1, 128), np.uint32),
                sw_liq=np.zeros((1, 128), np.uint32),
                sw_pid=np.zeros((1, 4, 128), np.uint32))
            planes = {k: _i32(a, dev) for k, a in planes.items()}
        else:
            names = ("sw_solid", "sw_liq", "sw_meta", "sw_pid")
            if self._dev is None:
                self._dev = {k: _i32(getattr(self, k), dev)
                             for k in names + ("wmeta",)}
            else:
                if self._dirty_sw:
                    rows = np.asarray(sorted(self._dirty_sw), np.int64)
                    idx = torch.from_numpy(rows).to(dev)
                    for k in names:
                        self._dev[k].index_copy_(
                            0, idx, _i32(getattr(self, k)[rows], dev))
                if self._dirty_w:
                    rows = np.asarray(sorted(self._dirty_w), np.int64)
                    self._dev["wmeta"].index_copy_(
                        0, torch.from_numpy(rows).to(dev),
                        _i32(self.wmeta[rows], dev))
            self._dirty_sw.clear()
            self._dirty_w.clear()
            planes = self._dev
        self._cached_rg = RenderGrid3(
            gw_jump=_i32(gw_jump, dev),
            gw_liq=_i32(gw_liq, dev),
            wmeta=planes["wmeta"],
            sw_meta=planes["sw_meta"],
            sw_solid=planes["sw_solid"],
            sw_liq=planes["sw_liq"],
            sw_pid=planes["sw_pid"],
            # JAX's stand-ins (render_grid.py:449-450): the "gather"
            # hit-id route is for one-shot grids with overflowed palettes
            brick_dir=torch.zeros(1, dtype=torch.int32, device=dev),
            bricks=torch.zeros((1, 16), dtype=torch.int32, device=dev),
            world_min=_i32(self.world_min.astype(np.int32), dev),
            to_pack=_i32(self.to_pack, dev),
            n_liquid=int(self.n_liquid),
            size_voxels=self.v,
            palettes_ok=self.palettes_ok,
        )
        return self._cached_rg

    # --------------------------------------------------------- sparse twin

    def _sp_alloc(self):
        if self._sp_free:
            return self._sp_free.pop()
        r = self._sp_next
        self._sp_next += 1
        if r >= self._sp_cap:
            new_cap = max(self._sp_cap * 2, 4096)
            host = np.zeros((new_cap, 7, 128), np.uint32)
            if self._sp_host is not None:
                host[: self._sp_cap] = self._sp_host
            self._sp_host = host
            self._sp_cap = new_cap
            self._sp_dev = None      # full re-upload on the next prepared()
        return r

    def _sp_row_content(self, sid):
        return _pack_rows_np(self.sw_solid[sid:sid + 1],
                             self.sw_liq[sid:sid + 1],
                             self.sw_pid[sid:sid + 1],
                             self.sw_meta[sid:sid + 1])[0]

    def prepared_sparse(self):
        """Sparse v4 packed tables (PreparedGrid4Sparse) on the builder's
        device. Content rows: one per non-jump subwindow, all-solid rows
        shared as at most 4096 canonical rows stamped ``_CANON_STAMP`` at
        meta lane 8 (buried volume collapses to about one row per
        material); an owned row carries its sid there. Window-meta rows
        carry the interleaved meta at lanes 0-7 and their 64 subwindows'
        content rows at lanes 64-127 (-1 for a jump subwindow). Rows are
        allocated in JAX's order: sorted dirty sids, the free list popped
        from its end, the canonical dict."""
        from ..ops.wavefront4 import PreparedGrid4Sparse

        self.grid()  # refresh the window metas and subwindow flags first
        ns, nw = self.ns, self.nw
        for sid in sorted(self._sp_dirty_sids):
            jump = (not self.s_any_solid[sid]) and (
                self.s_all_liq[sid] or not self.s_any_liq[sid])
            old = int(self._sp_row[sid])
            owned = bool(self._sp_own[sid])
            if jump:
                new, own = -1, False
            else:
                row = self._sp_row_content(sid)
                all_solid = bool((row[0] == 0xFFFFFFFF).all())
                key = row.tobytes() if all_solid else None
                if key is not None and (
                        key in self._sp_canon
                        or len(self._sp_canon) < _MAX_CANON):
                    r = self._sp_canon.get(key)
                    if r is None:
                        r = self._sp_alloc()
                        c = row.copy()
                        c[6, 8] = np.uint32(_CANON_STAMP)
                        self._sp_host[r] = c
                        self._sp_dirty_rows.add(r)
                        self._sp_canon[key] = r
                    new, own = r, False
                else:
                    r = old if (owned and old >= 0) else self._sp_alloc()
                    row[6, 8] = np.uint32(sid)
                    self._sp_host[r] = row
                    self._sp_dirty_rows.add(r)
                    new, own = r, True
            if new != old or own != owned:
                if owned and old >= 0 and old != new:
                    self._sp_free.append(old)
                self._sp_row[sid] = new
                self._sp_own[sid] = own
                sx, sy, sz = sid % ns, (sid // ns) % ns, sid // (ns * ns)
                self._sp_dirty_w.add(
                    (sx >> 2) + (sy >> 2) * nw + (sz >> 2) * nw * nw)
        self._sp_dirty_sids.clear()

        dirty_w = sorted(self._sp_dirty_w)
        self._sp_dirty_w.clear()
        if dirty_w:
            wids = np.asarray(dirty_w, np.int64)
            rows = self._sp_row[self._window_sids(wids)]
            self._sp_widx[wids, :8] = _interleave_meta_np(self.wmeta[wids])
            self._sp_widx[wids, 8:64] = 0
            self._sp_widx[wids, 64:] = np.where(
                rows >= 0, rows, 0xFFFFFFFF).astype(np.uint32)

        dev = self.device
        if self._sp_host is None:
            self._sp_cap = 16
            self._sp_host = np.zeros((16, 7, 128), np.uint32)
        if self._sp_dev is None:
            self._sp_dev = _i32(self._sp_host, dev)
            self._sp_dirty_rows.clear()
            self._sp_wdev = _i32(self._sp_widx[:, None, :], dev)
        else:
            if self._sp_dirty_rows:
                rows = np.asarray(sorted(self._sp_dirty_rows), np.int64)
                self._sp_dev.index_copy_(
                    0, torch.from_numpy(rows).to(dev),
                    _i32(self._sp_host[rows], dev))
                self._sp_dirty_rows.clear()
            if dirty_w:
                rows = np.asarray(dirty_w, np.int64)
                self._sp_wdev.index_copy_(
                    0, torch.from_numpy(rows).to(dev),
                    _i32(self._sp_widx[rows][:, None, :], dev))
        return PreparedGrid4Sparse(self._sp_dev, self._sp_wdev, self.ns)

    def sparse_tables_mb(self):
        """Device footprint of the sparse tables (content + window rows),
        MB."""
        if self._sp_dev is None:
            return 0.0
        return (self._sp_dev.numel() + self._sp_wdev.numel()) * 4 / 1e6

    def prepared(self):
        """The incrementally kept v4 packed tables.

        Dense: a :class:`~..ops.wavefront4.PreparedGrid4` equal to
        ``prepare_grid4(grid())``; after the first full pack, only the
        rows an install, edit or eviction touched are repacked (on the
        host) and copied into the device tables in place. Sparse: the
        token of :meth:`prepared_sparse`."""
        if self.sparse:
            return self.prepared_sparse()
        from ..ops.wavefront4 import PreparedGrid4, prepare_grid4

        rg = self.grid()  # refresh the window metas before packing them
        if self._prep is None:
            self._prep = prepare_grid4(rg)
            self._dirty_sw_pack.clear()
            self._dirty_w_pack.clear()
            return self._prep
        sw_cont, wmeta_pad = self._prep
        dev = self.device
        if self._dirty_sw_pack:
            rows = np.asarray(sorted(self._dirty_sw_pack), np.int64)
            packed = _pack_rows_np(self.sw_solid[rows], self.sw_liq[rows],
                                   self.sw_pid[rows], self.sw_meta[rows])
            sw_cont.index_copy_(0, torch.from_numpy(rows).to(dev),
                                _i32(packed, dev))
            self._dirty_sw_pack.clear()
        if self._dirty_w_pack:
            rows = np.asarray(sorted(self._dirty_w_pack), np.int64)
            meta = np.zeros((rows.size, 1, 128), np.uint32)
            meta[:, 0, :8] = _interleave_meta_np(self.wmeta[rows])
            wmeta_pad.index_copy_(0, torch.from_numpy(rows).to(dev),
                                  _i32(meta, dev))
            self._dirty_w_pack.clear()
        self._prep = PreparedGrid4(sw_cont, wmeta_pad)
        return self._prep
