"""Ray–world traversal over the SVO node pool: the reference tracer.

Port of ``voxelraytracing_tpu/ops/traverse.py``, the batched, maskable
re-expression of the reference GPU kernel's DDA/octree march
(ray_tracer.wgsl:182-316): every ray repeatedly (a) locates the leaf node
containing its position — chunk lookup by ``floor(pos/32)`` into the root
table, then a <=5-level stackless octree descent re-deriving the octant
from the position at each level (ray_tracer.wgsl:76-125) — and (b)
advances to that node's AABB exit with a small epsilon nudge across the
boundary (ray_tracer.wgsl:243-283).

The JAX package computes this with XLA outside any Pallas kernel, so
torch ops on the device of the world's tensors are its port: the card,
or the CPU when the world was built there. JAX's ``lax.while_loop`` is a
Python loop here. Its exit test (``any(active)``) needs a host sync, so
the loop tests it every ``sync_every`` iterations: a ray whose ``active``
is false is frozen (no field of it changes), so the extra iterations
change no word. Every multiply and add is rounded on its own, in the JAX
source's order, so the result equals JAX's program evaluated one
primitive at a time (``jax.disable_jit()``); XLA's CPU compiler contracts
``a*b+c`` inside the jitted program, which moves some positions by an ulp.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core import nodes as nodefmt
from ..core.constants import CHUNK_SIZE, MAX_RAY_STEPS, RAY_EPS
from .camera import sqrt_rn

_BIG = 1e9
# Squaring this must stay finite (see _ratio in trace_rays).
_BIG_RATIO = 1e4
# iterations between two tests of any(active) (one host sync each)
SYNC_EVERY = 8


class WorldSlice(NamedTuple):
    """Device-resident render view of the world — the two-buffer contract
    shared with the reference's bind group (shader.rs:317-320).

    nodes: ``int32[pool]`` widened 16-bit SVO nodes, or ``uint32[ceil(pool
      / 2)]`` packed pairs (:meth:`packed`); index 0 is a reserved air leaf
      so missing chunks (root 0) read as empty.
    chunk_roots: ``int32[W**3]`` absolute node-pool address of each chunk's
      root, flat-indexed ``x + y*W + z*W²``.
    world_min: ``int32[3]`` voxel coordinate of the grid's min corner.
    """

    nodes: torch.Tensor
    chunk_roots: torch.Tensor
    world_min: torch.Tensor

    @property
    def size_in_chunks(self):
        w = round(self.chunk_roots.shape[0] ** (1 / 3))
        assert w**3 == self.chunk_roots.shape[0]
        return w

    @property
    def size_in_voxels(self):
        return self.size_in_chunks * CHUNK_SIZE

    def packed(self):
        """Same world with the node pool packed two u16 nodes per u32
        word — the reference's device layout (shader.rs:22-40), halving
        the pool's footprint. ``find_node`` dispatches on dtype, so a
        packed slice is a drop-in replacement everywhere."""
        if self.nodes.dtype == torch.uint32:
            return self
        return self._replace(nodes=pack_nodes(self.nodes))


def pack_nodes(nodes_i32):
    """int32[pool] widened nodes -> uint32[ceil(pool/2)] packed pairs (the
    pairs are formed in int32 on the same bits, then viewed as uint32)."""
    n = nodes_i32.shape[0]
    ev = nodes_i32[0::2] & 0xFFFF
    od = nodes_i32[1::2] & 0xFFFF
    od = torch.cat([od, od.new_zeros((n + 1) // 2 - n // 2)])
    return (ev | (od << 16)).view(torch.uint32)


def _node_fetch(nodes, i):
    """Node value at pool index ``i`` (int64) for either pool layout."""
    if nodes.dtype == torch.uint32:  # packed u16 pairs
        w_ = nodes.view(torch.int32)[_clip(i >> 1, nodes)]
        return (w_ >> ((i & 1) * 16).to(torch.int32)) & 0xFFFF
    return nodes[_clip(i, nodes)]


def _clip(i, table):
    """Indices clamped into ``table``, as XLA's gathers clamp them. Only
    rays that are no longer active read past a table (their positions
    lie outside the world), and their reads are masked out."""
    return i.clamp(0, table.shape[0] - 1)


class FoundNodes(NamedTuple):
    node: torch.Tensor  # int32[N] — node value at the query position
    box_min: torch.Tensor  # f32[N,3]
    box_max: torch.Tensor  # f32[N,3]


class TraceResult(NamedTuple):
    hit: torch.Tensor  # bool[N]
    voxel: torch.Tensor  # int32[N] — voxel id at the hit (or last sampled)
    norm: torch.Tensor  # f32[N,3] — entry-face normal (0 if camera starts inside)
    pos: torch.Tensor  # f32[N,3] — world-local hit position
    water_dist: torch.Tensor  # f32[N] — distance traveled through liquid
    steps: torch.Tensor  # int32[N] — march iterations (debug heatmap)


def find_node(nodes, chunk_roots, size_in_chunks, pos):
    """Locate the leaf (or depth-5) node containing each position.

    ``pos``: f32[..., 3], world-local, assumed inside the world volume.
    Fixed 5-level unrolled descent with done-masking (ray_tracer.wgsl:87-111).
    """
    w = size_in_chunks
    cc = torch.floor(pos / CHUNK_SIZE).to(torch.int32)
    chunk_idx = cc[..., 0] + cc[..., 1] * w + cc[..., 2] * (w * w)
    root = chunk_roots[_clip(chunk_idx.long(), chunk_roots)].long()

    center = cc.to(torch.float32) * CHUNK_SIZE + CHUNK_SIZE / 2.0
    size = torch.full(pos.shape[:-1], float(CHUNK_SIZE), dtype=torch.float32,
                      device=pos.device)
    idx = torch.zeros_like(root)
    done = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)

    node = _node_fetch(nodes, root + idx)
    for _ in range(5):  # CHUNK_DEPTH
        leaf = (node & nodefmt.SPLIT_MASK) == 0
        done = done | leaf
        half = size * 0.5
        gt = pos >= center
        gi = gt.to(torch.int32)
        child = gi[..., 0] + 2 * gi[..., 1] + 4 * gi[..., 2]
        nxt_idx = ((node & nodefmt.DATA_MASK) + child).long()
        child_dir = gt.to(torch.float32) * 2.0 - 1.0
        nxt_center = center + (half * 0.5)[..., None] * child_dir

        idx = torch.where(done, idx, nxt_idx)
        center = torch.where(done[..., None], center, nxt_center)
        size = torch.where(done, size, half)
        node = torch.where(done, node, _node_fetch(nodes, root + idx))

    half = (size * 0.5)[..., None]
    return FoundNodes(node=node, box_min=center - half, box_max=center + half)


def _select_step(ax):
    """Min over the three axis distances with the reference's exact
    zero-distance special-casing (ray_tracer.wgsl:247-270)."""
    x, y, z = ax[..., 0], ax[..., 1], ax[..., 2]
    xz = x == 0.0
    yz = y == 0.0
    zz = z == 0.0
    mn = torch.minimum
    return torch.where(
        xz,
        torch.where(yz, z, torch.where(zz, y, mn(y, z))),
        torch.where(
            yz,
            torch.where(zz, x, mn(x, z)),
            torch.where(zz, mn(y, x), mn(x, mn(y, z))),
        ),
    )


def _on(x, dtype, dev):
    """``x`` (a tensor, an array or a sequence) as a ``dtype`` tensor on
    ``dev``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x), dtype=dtype)
    return x.to(device=dev, dtype=dtype)


def trace_rays(world: WorldSlice, is_liquid, origin, dirs,
               max_steps=MAX_RAY_STEPS, sync_every=SYNC_EVERY):
    """March a batch of rays through the world, on the device of its
    node pool.

    Args:
      world: WorldSlice.
      is_liquid: ``bool[V]`` per-voxel liquid flags (material table column).
      origin: ``f32[3]`` shared world-local ray origin, or ``f32[N,3]``.
      dirs: ``f32[N,3]`` unit directions (any leading batch shape).
      max_steps: iteration cap (500 for the primary tracer).
      sync_every: iterations between two tests of ``any(active)``; any
        value gives the same words.

    Returns a TraceResult with the same leading batch shape as ``dirs``.
    """
    dev = world.nodes.device
    f32 = torch.float32
    dirs = _on(dirs, f32, dev)
    batch_shape = dirs.shape[:-1]
    d = dirs.reshape(-1, 3)
    n = d.shape[0]
    origin = _on(origin, f32, dev)
    if origin.ndim > 1:
        origin = origin.reshape(-1, 3)
    pos = origin.expand(n, 3)

    w = world.size_in_chunks
    world_size = float(w * CHUNK_SIZE)
    nodes = world.nodes
    chunk_roots = world.chunk_roots
    is_liquid = _on(is_liquid, torch.bool, dev)

    mask = (d >= 0.0).to(f32)
    imask = 1.0 - mask

    # Initial boundary nudge (ray_tracer.wgsl:188-190).
    near_face = ((pos - torch.floor(pos)) < RAY_EPS).any(dim=-1)
    pos = torch.where(near_face[:, None], pos + RAY_EPS * d, pos)

    # Out-of-world cameras see nothing (ray_tracer.wgsl:197-200).
    inside = ~((pos <= 0.0).any(dim=-1) | (pos >= world_size).any(dim=-1))

    # Per-axis length of a ray segment that advances one unit on that axis
    # (ray_tracer.wgsl:206-210). Axis-aligned rays have zero components:
    # the divisor is guarded, then the sentinel substituted, as in JAX.
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    def _ratio(a, b):
        ok = b.abs() > 1e-12
        r = a / torch.where(ok, b, torch.ones_like(b))
        return torch.where(ok, r, torch.full_like(r, _BIG_RATIO))

    def sq(a):
        return a * a

    usq = torch.stack(
        [
            1.0 + sq(_ratio(dy, dx)) + sq(_ratio(dz, dx)),
            1.0 + sq(_ratio(dx, dy)) + sq(_ratio(dz, dy)),
            1.0 + sq(_ratio(dx, dz)) + sq(_ratio(dy, dz)),
        ],
        dim=-1,
    )
    unit_step = torch.minimum(sqrt_rn(usq), torch.full_like(usq, _BIG))
    # -sign(d): XLA's sign keeps a zero's sign, torch's gives +0.0
    neg_sign = torch.where(d == 0.0, -d, -torch.sign(d))

    active = inside
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    voxel = torch.zeros(n, dtype=torch.int32, device=dev)
    norm = torch.zeros((n, 3), dtype=f32, device=dev)
    water_dist = torch.zeros(n, dtype=f32, device=dev)
    entered_water = torch.full((n,), -1.0, dtype=f32, device=dev)
    total_len = torch.zeros(n, dtype=f32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    minus_one = torch.full((), -1.0, dtype=f32, device=dev)

    for i in range(max_steps):
        if i % sync_every == 0 and not bool(active.any()):
            break
        found = find_node(nodes, chunk_roots, w, pos)
        vox = found.node & nodefmt.DATA_MASK
        liq = is_liquid[_clip(vox.long(), is_liquid)]

        steps = steps + active.to(torch.int32)
        hit_now = active & (vox != 0) & ~liq
        voxel = torch.where(active, vox, voxel)
        cont = active & ~hit_now

        # Liquid bookkeeping (ray_tracer.wgsl:231-242).
        in_water = entered_water != -1.0
        exit_water = cont & ~liq & in_water
        water_dist = water_dist + torch.where(
            exit_water, total_len - entered_water, zero)
        entered_water = torch.where(exit_water, minus_one, entered_water)
        enter_water = cont & liq & (entered_water == -1.0)
        entered_water = torch.where(enter_water, total_len, entered_water)

        # Advance to the node AABB exit (ray_tracer.wgsl:243-283).
        axis_dist = ((pos - found.box_min) * imask
                     + (found.box_max - pos) * mask) * unit_step
        step = _select_step(axis_dist)
        total_len = total_len + torch.where(cont, step, zero)
        stepped = (step[:, None] == axis_dist).to(f32)
        new_norm = stepped * neg_sign
        new_pos = (pos + d * (step + RAY_EPS)[:, None] * stepped
                   + d * step[:, None] * (1.0 - stepped))

        oob = cont & ((new_pos < 0.0).any(dim=-1)
                      | (new_pos >= world_size).any(dim=-1))
        # Water credit for rays that exit the world while submerged
        # (ray_tracer.wgsl:285-290).
        water_dist = water_dist + torch.where(
            oob & (entered_water != -1.0), total_len - entered_water, zero)

        pos = torch.where(cont[:, None], new_pos, pos)
        active = cont & ~oob
        hit = hit | hit_now
        norm = torch.where(cont[:, None], new_norm, norm)

    # Epilogue (ray_tracer.wgsl:291-309): rays that hit — or exhausted the
    # step budget while still active — are reported as hits; submerged
    # distance up to the hit is credited.
    hit = hit | active
    water_dist = water_dist + torch.where(
        hit & (entered_water != -1.0), total_len - entered_water, zero)

    def unflat(x):
        return x.reshape(batch_shape + x.shape[1:])

    return TraceResult(
        hit=unflat(hit),
        voxel=unflat(voxel),
        norm=unflat(norm),
        pos=unflat(pos.contiguous()),
        water_dist=unflat(water_dist),
        steps=unflat(steps),
    )
