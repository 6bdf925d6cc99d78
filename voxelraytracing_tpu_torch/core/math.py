"""Host-side geometry: swept AABBs, CPU DDA picking, 3D line walk, random dirs.

Small, latency-sensitive routines used by the interactive layer (player
physics, block picking, feature building). They run per-event on the host, so
plain NumPy is the right tool; the per-pixel equivalents live in ``ops/``.

Reference: common/src/math.rs. Port of ``voxelraytracing_tpu/core/math.py``
(host NumPy, unchanged; the random helpers draw from the NumPy
``Generator`` the caller passes).
"""

import math

import numpy as np

EPSILON = 1e-5


def vec3(x, y, z):
    return np.array([x, y, z], dtype=np.float32)


class Aabb:
    """Axis-aligned box with swept-collision clipping (reference: math.rs:5-126)."""

    __slots__ = ("from_", "to")

    def __init__(self, from_, to):
        self.from_ = np.asarray(from_, dtype=np.float32)
        self.to = np.asarray(to, dtype=np.float32)

    def expand(self, a):
        """Grow the box along the direction of motion ``a`` (reference: math.rs:18-44)."""
        a = np.asarray(a, dtype=np.float32)
        from_ = self.from_ + np.minimum(a, 0.0)
        to = self.to + np.maximum(a, 0.0)
        return Aabb(from_, to)

    def grow(self, a):
        a = np.asarray(a, dtype=np.float32)
        return Aabb(self.from_ - a, self.to + a)

    def translate(self, a):
        a = np.asarray(a, dtype=np.float32)
        return Aabb(self.from_ + a, self.to + a)

    def intersects(self, c):
        return bool(
            np.all(c.to > self.from_) and np.all(c.from_ < self.to)
        )

    def _clip_axis_collide(self, c, a, axis):
        """Clip movement ``a`` of box ``c`` along ``axis`` against ``self``.

        Matches the reference's per-axis clip functions (math.rs:50-115):
        if the boxes overlap on both *other* axes, the motion is clamped so
        ``c`` stops EPSILON short of ``self``.
        """
        others = [i for i in range(3) if i != axis]
        for o in others:
            if c.to[o] <= self.from_[o] or c.from_[o] >= self.to[o]:
                return a
        if a > 0.0 and c.to[axis] <= self.from_[axis]:
            m = float(self.from_[axis] - c.to[axis]) - EPSILON
            if m < a:
                a = m
        if a < 0.0 and c.from_[axis] >= self.to[axis]:
            m = float(self.to[axis] - c.from_[axis]) + EPSILON
            if m > a:
                a = m
        return a

    def clip_x_collide(self, c, a):
        return self._clip_axis_collide(c, a, 0)

    def clip_y_collide(self, c, a):
        return self._clip_axis_collide(c, a, 1)

    def clip_z_collide(self, c, a):
        return self._clip_axis_collide(c, a, 2)


def axis_rot_to_ray(rot):
    """Euler rotation (radians) -> unit facing vector (reference: math.rs:131-146)."""
    r = math.cos(rot[0])
    x = r * -math.sin(rot[1])
    z = r * -math.cos(rot[1])
    y = -math.sin(rot[0])
    return vec3(x, y, z)


def cast_ray(start, direction, max_dist, collides):
    """Classic voxel DDA; returns ``(hit_pos, face)`` or ``None``.

    Used for the player's "looking at" picking with small ``max_dist``
    (reference: math.rs:153-226). ``collides(ivec3) -> bool``.
    """
    start = np.asarray(start, dtype=np.float32)
    d = np.asarray(direction, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        unit = np.sqrt(
            1.0
            + np.stack(
                [
                    (d[1] / d[0]) ** 2 + (d[2] / d[0]) ** 2,
                    (d[0] / d[1]) ** 2 + (d[2] / d[1]) ** 2,
                    (d[0] / d[2]) ** 2 + (d[1] / d[2]) ** 2,
                ]
            )
        )
    map_check = np.floor(start).astype(np.int64)
    step = np.where(d < 0.0, -1, 1).astype(np.int64)
    ray_len = np.where(
        d < 0.0,
        (start - map_check) * unit,
        (map_check + 1 - start) * unit,
    ).astype(np.float32)

    dist = 0.0
    while dist < max_dist:
        prev = map_check.copy()
        if ray_len[0] < ray_len[1] and ray_len[0] < ray_len[2]:
            map_check[0] += step[0]
            dist = float(ray_len[0])
            ray_len[0] += unit[0]
        elif ray_len[2] < ray_len[0] and ray_len[2] < ray_len[1]:
            map_check[2] += step[2]
            dist = float(ray_len[2])
            ray_len[2] += unit[2]
        else:
            map_check[1] += step[1]
            dist = float(ray_len[1])
            ray_len[1] += unit[1]
        if collides(map_check):
            return map_check.copy(), prev - map_check
    return None


def walk_line(a, b):
    """3D Bresenham walk from ``a`` to ``b`` inclusive (reference: math.rs:228-324)."""
    a = np.asarray(a, dtype=np.int64).copy()
    b = np.asarray(b, dtype=np.int64)
    dist = np.abs(b - a)
    step = np.where(b > a, 1, -1)
    yield a.copy()

    if dist[0] >= dist[1] and dist[0] >= dist[2]:
        drive, s1, s2 = 0, 1, 2
    elif dist[1] >= dist[0] and dist[1] >= dist[2]:
        drive, s1, s2 = 1, 0, 2
    else:
        drive, s1, s2 = 2, 1, 0
    p1 = 2 * dist[s1] - dist[drive]
    p2 = 2 * dist[s2] - dist[drive]
    while a[drive] != b[drive]:
        a[drive] += step[drive]
        if p1 >= 0:
            a[s1] += step[s1]
            p1 -= 2 * dist[drive]
        if p2 >= 0:
            a[s2] += step[s2]
            p2 -= 2 * dist[drive]
        p1 += 2 * dist[s1]
        p2 += 2 * dist[s2]
        yield a.copy()


_CARDINALS = np.array([[-1, 0, 0], [1, 0, 0], [0, 0, -1], [0, 0, 1]], dtype=np.int64)


def rand_cardinal_dir(rng):
    """Random horizontal unit step (reference: math.rs:326-333)."""
    return _CARDINALS[rng.integers(0, 4)].copy()


def rand_dir(rng):
    """Normal-distributed random unit vector (reference: math.rs:335-346)."""
    v = rng.normal(size=3).astype(np.float32)
    return v / np.linalg.norm(v)


def rand_hem_dir(rng, norm):
    """Random unit vector in the hemisphere around ``norm`` (reference: math.rs:348-351)."""
    d = rand_dir(rng)
    s = np.sign(np.dot(np.asarray(norm, dtype=np.float32), d))
    return d * (s if s != 0 else 1.0)
