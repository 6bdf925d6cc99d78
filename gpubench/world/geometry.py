# Frozen copy of walk_line, rand_cardinal_dir, rand_dir and rand_hem_dir from
# voxelraytracing_tpu_torch/core/math.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).

"""Host geometry the feature builder draws with (core/math.py)."""

import numpy as np


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
