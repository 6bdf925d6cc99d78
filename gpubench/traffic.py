"""The general generator of the benchmark's traffic: a mix is a data file,
``traffic/<mix>.json``, that this module reads. It names the entry the
window drives (``entries/<entry>.py``), the camera path, the key of each
frame, the frames kept in flight and the frames the check compares.

Camera paths:

* ``"still"``: the configuration's camera (``camera``: the land point plus
  ``offset``, ``rot_deg``, ``fov_deg``) in every frame;
* ``"walk"``: a closed walk of ``poses`` poses on a circle of ``radius``
  voxels about the land point, the eye ``eye_height`` above the highest
  voxel of its column, heading along the circle and looking up to
  ``look_deg`` to either side and ``pitch_deg`` up or down; the seed picks
  the pose the window starts at, so every seed walks the same poses in
  another order.

Keys: ``"none"``, or ``"per_frame"``: raw key words ``(seed mod 2**32,
frame)``, a new key every frame.
"""

import json
import math

import numpy as np

from .camera import camera
from .inputs import ROOT, top_solid

M32 = 0xFFFFFFFF


def load(kind, name):
    """``configs/<name>.json``, ``traffic/<name>.json`` or
    ``cells/<name>.json`` under the benchmark."""
    with open(ROOT / "gpubench" / kind / f"{name}.json") as f:
        return json.load(f)


def sun_position(cfg, eye):
    """The configuration's sun: ``sun_pos`` in world voxels, or
    ``sun_from_eye``: ``[dx, y, dz]``, the sun at ``(eye.x + dx, y, eye.z +
    dz)`` (benchmarks/run.py's config5)."""
    if "sun_pos" in cfg:
        return tuple(float(a) for a in cfg["sun_pos"])
    dx, y, dz = cfg["sun_from_eye"]
    return (float(eye[0]) + dx, float(y), float(eye[2]) + dz)


class Frames:
    """The cameras and keys of a mix's frames on a world."""

    def __init__(self, mix, cfg, world, seed):
        self.mix, self.cfg, self.seed = mix, cfg, int(seed)
        size = tuple(cfg["resolution"])
        path = mix["camera_path"]
        x, h, z = world.land
        if path["kind"] == "still":
            c = cfg["camera"]
            eye = tuple(float(a + b) for a, b in zip((x, h, z), c["offset"]))
            self.cams = [camera(c["rot_deg"], eye, c["fov_deg"], size)]
            self.start = 0
        elif path["kind"] == "walk":
            n = int(path["poses"])
            self.cams = []
            for k in range(n):
                a = 2.0 * math.pi * k / n
                px = x + 0.5 + path["radius"] * math.cos(a)
                pz = z + 0.5 + path["radius"] * math.sin(a)
                ground = top_solid(world, int(math.floor(px)), int(math.floor(pz)))
                eye = (px, ground + 1.0 + cfg["eye_height"], pz)
                heading = math.degrees(a) + 180.0    # along the circle
                yaw = heading + path["look_deg"] * math.sin(2.0 * a)
                pitch = path["pitch_deg"] * math.sin(3.0 * a)
                self.cams.append(camera((pitch, yaw % 360.0, 0.0), eye,
                                        cfg["camera"]["fov_deg"], size))
            self.start = self.seed % n
        else:
            raise ValueError(f"unknown camera path {path['kind']!r}")
        self.sun = sun_position(cfg, self.cams[0].pos)

    def camera(self, i):
        return self.cams[(self.start + i) % len(self.cams)]

    def key(self, i):
        if self.mix["keys"] == "none":
            return None
        if self.mix["keys"] == "per_frame":
            return np.array([self.seed & M32, i & M32], np.uint32)
        raise ValueError(f"unknown keys {self.mix['keys']!r}")


def check_sample(mix, seed, n_safe):
    """The frames the check compares: one drawn from the seed in each of
    ``check_frames`` equal strata of the first ``n_safe`` frames, the
    frames the window is sure to finish."""
    n = min(int(mix["check_frames"]), n_safe)
    rng = np.random.default_rng([int(seed) & M32, (int(seed) >> 32) & M32, 0xC4EC])
    edges = np.linspace(0, n_safe, n + 1).astype(np.int64)
    return sorted({int(rng.integers(lo, max(hi, lo + 1)))
                   for lo, hi in zip(edges[:-1], edges[1:])})
