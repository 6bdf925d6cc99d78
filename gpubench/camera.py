# The matrix arithmetic below is a frozen copy of CamData.create from
# voxelraytracing_tpu_torch/ops/camera.py at commit
# 5046bbb1c27cf55a0e0985dd2724f80b90766057 (the benchmark's yardstick).

"""Cameras the benchmark hands to both sides: the eye, the inverse view and
projection matrices and the frame size, as the upstream client builds them
(clientdesktop/src/graphics/mod.rs:92-110): an inverse view ``T(eye) ·
Rx(pitch) · Ry(-yaw) · Rz(roll)`` and an inverted right-handed perspective
(glam's ``perspective_rh``, near 0.001, far 1000)."""

from dataclasses import dataclass

import numpy as np


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float64)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    dtype=np.float64)


def _translation(t):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def _perspective_rh(fov_y, aspect, z_near, z_far):
    h = np.cos(0.5 * fov_y) / np.sin(0.5 * fov_y)
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = h / aspect
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


@dataclass(frozen=True)
class Camera:
    """One frame's camera, in the fields the program's frame entries read."""

    pos: np.ndarray       # f32[3] eye, world coordinates
    inv_view: np.ndarray  # f32[4, 4]
    inv_proj: np.ndarray  # f32[4, 4]
    proj_size: tuple      # (width, height)


def camera(rot_deg, eye, fov_deg, size):
    """``rot_deg`` = (pitch, yaw, roll) in degrees."""
    rot = np.deg2rad(np.asarray(rot_deg, dtype=np.float64))
    inv_view = (_translation(np.asarray(eye, dtype=np.float64)) @ _rot_x(rot[0])
                @ _rot_y(-rot[1]) @ _rot_z(rot[2]))
    inv_proj = np.linalg.inv(_perspective_rh(np.deg2rad(fov_deg),
                                             size[0] / size[1], 0.001, 1000.0))
    return Camera(pos=np.asarray(eye, dtype=np.float32),
                  inv_view=inv_view.astype(np.float32),
                  inv_proj=inv_proj.astype(np.float32),
                  proj_size=(int(size[0]), int(size[1])))
