"""Camera model: inverse view/projection matrices and per-pixel ray generation.

Port of ``voxelraytracing_tpu/ops/camera.py``. The host builds an inverse
view matrix ``T(eye) · Rx(pitch) · Ry(-yaw) · Rz(roll)`` and an inverted
right-handed perspective matrix (clientdesktop/src/graphics/mod.rs:92-110);
rays unproject each pixel with *row-vector* products, i.e. ``v · M ≡ Mᵀ v``
(ray_tracer.wgsl:159-171). ``CamData`` is host data (NumPy); ray
generation runs in torch on any device, one rounding per multiply and add
in the JAX source's order. That equals the JAX function evaluated op by op
(``jax.disable_jit()``); XLA's CPU compiler contracts ``a*b+c`` into FMAs
inside a fused program, which moves some directions by an ulp.
"""

from dataclasses import dataclass

import numpy as np
import torch


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array(
        [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def _translation(t):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def _perspective_rh(fov_y, aspect, z_near, z_far):
    """Right-handed, zero-to-one depth — glam's ``Mat4::perspective_rh``."""
    h = np.cos(0.5 * fov_y) / np.sin(0.5 * fov_y)
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


@dataclass(frozen=True)
class CamData:
    """Everything the tracer needs about the camera (one frame)."""

    pos: np.ndarray  # f32[3] — eye position, world coordinates
    inv_view: np.ndarray  # f32[4,4]
    inv_proj: np.ndarray  # f32[4,4]
    proj_size: tuple  # (width, height) in pixels

    @classmethod
    def create(cls, rot_deg, eye, fov_deg, proj_size):
        """rot_deg = (pitch, yaw, roll) in degrees; mirrors CamData::create
        (clientdesktop/src/graphics/mod.rs:93-110)."""
        rot = np.deg2rad(np.asarray(rot_deg, dtype=np.float64))
        inv_view = (
            _translation(np.asarray(eye, dtype=np.float64))
            @ _rot_x(rot[0])
            @ _rot_y(-rot[1])
            @ _rot_z(rot[2])
        )
        aspect = proj_size[0] / proj_size[1]
        inv_proj = np.linalg.inv(
            _perspective_rh(np.deg2rad(fov_deg), aspect, 0.001, 1000.0)
        )
        return cls(
            pos=np.asarray(eye, dtype=np.float32),
            inv_view=inv_view.astype(np.float32),
            inv_proj=inv_proj.astype(np.float32),
            proj_size=(int(proj_size[0]), int(proj_size[1])),
        )


def sqrt_rn(x):
    """Correctly rounded float32 square root. torch.sqrt on CPU tensors
    takes a vectorized approximation that misses IEEE rounding in about
    one value in 200; on CUDA it is the IEEE ``sqrtf`` the kernels use."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _f32(x, device):
    """A 0-d float32 tensor on ``device``. Dividing by it (never by a Python
    number) keeps IEEE division on CUDA, where torch turns division by a
    host scalar into a multiply by its reciprocal."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def generate_rays_raw(
    inv_view, inv_proj, cam_pos, width, height, world_min, y0=0, full_height=None,
    device="cuda",
):
    """Per-pixel primary rays, world-local coordinates.

    Returns ``(origin f32[3], dirs f32[H, W, 3])`` on ``device``, the card
    unless the caller asks for the CPU; the origin is shared by every pixel
    (ray_tracer.wgsl:159-171). ``y0``/``full_height`` select a horizontal
    band of a taller frame: band ``i`` of ``n`` is ``y0=i*height,
    full_height=n*height``.
    """
    f32 = torch.float32
    w, h = width, height
    fh = full_height if full_height is not None else h
    px = torch.arange(w, dtype=f32, device=device)
    py = torch.arange(h, dtype=f32, device=device) + float(np.float32(y0))
    x = (px * 2.0) / _f32(w, device) - 1.0
    y = (py * 2.0) / _f32(fh, device) - 1.0
    yg, xg = torch.meshgrid(y, x, indexing="ij")  # [H, W]

    one = torch.ones_like(xg)
    clip = torch.stack([xg, -yg, -one, one], dim=-1)  # [H, W, 4]
    inv_proj = torch.as_tensor(np.asarray(inv_proj, np.float32), device=device)
    inv_view = torch.as_tensor(np.asarray(inv_view, np.float32), device=device)

    def row_vec_mul(v, m):
        # v · M as explicit f32 multiply-adds in a fixed order (never a
        # matmul: TF32 or a blocked sum would change the rounding)
        return ((v[..., 0, None] * m[0] + v[..., 1, None] * m[1])
                + (v[..., 2, None] * m[2] + v[..., 3, None] * m[3]))

    eye0 = row_vec_mul(clip, inv_proj)
    eye = torch.cat(
        [eye0[..., :2], -torch.ones_like(eye0[..., :1]),
         torch.zeros_like(eye0[..., :1])],
        dim=-1,
    )
    d = row_vec_mul(eye, inv_view)[..., :3]
    n = sqrt_rn(
        (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    )
    dirs = d / n[..., None]

    origin = (torch.as_tensor(np.asarray(cam_pos, np.float32), device=device)
              - torch.as_tensor(np.asarray(world_min, np.float32), device=device))
    return origin, dirs


def generate_rays(cam: CamData, world_min, device="cuda"):
    """Convenience wrapper over :func:`generate_rays_raw` for a CamData."""
    w, h = cam.proj_size
    return generate_rays_raw(cam.inv_view, cam.inv_proj, cam.pos, w, h,
                             world_min, device=device)
