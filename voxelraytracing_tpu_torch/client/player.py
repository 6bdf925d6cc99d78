"""First-person player controller.

Port of ``voxelraytracing_tpu/client/player.py``.

Semantics match the reference controller (client/src/player.rs): gravity
−0.050/tick with ×0.95 drag, jump velocity 0.6, fly toggle, sprint ×1.5,
mouse look with pitch clamped to ±90°, swept-AABB collision clipping with
auto-jump (retry the move 1.1 higher; hop if it clears), and a smoothed
camera that floats back to eye height after landing.

All host-side NumPy: per-event, latency-sensitive, tiny (SURVEY §7).
"""

from dataclasses import dataclass, field

import numpy as np

from ..core.math import Aabb, axis_rot_to_ray, vec3

GRAVITY = -0.050
JUMP_VELOCITY = 0.6
DRAG = 0.95
SPRINT_MULT = 1.5
SENSITIVITY = 0.3
WIDTH = 0.9
AUTOJUMP_RISE = 1.1


@dataclass
class PlayerInput:
    cursor_movement: tuple = (0.0, 0.0)
    left: bool = False
    right: bool = False
    forward: bool = False
    backward: bool = False
    jump: bool = False
    crouch: bool = False
    toggle_fly: bool = False
    sprint: bool = False


@dataclass
class PlayerMovement:
    new_cam: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    cam_moved: bool = False
    new_vel: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    frame_vel: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    flying: bool = False
    jumped: bool = False


class Player:
    def __init__(self, pos, speed=0.2):
        self.fov = 70.0
        self.flying = False
        self.on_ground = False
        self.jumped = False
        self.pos = np.asarray(pos, np.float32).copy()
        self.height = 4.0
        self.cam_pos = self.pos + vec3(0.0, self.height, 0.0)
        self.rot = np.zeros(3, np.float32)  # degrees (pitch, yaw, roll)
        self.vel = np.zeros(3, np.float32)
        self.speed = speed

    def desired_cam_pos(self):
        return self.pos + vec3(0.0, self.height, 0.0)

    def facing(self):
        return axis_rot_to_ray(np.deg2rad(self.rot))

    def create_aabb(self):
        half = vec3(WIDTH * 0.5, 0.0, WIDTH * 0.5)
        return Aabb(self.pos - half, self.pos + vec3(WIDTH * 0.5, self.height, WIDTH * 0.5))

    def process_input(self, t_delta, inp: PlayerInput):
        dx = np.sin(np.deg2rad(self.rot[1])) * self.speed
        dz = np.cos(np.deg2rad(self.rot[1])) * self.speed
        rs = PlayerMovement()

        delta = np.asarray(inp.cursor_movement, np.float32) * t_delta
        rs.new_cam = self.rot.copy()
        rs.new_cam[0] = float(np.clip(self.rot[0] + SENSITIVITY * delta[1], -90.0, 90.0))
        rs.new_cam[1] = self.rot[1] - SENSITIVITY * delta[0]
        rs.cam_moved = not np.array_equal(self.rot, rs.new_cam)

        rs.new_vel = self.vel.copy()
        if self.flying:
            rs.new_vel[1] = 0.0
        else:
            rs.new_vel[1] += GRAVITY
        rs.new_vel *= DRAG

        frame_vel = rs.new_vel.copy()
        rs.flying = self.flying
        if inp.toggle_fly:
            rs.flying = not rs.flying
            if rs.flying:
                rs.new_vel = np.zeros(3, np.float32)
                return rs

        if inp.forward:
            frame_vel[0] += -dx
            frame_vel[2] += -dz
        if inp.backward:
            frame_vel[0] += dx
            frame_vel[2] += dz
        if inp.right:
            frame_vel[0] += dz
            frame_vel[2] += -dx
        if inp.left:
            frame_vel[0] += -dz
            frame_vel[2] += dx
        if self.flying:
            if inp.jump:
                frame_vel[1] += self.speed
            if inp.crouch:
                frame_vel[1] -= self.speed
        elif inp.jump and self.on_ground:
            rs.new_vel[1] = JUMP_VELOCITY
            frame_vel[1] = JUMP_VELOCITY
            rs.jumped = True
        if inp.sprint:
            frame_vel = frame_vel * SPRINT_MULT
        rs.frame_vel = frame_vel * t_delta
        return rs

    def update(self, mv: PlayerMovement, collisions):
        """Advance one tick. ``collisions(aabb) -> [Aabb]`` queries the world."""
        self.vel = mv.new_vel
        self.rot = mv.new_cam
        self.flying = mv.flying
        self.jumped = self.jumped or mv.jumped

        if self.flying:
            self.pos = self.pos + mv.frame_vel
        else:
            clipped = clip_aabb_movement(self.create_aabb(), mv.frame_vel, collisions, True)
            self.pos = self.pos + clipped
            self.on_ground = abs(float(clipped[1])) < 0.001 and mv.frame_vel[1] < 0.001
            if self.on_ground:
                self.jumped = False

        if self.flying or self.jumped:
            self.cam_pos = self.desired_cam_pos()
        else:
            want = self.desired_cam_pos()
            dist = float(np.linalg.norm(want - self.cam_pos))
            if dist > 0.01:
                speed = min(max(dist * 0.1, 0.1), dist)
                self.cam_pos = self.cam_pos + (want - self.cam_pos) / dist * speed
                self.cam_pos[0] = self.pos[0]
                self.cam_pos[2] = self.pos[2]


def clip_aabb_movement(bbox, mv, collisions, autojump=True):
    """Clip a swept move against world boxes, with auto-jump retry
    (reference: client/src/player.rs:203-244)."""
    mv = np.asarray(mv, np.float32)

    def clip(box, m):
        out = m.copy()
        for wb in collisions(box.expand(out)):
            out[1] = wb.clip_y_collide(box, float(out[1]))
            out[0] = wb.clip_x_collide(box, float(out[0]))
            out[2] = wb.clip_z_collide(box, float(out[2]))
        return out

    clipped = clip(bbox, mv)
    eq = clipped == mv
    if autojump and (not eq[0] or not eq[2]):
        raised = bbox.translate(vec3(0.0, AUTOJUMP_RISE, 0.0))
        jmp = clip(raised, mv)
        jmp[1] = 0.0
        if np.any(np.abs(jmp) > np.abs(clipped)):
            clipped = clipped.copy()
            clipped[1] += 1.0
            clipped[0] = jmp[0]
            clipped[2] = jmp[2]
    return clipped
