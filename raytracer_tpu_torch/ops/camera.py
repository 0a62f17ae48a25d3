"""Fly camera producing the view/projection matrices the integrator consumes.

Reproduces `src/raytracer/camera.odin` exactly: GLM right-handed lookAt,
45-degree-fov perspective with near=0.1 / far=1000 and GL [-1,1] clip depth,
then the Vulkan Y-flip `proj[1][1] *= -1` (camera.odin:74-85). Primary rays
are generated from inverse_view/inverse_proj the same way simple.rgen:41-53
does, so keeping these conventions keeps images aligned with the reference.

Host-side (numpy): matrices are tiny and change at most once per frame; the
device only ever sees the two inverse 4x4s (the reference's camera UBO,
raytracing_renderer.odin:354-365).
"""

from __future__ import annotations

import dataclasses

import numpy as np

FOV_DEGREES = 45.0  # camera.odin:76
NEAR = 0.1  # camera.odin:77
FAR = 1000.0  # camera.odin:78


def look_at_matrix(eye, center, up):
    """GLM lookAtRH (what Odin's glsl math package implements)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_matrix(fov_y_radians, aspect, near, far):
    """GLM perspectiveRH_NO (GL clip z in [-1,1]), row-major math layout."""
    t = np.tan(fov_y_radians / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Position/forward/up/right fly camera with dirty tracking.

    `dirty` mirrors camera.odin:42,84: any change flips it, and the
    progressive renderer resets accumulation when it sees it
    (raytracing_renderer.odin:196-199).
    """

    position: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    right: np.ndarray
    aspect: float
    dirty: bool = True

    @staticmethod
    def create(position, aspect, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
        """camera_init (camera.odin:45-61); app default position is
        (0, 0, -3) looking at the origin (application.odin:50)."""
        cam = Camera(
            position=np.asarray(position, np.float32),
            forward=np.zeros(3, np.float32),
            up=np.asarray(up, np.float32),
            right=np.zeros(3, np.float32),
            aspect=float(aspect),
        )
        cam.look_at(target)
        return cam

    def look_at(self, target, up=None):
        """camera_look_at (camera.odin:63-66)."""
        if up is not None:
            self.up = np.asarray(up, np.float32)
        f = np.asarray(target, np.float32) - self.position
        self.forward = f / np.linalg.norm(f)
        self.right = np.cross(self.forward, self.up)
        self.dirty = True

    def move(self, delta):
        self.position = self.position + np.asarray(delta, np.float32)
        self.dirty = True

    # -- fly-camera controller parity (camera_controller.odin + camera.odin)
    SPEED = 5.0  # CAMERA_SPEED (camera.odin:7)
    SENSITIVITY = 0.001  # CAMERA_SENSIVITY (camera.odin:8)

    def move_direction(self, direction: str, delta_time: float):
        """camera_move (camera.odin:111-132): WASD/Space/Shift movement.
        direction in {forward, backwards, left, right, up, down}."""
        vec = {
            "forward": self.forward,
            "backwards": -self.forward,
            "right": self.right,
            "left": -self.right,
            "up": self.up,
            "down": -self.up,
        }[direction]
        self.position = self.position + vec * (self.SPEED * delta_time)
        self.dirty = True

    def process_mouse(self, dx: float, dy: float):
        """camera_process_mouse (camera.odin:87-109): RMB-drag look.
        Rotates forward by -dy*sens around `right` (pitch) and -dx*sens
        around world Y (yaw), then recomputes right."""

        def axis_angle(axis, angle):
            axis = np.asarray(axis, np.float64)
            axis = axis / np.linalg.norm(axis)
            c, s = np.cos(angle), np.sin(angle)
            x, y, z = axis
            return np.asarray([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)],
            ])

        pitch = axis_angle(self.right, -dy * self.SENSITIVITY)
        yaw = axis_angle([0.0, 1.0, 0.0], -dx * self.SENSITIVITY)
        rot = pitch @ yaw
        f = rot @ self.forward.astype(np.float64)
        self.forward = (f / np.linalg.norm(f)).astype(np.float32)
        self.right = np.cross(self.forward, self.up)
        self.dirty = True

    def on_resize(self, aspect):
        """camera_on_resize (camera.odin:69-72)."""
        self.aspect = float(aspect)
        self.dirty = True

    def matrices(self):
        """camera_update_matrices (camera.odin:74-85). Returns a dict with
        proj/view/inverse_view/inverse_proj f32[4,4] (the camera UBO)."""
        view = look_at_matrix(
            self.position, self.position + self.forward, self.up
        )
        proj = perspective_matrix(
            np.radians(FOV_DEGREES), self.aspect, NEAR, FAR
        )
        proj = proj.copy()
        proj[1, 1] *= -1.0  # Vulkan Y-flip (camera.odin:80)
        return {
            "proj": proj,
            "view": view,
            "inverse_view": np.linalg.inv(view).astype(np.float32),
            "inverse_proj": np.linalg.inv(proj).astype(np.float32),
        }

    def clear_dirty(self):
        self.dirty = False
