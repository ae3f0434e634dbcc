"""Camera: view/projection matrices, trackball, optimal-view fit, animation.

Numpy copy of viamd_tpu/render/camera.py (host-only: no device code), so the
port builds the same matrices without importing the JAX package.

Capability mirror of src/gfx/camera.h + camera_utils.{h,cpp} (reference:
quaternion ViewTransform, trackball controller, persp/ortho ± jitter,
compute_optimal_view from AABB/PCA at the reference's src/main.cpp:1100-1103,
exponential camera animation).

All matrices are float32 NumPy (host-side scene setup); the render kernels
consume them as small device constants. Convention: right-handed, camera
looks down -Z in view space, matrices are row-vector-on-the-right
(v' = M @ v with column vectors).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def normalize(v):
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    return (v / n if n > 0 else v).astype(np.float64)


def look_at(eye, center, up) -> np.ndarray:
    """4×4 world→view matrix."""
    eye = np.asarray(eye, np.float64)
    f = normalize(np.asarray(center) - eye)
    s = normalize(np.cross(f, normalize(up)))
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def perspective(
    fovy_rad: float, aspect: float, znear: float, zfar: float,
    jitter_xy: tuple = (0.0, 0.0),
) -> np.ndarray:
    """4×4 view→clip perspective; jitter in NDC pixels for TAA (the 8-sample
    Halton jitter of main.cpp:472-476 plugs in here)."""
    t = 1.0 / np.tan(fovy_rad / 2)
    m = np.zeros((4, 4))
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    m[0, 2] = jitter_xy[0]
    m[1, 2] = jitter_xy[1]
    return m.astype(np.float32)


def orthographic(
    left, right, bottom, top, znear, zfar
) -> np.ndarray:
    m = np.eye(4)
    m[0, 0] = 2 / (right - left)
    m[1, 1] = 2 / (top - bottom)
    m[2, 2] = -2 / (zfar - znear)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(zfar + znear) / (zfar - znear)
    return m.astype(np.float32)


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence (main.cpp:472 jitter source)."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def taa_jitter_sequence(n: int = 8) -> np.ndarray:
    """(n,2) Halton(2,3) jitter offsets in [-0.5, 0.5] pixels."""
    return np.array(
        [[halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5] for i in range(n)],
        np.float32,
    )


@dataclasses.dataclass
class Camera:
    eye: np.ndarray
    center: np.ndarray
    up: np.ndarray
    fovy: float = np.radians(45.0)
    znear: float = 0.1
    zfar: float = 10000.0

    def view_matrix(self) -> np.ndarray:
        return look_at(self.eye, self.center, self.up)

    def proj_matrix(self, width: int, height: int, jitter=(0.0, 0.0)) -> np.ndarray:
        return perspective(
            self.fovy, width / max(height, 1), self.znear, self.zfar,
            (2.0 * jitter[0] / width, 2.0 * jitter[1] / height),
        )

    def distance(self) -> float:
        return float(np.linalg.norm(np.asarray(self.eye) - np.asarray(self.center)))


def compute_optimal_view(
    aabb_min, aabb_max, fovy: float = np.radians(45.0), fill: float = 0.8
) -> Camera:
    """Fit camera to an AABB (compute_optimal_view, camera_utils.h:120)."""
    lo = np.asarray(aabb_min, np.float64)
    hi = np.asarray(aabb_max, np.float64)
    center = 0.5 * (lo + hi)
    radius = 0.5 * float(np.linalg.norm(hi - lo)) + 1e-6
    dist = radius / (np.tan(fovy / 2) * fill)
    eye = center + normalize([1.0, 0.5, 1.0]) * dist
    return Camera(
        eye=eye.astype(np.float32),
        center=center.astype(np.float32),
        up=np.array([0, 1, 0], np.float32),
        fovy=fovy,
        znear=max(dist / 1000.0, 0.01),
        zfar=dist + 4 * radius,
    )


def trackball_rotate(cam: Camera, dx: float, dy: float, speed=4.0) -> Camera:
    """Orbit the eye about the center (camera_controller_trackball analog)."""
    offset = np.asarray(cam.eye, np.float64) - cam.center
    r = np.linalg.norm(offset)
    theta = np.arctan2(offset[0], offset[2]) - dx * speed
    phi = np.arccos(np.clip(offset[1] / r, -1, 1)) + dy * speed
    phi = np.clip(phi, 0.05, np.pi - 0.05)
    new_off = r * np.array(
        [np.sin(phi) * np.sin(theta), np.cos(phi), np.sin(phi) * np.cos(theta)]
    )
    return dataclasses.replace(
        cam, eye=(np.asarray(cam.center) + new_off).astype(np.float32)
    )


def camera_animate(cam: Camera, target: Camera, dt: float, speed=10.0) -> Camera:
    """Exponential approach to a target view (camera_animate analog)."""
    t = 1.0 - np.exp(-dt * speed)
    return Camera(
        eye=(cam.eye + (target.eye - cam.eye) * t).astype(np.float32),
        center=(cam.center + (target.center - cam.center) * t).astype(np.float32),
        up=target.up,
        fovy=cam.fovy + (target.fovy - cam.fovy) * t,
        znear=target.znear,
        zfar=target.zfar,
    )
