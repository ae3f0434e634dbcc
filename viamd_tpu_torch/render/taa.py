"""Velocity-reprojected temporal antialiasing resolve (TAA).

Torch port of viamd_tpu/render/taa.py (the reference's temporal resolve,
VIAMD src/shaders/temporal.frag:374-560, the Playdead "Temporal
Reprojection Anti-Aliasing" formulation) in the shader's shipping
configuration: 3x3 closest-fragment velocity dilation, the unjittered
current sample, the rounded 3x3 neighbourhood min/max, the centre-clip
AABB history clamp, Lottes' unbiased-luminance feedback between 0.88 and
0.97, and the motion-blur half (neighbour-max velocity, the velocity-trust
blend, an 11-tap triangle-weighted line blur with a per-pixel noise
offset).

The 3x3 stencils are whole-image rolls, as in the JAX package. The
bilinear fetches (`_sample_bilinear`) are postprocess.py's four-gather
`_map_coordinates`, with the edge rule of jax.scipy.ndimage.
map_coordinates(order=1, mode="constant"): a corner outside the image
contributes 0 with its weight (the coordinates are clamped into the image
first, so only a zero-weight corner ever falls outside). The noise of the line blur uses bokeh.py's sin hash, the same on
every device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from viamd_tpu_torch.ops.rdf import div_rn
from viamd_tpu_torch.render.bokeh import _glsl_sin
from viamd_tpu_torch.render.postprocess import _map_coordinates, velocity_dilate

_NINE = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
         (1, -1), (1, 0), (1, 1)]
_LUMA_W = (0.2125, 0.7154, 0.0721)  # temporal.frag:97


def _roll2(a, dy, dx):
    """a[y + dy, x + dx] at every pixel (a texture tap at uv + (dx, dy)
    texels, wrapping at the edges)."""
    return torch.roll(a, (-dy, -dx), (0, 1))


def _sample_bilinear(img, yy, xx):
    """Clamped bilinear fetch of (H, W, C) at float pixel coords (H, W)."""
    H, W = img.shape[:2]
    return _map_coordinates(img, yy.clamp(0.0, H - 1.0), xx.clamp(0.0, W - 1.0))


def _pixel_grid(H: int, W: int, dev):
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    return yy, xx


def closest_fragment_velocity(view_depth, velocity):
    """3x3 closest-fragment velocity dilation (find_closest_fragment_3x3,
    temporal.frag:158-188): each pixel takes the velocity of its nearest
    (least linear depth) 3x3 neighbour, the first of equals in _NINE
    order. → (ss_vel (H, W, 2), vs_dist (H, W))."""
    d = torch.where(torch.isfinite(view_depth), view_depth,
                    torch.full_like(view_depth, 3.0e38))
    ds = torch.stack([_roll2(d, dy, dx) for dy, dx in _NINE])
    vs_dist = ds.amin(dim=0)
    k = ds.argmin(dim=0)  # the first minimum, as jnp.argmin
    ss_vel = torch.zeros_like(velocity)
    for i, (dy, dx) in enumerate(_NINE):
        ss_vel = torch.where((k == i)[..., None], _roll2(velocity, dy, dx), ss_vel)
    return ss_vel, vs_dist


def clip_aabb(cmin, cmax, p, q):
    """Centre-clip q toward the AABB [cmin, cmax] (clip_aabb
    USE_OPTIMIZATIONS branch, temporal.frag:222-238)."""
    eps = 1e-7
    p_clip = 0.5 * (cmax + cmin)
    e_clip = 0.5 * (cmax - cmin) + eps
    v_clip = q - p_clip
    a_unit = (v_clip / e_clip).abs()
    ma = a_unit.amax(dim=-1, keepdim=True)
    return torch.where(ma > 1.0, p_clip + v_clip / ma, q)


def _neighborhood_rounded(curr):
    """Rounded 3x3 min/max/avg (MINMAX_3X3_ROUNDED, temporal.frag:
    404-426): the mean of the full 3x3 stats and the 5-tap cross stats."""
    taps = [_roll2(curr, dy, dx) for dy, dx in _NINE]
    stack9 = torch.stack(taps)
    cross = torch.stack([taps[i] for i in (1, 3, 4, 5, 7)])
    cmin9, cmax9 = stack9.amin(0), stack9.amax(0)
    cmin5, cmax5 = cross.amin(0), cross.amax(0)
    cavg9 = _mean(taps)
    cavg5 = _mean([taps[i] for i in (1, 3, 4, 5, 7)])
    return 0.5 * (cmin9 + cmin5), 0.5 * (cmax9 + cmax5), 0.5 * (cavg9 + cavg5)


def _mean(taps):
    """Mean of a list of equal-shape tensors, summed in list order."""
    acc = taps[0]
    for t in taps[1:]:
        acc = acc + t
    return acc / float(len(taps))


def sample_color_motion(curr, ss_vel, time_seed: float = 0.0):
    """11-tap triangle-weighted line blur along the velocity
    (sample_color_motion, temporal.frag:286-306): taps at pos0 +
    i·v/(2·taps) for i in [−taps, taps], pos0 offset by a per-pixel
    PDsrand noise that breaks the trailing shell into noise."""
    H, W = curr.shape[:2]
    taps = 5
    v = 0.5 * ss_vel
    vtap = v / taps
    yy, xx = _pixel_grid(H, W, curr.device)
    # PDsrand(uv + time) (temporal.frag:102,116): fract-sin hash → [−1, 1]
    n = _glsl_sin(div_rn(xx, W) + time_seed, div_rn(yy, H) + time_seed) * 43758.5453
    srand = (n - torch.floor(n)) * 2.0 - 1.0
    y0 = yy + srand * vtap[..., 1] * 0.5
    x0 = xx + srand * vtap[..., 0] * 0.5
    acc = torch.zeros_like(curr)
    wsum = 0.0
    for i in range(-taps, taps + 1):
        wgt = float(taps - abs(i) + 1)
        acc = acc + wgt * _sample_bilinear(curr, y0 + i * vtap[..., 1], x0 + i * vtap[..., 0])
        wsum += wgt
    return acc / wsum


def taa_resolve(
    curr,
    history,
    velocity,
    view_depth,
    jitter_px=(0.0, 0.0),
    feedback_min: float = 0.88,
    feedback_max: float = 0.97,
    motion_blur: bool = False,
    motion_scale: float = 1.0,
    time_seed: float = 0.0,
):
    """One temporal resolve step (temporal.frag main, :487-560), on the
    device of `curr`.

    curr: (H, W, 3) this frame's shaded colour (jittered render); history:
    (H, W, 3) the previous resolve's `to_buffer`; velocity: (H, W, 2)
    screen-space motion in pixels (+x right, +y down), current minus
    previous position of the surface under the pixel
    (postprocess.velocity_image); view_depth: (H, W) linear view depth
    (+inf background); jitter_px: this frame's sub-pixel camera jitter, the
    current colour is resampled at −jitter.

    → (to_buffer, to_screen): the new history, and the frame to show (with
    the velocity-trust-blended motion blur when motion_blur, else
    to_buffer)."""
    curr = torch.as_tensor(curr)
    dev = curr.device
    history = torch.as_tensor(history, device=dev)
    velocity = torch.as_tensor(velocity, device=dev)
    view_depth = torch.as_tensor(view_depth, device=dev)
    H, W = curr.shape[:2]
    yy, xx = _pixel_grid(H, W, dev)

    ss_vel, _ = closest_fragment_velocity(view_depth, velocity)
    jx, jy = float(np.float32(jitter_px[0])), float(np.float32(jitter_px[1]))
    texel0 = _sample_bilinear(curr, yy - jy, xx - jx)
    texel1 = _sample_bilinear(history, yy - ss_vel[..., 1], xx - ss_vel[..., 0])
    cmin, cmax, cavg = _neighborhood_rounded(curr)
    texel1 = clip_aabb(cmin, cmax, torch.minimum(torch.maximum(cavg, cmin), cmax), texel1)

    # Lottes' unbiased-luminance feedback (temporal.frag:477-481)
    wl = _LUMA_W
    lum0 = texel0[..., 0] * wl[0] + texel0[..., 1] * wl[1] + texel0[..., 2] * wl[2]
    lum1 = texel1[..., 0] * wl[0] + texel1[..., 1] * wl[1] + texel1[..., 2] * wl[2]
    unbiased = 1.0 - (lum0 - lum1).abs() / torch.maximum(lum0, torch.clamp_min(lum1, 0.2))
    # the feedback bounds are float32 values, their difference too
    fmin, fmax = np.float32(feedback_min), np.float32(feedback_max)
    span = float(np.float32(fmax - fmin))
    k_feedback = (float(fmin) + span * unbiased * unbiased)[..., None]
    to_buffer = texel0 * (1.0 - k_feedback) + texel1 * k_feedback
    if not motion_blur:
        return to_buffer, to_buffer

    # the motion-blur half: neighbour-max velocity, trust blend (:522-548)
    mv = velocity_dilate(velocity) * motion_scale
    vel_mag = torch.sqrt(mv[..., 0] * mv[..., 0] + mv[..., 1] * mv[..., 1])
    trust_full, trust_none = 2.0, 15.0
    trust = 1.0 - (vel_mag - trust_full).clamp(0.0, trust_none - trust_full) / (
        trust_none - trust_full
    )
    color_motion = sample_color_motion(curr, mv, time_seed=time_seed)
    to_screen = color_motion * (1.0 - trust[..., None]) + to_buffer * trust[..., None]
    return to_buffer, to_screen


@dataclass
class TAAReprojector:
    """Stateful wrapper feeding taa_resolve across a frame sequence (the
    gbuffer history attachment, src/gfx/gbuffer.h:14-44). The first frame
    passes through; later frames resolve against the running history,
    which stays a tensor on the frames' device."""

    feedback_min: float = 0.88
    feedback_max: float = 0.97
    history: torch.Tensor | None = field(default=None, repr=False)
    frame: int = 0

    def reset(self):
        self.history = None
        self.frame = 0

    def step(self, curr, velocity, view_depth, jitter_px=(0.0, 0.0),
             motion_blur: bool = False, motion_scale: float = 1.0) -> torch.Tensor:
        curr = torch.as_tensor(curr, dtype=torch.float32)
        if self.history is None or self.history.shape != curr.shape:
            self.history = curr.clone()
            self.frame = 1
            return curr
        dev = curr.device
        to_buffer, to_screen = taa_resolve(
            curr, self.history.to(dev),
            torch.as_tensor(velocity, dtype=torch.float32, device=dev),
            torch.as_tensor(view_depth, dtype=torch.float32, device=dev),
            jitter_px=(float(jitter_px[0]), float(jitter_px[1])),
            feedback_min=self.feedback_min, feedback_max=self.feedback_max,
            motion_blur=motion_blur, motion_scale=motion_scale,
            time_seed=float(self.frame % 64) / 64.0,
        )
        self.history = to_buffer
        self.frame += 1
        return to_screen
