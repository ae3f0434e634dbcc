"""FXAA 3.11 (PC quality, preset 12) on image tensors.

Torch port of viamd_tpu/render/fxaa.py (`fxaa311`): NVIDIA FXAA 3.11 by
Timothy Lottes with the reference's tuning (subpix 0.5, edge threshold
0.125, edge threshold min 0.0625) on luma = dot(rgb, (0.299, 0.587,
0.114)). Per-pixel branches are masked tensor math, the end-of-edge search
is a fixed 5-step masked march (steps 1, 1.5, 2, 4, 12), and the half-texel
bilinear taps are explicit 4-corner gathers, clamp to edge.

Applied to the tonemapped image after compose: (H, W, 3|4) in, same shape
out, on the input's device.
"""

from __future__ import annotations

import torch

_STEPS = (1.0, 1.5, 2.0, 4.0, 12.0)  # FXAA_QUALITY__PRESET 12

_LUMA_W = (0.299, 0.587, 0.114)


def _luma(rgb3: torch.Tensor) -> torch.Tensor:
    """dot(rgb, _LUMA_W) rounded as the JAX package's CPU backend rounds its
    dot: fma(b, w2, fma(g, w1, r·w0)), each fused step evaluated in float64
    (where a float32 product is exact) and rounded to float32. FXAA's span test
    `edge_horz >= edge_vert` is an exact tie in real arithmetic wherever the
    centre is a local luma extremum, so its outcome hangs on the luma's last
    bit: a plain three-term sum flips it at ~2% of a noise image's pixels."""
    f64, f32 = torch.float64, torch.float32
    r, g, b = (rgb3[..., i].to(f64) for i in range(3))
    w0, w1, w2 = (float(torch.tensor(w, dtype=f32)) for w in _LUMA_W)
    acc = (r * w0).to(f32).to(f64)
    acc = (g * w1 + acc).to(f32).to(f64)
    return (b * w2 + acc).to(f32)


def _bilinear_gather(flat_rows, X, Y, W: int, H: int):
    """Bilinear samples of flat_rows ((H*W, C)) at float pixel coordinates
    (X, Y), clamp to edge: one gather per corner."""
    x0 = torch.floor(X - 0.5)
    y0 = torch.floor(Y - 0.5)
    fx = (X - 0.5 - x0)[..., None]
    fy = (Y - 0.5 - y0)[..., None]
    x0 = x0.to(torch.int32).clamp(0, W - 1).long()
    y0 = y0.to(torch.int32).clamp(0, H - 1).long()
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    v00 = flat_rows[y0 * W + x0]
    v10 = flat_rows[y0 * W + x1]
    v01 = flat_rows[y1 * W + x0]
    v11 = flat_rows[y1 * W + x1]
    top = v00 * (1 - fx) + v10 * fx
    bot = v01 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def fxaa311(
    rgb: torch.Tensor,
    subpix: float = 0.5,
    edge_threshold: float = 0.125,
    edge_threshold_min: float = 0.0625,
) -> torch.Tensor:
    """→ antialiased image, FXAA 3.11 PC quality, preset 12."""
    nch = rgb.shape[-1]
    rgb3 = rgb[..., :3]
    luma = _luma(rgb3)
    H, W = luma.shape
    lp = torch.cat([luma[:, :1], luma, luma[:, -1:]], dim=1)
    lp = torch.cat([lp[:1], lp, lp[-1:]], dim=0)  # edge pad by 1

    lM = luma
    lN = lp[0:H, 1 : W + 1]
    lS = lp[2 : H + 2, 1 : W + 1]
    lW_ = lp[1 : H + 1, 0:W]
    lE = lp[1 : H + 1, 2 : W + 2]
    lNW = lp[0:H, 0:W]
    lNE = lp[0:H, 2 : W + 2]
    lSW = lp[2 : H + 2, 0:W]
    lSE = lp[2 : H + 2, 2 : W + 2]

    mx = torch.maximum
    mn = torch.minimum
    rng_max = mx(lM, mx(mx(lN, lS), mx(lW_, lE)))
    rng_min = mn(lM, mn(mn(lN, lS), mn(lW_, lE)))
    rng = rng_max - rng_min
    early_exit = rng < (rng_max * edge_threshold).clamp_min(edge_threshold_min)

    luma_ns = lN + lS
    luma_we = lW_ + lE
    subpix_rcp_range = 1.0 / rng.clamp_min(1e-12)
    subpix_nswe = luma_ns + luma_we
    edge_horz1 = -2.0 * lM + luma_ns
    edge_vert1 = -2.0 * lM + luma_we
    edge_horz2 = -2.0 * lE + (lNE + lSE)
    edge_vert2 = -2.0 * lN + (lNW + lNE)
    edge_horz3 = -2.0 * lW_ + (lNW + lSW)
    edge_vert3 = -2.0 * lS + (lSW + lSE)
    edge_horz = edge_horz3.abs() + edge_horz1.abs() * 2.0 + edge_horz2.abs()
    edge_vert = edge_vert3.abs() + edge_vert1.abs() * 2.0 + edge_vert2.abs()
    horz_span = edge_horz >= edge_vert

    # perpendicular pair: for a horizontal span the N/S neighbours, else W/E
    luma1 = torch.where(horz_span, lN, lW_)
    luma2 = torch.where(horz_span, lS, lE)
    gradient1 = luma1 - lM
    gradient2 = luma2 - lM
    pair1 = gradient1.abs() >= gradient2.abs()
    gradient = mx(gradient1.abs(), gradient2.abs())
    # lengthSign in pixels: +1 toward S/E, -1 when the stronger gradient is
    # on the N/W side
    one = torch.ones_like(lM)
    length_sign = torch.where(pair1, -one, one)
    luma_pair = torch.where(pair1, luma1 + lM, luma2 + lM)

    subpix_a = subpix_nswe * 2.0 + (lNW + lNE + lSW + lSE)
    subpix_b = subpix_a * (1.0 / 12.0) - lM
    subpix_c = (subpix_b.abs() * subpix_rcp_range).clamp(0.0, 1.0)
    subpix_d = -2.0 * subpix_c + 3.0
    subpix_e = subpix_c * subpix_c
    subpix_f = subpix_d * subpix_e
    subpix_g = subpix_f * subpix_f
    subpix_h = subpix_g * subpix

    gradient_scaled = gradient * 0.25
    luma_mm = lM - luma_pair * 0.5
    luma_m_lt_zero = luma_mm < 0.0

    # search start: half a pixel toward the stronger-gradient side
    dev = luma.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(H, W)
    ys = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5).expand(H, W)
    pos_bx = torch.where(horz_span, xs, xs + length_sign * 0.5)
    pos_by = torch.where(horz_span, ys + length_sign * 0.5, ys)
    zero = torch.zeros_like(lM)
    off_x = torch.where(horz_span, one, zero)
    off_y = torch.where(horz_span, zero, one)

    luma_flat = luma.reshape(-1, 1)

    def end_luma(px, py):
        return _bilinear_gather(luma_flat, px, py, W, H)[..., 0] - luma_pair * 0.5

    pos_nx = pos_bx - off_x * _STEPS[0]
    pos_ny = pos_by - off_y * _STEPS[0]
    pos_px = pos_bx + off_x * _STEPS[0]
    pos_py = pos_by + off_y * _STEPS[0]
    luma_end_n = end_luma(pos_nx, pos_ny)
    luma_end_p = end_luma(pos_px, pos_py)
    done_n = luma_end_n.abs() >= gradient_scaled
    done_p = luma_end_p.abs() >= gradient_scaled

    for step in _STEPS[1:]:
        pos_nx = torch.where(done_n, pos_nx, pos_nx - off_x * step)
        pos_ny = torch.where(done_n, pos_ny, pos_ny - off_y * step)
        pos_px = torch.where(done_p, pos_px, pos_px + off_x * step)
        pos_py = torch.where(done_p, pos_py, pos_py + off_y * step)
        ln = end_luma(pos_nx, pos_ny)
        lp_ = end_luma(pos_px, pos_py)
        luma_end_n = torch.where(done_n, luma_end_n, ln)
        luma_end_p = torch.where(done_p, luma_end_p, lp_)
        done_n = done_n | (luma_end_n.abs() >= gradient_scaled)
        done_p = done_p | (luma_end_p.abs() >= gradient_scaled)

    dst_n = torch.where(horz_span, xs - pos_nx, ys - pos_ny)
    dst_p = torch.where(horz_span, pos_px - xs, pos_py - ys)
    good_span_n = (luma_end_n < 0.0) != luma_m_lt_zero
    good_span_p = (luma_end_p < 0.0) != luma_m_lt_zero
    span_len = dst_p + dst_n
    direction_n = dst_n < dst_p
    dst = mn(dst_n, dst_p)
    good_span = torch.where(direction_n, good_span_n, good_span_p)
    pixel_offset = dst * (-1.0 / span_len.clamp_min(1e-12)) + 0.5
    pixel_offset_good = torch.where(good_span, pixel_offset, zero)
    pixel_offset_subpix = mx(pixel_offset_good, subpix_h)

    pos_mx = torch.where(horz_span, xs, xs + pixel_offset_subpix * length_sign)
    pos_my = torch.where(horz_span, ys + pixel_offset_subpix * length_sign, ys)
    out3 = _bilinear_gather(rgb3.reshape(-1, 3), pos_mx, pos_my, W, H)
    out3 = torch.where(early_exit[..., None], rgb3, out3)
    if nch > 3:
        return torch.cat([out3, rgb[..., 3:]], dim=-1)
    return out3
