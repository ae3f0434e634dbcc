"""Smoke run of the PyTorch/CUDA port (viamd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through the entry points a user calls. First
the headline analysis path — the script
    r = rdf(element('O'), element('O'), 10.0);
    v = sdf(residue(1:64), element('H'), 5.0);
    {lin, plan, iso} = shape_weights(all);
over a 100,002-atom periodic water box, 384 frames — through the entry
points a user calls (datagen.water_box_device → script.compile_script →
eval.Evaluator). Then the molecule render path at the JAX package's own
render configuration (bench.py): the box's frames at 1920×1080, eye at box
centre + (0, 0, 1.6·box), perspective(45°, 16/9, 1, 500), CPK colours, in
spacefill and in licorice (133,336 bond half-capsules) — through
render.raster.render_molecules → render.postprocess.execute (HBAO, ACES,
compose, FXAA 3.11). Phases, one result line each:

1. the device (fails without CUDA; nothing falls back to the CPU);
2. the build of the hand-written CUDA kernels from csrc/ (one nvcc per
   library, sm_90a, all started together), with ptxas' registers, shared
   memory and spills;
3. pair_hist at the headline shape, held exactly to both plain versions
   (the all-pairs specification and `pair_hist_cells_plain`, the kernel's
   own walk) for O–O through the half stencil and for O against every 5th
   atom through the full one; the walk's candidate pairs (ordered before,
   unordered now) and its sqrt count; whether `inv_basis_of` gave
   exact-zero off-diagonals (the kernel's orthorhombic branch); the
   kernel's device time against its bound, its wrapper's host time behind
   a queued sleep (fails if the launch waits on the device), the route and
   the plain times;
4. the analysis path: warm-up, then three timed runs over all frames, with
   the kernels' launch counts set to 0 before and read after;
5. its output against references: the per-frame RDF against the plain
   histogram, and the whole script on a small box against the CPU;
6. the culled raster kernel against its unculled plain version on the
   full-width frame 0, spacefill and licorice: mismatches, errors,
   tile-list sizes, the ray tests of all candidates beside those an exact
   front-to-back cull must do and those the kernel does (its walk
   replayed), both bounds, the kernel, binning + kernel and plain times,
   and build_scene with the depth sort against the same binning in
   primitive order;
7. the render path: frames 0–15, render + postprocess, three timed runs,
   launch counts set to 0 before and read after;
8. the render output against references: sampled pixels of the full-width
   frames against a brute-force ray cast over every primitive, and the
   whole chain on a small box against the CPU.

Ends with a JSON line of kernel results, the `nvidia-smi` name/power-limit
line, and the JSON status line. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from viamd_tpu_torch import cuda_build, datagen
from viamd_tpu_torch.datagen import water_box, water_box_device
from viamd_tpu_torch.eval import Evaluator
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.ops import cuda_rdf
from viamd_tpu_torch.ops.neighbors import build_cell_list, choose_grid_r
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_scatter_idx, sqrt_rn
from viamd_tpu_torch.render import cuda_raster, postprocess
from viamd_tpu_torch.render import raster as raster_mod
from viamd_tpu_torch.render.raster import (
    RasterSettings,
    build_scene,
    render_molecules,
    render_scene,
)
from viamd_tpu_torch.script import compile_script

HEADLINE = (
    "r = rdf(element('O'), element('O'), 10.0);\n"
    "v = sdf(residue(1:64), element('H'), 5.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
)
N_WATERS = 33_334  # 100,002 atoms
N_FRAMES = 384
CHUNK = 64
SEED = 3
NBINS, R_MAX = 128, 10.0
WIDTH, HEIGHT = 1920, 1080
RENDER_FRAMES = 16
REPS = ("spacefill", "licorice")
RGB_TOL = 1e-5  # kernel vs plain: powf against torch.pow; all else exact
TIE_RTOL = 1e-6  # a pick mismatch must be a near-tie |t1 - t2| <= 1e-6 t
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# f32 operations (an add, multiply, divide, sqrt, rint, max or compare each
# count one) that each function needs, with work that depends on one operand
# only counted once per operand. pair_hist on an orthorhombic box, per
# candidate pair: d (3), d / box (3), rint (3), subtract (3), · box (3),
# |d|² (5), sqrt, the r_max test; per in-range pair the bin (1). With A == B
# the histogram is symmetric, so only unordered pairs are needed.
OPS_PAIR, OPS_PAIR_HIT = 22, 1
# raster, per (pixel, candidate): sphere dc (4), disc (3), t (4), three tests;
# capsule da (4), dp (4), A (3), Bq (2), disc (3), t (4), sax (2), five tests.
OPS_SPHERE, OPS_CAPSULE = 14, 27
# once per primitive: |c|² − r² (7); p·a and |p|² − (p·a)² − r² (14); and,
# for a front-to-back cull, the near depth: −cz − r (1); min(−qz, −(qz +
# len·az)) − r (4)
OPS_SPHERE_PRIM, OPS_CAPSULE_PRIM = 7, 14
OPS_SPHERE_NEAR, OPS_CAPSULE_NEAR = 1, 4
# per pixel: its ray dx, dy, |d|², 1/|d|² (15); per hit pixel: the normal
# and the Phong shading (52)
OPS_RAY, OPS_SHADE = 15, 52
SLEEP_CYCLES = 2_000_000  # ~1 ms of the SM clock, ahead of a queued timing


def host_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Median host time of fn() in ms, up to its return (no synchronize
    inside the timed span). `queued` puts a ~1 ms sleep kernel on the
    stream first: a fn that waits on the device then takes over 1 ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        t1 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Median time of fn() in ms, from CUDA events around the call. Where
    fn is shorter on the device than its host code (a kernel behind its
    wrapper's checks and allocations), the device idles inside that span;
    `queued` puts a ~1 ms sleep kernel on the stream first, so the host
    enqueues fn while the device sleeps and the span holds device time
    only (for functions that do not wait on the device themselves)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) on the card for `ops` f32 operations and `nbytes`
    moved, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hist_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got − want| per bin; raises unless the histograms are equal bin
    for bin (the kernel and both plain versions compute every distance with
    the same float operations, so no tolerance) and not empty."""
    g, w = got.double().cpu(), want.double().cpu()
    err = (g - w).abs().max().item()
    if err != 0 or g.sum().item() != w.sum().item():
        raise AssertionError(f"histograms differ: max bin err {err}, totals "
                             f"{g.sum().item()} vs {w.sum().item()}")
    if w.sum().item() <= 0:
        raise AssertionError("empty histogram")
    return err


def tile_pixels(width: int, height: int, dev) -> torch.Tensor:
    """(T,) number of in-frame pixels of each 16×16 tile."""
    t = cuda_raster.TILE
    wx = torch.clamp(width - torch.arange(0, width, t, device=dev), max=t)
    wy = torch.clamp(height - torch.arange(0, height, t, device=dev), max=t)
    return (wy[:, None] * wx[None, :]).reshape(-1).double()


def compare_raster(got, want) -> dict:
    """Kernel (rgba, depth, pick) against the plain version's: raises
    unless every pick or alpha mismatch is a near-tie (both hit, depths
    within TIE_RTOL) and rgb is within RGB_TOL where the picks agree."""
    (img, dep, pick), (pimg, pdep, ppick) = got, want
    pick_mis = pick != ppick
    alpha_mis = img[..., 3] != pimg[..., 3]
    odd = pick_mis | alpha_mis
    hit = (pick >= 0) & (ppick >= 0)
    tie = odd & hit & ((dep - pdep).abs() <= TIE_RTOL * pdep)
    if bool((odd & ~tie).any()):
        raise AssertionError(f"{int((odd & ~tie).sum())} raster mismatches are not near-ties")
    same = ~odd & (ppick >= 0)
    depth_err = float((dep[same] - pdep[same]).abs().max()) if bool(same.any()) else 0.0
    rgb_err = float((img[~odd][:, :3] - pimg[~odd][:, :3]).abs().max())
    if rgb_err > RGB_TOL or depth_err != 0.0:
        raise AssertionError(f"raster rgb err {rgb_err}, depth err {depth_err}")
    if int((ppick >= 0).sum()) < 0.2 * ppick.numel():
        raise AssertionError("raster frame mostly empty")
    return dict(pick_mismatch=int(pick_mis.sum()), alpha_mismatch=int(alpha_mis.sum()),
                ties=int(tie.sum()), depth_err=depth_err, rgb_err=rgb_err,
                hits=int((ppick >= 0).sum()), max_abs_err=max(depth_err, rgb_err))


def rays(s, xs, ys):
    """(dx, dy, |d|²) of pixel centres, as the kernel computes them."""
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=xs.device)
    dx = ((xs.to(f32) + 0.5) * s.two_over_w - 1.0 + s.p02) * (one / s.p00)
    dy = ((ys.to(f32) + 0.5) * s.two_over_h - 1.0 + s.p12) * (one / s.p11)
    return dx, dy, dx * dx + dy * dy + 1.0


def sphere_hits(sph, dx, dy, dd):
    """(t, hit) of spheres (..., 4) and rays that broadcast with them, in the
    plain version's float32 arithmetic."""
    cx, cy, cz, r = sph.unbind(-1)
    cc = cx * cx + cy * cy + cz * cz - r * r
    dc = dx * cx + dy * cy - cz
    disc = dc * dc - dd * cc
    t = (dc - sqrt_rn(disc.clamp_min(0.0))) * (1.0 / dd)
    return t, (disc > 0.0) & (t > 1e-6)


def capsule_hits(cyl, dx, dy, dd):
    """(t, hit) of half-capsules (..., 8), likewise."""
    qx, qy, qz, ax, ay, az, ln, rr = cyl.unbind(-1)
    pa = qx * ax + qy * ay + qz * az
    cc2 = qx * qx + qy * qy + qz * qz - pa * pa - rr * rr
    da = dx * ax + dy * ay - az
    dp = dx * qx + dy * qy - qz
    A = (dd - da * da).clamp_min(1e-9)
    Bq = dp - da * pa
    disc = Bq * Bq - A * cc2
    t = (Bq - sqrt_rn(disc.clamp_min(0.0))) / A
    sax = t * da - pa
    return t, (disc > 0.0) & (t > 1e-6) & (sax >= 0.0) & (sax <= ln)


def brute_pick(scene, ys, xs) -> torch.Tensor:
    """Pick of pixels (ys, xs) from a ray cast over EVERY primitive of the
    scene (no tile lists), with the plain version's float32 arithmetic:
    spheres with the centre in front, then half-capsules, nearest hit."""
    dx, dy, dd = (v[:, None] for v in rays(scene.shading, xs, ys))
    t, ok = sphere_hits(scene.sph, dx, dy, dd)
    ok &= -scene.sph[:, 2] > 1e-6
    ts, si = torch.where(ok, t, torch.full_like(t, float("inf"))).min(dim=1)
    best = torch.where(torch.isfinite(ts), scene.sph_ci[si, 1], torch.full_like(si, -1).int())
    if scene.cyl.shape[0]:
        t, ok = capsule_hits(scene.cyl, dx, dy, dd)
        tc, ci = torch.where(ok, t, torch.full_like(t, float("inf"))).min(dim=1)
        best = torch.where(tc < ts, scene.cyl_ci[ci, 1], best)
    return best


def kernel_walk(scene, final_depth) -> dict:
    """The kernel's culled walk replayed slot by slot with the plain
    arithmetic, to count its work, per kind (spheres, capsules):
    `lane_tests`, the (pixel, candidate) tests past the cull; `warp_steps`,
    the slots that a 32-pixel warp enters while any of its pixels is live
    (the kernel's loop runs until __all_sync says none is); `needed`, the
    tests that any exact front-to-back cull must still do: for each pixel,
    the candidates of its tile's lists whose near depth is ≤ its final
    depth (the (H, W) `final_depth`, +inf where nothing is hit: then all of
    them). Also returns the walk's (H, W) depth and pick."""
    t_ = cuda_raster.TILE
    W, H = scene.width, scene.height
    dev = scene.sph.device
    tx, ty = -(-W // t_), -(-H // t_)
    lane = torch.arange(t_ * t_, device=dev)
    tid = torch.arange(tx * ty, device=dev)
    px = ((tid % tx) * t_)[:, None] + (lane % t_)[None, :]
    py = ((tid // tx) * t_)[:, None] + (lane // t_)[None, :]
    outside = (px >= W) | (py >= H)
    final = torch.full((ty * t_, tx * t_), float("-inf"), device=dev)
    final[:H, :W] = final_depth
    final = final.reshape(ty, t_, tx, t_).transpose(1, 2).reshape(tx * ty, t_ * t_)
    dx, dy, dd = rays(scene.shading, px, py)
    bt = torch.full(dx.shape, 1e30, device=dev)
    bid = torch.full(dx.shape, -1, dtype=torch.int32, device=dev)
    ls = scene.lists
    out = dict(lane_tests=[], warp_steps=[], needed=[])
    for start, lst, prims, ci, near, hits in (
        (ls.s_start, ls.s_list, scene.sph, scene.sph_ci,
         cuda_raster.near_depth_spheres(scene.sph), sphere_hits),
        (ls.c_start, ls.c_list, scene.cyl, scene.cyl_ci,
         cuda_raster.near_depth_capsules(scene.cyl), capsule_hits),
    ):
        done = outside.clone()
        bi = torch.full(dx.shape, -1, dtype=torch.long, device=dev)
        cut = cuda_raster.cull_depth(near)
        count = start[1:] - start[:-1]
        tests = steps = needed = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(int(count.max()) if count.numel() else 0):
            ids, valid = cuda_raster._slot(start, lst, k)
            valid = valid[:, None]
            needed = needed + (valid & (near[ids][:, None] <= final)).sum()
            steps = steps + (valid & ~done).reshape(tx * ty, -1, 32).any(-1).sum()
            done = done | (valid & (cut[ids][:, None] > bt))
            live = valid & ~done
            tests = tests + live.sum()
            t, ok = hits(prims[ids][:, None, :], dx, dy, dd)
            win = live & ok & ((t < bt) | ((t == bt) & (ids[:, None] < bi)))
            bt = torch.where(win, t, bt)
            bi = torch.where(win, ids[:, None], bi)
            bid = torch.where(win, ci[ids, 1][:, None], bid)
        for key, v in (("lane_tests", tests), ("warp_steps", steps), ("needed", needed)):
            out[key].append(int(v))

    def image(a):
        a = a.reshape(ty, tx, t_, t_).transpose(1, 2).reshape(ty * t_, tx * t_)
        return a[:H, :W]

    out["depth"] = image(torch.where(bid >= 0, bt, torch.full_like(bt, float("inf"))))
    out["pick"] = image(bid)
    return out


def small_chain(dev) -> str:
    """render_molecules → execute on a 1,500-atom box at 320×240, CUDA
    against the CPU (held to the JAX package by tests/test_torch_render.py
    and tests/test_torch_postprocess.py). Raster: picks, alpha and depth
    equal, rgb within RGB_TOL; the finished frame within 1e-4 at 97% of
    pixels (FXAA's ties, see tests/test_torch_postprocess.py)."""
    sys_, traj = water_box(500, n_frames=1, seed=SEED)
    x = traj.load_frames([0])[0][0]
    d = datagen.render_inputs(sys_, 320, 240, (0.9, 0.7, 1.2))
    notes = []
    for rep in REPS:
        s = RasterSettings(width=320, height=240, rep=rep)
        res = {}
        for dev_ in ("cpu", dev):
            img, dep, pick = render_molecules(x, d["radii"], d["colors"], d["view"],
                                              d["proj"], s, d["bonds"], device=dev_)
            out = postprocess.execute(img, dep, postprocess.PostprocessSettings(),
                                      proj=d["proj"])
            res[str(dev_)] = [v.cpu() for v in (img, dep, pick, out)]
        (ci, cd, cp, co), (gi, gd, gp, go) = res["cpu"], res[str(dev)]
        if not (torch.equal(cp, gp) and torch.equal(ci[..., 3], gi[..., 3]) and torch.equal(cd, gd)):
            raise AssertionError(f"{rep}: small-box raster differs between CUDA and the CPU")
        rgb = float((ci - gi).abs().max())
        err = (co - go).abs().amax(-1)
        frac = float((err <= 1e-4).double().mean())
        if rgb > RGB_TOL or frac < 0.97:
            raise AssertionError(f"{rep}: small-box chain rgb {rgb}, {frac} of pixels within 1e-4")
        notes.append(f"{rep} raster equal (rgb {rgb:.2g}), frame within 1e-4 at "
                     f"{frac * 100:.2f}% (max {float(err.max()):.3g})")
    return "; ".join(notes)


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0, f"{kind} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build(dict([cuda_rdf.LIBRARY, cuda_raster.LIBRARY]))
    lines = []
    for mod in (cuda_rdf, cuda_raster):
        secs = mod.load_kernel()
        name = mod.LIBRARY[0]
        ptxas = [
            ln.strip() for ln in cuda_build.build_info[name]["log"].splitlines()
            if "registers" in ln or "spill" in ln
        ]
        lines.append(f"{name}: nvcc {secs:.2f} s; " + " | ".join(ptxas) if secs
                     else f"{name}: reused the build in viamd_tpu_torch/_build")
    phase("build", t0, " || ".join(lines))

    # -- 3. kernel vs plain at the headline shape --------------------------
    t0 = time.perf_counter()
    sys_, traj = water_box_device(N_WATERS, n_frames=N_FRAMES, seed=SEED, device=dev)
    x0, basis = traj.device_frame(0)
    inv = inv_basis_of(basis)
    box = torch.diagonal(basis)
    idx_o_np = np.nonzero(sys_.element == 8)[0].astype(np.int32)
    idx_o = torch.as_tensor(idx_o_np, device=dev)
    dims, _ = choose_grid_r(sys_.cell.extent(), R_MAX, idx_o_np.size, radius=1)

    def plain(x, ia, ib):
        return pair_dist_histogram_scatter_idx(
            x, ia, ib, torch.ones(ia.shape[0], device=dev),
            torch.ones(ib.shape[0], device=dev), basis, inv, NBINS, R_MAX,
        )

    # the kernel's orthorhombic branch needs exact-zero off-diagonals
    inv_exact = bool((inv - torch.diag(torch.diagonal(inv)) == 0).all())
    # O–O: one index tensor, so the route takes the half stencil
    h_kernel = cuda_rdf.pair_dist_histogram_cl(
        x0, idx_o, idx_o, basis, inv, NBINS, R_MAX, dims
    )
    h_plain = plain(x0, idx_o, idx_o)
    err_same = hist_err(h_kernel, h_plain)
    # A ≠ B with overlapping selections: O atoms vs every 5th atom
    idx_b = torch.arange(0, sys_.natoms, 5, dtype=torch.int32, device=dev)
    err_ab = hist_err(
        cuda_rdf.pair_dist_histogram_cl(x0, idx_o, idx_b, basis, inv, NBINS, R_MAX, dims),
        plain(x0, idx_o, idx_b),
    )
    # the kernel on prebuilt cell lists, against its own walk in plain torch
    xo = x0[idx_o]
    cl = build_cell_list(xo, box, dims)
    xs, ids = xo[cl.order].contiguous(), idx_o[cl.order].contiguous()
    cells = (xs, ids, cl.cell_start, xs, ids, cl.cell_start, basis, inv, dims, NBINS, R_MAX, True)
    work = {}
    h_cells = cuda_rdf.pair_hist_cells(*cells)
    err_walk = hist_err(h_cells, cuda_rdf.pair_hist_cells_plain(*cells, work=work))
    hist_err(h_cells, h_plain)
    # times: the kernel alone (device time), the whole cell-list route (cell
    # list + kernel), and the all-pairs plain version
    ms_kernel = cuda_ms(lambda: cuda_rdf.pair_hist_cells(*cells), queued=True)
    # the main path is host-bound: the launch must not wait on the device
    ms_host = host_ms(lambda: cuda_rdf.pair_hist_cells(*cells), queued=True)
    if ms_host > 0.5:
        raise AssertionError(f"pair_hist_cells took {ms_host:.4f} ms of host time "
                             "behind a ~1 ms queued sleep: it waits on the device")
    ms_route = cuda_ms(lambda: cuda_rdf.pair_dist_histogram_cl(
        x0, idx_o, idx_o, basis, inv, NBINS, R_MAX, dims
    ))
    ms_plain = cuda_ms(lambda: plain(x0, idx_o, idx_o))
    hits = int(h_plain.sum().item())
    # ordered candidate pairs of a full-stencil walk: every A atom against
    # the 27-cell stencil around it
    occ = (cl.cell_start[1:] - cl.cell_start[:-1]).double().reshape(dims)
    near = sum(
        torch.roll(occ, (ox, oy, oz), (0, 1, 2))
        for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
    )
    pairs = int((occ * near).sum().item())
    if bool((basis != torch.diag(box)).any()):
        raise AssertionError("the operation count assumes an orthorhombic box")
    # unordered pairs of distinct atoms: the stencil holds each atom itself
    needed = (pairs - idx_o_np.size) // 2
    if work["pairs"] != needed:
        raise AssertionError(f"the half-stencil walk tests {work['pairs']} pairs, "
                             f"expected {needed} unordered ones")
    nbytes_hist = xs.numel() * 4 + ids.numel() * 4 + cl.cell_start.numel() * 4 + 72 + NBINS * 4
    hist_bound, hist_bound_by = bound(needed * OPS_PAIR + hits / 2 * OPS_PAIR_HIT, nbytes_hist)
    phase("kernel", t0, (
        f"pair_hist O-O n={idx_o_np.size} dims={dims}: candidate pairs, ordered "
        f"(full stencil) {pairs}, unordered (the kernel's half stencil) "
        f"{work['pairs']}, past the sqrt reject {work['sqrt']}; in-range pairs "
        f"{hits}; max bin err vs all-pairs {err_same:g} (A!=B {err_ab:g}), vs "
        f"the kernel's walk {err_walk:g}; inv_basis_of off-diagonals exactly 0: "
        f"{inv_exact}; kernel {ms_kernel:.4f} ms (device, queued), the "
        f"wrapper's host time {ms_host:.4f} ms (behind a queued sleep), cell list + "
        f"kernel {ms_route:.4f} ms, plain {ms_plain:.4f} ms, plain/kernel "
        f"{ms_plain / ms_kernel:.1f}x; bound {hist_bound:.4f} ms ({hist_bound_by}), "
        f"kernel at {hist_bound / ms_kernel * 100:.1f}% of the bound"
    ))

    # -- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_rdf.launches = 0
    compiled = compile_script(HEADLINE, sys_, dev)
    t_compile = time.perf_counter() - t0
    ev = Evaluator(compiled, traj, chunk=CHUNK)
    ev.run(frame_range=range(CHUNK)).force()
    torch.cuda.synchronize()
    launches_warm = cuda_rdf.launches
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        res = ev.run()
        checksum = res.force()
        times.append(time.perf_counter() - t1)
    launches = cuda_rdf.launches  # read just after the main path
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches - launches_warm < N_FRAMES:
        raise AssertionError(
            f"pair_hist launched {launches - launches_warm} times in the timed "
            f"runs, expected >= {N_FRAMES}"
        )
    if res.n_frames_done != N_FRAMES or compiled.routes != ["rdf:cell_list", "sdf:pairs"]:
        raise AssertionError((res.n_frames_done, compiled.routes))
    r_sum = float(res.distributions["r"].sum())
    v_sum = float(res.volumes["v"].sum())
    if not (r_sum > 0 and v_sum > 0 and np.isfinite(checksum)):
        raise AssertionError((r_sum, v_sum, checksum))
    for k in ("lin", "plan", "iso"):
        t = res.temporal[k]
        if t.shape != (N_FRAMES, 1) or not np.isfinite(t).all():
            raise AssertionError((k, t.shape))
    fps = [N_FRAMES / t for t in times]
    phase("main", t0, (
        f"{sys_.natoms} atoms x {N_FRAMES} frames, chunk {CHUNK}: "
        f"frames/s {' '.join(f'{f:.1f}' for f in fps)} (best {max(fps):.1f}); "
        f"compile {t_compile:.2f} s; r-sum {r_sum:.6g} v-sum {v_sum:.6g}; "
        f"peak mem {peak_gib:.3f} GiB; pair_hist launches {launches} "
        f"({launches - launches_warm} in the timed runs)"
    ))

    # -- 5. output against references ----------------------------------------
    t0 = time.perf_counter()
    errs = []
    for f in (0, 1):
        x, b = traj.device_frame(f)
        _, acc = compiled.frame_fn(x, b, inv_basis_of(b))
        errs.append(hist_err(acc["r"], plain(x, idx_o, idx_o)))
    # the whole script on a small box: CUDA against the CPU (the CPU path is
    # held to the JAX package by tests/test_torch_slice.py)
    small_sys, small_traj = water_box(3_000, n_frames=2, seed=SEED)
    frames, cells = small_traj.load_frames([0, 1])
    out = {}
    for d in ("cpu", "cuda"):
        cs = compile_script(HEADLINE, small_sys, d)
        out[d] = Evaluator(cs, trajectory_from_numpy(frames, cells, d), chunk=2).run()
    err_r = hist_err(
        torch.as_tensor(out["cuda"].distributions["r"]),
        torch.as_tensor(out["cpu"].distributions["r"]),
    )
    v_cpu, v_cuda = out["cpu"].volumes["v"], out["cuda"].volumes["v"]
    np.testing.assert_allclose(v_cuda, v_cpu, rtol=1e-4, atol=1e-5 * np.abs(v_cpu).max())
    for k in ("lin", "plan", "iso"):
        np.testing.assert_allclose(out["cuda"].temporal[k], out["cpu"].temporal[k], atol=1e-5)
    phase("check", t0, (
        f"per-frame r vs plain: max bin err {max(errs):g}; small box CUDA vs "
        f"CPU: r err {err_r:g}, v max abs diff "
        f"{float(np.abs(v_cuda - v_cpu).max()):.3g}"
    ))

    # -- 6. raster kernel vs plain at full width ------------------------------
    t0 = time.perf_counter()
    scene_in = datagen.render_inputs(sys_, WIDTH, HEIGHT, device=dev)
    x0 = traj.device_frame(0)[0]
    raster = {}
    for rep in REPS:
        s = RasterSettings(width=WIDTH, height=HEIGHT, rep=rep)
        args = (scene_in["radii"], scene_in["colors"], scene_in["view"],
                scene_in["proj"], s, scene_in["bonds"])
        scene = build_scene(x0, *args, device=dev)
        got = render_scene(scene)
        want = cuda_raster.raster_tiles_plain(*scene.raster_args())
        torch.cuda.synchronize()
        cmp = compare_raster(got, want)
        ls = scene.lists
        per_tile = [st[1:] - st[:-1] for st in (ls.s_start, ls.c_start)]
        npix = tile_pixels(WIDTH, HEIGHT, dev)
        tests = [int((c.double() * npix).sum().item()) for c in per_tile]
        walk = kernel_walk(scene, want[1])
        needed = walk["needed"]
        if not (torch.equal(walk["pick"], got[2]) and torch.equal(walk["depth"], got[1])):
            raise AssertionError(f"{rep}: the replayed culled walk differs from the kernel")
        busy = sum(walk["lane_tests"]) / max(32 * sum(walk["warp_steps"]), 1)
        nbytes = (scene.sph.numel() * 4 + scene.sph_ci.numel() * 4
                  + scene.cyl.numel() * 4 + scene.cyl_ci.numel() * 4
                  + (ls.s_list.numel() + ls.c_list.numel()
                     + ls.s_start.numel() + ls.c_start.numel()) * 4
                  + WIDTH * HEIGHT * 24)
        per_pixel = WIDTH * HEIGHT * OPS_RAY + cmp["hits"] * OPS_SHADE
        ops_all = (tests[0] * OPS_SPHERE + tests[1] * OPS_CAPSULE
                   + scene.sph.shape[0] * OPS_SPHERE_PRIM
                   + scene.cyl.shape[0] * OPS_CAPSULE_PRIM + per_pixel)
        ops = (needed[0] * OPS_SPHERE + needed[1] * OPS_CAPSULE
               + scene.sph.shape[0] * (OPS_SPHERE_PRIM + OPS_SPHERE_NEAR)
               + scene.cyl.shape[0] * (OPS_CAPSULE_PRIM + OPS_CAPSULE_NEAR) + per_pixel)
        b_all_ms, b_all_by = bound(ops_all, nbytes)
        b_ms, b_by = bound(ops, nbytes)
        ms_k = cuda_ms(lambda: render_scene(scene), queued=True)
        ms_k_call = cuda_ms(lambda: render_scene(scene))
        ms_k_host = host_ms(lambda: render_scene(scene))
        ms_bk = cuda_ms(lambda: render_scene(build_scene(x0, *args, device=dev)))
        ms_p = cuda_ms(lambda: cuda_raster.raster_tiles_plain(*scene.raster_args()))
        # build_scene with the depth sort, and with the binning in primitive
        # order (the sort replaced by the identity), in turns
        builds = {"sorted": [], "primitive order": []}
        for order in ("sorted", "primitive order", "primitive order", "sorted"):
            with (contextlib.nullcontext() if order == "sorted" else mock.patch.object(
                raster_mod, "_depth_order",
                lambda near: torch.arange(near.shape[0], device=near.device),
            )):
                builds[order].append(cuda_ms(lambda: build_scene(x0, *args, device=dev)))
        near = (cuda_raster.near_depth_spheres(scene.sph), cuda_raster.near_depth_capsules(scene.cyl))
        ms_sort = cuda_ms(lambda: [raster_mod._depth_order(n) for n in near], queued=True)
        raster[rep] = dict(cmp, ms=ms_k, binned_ms=ms_bk, plain_ms=ms_p,
                           bound_ms=b_ms, bound_by=b_by, bound_all_ms=b_all_ms,
                           scene=scene, pick=got[2])
        phase("raster", t0, (
            f"{rep} {WIDTH}x{HEIGHT}, {scene.sph.shape[0]} spheres, "
            f"{scene.cyl.shape[0]} half-capsules: tile-list entries "
            f"{ls.s_list.numel()} + {ls.c_list.numel()}, largest tile list "
            f"{int(per_tile[0].max())} + {int(per_tile[1].max())}; ray tests, all "
            f"candidates {tests[0]} + {tests[1]}, an exact cull's {needed[0]} + "
            f"{needed[1]} ({sum(tests) / max(sum(needed), 1):.2f}x fewer), the kernel's "
            f"{walk['lane_tests'][0]} + {walk['lane_tests'][1]} in "
            f"{walk['warp_steps'][0]} + {walk['warp_steps'][1]} warp steps "
            f"({busy * 100:.1f}% of lanes busy); "
            f"pick mismatches {cmp['pick_mismatch']} "
            f"(near-ties {cmp['ties']}), alpha mismatches {cmp['alpha_mismatch']}, "
            f"max depth err {cmp['depth_err']:.3g}, max rgb err {cmp['rgb_err']:.3g}; "
            f"hits {cmp['hits']}; kernel {ms_k:.4f} ms (device, queued; events "
            f"around the call {ms_k_call:.4f} ms, the wrapper's host time "
            f"{ms_k_host:.4f} ms), binning + kernel "
            f"{ms_bk:.4f} ms, plain {ms_p:.4f} ms, plain/kernel "
            f"{ms_p / ms_k:.1f}x; bound {b_ms:.4f} ms ({b_by}; {ops:.6g} operations, "
            f"{nbytes} bytes), bound, all candidates {b_all_ms:.4f} ms ({b_all_by}; "
            f"{ops_all:.6g} operations); kernel at {b_ms / ms_k * 100:.1f}% of the "
            f"bound; build_scene with the depth sort "
            f"{' / '.join(f'{v:.4f}' for v in builds['sorted'])} ms, in primitive "
            f"order {' / '.join(f'{v:.4f}' for v in builds['primitive order'])} ms; "
            f"the two sorts alone {ms_sort:.4f} ms"
        ))

    # -- 7. the render path ----------------------------------------------------
    t0 = time.perf_counter()
    pp = postprocess.PostprocessSettings()

    def render_frames(rep):
        s = RasterSettings(width=WIDTH, height=HEIGHT, rep=rep)
        t_r = t_p = 0.0
        for f in range(RENDER_FRAMES):
            x = traj.device_frame(f)[0]
            t1 = time.perf_counter()
            img, dep, _ = render_molecules(
                x, scene_in["radii"], scene_in["colors"], scene_in["view"],
                scene_in["proj"], s, scene_in["bonds"], device=dev,
            )
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = postprocess.execute(img, dep, pp, proj=scene_in["proj"])
            torch.cuda.synchronize()
            t_r, t_p = t_r + t2 - t1, t_p + time.perf_counter() - t2
        if not (out.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(out).all())):
            raise AssertionError(("render path output", out.shape))
        return t_r * 1e3 / RENDER_FRAMES, t_p * 1e3 / RENDER_FRAMES

    for rep in REPS:  # warm-up: allocator, cuRAND-free, nothing to compile
        render_frames(rep)
    torch.cuda.reset_peak_memory_stats()
    cuda_rdf.launches = cuda_raster.launches = 0
    path = {rep: [render_frames(rep) for _ in range(3)] for rep in REPS}
    raster_launches = cuda_raster.launches  # read just after the render path
    hist_launches_render = cuda_rdf.launches
    render_peak = torch.cuda.max_memory_allocated() / 2**30
    if raster_launches < len(REPS) * 3 * RENDER_FRAMES:
        raise AssertionError(f"raster launched {raster_launches} times in the render path")
    for rep in REPS:
        best = min(path[rep], key=sum)
        phase("render", t0, (
            f"{rep} {WIDTH}x{HEIGHT} frames 0-{RENDER_FRAMES - 1}, ms/frame "
            f"raster + postprocess: " + " | ".join(
                f"{r:.3f} + {p:.3f}" for r, p in path[rep]
            ) + f" (best {best[0]:.3f} + {best[1]:.3f} = {sum(best):.3f})"
        ))
    phase("render", t0, (
        f"raster launches {raster_launches} (pair_hist {hist_launches_render}); "
        f"peak mem {render_peak:.3f} GiB"
    ))

    # -- 8. render output against references ------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sampled = {}
    for rep in REPS:
        pick = raster[rep]["pick"]
        hit_px = torch.nonzero(pick >= 0).cpu()
        sel = hit_px[torch.randperm(hit_px.shape[0], generator=gen)[:100]]
        rnd = torch.stack([torch.randint(0, HEIGHT, (100,), generator=gen),
                           torch.randint(0, WIDTH, (100,), generator=gen)], 1)
        yx = torch.cat([sel, rnd]).to(dev)
        want = brute_pick(raster[rep]["scene"], yx[:, 0], yx[:, 1])
        wrong = int((pick[yx[:, 0], yx[:, 1]] != want).sum().item())
        if wrong:
            raise AssertionError(f"{rep}: {wrong} of {yx.shape[0]} sampled pixels disagree with the brute force")
        sampled[rep] = yx.shape[0]
    chain = small_chain(dev)
    phase("render-check", t0, (
        f"sampled pixels vs brute force over all primitives: "
        + ", ".join(f"{rep} {n} pixels, 0 wrong" for rep, n in sampled.items())
        + f"; small box chain CUDA vs CPU: {chain}"
    ))

    print(json.dumps({"kernels": [
        {
            "name": "pair_hist",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/pair_hist.cu",
            "replaces": "viamd_tpu/ops/pallas_rdf.py:58",
            "launches": launches,
            "max_abs_err": err_same,
            "ms": ms_kernel,
            "plain_ms": ms_plain,
            "bound_ms": hist_bound,
            "bound_by": hist_bound_by,
            "library_ms": None,
        },
        {
            "name": "raster",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/raster.cu",
            "replaces": "viamd_tpu/render/pallas_raster.py:58",
            "launches": raster_launches,
            "max_abs_err": max(raster[r]["max_abs_err"] for r in REPS),
            "ms": raster["spacefill"]["ms"],
            "plain_ms": raster["spacefill"]["plain_ms"],
            "bound_ms": raster["spacefill"]["bound_ms"],
            "bound_by": raster["spacefill"]["bound_by"],
            "bound_all_candidates_ms": raster["spacefill"]["bound_all_ms"],
            "library_ms": None,
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
