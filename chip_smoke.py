"""Smoke run of the PyTorch/CUDA port (viamd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls. First
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
compose, FXAA 3.11). Then the volume view (phase 16), the protein views
(17–18), the VeloxChem and SDF windows (19–20), the app layer (21) and
multi-device evaluation with ranks sharing the card (22) and the per-atom
colours (23). Phases, one result line each (several for 16–22):

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
4. the analysis path: warm-up, then six timed runs over all frames, with
   the kernels' launch counts set to 0 before and read after: three with
   the port's fixed-point SDF splat sum, three with a float `index_add_`
   in its place, in turns (fixed, index_add_, index_add_, fixed, fixed,
   index_add_), two fixed-point runs' grids equal; and both splat sums'
   device time on frame 0's terms;
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
   whole chain on a small box against the CPU;
9. `[kernel-tri]`: pair_hist's triclinic mode at full width — the box's
   waters moved rigidly into a rhombic dodecahedron of the same volume
   (fractional cells, the kernel's general 3x3 min-image), O–O through the
   half stencil and O against every 5th atom through the full one, each
   held exactly to the all-pairs version and to the kernel's walk; the
   walk's candidates, the kernel's device time, the route, plain and bound;
10. `[main-tri]`: the headline script over that cell, 384 frames, its
   basis breathing between 0.98 and 1.02 (fractional coordinates kept):
   the routes, the grid sized from the smallest frame, frames/s of three
   runs with the launch count set to 0 before and read after, and the
   smallest and largest frames' `r` against the all-pairs version;
11. `[kernel-r2]`: pair_hist's radius-2 stencil at full width, the grid of
   rdf(O, O, 35 Å) on the box (under 3 cutoffs across: 5x5x5 cells at
   least 17.5 Å wide, ±2 cells): O–O through the half stencil (self cell
   and 62 upper offsets) and O against every 5th atom through all 125
   cells, each held exactly to the all-pairs version and to the kernel's
   walk; the walk's candidates, the kernel's device time, route, plain and
   bound; then that script through the Evaluator (the `rdf:cell_list_r2`
   route), its launch count set to 0 before and read after, ms per frame,
   and frame 0's `r` against the all-pairs version;
12. `[routes]`: the other routes — BASELINE config #1 (the reference's
   default script on a 448-atom aperiodic poly-alanine, 500 frames, the
   dense RDF) against the CPU; sdf(residue(1:4096), element('H'), 5 Å) on
   the box (S·n_t = 2.7e8: the SDF cell list) in ms per frame, and that
   route on a small box against the CPU; config #5's script on 20,001
   atoms in frames/s, and its frames 0-7 against the CPU;
13. `[default]`: the reference's default script (VIAMD src/main.cpp:
   513-530) over polyala_helix(64, 500 frames) with postprocess: routes,
   frames/s of three runs, launches a frame, all 500 frames against the
   CPU;
14. `[lang]`: the rest of the language over the box (LANG: within and
   count, com, distance_min, rmsd, 33,334 mapped angles, plane, the RDF):
   frames/s of three runs with pair_hist's launch count set to 0 before
   and read after (once a frame), launches a frame, whether frame_fn (and
   the headline's) waits on the device, each statement's ms/frame alone,
   `n` against a float64 count on frames 0, 191 and 383, frames 0-7
   against the CPU;
15. `[io]`: the headline box written by the port's writers as a `.gro`
   and a precision-1000 `.xtc` under `.chip_scratch/` (removed at the
   end), opened with `io.load_file` twice (decode + `.vtraj` transcode,
   then the sidecar) and evaluated staged (`DeviceTrajectory.stage`),
   streamed from the sidecar and streamed from the `.xtc` itself
   (`cache=False`): frames/s, launch counts, the streamed results equal to
   the staged one bit for bit, frames 0 and 383 against all pairs, the
   streamed staging step's sync points and host time behind 100 ms of
   queued sleep, an interrupted run saved, loaded and resumed, and
   `import` of a 384-row `.xvg`;
16. `[volume]`: the volume view. bench.py's volume configuration at
   1920×1080 (128³ two-Gaussian grid, viridis TF at alpha 0.6, DVR + isos
   0.25 and 0.6, jitter): csrc/volume.cu (ray setup and march in one
   launch) against its plain version, ray_setup + march_plain, on the same
   parameter block and jitter over the whole frame — the ray table the
   kernel writes to `rays_out` equal to ray_setup's with 0 differing words,
   max rgba and depth error at decided pixels, the undecided ones counted —
   the live samples and iso crossings, the kernel's registers and spills,
   its device time behind a queued sleep and with events around the call,
   the plain time, the bound of the fused
   function and that of the march alone; render_volume's ms/frame over 16
   frames (a new seed each), three runs, against the 16.7 ms vsync
   contract, with the launch count set to 0 before and read after, peak
   memory, and ray_setup alone (the plain setup). Then the in-scene SDF view of the headline
   result (the normalized `v`, 64³ over ±5 Å; frame 0's reference waters
   aligned by sdf_reference_frames at 0.3 × vdW through raster.cu; the
   volume marched to their depth; the OVER composite; execute with HBAO,
   motion blur from frames 0 → 1, bokeh DOF, ACES, FXAA and sharpen), each
   stage timed, and the kernel against its plain version there (the ray
   table with the scene-depth clamp); the same at 512² with a colour
   volume (splat_color_volume), a clip sub-box with a background, and isos
   only; TAAReprojector over the render path's frames 0–15 with Halton
   jitter, the resolve timed; and the small volume + postprocess chain on
   CUDA against the CPU;
17. `[cartoon]`: the protein views at full width — a bundle of 16
   polyala_helix(64) chains on a 4×4 lattice 12 Å apart (7,168 atoms, 1,024
   backbone residues), 16 frames jittered from a numpy seed, 1920×1080
   under compute_optimal_view: every stage's ms a frame (current_ss_weights
   on the device, the SS colouring, the view-space mesh by csrc/ribbon.cu
   through ribbon_view as Session.render builds it, the CA colours
   gathered per triangle and the binning, csrc/triangles.cu, the tube
   through raster.cu, the depth composite) over three runs, launch counts
   set to 0 before and read after; csrc/ribbon.cu against its plain
   version, view_transform(ribbon_mesh(...)), bit for bit (every float of
   every triangle, and the tables' source atoms) on the bundle's frame 0
   in cartoon and ribbons mode and on the stmv.cartoon capsid's base frame
   (60 chains × 159 residues, 606,960 triangles), one launch a call, its
   device time behind a queued sleep and with events around the call, the
   plain version's time and the byte bound; the triangle kernel against its plain version on frame 0
   over the whole frame (0 mismatching rgba, depth and pick pixels), the
   ray tests it does (every pixel of a tile against every candidate), its
   device time, registers and spills, plain time and bound; 4,096 sampled
   pixels against a brute-force cast over every triangle; the tiles over
   JAX's 64-slot cap and the sampled pixels such a cap gets wrong; the
   ribbons mode once; an overlay frame over the cartoon, its triangle
   launches equal to the plain version;
18. `[rama]`: the backbone analyses — the Ramachandran component over the
   bundle × 1,000 frames on the card (compute_angles, density), frames
   0–7 against the CPU, and the shape-space component over the 16 chains
   in frames/s;
19. `[qm]`: the VeloxChem window at a real size — polyala_helix(8) frame 0
   (56 atoms, in Bohr) in 6-31G (392 cartesian functions, 944 primitives),
   seeded synthetic MO coefficients (a QR's Q), 140 occupied orbitals, one
   synthetic excited state, through components.VeloxchemComponent: the
   Export window's OBB grids at "mid" and "high", HOMO and the electron
   density each through csrc/gto.cu (one launch a grid: ψ mode for the
   HOMO, ρ mode for the density, neither writes Φ; ms by events and host
   clock, launches, no primitive_matrix build, peak memory, the pairs that
   are not 0 (α·r² < 40 at the voxel) and the pairs the kernel's brick
   screen evaluates, the bounds over those two and over all pairs and the
   grid's share of each,
   export_volume to .mhd/.raw/.xyz under `.chip_scratch/`, removed); the
   kernel against its plain version on the card (ψ over the whole "mid"
   grid within its stated bound; the "mid" density whole, the "high"
   density at sampled voxels and a "mid" transition density, each within
   QM_RTOL and its float32 bound, one launch each; two density runs
   bit-equal) and the kernel's and the plain version's "high" HOMO and
   density times (device time behind a queued sleep; events);
   orbital_grid at 128³ and
   render_orbital at 1920×1080 through volume.cu; the 64³ density's
   topology (critical points, edges, the numpy host time) and
   render_topology through raster.cu; the excited state's transition
   density, NTO pair and charge transfer by grid and by Mulliken, two
   grid runs bit-equal; 8,192 sampled voxels of the "high" grid (eval_gto
   and the kernel's grid) and the attribution on the card against the CPU;
20. `[density-volume]`: the SDF window over the headline result (`v`, 64
   reference structures) through components.DensityVolumeComponent:
   render_composite at 1920×1080 stage by stage, launch counts set to 0
   before and read after; render alone with a blur, with a clip sub-box
   and two isos, and at 512²; sdf_vis by name after a checkpoint round
   trip; the component on a small box against the CPU at 160×120; the
   dataset component's summary of the box and remap_element on the small
   box on both devices;
21. `[session]`: the app layer over the headline box — the box written by
   the port (write_gro, a lossless .vtraj of [main]'s frames) and opened
   with Session(device="cuda").load, stage_to_device, set_script +
   evaluate (frames/s over three runs; r, v, lin, plan, iso equal bit for
   bit to compile_script + Evaluator on the loaded box, and r, lin, plan,
   iso to [main]'s), frame 0 at 1920×1080 raw spacefill equal to
   render_molecules, the composed frame (a selection outline, the in-scene
   volume v, postprocess) by stage, the sync points inside render,
   render_frames over 16 frames with TAA, recentring (two recentred frames
   bit-equal), a .via round trip rendering the same pixels, the CLI's
   `render demo --postprocess` in a process of its own, the viewer on
   127.0.0.1 (/api/state, /render at full width, /api/orbit), and the
   demo's cartoon with an orbital composited in-scene; launch counts of
   all eight kernels set to 0 before and read after. Its `[hbao]` line:
   csrc/hbao.cu on the session's 1920×1080 depth — the kernel against
   `hbao_plain` on the card (largest difference, bit-equal share; it raises
   unless the two are equal bit for bit outside `cuda_hbao.tie_pixels`), its
   device time behind a queued sleep (the mips, the occlusion, the blur)
   against its bound, the plain version's time, the launches of one call,
   ptxas' registers and spills of its three kernels, and the composed
   frame with the kernel and with the plain version in turns;
22. `[multi]`: multi-device evaluation (viamd_tpu_torch.parallel) with 4
   ranks — processes started by parallel.launch.spawn — sharing the card
   over gloo (NCCL refuses two ranks on one device); an exclusive compute
   mode fails the phase. pair_hist's slab-sharded mode: the headline O–O
   grid (10×10×10), the rhombic dodecahedron's (fractional) and the
   radius-2 grid (5×5×5), their cell rows split over 2 and 4 ranks
   (pair_dist_histogram_cl_sharded: the kernel on each rank's rows, the
   int32 partials summed): every rank's partial equal to the plain walk of
   its rows, every summed histogram equal to the one-rank kernel bit for
   bit, each rank's device time (alone on the card, behind a queued
   sleep) against the bound of its rows' work, the all_reduce's host
   time. Then the headline script frames-sharded on 2 ranks over all 384
   frames against [main]'s one-rank result (temporal rows bit-equal,
   accumulators within the float32 reassociation bound n·2⁻²⁴ relative and
   equal where a bin stays a whole count below 2²⁴), and dp × tp on a 2 × 2
   mesh (compile_script(atom_shard=("atoms", 2)), frames 0–127) against
   one rank over the same frames: frames/s with the ranks sharing one card
   (no speed-up can show), the ranks' own launch counts set to 0 before
   and read after, host waits a frame. Then the dry run,
   parallel.dryrun.dryrun_multichip(4), and its six "ok" lines;
23. `[colors]`: csrc/colors.cu at the cells' sizes — the stmv.cartoon
   capsid's SS colours over its 9,540 CA atoms (the cartoon's launch) and
   over all 1,066,628 atoms with the radii, and a 1,000,002-atom water
   box's CPK colours with the radii (water1m.view's launch), each with the
   cell's filter and selection: the kernel against colors_plain on the
   card bit for bit and against the numpy chain of render/color.py that
   the session ran before (alpha and radii bit-equal, rgb within 1e-6),
   one launch a call, its device time behind a queued sleep and with
   events around the call, its host time behind a queued sleep (it raises
   if the launch waits on the device), the byte bound, the plain
   version's time, and the numpy chain's host time with its upload.

Ends with a JSON line of kernel results, the `nvidia-smi` name/power-limit
line, and the JSON status line. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from viamd_tpu_torch import cuda_build, datagen
from viamd_tpu_torch.datagen import water_box, water_box_device
from viamd_tpu_torch.eval import Evaluator, load_checkpoint, save_checkpoint
from viamd_tpu_torch.interop import trajectory_from_numpy
from viamd_tpu_torch.io import load_file
from viamd_tpu_torch.io.trajectory import DeviceTrajectory
from viamd_tpu_torch.io.xtc import write_xtc
from viamd_tpu_torch.io.xvg import read_xvg, write_xvg
from viamd_tpu_torch.core.elements import vdw_radius
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.ops import cuda_rdf, density
from viamd_tpu_torch.ops import sdf as sdf_ops
from viamd_tpu_torch.ops.neighbors import (
    choose_grid,
    choose_grid_r,
    choose_grid_triclinic,
    perpendicular_widths,
)
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_scatter_idx, sqrt_rn
from viamd_tpu_torch.render import cuda_colors, cuda_hbao, cuda_raster, cuda_volume, postprocess
from viamd_tpu_torch.render import hbao as hbao_mod
from viamd_tpu_torch.render import raster as raster_mod
from viamd_tpu_torch.render.camera import (
    compute_optimal_view,
    look_at,
    perspective,
    taa_jitter_sequence,
)
from viamd_tpu_torch.render.colormap import colormap, transfer_function
from viamd_tpu_torch.render.raster import (
    RasterSettings,
    build_scene,
    render_molecules,
    render_scene,
)
from viamd_tpu_torch.render.taa import TAAReprojector
from viamd_tpu_torch.render.volume import (
    VolumeRenderSettings,
    march_params,
    model_matrix_from_extent,
    ray_params,
    ray_setup,
    render_volume,
)
from viamd_tpu_torch.script import compile_script
from viamd_tpu_torch.app.events import EventBus
from viamd_tpu_torch.components import RamachandranComponent, ShapespaceComponent
from viamd_tpu_torch.components.ramachandran import ACC_RES
from viamd_tpu_torch.core.system import build_system
from viamd_tpu_torch.core.system import postprocess as core_postprocess
from viamd_tpu_torch.io.trajectory import InMemoryTrajectory
from viamd_tpu_torch.render import cuda_ribbon, cuda_triangles
from viamd_tpu_torch.render import triangles as tri_mod
from viamd_tpu_torch.render.backbone_rep import backbone_tube, current_ss_weights
from viamd_tpu_torch.render.color import (
    color_atoms_cpk, color_atoms_secondary_structure, desaturate_colors, filter_colors,
)
from viamd_tpu_torch.render.overlay import OverlayQueue
from viamd_tpu_torch.render.ribbon_mesh import ribbon_mesh, ribbon_tables, ribbon_view
from viamd_tpu_torch.render.triangles import (
    bin_triangles,
    pixel_rays,
    raster_triangles,
    raster_triangles_plain,
    view_transform,
)
from viamd_tpu_torch.components import (
    DatasetComponent,
    DensityVolumeComponent,
    VeloxchemComponent,
)
from viamd_tpu_torch.io.vlx import BOHR_PER_ANGSTROM, ExcitedStates, QMData, shells_from_label
from viamd_tpu_torch.ops import cuda_gto, gto
from viamd_tpu_torch.ops.topo import bond_graph, critical_points
from viamd_tpu_torch.parallel import dryrun, launch
from viamd_tpu_torch.render import volume as vol_mod

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
RAD2DEG = 57.29577951308232
# f32 operations (an add, multiply, divide, sqrt, rint, max or compare each
# count one) that each function needs, with work that depends on one operand
# only counted once per operand. pair_hist on an orthorhombic box, per
# candidate pair: d (3), d / box (3), rint (3), subtract (3), · box (3),
# |d|² (5), sqrt, the r_max test; per in-range pair the bin (1). With A == B
# the histogram is symmetric, so only unordered pairs are needed.
OPS_PAIR, OPS_PAIR_HIT = 22, 1
# pair_hist on a triclinic cell (the general 3x3 min-image), per candidate:
# d (3), d · inv (15), rint (3), subtract (3), · basis (15), |o|² (5), sqrt,
# the r_max test
OPS_PAIR_TRI = 46
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
# a rhombic dodecahedron, rows (d, 0, 0), (0, d, 0), (d/2, d/2, d/√2)
RHOMBIC = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.5, 0.5**0.5]])
BREATH = 0.02  # frame f's basis is scaled by 1 + BREATH · sin(2π f / F)
CONFIG1 = "d1 = distance(10, 30);\nr = rdf(element('C'), element('H'), 10.0);\n"
CONFIG5 = (
    "d1 = distance(1, 4);\n"
    "a1 = angle(1, 2, 3);\n"
    "r = rdf(element('O'), element('O'), 10.0);\n"
    "{lin, plan, iso} = shape_weights(all);\n"
)
CONFIG1_FRAMES, CONFIG5_WATERS, CONFIG5_FRAMES = 500, 6_667, 1_024
# the reference's default script (VIAMD src/main.cpp:513-530), verbatim
DEFAULT = (
    's1 = resname("ALA")[2:8];\n'
    "d1 = distance(10,30);\n"
    'a1 = angle(2,1,3) in resname("ALA");\n'
    "r = rdf(element('C'), element('H'), 10.0);\n"
    "v = sdf(s1, element('H'), 10.0);\n"
    "{lin,plan,iso} = shape_weights(all);\n"
)
DEFAULT_RES, DEFAULT_FRAMES = 64, 500
# the rest of the language over the headline box
LANG = [
    "s = residue(1:64);",
    "n = count(within(3.5, s));",
    "c = com(s);",
    "dm = distance_min(s, element('O') and not s);",
    "rm = rmsd(s);",
    'a = angle(2, 1, 3) in resname("SOL");',
    "p = plane(s);",
    "r = rdf(element('O'), element('O'), 10.0);",
]
LANG_ALONE_FRAMES, LANG_CPU_FRAMES, LANG_COUNT_FRAMES = 64, 8, (0, 191, 383)
# pair_hist's grid in the rhombic dodecahedron at scale 1 and at 0.98
TRI_DIMS, TRI_GRID = (9, 9, 7), (8, 8, 7)
# rdf(O, O, 35 Å) on the 100 Å box: under 3 cutoffs, the radius-2 grid
R2_CUTOFF, R2_DIMS, R2_FRAMES = 35.0, (5, 5, 5), 64
# [main]'s timed runs: the fixed-point splat sum and a float index_add_ in turns
MAIN_SPLAT_ORDER = ("fixed", "index_add_", "index_add_", "fixed", "fixed", "index_add_")
# [io]: the headline box written to .gro + .xtc, streamed 16 frames a chunk,
# a run interrupted after 12 chunks; the float32 reordering of 24 chunk sums
IO_CHUNK, IO_STOP_CHUNKS, IO_RTOL = 16, 12, 4e-6
SCRATCH = Path(__file__).resolve().parent / ".chip_scratch"
# [volume]: bench.py's volume configuration (bench.py:141-177): a 128³
# two-Gaussian grid, viridis TF at alpha 0.6, DVR + isos 0.25 and 0.6,
# value range (0, 1.5), jitter, eye (2.2, 1.4, 2.6) on the origin,
# perspective(45°, 16/9, 0.1, 50), model = I; 16 frames a run against the
# 16.7 ms vsync contract (BASELINE.md:15); the branch frames at 512²; the
# in-scene SDF view's isos at 0.25 and 0.6 of the grid's largest value in
# plasma colours at alpha 0.8 (density_volume.py:53-60)
VOL_D, VOL_FRAMES, VOL_VSYNC_MS, VOL_SMALL = 128, 16, 16.7, 512
VOL_ISOS = ((0.25, 0.6), ((0.9, 0.4, 0.2, 0.6), (0.2, 0.5, 0.9, 0.8)))
SDF_ISO_FRACTIONS = (0.25, 0.6)
VOL_TOL = 1e-5  # kernel vs plain: powf against torch.pow; all else exact
# f32 operations of the march (csrc/volume.cu; compares and a powf count
# one each): per live step, its test (4), t (3), p (6), the trilinear
# sample (15 + 8 corners × 4), trans (1); the DVR's transfer function,
# opacity and compositing (35); per iso and live step k > 0, the crossing
# test (4); per crossing, its refinement, the 6-sample gradient (6 × 47),
# the shading and compositing (351); per pixel, the half vector, the
# hit test and the background compose (25)
OPS_VSTEP, OPS_VDVR, OPS_VISO, OPS_VCROSS, OPS_VRAY = 61, 35, 4, 351, 25
# f32 operations of the ray setup per pixel (csrc/volume.cu, the kernel's
# first part): the NDC point (8); four 4x4 transforms, each 12 products and
# sums, the guard (3) and 3 divisions (4 × 30); d = e − o (3); the box test
# per axis, the guard (2), the reciprocal (1), 2 differences and 2
# products, min and max, and the running max and min (2 on axes 1, 2) =
# 31, and t0's clamp (1); hit, dt (2), |d| (6), tex_dt, the clamp, 3
# negations and 3 divisions (17). With a scene depth, two view depths
# (2 × 7), their difference, guard (2), t_scene (2), isfinite, the min (21)
OPS_VSETUP, OPS_VSCENE = 180, 21
# phases 17-18: the protein views and the backbone analyses. The bundle: 16
# polyala_helix(64) chains on a 4x4 lattice 12 Å apart (7,168 atoms), 16
# frames jittered by 0.08 Å (σ, as polyala_helix jitters) for the views,
# 1,000 for the analyses; 4,096 sampled pixels against the brute force.
BUNDLE_SIDE, BUNDLE_RES, BUNDLE_SPACING, BUNDLE_SIGMA = 4, 64, 12.0, 0.08
CARTOON_FRAMES, RAMA_FRAMES, RAMA_CPU_FRAMES, CARTOON_SAMPLES = 16, 1_000, 8, 4_096
# the capsid of the stmv.cartoon cell, made at a seed above 2**31 as the
# benchmark's seeds are
CAPSID_SEED = 2**31 + 977
JAX_TRI_CAP = 64  # viamd_tpu/render/triangles.py's max_per_tile
# csrc/triangles.cu's float32 operations: per (pixel, candidate) test,
# d × e2 (9), det (5), |det| test (2), 1/det (1), u (6), v (6), t (1), the
# hit tests (6); per staged candidate, e1 e2 (6), −v0 (3), qvec (9), tnum
# (5), the normal, its length and division (9 + 7 + 3); per pixel, the ray
# (10); per hit pixel, the flip (6) and the shading (54)
OPS_TRI_TEST, OPS_TRI_STAGE, OPS_TRI_RAY, OPS_TRI_SHADE = 36, 42, 10, 60
# [qm] (phase 19): polyala_helix(8) frame 0 in 6-31G (56 atoms, 392
# cartesian functions, 944 primitives, 140 occupied orbitals) with seeded
# synthetic MO coefficients and one synthetic excited state; the Export
# window's "mid" and "high" presets (veloxchem.py:127-133), the orbital
# grid at 128³, the topology and excited-state grids at 64³; 8,192 sampled
# voxels of the "high" grid against the CPU within QM_RTOL of their largest
# |value| (CUDA's expf and cuBLAS's sum order against the CPU's), grid
# charges within QM_CHARGE_RTOL (the same winners and fixed-point sums)
QM_RES, QM_PRESETS, QM_ORBITAL_DIMS, QM_TOPO_DIMS, QM_SAMPLES = 8, ("mid", "high"), 128, 64, 8_192
QM_RTOL, QM_CHARGE_RTOL = 1e-5, 1e-6
# csrc/gto.cu against its plain version on the card: ψ within
# 2·K·2⁻²⁴·Σ_k |φ_k·c_k| at each voxel (both sum orders' float32 error
# bound); ρ within QM_RTOL of the largest and within 2·(2K + M + 8)·2⁻²⁴·
# Σ_m |w_m|·(|Φ||A|)_m·(|Φ||B|)_m at each voxel (csrc/gto.cu's note); over
# the whole first preset's grid, and QM_CHUNKS chunks of QM_SAMPLES voxels
# at seeded offsets of the last preset's
QM_CHUNKS, F32_U = 4, 2.0**-24
# f32 operations of one primitive evaluation (ops/gto.py::primitive_matrix),
# the exp counted as one: d (3), r² (5), α·r² (1), the cutoff test (1),
# −α·r² (1), exp (1), the product of the three powers (2), ang · rad (1);
# each power beyond the first adds a multiply (counted from the basis).
# The contraction: 2 per (point, primitive, column); the density adds ψ²,
# · occ and the sum (3 per point and column)
OPS_GTO_PRIM, OPS_RHO_COL = 15, 3
# [density-volume] (phase 20): the headline's SDF at full width with its 64
# reference structures; render alone with a blur, with a clip sub-box and
# two isos, at 512²; the CUDA-vs-CPU check at 160x120 on a 2,000-water box
DV_STRUCTURES, DV_CHECK_WATERS, DV_CHECK_WH = 64, 2_000, (160, 120)
DV_SCRIPT = "v = sdf(residue(1:64), element('H'), 5.0);"
# the check's references: the card's float32 Kabsch rounds the reference
# frames apart from the CPU's (the last bits of the rotations and of the
# translations, ~30 Å), which moves an atom's depth past TIE_RTOL at a few
# silhouette pixels and its shading by ~1e-4 (on an H100: the 4x4 frames
# 1.14e-5 apart, 20 of 19,200 pixels off, rgba 1.6e-4); the frames are
# held relative to their largest entry
DV_FRAME_RTOL, DV_REF_SHARE, DV_REF_RGBA = 2e-6, 0.005, 1e-3


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


def rhombic_dodecahedron(sys_, traj):
    """The water box moved into a rhombic dodecahedron of the same volume,
    its basis breathing: frame f's basis is scaled by 1 + BREATH · sin(2π
    f / F) (1.0 at frame 0, 1.02 at F/4, 0.98 at 3F/4). Each water's O keeps
    its fractional coordinates in the box, and its atoms their cartesian
    offsets from it, so waters stay rigid. → (System at scale 1,
    DeviceTrajectory, (F,) scales)."""
    L = float(sys_.cell.basis[0, 0])
    B = RHOMBIC * (L**3 / np.linalg.det(RHOMBIC)) ** (1.0 / 3.0)
    F = traj.num_frames
    scales = 1.0 + BREATH * np.sin(2.0 * np.pi * np.arange(F) / F)
    cells = np.stack([B * s for s in scales]).astype(np.float32)

    def move(x, cell):  # (..., n, 3) in the box → the cell
        o = x[..., 0::3, :]
        shift = (o / L) @ cell - o
        return x + torch.repeat_interleave(shift, 3, dim=-2)

    dev = traj.stack.device
    stack = move(traj.stack, torch.as_tensor(cells, device=dev))
    x0 = move(torch.as_tensor(sys_.coords()), torch.as_tensor(B, dtype=torch.float32)).numpy()
    tri_sys = dataclasses.replace(
        sys_, x=x0[:, 0].copy(), y=x0[:, 1].copy(), z=x0[:, 2].copy(),
        cell=UnitCell.from_basis(B.astype(np.float32)),
    )
    return tri_sys, DeviceTrajectory(stack, cells), scales


def all_pairs(x, ia, ib, basis, inv, r_max=R_MAX):
    """The all-pairs plain version of pair_hist (unit weights)."""
    ones = lambda idx: torch.ones(idx.shape[0], device=x.device)  # noqa: E731
    return pair_dist_histogram_scatter_idx(
        x, ia, ib, ones(ia), ones(ib), basis, inv, NBINS, r_max
    )


def stencil_pairs(cell_start, dims, radius: int = 1) -> int:
    """Ordered candidate pairs that the full stencil of `radius` walks over
    a CSR cell list: each atom against the (2·radius + 1)³ cells around its
    own, itself included."""
    occ = (cell_start[1:] - cell_start[:-1]).double().reshape(dims)
    span = range(-radius, radius + 1)
    near = sum(
        torch.roll(occ, (ox, oy, oz), (0, 1, 2)) for ox in span for oy in span for oz in span
    )
    return int((occ * near).sum().item())


def half_stencil_pairs(cell_start, dims, n, radius: int = 1) -> int:
    """Unordered candidate pairs of distinct atoms that the half stencil
    walks over a CSR cell list of n atoms: the full stencil's, less each
    atom with itself, halved."""
    return (stencil_pairs(cell_start, dims, radius) - n) // 2


def timed_runs(ev, n_runs: int = 3) -> list:
    """Host seconds of n_runs Evaluator runs over all frames, each ended by
    a synchronize (EvalResult.force), after one warm-up run. → (seconds,
    the last EvalResult)."""
    ev.run().force()
    return timed_runs_range(ev, None, n_runs)


def timed_runs_range(ev, frames, n_runs: int = 3) -> list:
    """Host seconds of n_runs Evaluator runs over `frames` (None: all),
    each ended by a synchronize, no warm-up. → (seconds, the last
    EvalResult)."""
    times = []
    for _ in range(n_runs):
        t1 = time.perf_counter()
        res = ev.run(frames)
        res.force()
        times.append(time.perf_counter() - t1)
    return times, res


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


def kernel_tri(sys_, traj, idx_o, idx_o_np, idx_b) -> dict:
    """Phase 9: pair_hist's triclinic mode at full width, on frame 0 (scale
    1) of the box moved into the rhombic dodecahedron. → the kernel's
    results and the moved system and trajectory."""
    t0 = time.perf_counter()
    tri_sys, tri_traj, scales = rhombic_dodecahedron(sys_, traj)
    xt, bt = tri_traj.device_frame(0)  # scale 1
    it = inv_basis_of(bt)
    dims_t, _ = choose_grid_triclinic(bt.cpu().numpy(), R_MAX, idx_o_np.size, radius=1)
    if dims_t != TRI_DIMS:
        raise AssertionError(f"rhombic dodecahedron grid {dims_t}, expected {TRI_DIMS}")
    h_tri = cuda_rdf.pair_dist_histogram_cl(
        xt, idx_o, idx_o, bt, it, NBINS, R_MAX, dims_t, fractional=True
    )
    h_tri_plain = all_pairs(xt, idx_o, idx_o, bt, it)
    err_tri = hist_err(h_tri, h_tri_plain)
    err_tri_ab = hist_err(
        cuda_rdf.pair_dist_histogram_cl(xt, idx_o, idx_b, bt, it, NBINS, R_MAX, dims_t,
                                        fractional=True),
        all_pairs(xt, idx_o, idx_b, bt, it),
    )
    # the kernel on prebuilt fractional cell lists against its walk: the half
    # stencil (O–O) and the full one (O against every 5th atom)
    a_cells = cuda_rdf.cell_lists(xt, idx_o, bt, it, dims_t, fractional=True)
    b_cells = cuda_rdf.cell_lists(xt, idx_b, bt, it, dims_t, fractional=True)
    tri_args = (*a_cells, *a_cells, bt, it, dims_t, NBINS, R_MAX, True)
    tri_ab_args = (*a_cells, *b_cells, bt, it, dims_t, NBINS, R_MAX, False)
    work_t, work_ab = {}, {}
    h_cells_t = cuda_rdf.pair_hist_cells(*tri_args)
    err_tri_walk = hist_err(h_cells_t, cuda_rdf.pair_hist_cells_plain(*tri_args, work=work_t))
    hist_err(h_cells_t, h_tri_plain)
    err_tri_walk_ab = hist_err(cuda_rdf.pair_hist_cells(*tri_ab_args),
                               cuda_rdf.pair_hist_cells_plain(*tri_ab_args, work=work_ab))
    needed_t = half_stencil_pairs(a_cells[2], dims_t, idx_o_np.size)
    if work_t["pairs"] != needed_t:
        raise AssertionError(f"the triclinic half-stencil walk tests {work_t['pairs']} "
                             f"pairs, expected {needed_t}")
    ms_kernel_tri = cuda_ms(lambda: cuda_rdf.pair_hist_cells(*tri_args), queued=True)
    ms_route_tri = cuda_ms(lambda: cuda_rdf.pair_dist_histogram_cl(
        xt, idx_o, idx_o, bt, it, NBINS, R_MAX, dims_t, fractional=True
    ))
    ms_plain_tri = cuda_ms(lambda: all_pairs(xt, idx_o, idx_o, bt, it))
    hits_t = int(h_tri_plain.sum().item())
    nbytes_tri = sum(a.numel() * 4 for a in a_cells) + 72 + NBINS * 4
    tri_bound, tri_bound_by = bound(
        needed_t * OPS_PAIR_TRI + hits_t / 2 * OPS_PAIR_HIT, nbytes_tri
    )
    phase("kernel-tri", t0, (
        f"pair_hist triclinic, rhombic dodecahedron d={float(bt[0, 0]):.3f} A, O-O "
        f"n={idx_o_np.size} dims={dims_t} ({idx_o_np.size / np.prod(dims_t):.1f} O a "
        f"cell): candidates, unordered (half stencil) {work_t['pairs']}, past the sqrt "
        f"reject {work_t['sqrt']}; O vs every 5th atom (full stencil) {work_ab['pairs']}; "
        f"in-range pairs {hits_t}; max bin err vs all-pairs {err_tri:g} (A!=B "
        f"{err_tri_ab:g}), vs the kernel's walk {err_tri_walk:g} (A!=B "
        f"{err_tri_walk_ab:g}); kernel {ms_kernel_tri:.4f} ms (device, queued), cell "
        f"list + kernel {ms_route_tri:.4f} ms, plain {ms_plain_tri:.4f} ms, plain/kernel "
        f"{ms_plain_tri / ms_kernel_tri:.1f}x; bound {tri_bound:.4f} ms ({tri_bound_by}; "
        f"{OPS_PAIR_TRI} operations a candidate), kernel at "
        f"{tri_bound / ms_kernel_tri * 100:.1f}% of the bound"
    ))
    return dict(sys=tri_sys, traj=tri_traj, scales=scales, dims=dims_t, err=err_tri,
                ms=ms_kernel_tri, plain_ms=ms_plain_tri, bound_ms=tri_bound,
                bound_by=tri_bound_by)


def main_tri(dev, tri, idx_o) -> int:
    """Phase 10: the headline script over the breathing rhombic
    dodecahedron, the launch count set to 0 just before and read just
    after. → pair_hist's launches."""
    tri_sys, tri_traj, scales, dims_t = tri["sys"], tri["traj"], tri["scales"], tri["dims"]
    t0 = time.perf_counter()
    cuda_rdf.launches = 0
    compiled_t = compile_script(HEADLINE, tri_sys, dev)
    ev_t = Evaluator(compiled_t, tri_traj, chunk=CHUNK)
    fit = ev_t.script  # the script on the grids sized for this trajectory
    if fit.routes != ["rdf:cell_list_triclinic", "sdf:pairs"]:
        raise AssertionError(fit.routes)
    widths = perpendicular_widths(tri_traj.cells.cpu().numpy()).min(axis=0)
    grid_t = fit.grids[0].dims
    if grid_t != TRI_GRID:
        raise AssertionError(f"breathing-box grid {grid_t}, expected {TRI_GRID} from the "
                             f"smallest frame's widths {widths}")
    times_t, res_t = timed_runs(ev_t)
    launches_tri = cuda_rdf.launches  # read just after the main path
    if launches_tri < 4 * N_FRAMES:
        raise AssertionError(f"pair_hist launched {launches_tri} times over the "
                             f"triclinic main path, expected >= {4 * N_FRAMES}")
    r_sum_t = float(res_t.distributions["r"].sum())
    v_sum_t = float(res_t.volumes["v"].sum())
    if not (r_sum_t > 0 and v_sum_t > 0 and np.isfinite(res_t.temporal["iso"]).all()):
        raise AssertionError((r_sum_t, v_sum_t))
    f_small, f_large = int(np.argmin(scales)), int(np.argmax(scales))
    errs_t = []
    for f in (f_small, f_large):
        x, b = tri_traj.device_frame(f)
        i = inv_basis_of(b)
        _, acc = fit.frame_fn(x, b, i)
        errs_t.append(hist_err(acc["r"], all_pairs(x, idx_o, idx_o, b, i)))
    fps_t = [N_FRAMES / t for t in times_t]
    phase("main-tri", t0, (
        f"{tri_sys.natoms} atoms x {N_FRAMES} frames in the breathing rhombic "
        f"dodecahedron (scale {scales.min():.4f}-{scales.max():.4f}), routes "
        f"{fit.routes}, grid {grid_t} from the smallest perpendicular widths "
        f"{np.round(widths, 3).tolist()} A (frame 0's grid {dims_t}): frames/s "
        f"{' '.join(f'{f:.1f}' for f in fps_t)} (best {max(fps_t):.1f}); r-sum "
        f"{r_sum_t:.6g} v-sum {v_sum_t:.6g}; pair_hist launches {launches_tri}; "
        f"per-frame r vs all-pairs, smallest frame {f_small} / largest {f_large}: "
        f"max bin err {max(errs_t):g}"
    ))
    return launches_tri


def kernel_r2(dev, sys_, traj, idx_o, idx_b) -> dict:
    """Phase 11: pair_hist's radius-2 stencil at full width on frame 0 of
    the box, then rdf(O, O, 35 Å) through the Evaluator, the launch count
    set to 0 just before and read just after. → the kernel's results."""
    t0 = time.perf_counter()
    n_o = idx_o.shape[0]
    x0, basis = traj.device_frame(0)
    inv = inv_basis_of(basis)
    dims, _ = choose_grid(sys_.cell.extent(), R2_CUTOFF, n_o)
    if dims != R2_DIMS or choose_grid_r(sys_.cell.extent(), R2_CUTOFF, n_o)[0] != (2, 2, 2):
        raise AssertionError(f"rdf at {R2_CUTOFF} A: grid {dims}, expected {R2_DIMS}")
    h_route = cuda_rdf.pair_dist_histogram_cl(
        x0, idx_o, idx_o, basis, inv, NBINS, R2_CUTOFF, dims, radius=2
    )
    h_plain = all_pairs(x0, idx_o, idx_o, basis, inv, R2_CUTOFF)
    err = hist_err(h_route, h_plain)
    err_ab = hist_err(
        cuda_rdf.pair_dist_histogram_cl(x0, idx_o, idx_b, basis, inv, NBINS, R2_CUTOFF,
                                        dims, radius=2),
        all_pairs(x0, idx_o, idx_b, basis, inv, R2_CUTOFF),
    )
    # on prebuilt cell lists against the kernel's walk: the half stencil
    # (O–O) and the full one (O against every 5th atom)
    a_cells = cuda_rdf.cell_lists(x0, idx_o, basis, inv, dims)
    b_cells = cuda_rdf.cell_lists(x0, idx_b, basis, inv, dims)
    args = (*a_cells, *a_cells, basis, inv, dims, NBINS, R2_CUTOFF, True, 2)
    args_ab = (*a_cells, *b_cells, basis, inv, dims, NBINS, R2_CUTOFF, False, 2)
    work, work_ab = {}, {}
    h_cells = cuda_rdf.pair_hist_cells(*args)
    err_walk = hist_err(h_cells, cuda_rdf.pair_hist_cells_plain(*args, work=work))
    hist_err(h_cells, h_plain)
    err_walk_ab = hist_err(cuda_rdf.pair_hist_cells(*args_ab),
                           cuda_rdf.pair_hist_cells_plain(*args_ab, work=work_ab))
    needed = half_stencil_pairs(a_cells[2], dims, n_o, radius=2)
    if work["pairs"] != needed:
        raise AssertionError(f"the radius-2 half-stencil walk tests {work['pairs']} "
                             f"pairs, expected {needed}")
    if bool((basis != torch.diag(torch.diagonal(basis))).any()):
        raise AssertionError("the operation count assumes an orthorhombic box")
    ms_kernel = cuda_ms(lambda: cuda_rdf.pair_hist_cells(*args), queued=True)
    ms_route = cuda_ms(lambda: cuda_rdf.pair_dist_histogram_cl(
        x0, idx_o, idx_o, basis, inv, NBINS, R2_CUTOFF, dims, radius=2
    ))
    ms_plain = cuda_ms(lambda: all_pairs(x0, idx_o, idx_o, basis, inv, R2_CUTOFF),
                       reps=3, warmup=1)
    hits = int(h_plain.sum().item())
    nbytes = sum(a.numel() * 4 for a in a_cells) + 72 + NBINS * 4
    r2_bound, r2_bound_by = bound(needed * OPS_PAIR + hits / 2 * OPS_PAIR_HIT, nbytes)
    # the script through the Evaluator
    src = f"r = rdf(element('O'), element('O'), {R2_CUTOFF});"
    cs = compile_script(src, sys_, dev)
    ev = Evaluator(cs, traj, chunk=16)
    g = ev.script.grids[0]
    if cs.routes != ev.script.routes or ev.script.routes != ["rdf:cell_list_r2"] \
            or (g.dims, g.radius) != (R2_DIMS, 2):
        raise AssertionError((cs.routes, ev.script.routes, g))
    ev.run(range(16)).force()  # warm-up
    cuda_rdf.launches = 0
    times, res = timed_runs_range(ev, range(R2_FRAMES))
    launches = cuda_rdf.launches  # read just after the main path
    if launches < 3 * R2_FRAMES:
        raise AssertionError(f"pair_hist launched {launches} times over the radius-2 "
                             f"path, expected >= {3 * R2_FRAMES}")
    _, acc = ev.script.frame_fn(x0, basis, inv)
    err_frame = hist_err(acc["r"], h_plain)
    r_sum = float(res.distributions["r"].sum())
    if not r_sum > 0:
        raise AssertionError("empty radius-2 rdf")
    ms_frame = [t * 1e3 / R2_FRAMES for t in times]
    phase("kernel-r2", t0, (
        f"pair_hist radius 2, rdf(O, O, {R2_CUTOFF:g} A) n={n_o} dims={dims} "
        f"({n_o / np.prod(dims):.1f} O a cell): candidates, unordered (half stencil, "
        f"63 cells) {work['pairs']}, past the sqrt reject {work['sqrt']}; O vs every "
        f"5th atom (125 cells) {work_ab['pairs']}; in-range pairs {hits}; max bin err "
        f"vs all-pairs {err:g} (A!=B {err_ab:g}), vs the kernel's walk {err_walk:g} "
        f"(A!=B {err_walk_ab:g}); kernel {ms_kernel:.4f} ms (device, queued), cell "
        f"list + kernel {ms_route:.4f} ms, plain {ms_plain:.4f} ms, plain/kernel "
        f"{ms_plain / ms_kernel:.1f}x; bound {r2_bound:.4f} ms ({r2_bound_by}), kernel "
        f"at {r2_bound / ms_kernel * 100:.1f}% of the bound | the script ({ev.script.routes}, "
        f"grid {g.dims}, radius {g.radius}), frames 0-{R2_FRAMES - 1}: ms/frame "
        f"{' '.join(f'{m:.3f}' for m in ms_frame)} (best {min(ms_frame):.3f}); r-sum "
        f"{r_sum:.6g}; pair_hist launches {launches}; frame 0's r vs all-pairs max bin "
        f"err {err_frame:g}"
    ))
    return dict(launches=launches, err=err, ms=ms_kernel, plain_ms=ms_plain,
                bound_ms=r2_bound, bound_by=r2_bound_by)


def other_routes(dev, sys_, traj) -> None:
    """Phase 12: config #1 against the CPU, the SDF cell list on the box,
    that SDF route on a small box against the CPU, config #5 and its frames
    0-7 against the CPU."""
    t0 = time.perf_counter()
    # BASELINE config #1: the reference's default script, aperiodic, dense
    pa_sys, pa_traj = datagen.polyala_helix(64, n_frames=CONFIG1_FRAMES)
    pa_frames, pa_cells = pa_traj.load_frames(range(CONFIG1_FRAMES))
    out1 = {}
    for d in ("cpu", dev):
        cs = compile_script(CONFIG1, pa_sys, d)
        if cs.routes != ["rdf:dense"]:
            raise AssertionError(cs.routes)
        ev1 = Evaluator(cs, trajectory_from_numpy(pa_frames, pa_cells, d), chunk=50)
        out1[str(d)] = timed_runs(ev1, 3 if d == dev else 1)
    times1, res1 = out1[str(dev)]
    res1_cpu = out1["cpu"][1]
    err1 = hist_err(torch.as_tensor(res1.distributions["r"]),
                    torch.as_tensor(res1_cpu.distributions["r"]))
    d1_err = float(np.abs(res1.temporal["d1"] - res1_cpu.temporal["d1"]).max())
    if d1_err > 1e-5:
        raise AssertionError(f"config #1 d1 differs from the CPU by {d1_err}")
    fps1 = [CONFIG1_FRAMES / t for t in times1]
    # sdf over 4,096 water residues: S·n_t = 2.7e8, the SDF cell list
    src_cl = "v = sdf(residue(1:4096), element('H'), 5.0);"
    t1 = time.perf_counter()
    cs_cl = compile_script(src_cl, sys_, dev)
    t_compile_cl = time.perf_counter() - t1
    ev_cl = Evaluator(cs_cl, traj, chunk=8)
    if cs_cl.routes != ["sdf:cell_list"] or ev_cl.script.routes != cs_cl.routes:
        raise AssertionError((cs_cl.routes, ev_cl.script.routes))
    site = ev_cl.script.grids[0]
    ev_cl.run(range(1)).force()
    t1 = time.perf_counter()
    r_cl = ev_cl.run(range(8))
    v_cl = float(r_cl.volumes["v"].sum())
    ms_cl = (time.perf_counter() - t1) * 1e3 / 8
    # that route on a small box, CUDA against the CPU
    # on the box's ideal waters: in a jittered frame the float32 closed-form
    # Kabsch of a few 3-atom waters is ill-conditioned (4 of these 512 turn
    # by up to 0.38 against float64), and the card and the CPU round those
    # differently (ROADMAP queue 3)
    sm_sys, _ = water_box(3_000, n_frames=1, seed=SEED)
    sm_x = sm_sys.coords()
    structs = [np.arange(3 * k, 3 * k + 3) for k in range(512)]
    sidx, sw, srefc = sdf_ops.make_structure_inputs(structs, sm_sys.mass, sm_x)
    tw = (sm_sys.element == 1).astype(np.float32)
    idx_t = np.nonzero(tw)[0]
    sm_basis = sm_sys.cell.basis
    grid_sm = sdf_ops.sdf_cell_grid(perpendicular_widths(sm_basis)[0], 4.0,
                                    sm_x[idx_t] / np.diag(sm_basis), False)
    sm_box = np.diag(sm_basis)
    sm_compact = sdf_ops.sdf_compact_capacity(
        len(structs), idx_t.size, sm_box, 4.0, 64,
        support_count=sdf_ops.sdf_frame0_support_count(
            sm_x[idx_t], sm_x, sidx, sw, srefc, sm_box, 4.0, 64),
    )
    v_sm = {}
    for d in ("cpu", dev):
        t = lambda a: torch.as_tensor(np.asarray(a), device=d)  # noqa: E731
        v_sm[str(d)] = sdf_ops.sdf_accumulate_cl(
            t(sm_x), t(tw), t(sidx).long(), t(sw), t(srefc), 4.0, 64, t(sm_basis),
            inv_basis_of(t(sm_basis)), t(idx_t).long(), grid_sm[0], grid_sm[1],
            t(grid_sm[2]).long(), compact_cap=sm_compact,
        ).cpu().numpy()
    # the card's Kabsch and min-image round differently from the CPU's: a
    # voxel moves by up to ~1e-5 of the grid's maximum (tests/test_torch_sdf_routes.py)
    np.testing.assert_allclose(v_sm[str(dev)], v_sm["cpu"], rtol=1e-4,
                               atol=2e-5 * np.abs(v_sm["cpu"]).max())
    if not v_sm["cpu"].sum() > 0:
        raise AssertionError("empty small-box SDF")
    # BASELINE config #5's script on 20,001 atoms
    s5_sys, s5_traj = water_box_device(CONFIG5_WATERS, n_frames=CONFIG5_FRAMES,
                                       seed=SEED, device=dev)
    cs5 = compile_script(CONFIG5, s5_sys, dev)
    if cs5.routes != ["rdf:cell_list"]:
        raise AssertionError(cs5.routes)
    ev5 = Evaluator(cs5, s5_traj, chunk=128)
    times5, res5 = timed_runs(ev5)
    fps5 = [CONFIG5_FRAMES / t for t in times5]
    for k in ("d1", "a1", "iso"):
        if not np.isfinite(res5.temporal[k]).all():
            raise AssertionError(k)
    # its frames 0-7 on CUDA against the CPU (held to the JAX package by
    # tests/test_torch_geometry.py): r exact, d1 within 1e-5 Å, a1 within
    # 1e-4 rad (in degrees), the shape weights within 1e-5
    res5_gpu = ev5.run(range(8))
    frames5 = s5_traj.stack[:8].cpu().numpy()
    cells5 = s5_traj.cells[:8].cpu().numpy()
    res5_cpu = Evaluator(compile_script(CONFIG5, s5_sys, "cpu"),
                         trajectory_from_numpy(frames5, cells5, "cpu"), chunk=8).run()
    err5 = hist_err(torch.as_tensor(res5_gpu.distributions["r"]),
                    torch.as_tensor(res5_cpu.distributions["r"]))
    diff5 = {}
    for k, tol in (("d1", 1e-5), ("a1", 1e-4 * 57.3), ("lin", 1e-5), ("plan", 1e-5),
                   ("iso", 1e-5)):
        got, want = res5_gpu.temporal[k], res5_cpu.temporal[k]
        if got.shape != (8, 1) or want.shape != (8, 1):
            raise AssertionError((k, got.shape, want.shape))
        diff5[k] = float(np.abs(got - want).max())
        if not diff5[k] <= tol:
            raise AssertionError(f"config #5 {k} differs from the CPU by {diff5[k]} (tol {tol})")
    phase("routes", t0, (
        f"config #1 ({pa_sys.natoms} atoms, aperiodic, {CONFIG1_FRAMES} frames, "
        f"{cs.routes}): frames/s {' '.join(f'{f:.1f}' for f in fps1)} (best "
        f"{max(fps1):.1f}); CUDA vs CPU: r max bin err {err1:g}, d1 max diff "
        f"{d1_err:.3g} | sdf(residue(1:4096), H, 5 A) "
        f"({cs_cl.routes}, grid {site.dims}, cap {site.capacity}, "
        f"{len(site.stencil)} stencil cells; compile {t_compile_cl:.2f} s): "
        f"{ms_cl:.3f} ms/frame (frames 0-7), v-sum {v_cl:.6g}; small box (512 "
        f"structures, grid {grid_sm[0]}) CUDA vs CPU max abs diff "
        f"{float(np.abs(v_sm[str(dev)] - v_sm['cpu']).max()):.3g} | config #5 "
        f"({s5_sys.natoms} atoms, {CONFIG5_FRAMES} frames, {cs5.routes}): frames/s "
        f"{' '.join(f'{f:.1f}' for f in fps5)} (best {max(fps5):.1f}); frames 0-7 "
        f"CUDA vs CPU: r max bin err {err5:g}, max diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in diff5.items())
    ))


def launches_per_frame(ev, frames) -> str:
    """CUDA kernel launches per frame of `ev` over `frames`, from the
    profiler's launch calls; "not measured" when it records none."""
    from torch.profiler import ProfilerActivity, profile

    ev.run(frames).force()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.run(frames).force()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return f"{n / len(frames):.1f}" if n else "not measured"


def sync_points(fn) -> list:
    """The places where fn() makes the host wait for the device, as
    torch.cuda's sync debug mode reports them: ["file:line message", ...]."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno} {str(w.message)[:80]}"
                   for w in caught if "called a synchronizing" in str(w.message)})


def frame_waits(fn) -> float:
    """Host ms of fn() behind ~100 ms of queued sleep: well under 100 when
    fn never waits on the device."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES * 100)
    t1 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    return ms


def default_phase(dev) -> None:
    """[default]: the reference's default script over polyala_helix(64, 500
    frames) with postprocess (BASELINE config #1's dataset size, 448 atoms,
    aperiodic) through compile_script → Evaluator on the card: routes,
    frames/s of three runs, launches a frame; all 500 frames held to the CPU
    path — r bin for bin, d1 rtol 1e-5 + 1e-4 Å, a1 1e-4 rad, the shape
    weights 1e-3 and v rtol 1e-3 + 1e-3 of its maximum (the float32
    closed-form Kabsch of mass-weighted residues, tests/test_torch_script_lang.py)."""
    t0 = time.perf_counter()
    sys_, traj = datagen.polyala_helix(DEFAULT_RES, n_frames=DEFAULT_FRAMES)
    frames, cells = traj.load_frames(range(DEFAULT_FRAMES))
    res = {}
    t_card = t_cpu = 0.0
    for d in (dev, "cpu"):
        cs = compile_script(DEFAULT, sys_, d)
        if cs.routes != ["rdf:dense", "sdf:dense"]:
            raise AssertionError(cs.routes)
        ev = Evaluator(cs, trajectory_from_numpy(frames, cells, d), chunk=50)
        t1 = time.perf_counter()
        if d == dev:
            ev.run(range(50)).force()
            times, res[d] = timed_runs_range(ev, None)
            launches = launches_per_frame(ev, range(8))
            t_card = time.perf_counter() - t1
        else:
            res[d] = ev.run()
            t_cpu = time.perf_counter() - t1
    got, want = res[dev], res["cpu"]
    r_err = hist_err(torch.as_tensor(got.distributions["r"]),
                     torch.as_tensor(want.distributions["r"]))
    diffs = {}
    for k, rtol, atol in (("d1", 1e-5, 1e-4), ("a1", 0.0, 1e-4 * RAD2DEG), ("lin", 0.0, 1e-3),
                          ("plan", 0.0, 1e-3), ("iso", 0.0, 1e-3)):
        g, w = got.temporal[k], want.temporal[k]
        if g.shape != w.shape or g.shape[0] != DEFAULT_FRAMES or not np.isfinite(g).all():
            raise AssertionError((k, g.shape, w.shape))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
        diffs[k] = float(np.abs(g - w).max())
    v, vw = got.volumes["v"], want.volumes["v"]
    np.testing.assert_allclose(v, vw, rtol=1e-3, atol=1e-3 * np.abs(vw).max())
    fps = [DEFAULT_FRAMES / t for t in times]
    phase("default", t0, (
        f"{sys_.natoms} atoms ({sys_.nbonds} bonds, {sys_.backbone.count} backbone "
        f"residues), {DEFAULT_FRAMES} frames, routes {cs.routes}: frames/s "
        f"{' '.join(f'{f:.1f}' for f in fps)} (best {max(fps):.1f}); launches a frame "
        f"{launches}; all frames vs the CPU: r max bin err {r_err:g}, max diff "
        + ", ".join(f"{k} {e:.3g}" for k, e in diffs.items())
        + f", v {float(np.abs(v - vw).max()):.3g} (max {float(vw.max()):.6g}); card "
        f"{t_card:.2f} s, CPU {t_cpu:.2f} s"
    ))


def count_within64(x: np.ndarray, tgt: np.ndarray, cut: float, box: np.ndarray) -> int:
    """Atoms within `cut` of any atom of `tgt`, in float64 on the host
    (periodic KD-tree)."""
    from scipy.spatial import cKDTree

    xw = np.mod(x.astype(np.float64), box)
    xw[xw >= box] = 0.0
    tree = cKDTree(xw[tgt], boxsize=box)
    return int((np.asarray(tree.query_ball_point(xw, r=cut, return_length=True)) > 0).sum())


def lang_phase(dev, sys_, traj, headline) -> int:
    """[lang]: the rest of the language over the headline box (LANG): routes,
    frames/s of three runs with pair_hist's launch count set to 0 before and
    read after, launches a frame, whether frame_fn waits on the device, each
    statement's ms/frame alone over 64 frames, `n` against a float64 count
    on three frames (exact), and frames 0-7 against the CPU path (r, whose
    CPU route is the all-pairs histogram, against that function on the
    card). `headline`: the `[main]` Evaluator, whose frame_fn's waits on
    the device are counted too. → pair_hist launches of the timed runs."""
    t0 = time.perf_counter()
    src = "\n".join(LANG) + "\n"
    t1 = time.perf_counter()
    cs = compile_script(src, sys_, dev)
    t_compile = time.perf_counter() - t1
    if cs.routes != ["rdf:cell_list"]:
        raise AssertionError(cs.routes)
    ev = Evaluator(cs, traj, chunk=CHUNK)
    ev.run(range(CHUNK)).force()
    n_frames = traj.num_frames
    cuda_rdf.launches = 0
    times, res = timed_runs_range(ev, None)
    launches = cuda_rdf.launches  # read just after the timed runs
    if launches != 3 * n_frames:
        raise AssertionError(f"pair_hist launched {launches} times in 3 runs of {n_frames} frames")
    per_frame = launches_per_frame(ev, range(min(8, n_frames)))
    x0, b0 = traj.device_frame(0)
    inv0 = inv_basis_of(b0)
    ev.script.frame_fn(x0, b0, inv0)
    syncs = sync_points(lambda: ev.script.frame_fn(x0, b0, inv0))
    head_syncs = sync_points(lambda: headline.script.frame_fn(x0, b0, inv0))
    wait_ms = frame_waits(lambda: ev.script.frame_fn(x0, b0, inv0))
    if syncs or wait_ms > 80.0:
        waits = {}  # statement by statement, to name the culprits
        for stmt in LANG[1:]:
            one = Evaluator(compile_script(LANG[0] + "\n" + stmt, sys_, dev), traj).script
            one.frame_fn(x0, b0, inv0)
            waits[stmt] = (frame_waits(lambda: one.frame_fn(x0, b0, inv0)),
                           sync_points(lambda: one.frame_fn(x0, b0, inv0)))
        raise AssertionError(f"frame_fn took {wait_ms:.1f} ms behind 100 ms of queued "
                             f"sleep; it waits on the device at {syncs}; alone: {waits}; "
                             f"the headline's frame_fn at {head_syncs}")
    shapes = {k: res.temporal[k].shape for k in ("n", "c", "dm", "rm", "a", "p")}
    n_a = int((sys_.element == 8).sum())
    want_shapes = {"n": (n_frames, 1), "c": (n_frames, 3), "dm": (n_frames, 1),
                   "rm": (n_frames, 1), "a": (n_frames, n_a), "p": (n_frames, 4)}
    if shapes != want_shapes:
        raise AssertionError((shapes, want_shapes))
    for k in shapes:
        if not np.isfinite(res.temporal[k]).all():
            raise AssertionError(k)
    # n against a float64 count
    box = np.asarray(sys_.cell.extent(), np.float64)
    tgt = np.arange(int(sys_.res_offsets[0]), int(sys_.res_offsets[64]))
    counts = []
    for f in LANG_COUNT_FRAMES:
        x = traj.stack[f].cpu().numpy()
        want = count_within64(x, tgt, 3.5, box)
        if res.temporal["n"][f, 0] != want:
            raise AssertionError(f"frame {f}: n {res.temporal['n'][f, 0]} vs float64 {want}")
        counts.append(want)
    # frames 0-7 against the CPU path
    t_cpu = time.perf_counter()
    frames = traj.stack[:LANG_CPU_FRAMES].cpu().numpy()
    cells = traj.cells[:LANG_CPU_FRAMES].cpu().numpy()
    cpu_src = "\n".join(st for st in LANG if not st.startswith("r ")) + "\n"
    cpu = Evaluator(compile_script(cpu_src, sys_, "cpu"),
                    trajectory_from_numpy(frames, cells, "cpu"), chunk=4).run()
    gpu = ev.run(range(LANG_CPU_FRAMES))
    diffs = {}
    for k, rtol, atol in (("n", 0.0, 0.0), ("c", 1e-5, 1e-4), ("dm", 1e-5, 1e-4),
                          ("rm", 0.0, 1e-3), ("a", 0.0, 1e-4 * RAD2DEG), ("p", 0.0, 1e-3)):
        g, w = gpu.temporal[k], cpu.temporal[k]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
        diffs[k] = float(np.abs(g - w).max())
    idx_o = torch.as_tensor(np.nonzero(sys_.element == 8)[0], device=dev)
    ones = torch.ones(idx_o.shape[0], device=dev)
    r_errs = []
    for f in (0, LANG_CPU_FRAMES - 1):
        x, b = traj.device_frame(f)
        _, acc = ev.script.frame_fn(x, b, inv_basis_of(b))
        r_errs.append(hist_err(acc["r"], pair_dist_histogram_scatter_idx(
            x, idx_o, idx_o, ones, ones, b, inv_basis_of(b), NBINS, R_MAX)))
    t_cpu = time.perf_counter() - t_cpu
    # each statement alone (after `s`), over 64 frames
    t_alone = time.perf_counter()
    alone = []
    for stmt in LANG:
        one = compile_script(stmt if stmt == LANG[0] else LANG[0] + "\n" + stmt, sys_, dev)
        ev1 = Evaluator(one, traj, chunk=CHUNK)
        frames1 = range(LANG_ALONE_FRAMES)
        ev1.run(range(4)).force()
        t1 = time.perf_counter()
        ev1.run(frames1).force()
        alone.append((stmt.split("=")[0].strip(), (time.perf_counter() - t1) * 1e3 / LANG_ALONE_FRAMES))
    t_alone = time.perf_counter() - t_alone
    fps = [n_frames / t for t in times]
    phase("lang", t0, (
        f"{sys_.natoms} atoms x {n_frames} frames, chunk {CHUNK}, routes {cs.routes}, "
        f"compile {t_compile:.2f} s: frames/s {' '.join(f'{f:.1f}' for f in fps)} (best "
        f"{max(fps):.1f}); pair_hist launches {launches} in 3 runs; launches a frame "
        f"{per_frame}; frame_fn behind 100 ms of queued sleep {wait_ms:.2f} ms, sync "
        f"points {len(syncs)} (the headline's frame_fn: {len(head_syncs)}"
        + (f", at {head_syncs}" if head_syncs else "") + "); ms/frame "
        f"alone over {LANG_ALONE_FRAMES} frames (each after s): "
        + ", ".join(f"{k} {ms:.3f}" for k, ms in alone)
        + f" | n vs float64 on frames {LANG_COUNT_FRAMES}: {counts} (equal); frames "
        f"0-{LANG_CPU_FRAMES - 1} vs the CPU: max diff "
        + ", ".join(f"{k} {e:.3g}" for k, e in diffs.items())
        + f"; r vs all pairs max bin err {max(r_errs):g}; the CPU comparison "
        f"{t_cpu:.2f} s, the statements alone {t_alone:.2f} s"
    ))
    return launches


def write_gro(path, sys_, x: np.ndarray, title: str = "viamd_tpu_torch water box") -> None:
    """A GROMACS .gro of `sys_` at coordinates `x` (Å): the fixed columns
    `%5d%-5s%5s%5d%8.3f%8.3f%8.3f` in nm, residue and atom serials mod
    100,000, then the box line (`%10.5f`, nm; the three extents, or all
    nine components of a triclinic cell)."""
    rid = sys_.atom_res_id() % 100_000
    rname = [sys_.res_names[i] for i in sys_.atom_res_name_id()]
    aname = [sys_.atom_names[i] for i in sys_.atom_name_id]
    xn = np.asarray(x, np.float64) / 10.0
    lines = [title, f"{sys_.natoms:5d}"]
    lines += [
        f"{r:5d}{rn:<5.5s}{an:>5.5s}{(i + 1) % 100_000:5d}{a:8.3f}{b:8.3f}{c:8.3f}"
        for i, (r, rn, an, (a, b, c)) in enumerate(zip(rid, rname, aname, xn.tolist()))
    ]
    v = np.asarray(sys_.cell.basis, np.float64) / 10.0
    box = [v[0, 0], v[1, 1], v[2, 2]]
    if sys_.cell.is_periodic and not sys_.cell.is_orthorhombic:
        box += [v[0, 1], v[0, 2], v[1, 0], v[1, 2], v[2, 0], v[2, 1]]
    lines.append("".join(f"{b:10.5f}" for b in box))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def equal_results(a, b) -> list:
    """The properties in which two EvalResults differ in any bit: every
    temporal value, distribution and volume."""
    bad = [k for k in a.temporal if not np.array_equal(a.temporal[k], b.temporal[k])]
    bad += [k for k in a.distributions if not np.array_equal(a.distributions[k], b.distributions[k])]
    bad += [k for k in a.volumes if not np.array_equal(a.volumes[k], b.volumes[k])]
    return bad


def io_phase(dev, n_waters: int = N_WATERS, n_frames: int = N_FRAMES,
             chunk: int = IO_CHUNK, stop_chunks: int = IO_STOP_CHUNKS,
             headline: "Evaluator | None" = None) -> dict:
    """[io]: the analysis path with its input read from files, through the
    entry points a user calls: the headline box (datagen.water_box on the
    host) written as .gro + .xtc, `load_file` of both (the first .xtc open
    decodes and transcodes a .vtraj sidecar, the second opens it),
    compile_script → Evaluator staged, streamed from the sidecar and
    streamed from the .xtc; checks as the docstring of this file lists.
    `headline`: the `[main]` Evaluator (the same script over the device-
    generated box, chunk 64), timed once here beside the staged runs.
    → {"launches": pair_hist launches of the timed runs, "fps": their
    frames/s by trajectory}."""
    t0 = time.perf_counter()
    SCRATCH.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="io-", dir=SCRATCH))
    try:
        return _io_phase(dev, n_waters, n_frames, chunk, stop_chunks, headline, work, t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _io_phase(dev, n_waters, n_frames, chunk, stop_chunks, headline, work: Path, t0) -> dict:
    # -- 1. the input files
    t1 = time.perf_counter()
    sys0, traj0 = water_box(n_waters, n_frames=n_frames, seed=SEED)
    frames0, _ = traj0.load_frames(range(n_frames))
    t_gen = time.perf_counter() - t1
    gro, xtc = str(work / "box.gro"), str(work / "box.xtc")
    t1 = time.perf_counter()
    write_gro(gro, sys0, sys0.coords())
    t_gro = time.perf_counter() - t1
    t1 = time.perf_counter()
    write_xtc(xtc, frames0, sys0.cell, precision=1000.0)
    t_xtc = time.perf_counter() - t1
    del frames0, traj0
    mib = {p: os.path.getsize(p) / 2**20 for p in (gro, xtc)}
    # -- 2. load
    t1 = time.perf_counter()
    system = load_file(gro).system
    t_gro_open = time.perf_counter() - t1
    t1 = time.perf_counter()
    first = load_file(xtc, system=system)
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    packed = load_file(xtc, system=system).trajectory
    t_second = time.perf_counter() - t1
    raw = load_file(xtc, system=system, cache=False).trajectory
    kinds = [type(t).__name__ for t in (first.trajectory, packed, raw)]
    if kinds != ["PackedTrajectory", "PackedTrajectory", "XTCTrajectory"]:
        raise AssertionError(kinds)
    mib["box.xtc.vtraj"] = os.path.getsize(xtc + ".vtraj") / 2**20
    sel = compile_script("o = element('O');\nh = element('H');\n", system, dev).selections
    for name, z in (("o", 8), ("h", 1)):
        want = np.nonzero(sys0.element == z)[0]
        if not np.array_equal(sel[name].mask.indices(), want):
            raise AssertionError(f"element({name!r}) selects {sel[name].mask.popcount()} "
                                 f"atoms of the .gro, datagen has {want.size}")
    if packed.num_frames != n_frames or packed.num_atoms != sys0.natoms:
        raise AssertionError((packed.num_frames, packed.num_atoms))
    # -- 3. evaluate: staged, streamed from the sidecar, streamed from the .xtc
    t1 = time.perf_counter()
    cs = compile_script(HEADLINE, system, dev)
    t_compile = time.perf_counter() - t1
    if cs.routes != ["rdf:cell_list", "sdf:pairs"]:
        raise AssertionError(cs.routes)
    t1 = time.perf_counter()
    staged = DeviceTrajectory.stage(packed, dev)
    staged.stack[-1, -1].sum().item()  # the staging copy has landed
    t_stage = time.perf_counter() - t1
    runs, results, launches = {}, {}, {}
    for name, traj, n_runs in (("staged", staged, 2), ("streamed", packed, 2),
                               ("xtc", raw, 1)):
        ev = Evaluator(cs, traj, chunk=chunk)
        if name == "staged":
            ev.run().force()  # warm-up (the frame function is shared)
        cuda_rdf.launches = 0
        runs[name], results[name] = timed_runs_range(ev, None, n_runs)
        launches[name] = cuda_rdf.launches  # read just after the timed runs
        if launches[name] != n_runs * n_frames:
            raise AssertionError(f"{name}: pair_hist launched {launches[name]} times in "
                                 f"{n_runs} runs of {n_frames} frames")
        if name == "staged" and headline is not None:
            main_fps = headline.traj.num_frames / timed_runs_range(headline, None, 1)[0][0]
    # -- 4. the results: streamed equal to staged, r against all pairs
    for name in ("streamed", "xtc"):
        bad = equal_results(results[name], results["staged"])
        if bad:
            raise AssertionError(f"{name} differs from staged in {bad}")
    res = results["staged"]
    for k in ("lin", "plan", "iso"):
        if res.temporal[k].shape != (n_frames, 1) or not np.isfinite(res.temporal[k]).all():
            raise AssertionError(k)
    if not (res.distributions["r"].sum() > 0 and res.volumes["v"].sum() > 0):
        raise AssertionError("empty r or v")
    ev_s = Evaluator(cs, staged, chunk=chunk)
    idx_o = torch.as_tensor(np.nonzero(system.element == 8)[0], device=dev)
    r_errs = []
    for f in (0, n_frames - 1):
        x, b = staged.device_frame(f)
        inv = inv_basis_of(b)
        _, acc = ev_s.script.frame_fn(x, b, inv)
        r_errs.append(hist_err(acc["r"], all_pairs(x, idx_o, idx_o, b, inv)))
    # -- 5. the streamed staging step never waits on the device
    ev = Evaluator(cs, packed, chunk=chunk)
    stream = ev.stream()
    stream.start([np.arange(i, min(i + chunk, n_frames)) for i in range(0, 3 * chunk, chunk)])
    try:
        stream.next()
        stream.ready()
        syncs = sync_points(stream.next)
        stream.ready()
        stage_ms = frame_waits(stream.next)
    finally:
        stream.close()
    if syncs or stage_ms >= 100.0:
        raise AssertionError(f"the staging step waits: {syncs}, {stage_ms:.2f} ms behind "
                             "100 ms of queued sleep")
    # -- 6. interrupt after `stop_chunks` chunks, checkpoint, resume
    state = {"done": 0.0}
    part = ev.run(progress=lambda f: state.update(done=f),
                  interrupt=lambda: state["done"] >= stop_chunks * chunk / n_frames)
    if not part.interrupted or part.n_frames_done != stop_chunks * chunk:
        raise AssertionError((part.interrupted, part.n_frames_done))
    ckpt = str(work / "part.npz")
    save_checkpoint(part, ckpt)
    resumed = ev.run(resume_from=load_checkpoint(ckpt))
    full = results["streamed"]
    if resumed.frame_mask.popcount() != n_frames or resumed.n_frames_done != n_frames:
        raise AssertionError((resumed.frame_mask.popcount(), resumed.n_frames_done))
    bad = [k for k in full.temporal if not np.array_equal(resumed.temporal[k], full.temporal[k])]
    if bad:
        raise AssertionError(f"resumed temporal values differ: {bad}")
    rel = {}
    for k, got, want in [(k, resumed.distributions[k], full.distributions[k]) for k in full.distributions] + \
            [(k, resumed.volumes[k], full.volumes[k]) for k in full.volumes]:
        dev_abs = np.abs(got.astype(np.float64) - want)
        if (dev_abs > IO_RTOL * np.abs(want)).any():
            raise AssertionError(f"resumed {k} off by {dev_abs.max()} (relative {IO_RTOL})")
        nz = want != 0
        rel[k] = float((dev_abs[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0
    # -- 7. import of an .xvg
    xvg = str(work / "energy.xvg")
    cols = np.stack([np.arange(n_frames) * 2.0, np.sin(np.arange(n_frames) * 0.1) * 50.0])
    write_xvg(xvg, cols, title="E", xaxis="t (ps)", yaxis="kJ/mol", legends=["E"])
    want_cols = read_xvg(xvg)[0]
    cs_e = compile_script(HEADLINE + f'e = import("{xvg}");\n', system, dev)
    x, b = staged.device_frame(0)
    t_e, _ = cs_e.frame_fn(x, b, inv_basis_of(b))
    got_cols = t_e["e"].cpu().numpy().reshape(want_cols.shape)
    if want_cols.shape != (2, n_frames) or not np.array_equal(got_cols, want_cols):
        raise AssertionError(f"import: {got_cols.shape} vs {want_cols.shape}")
    fps = {k: [n_frames / t for t in v] for k, v in runs.items()}
    phase("io", t0, (
        f"{system.natoms} atoms x {n_frames} frames, chunk {chunk}: water_box {t_gen:.2f} s, "
        f"wrote .gro {t_gro:.2f} s ({mib[gro]:.1f} MiB), .xtc {t_xtc:.2f} s "
        f"({mib[xtc]:.1f} MiB, {mib[xtc] * 2**20 / (system.natoms * n_frames):.3f} "
        f"B an atom a frame); load_file .gro {t_gro_open:.2f} s ({system.nbonds} bonds "
        f"inferred), .xtc first open (decode + transcode) {t_first:.2f} s "
        f"(.vtraj {mib['box.xtc.vtraj']:.1f} MiB), second open {t_second * 1e3:.2f} ms; "
        f"O/H selections equal datagen's; compile {t_compile:.2f} s, routes {cs.routes}; "
        f"stage {t_stage:.2f} s; frames/s staged "
        f"{' '.join(f'{f:.1f}' for f in fps['staged'])}"
        + (f" ([main]'s Evaluator here {main_fps:.1f})" if headline is not None else "")
        + f", streamed (.vtraj) "
        f"{' '.join(f'{f:.1f}' for f in fps['streamed'])}, streamed (.xtc, decode in "
        f"the loader) {' '.join(f'{f:.1f}' for f in fps['xtc'])}; pair_hist launches "
        f"{launches['staged']} / {launches['streamed']} / {launches['xtc']}; streamed == "
        f"staged bit for bit (temporal, r, v), from the .xtc too; frames 0 and "
        f"{n_frames - 1} r vs all pairs max bin err {max(r_errs):g}; staging step: sync "
        f"points {len(syncs)}, {stage_ms:.3f} ms behind 100 ms of queued sleep; "
        f"interrupted after {part.n_frames_done} frames, resumed: mask full, temporal "
        f"equal, largest relative deviation "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f"; import of a {n_frames}-row .xvg equal to its columns"
    ))
    return {"launches": sum(launches.values()), "fps": fps}


def bench_volume():
    """bench.py's 128³ two-Gaussian grid, TF, camera and settings at
    WIDTH × HEIGHT (bench.py:141-177) → (grid, tf, model, view, proj,
    settings), numpy."""
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, VOL_D)] * 3), indexing="ij")
    grid = (np.exp(-3 * (xx**2 + yy**2 + zz**2))
            + 0.5 * np.exp(-8 * ((xx - 0.4) ** 2 + yy**2 + zz**2))).astype(np.float32)
    tf = transfer_function("viridis", 256, alpha_scale=0.6)
    view = look_at(np.array([2.2, 1.4, 2.6]), np.zeros(3), np.array([0, 1, 0.0]))
    proj = perspective(np.radians(45.0), WIDTH / HEIGHT, 0.1, 50.0)
    s = VolumeRenderSettings(
        width=WIDTH, height=HEIGHT, enable_dvr=True, enable_iso=True,
        iso_values=VOL_ISOS[0], iso_colors=VOL_ISOS[1], value_range=(0.0, 1.5),
        jitter=True,
    )
    return grid, tf, np.eye(4, dtype=np.float32), view, proj, s


def compare_volume(got, want, und) -> dict:
    """Kernel (rgba, depth) against march_plain's on the same ray table:
    raises unless every pixel outside the undecided ones has rgba within
    VOL_TOL, the same depth (+inf at the same pixels), and the frame is
    not empty. An undecided pixel is one whose march came within rounding
    of a decision (an iso value, alpha 0.995 or 0.5, a grazing hit;
    cuda_volume.UNDECIDED_*); they are counted, and compared only for the
    report."""
    (img, dep), (pimg, pdep) = got, want
    e_rgba = (img - pimg).abs().amax(-1)
    fin = torch.isfinite(dep) & torch.isfinite(pdep)
    e_dep = torch.where(fin, dep - pdep, torch.zeros_like(dep)).abs()
    inf_mis = torch.isfinite(dep) != torch.isfinite(pdep)
    bad = (e_rgba > VOL_TOL) | (e_dep > 0) | inf_mis
    dec = ~und
    off = int((bad & dec).sum())
    if off:
        raise AssertionError(f"volume kernel differs from march_plain at {off} decided pixels "
                             f"(rgba {float(e_rgba[dec].max()):.3g}, depth {float(e_dep[dec].max()):.3g})")
    if float(pimg[..., 3].sum()) <= 1.0:
        raise AssertionError("volume frame empty")
    return dict(rgba_err=float(e_rgba[dec].max()), depth_err=float(e_dep[dec].max()),
                undecided=int(und.sum()), undecided_off=int((bad & und).sum()),
                max_abs_err=max(float(e_rgba[dec].max()), float(e_dep[dec].max())))


def volume_bound(rays, params, work, grid, tf, cvol=None, jitter=None, scene_depth=None) -> dict:
    """The bounds of one frame (ms, bound_by, ops, bytes each): `fused`,
    the kernel's function — the setup's operations per pixel and the
    march's for its live samples and crossings (work: march_plain's
    counts), the grid, TF, colour volume, jitter and scene depth read once
    and the outputs written once; `march`, the march alone on a ray table
    (the table read once instead of the setup's operations and inputs)."""
    P = rays.shape[1]
    hits = int((rays[cuda_volume.RAY_FIELDS.index("hit")] > 0).sum())
    n_iso = len(params.iso_values)
    ops = (work["samples"] * (OPS_VSTEP + (OPS_VDVR if params.enable_dvr else 0))
           + max(work["samples"] - hits, 0) * n_iso * OPS_VISO
           + work["crossings"] * OPS_VCROSS + P * OPS_VRAY)
    volumes = grid.numel() + tf.numel() + (cvol.numel() if cvol is not None else 0)
    nbytes = (rays.numel() + volumes + P * 5) * 4
    fused_ops = ops + P * (OPS_VSETUP + (OPS_VSCENE if scene_depth is not None else 0))
    fused_bytes = (volumes + P * 5 + (P if jitter is not None else 0)
                   + (P if scene_depth is not None else 0)) * 4
    return {"march": (*bound(ops, nbytes), ops, nbytes),
            "fused": (*bound(fused_ops, fused_bytes), fused_ops, fused_bytes)}


def volume_check(name, dev, grid, tf, cvol, model, view, proj, s, seed, t0,
                 scene_depth=None) -> dict:
    """The kernel against its plain version (ray_setup + march_plain) on one
    parameter block and jitter: the ray table it writes to `rays_out`
    against ray_setup's on the card word for word (raises unless 0
    differ), the frames compared, the work, the kernel's device time
    behind a queued sleep and with events around `render`, the plain
    time, both bounds."""
    params = march_params(grid.shape, s, cvol is not None)
    rp = ray_params(grid.shape, model, view, proj, s)
    jit = torch.rand(s.width * s.height, generator=torch.Generator(device=dev).manual_seed(seed),
                     device=dev) if s.jitter else None
    table = torch.full((len(cuda_volume.RAY_FIELDS), s.width * s.height), float("nan"), device=dev)
    got = cuda_volume.render(grid, tf, cvol, rp, params, jit, scene_depth, rays_out=table)
    rays = ray_setup(rp, jit, scene_depth, device=dev)
    torch.cuda.synchronize()
    differ = (table.view(torch.int32) != rays.view(torch.int32)).sum(1)
    if int(differ.sum()):
        raise AssertionError(f"{name}: the kernel's ray table differs from ray_setup's in "
                             f"{int(differ.sum())} words: " + ", ".join(
                                 f"{f} {int(n)}" for f, n in zip(cuda_volume.RAY_FIELDS, differ) if n))
    und, work = [], {}
    want = cuda_volume.march_plain(grid, tf, cvol, rays, s.width, s.height, params, undecided=und,
                                   work=work)
    torch.cuda.synchronize()
    cmp = compare_volume(got, want, und[0])
    def call():
        return cuda_volume.render(grid, tf, cvol, rp, params, jit, scene_depth)

    ms = cuda_ms(call, queued=True)
    ms_call = cuda_ms(call)
    plain_ms = cuda_ms(lambda: cuda_volume.render_plain(grid, tf, cvol, rp, params, jit, scene_depth),
                       reps=1, warmup=0)
    bounds = volume_bound(rays, params, work, grid, tf, cvol, jit, scene_depth)
    (b_ms, b_by, ops, nbytes), (m_ms, m_by, _, _) = bounds["fused"], bounds["march"]
    hit = rays[cuda_volume.RAY_FIELDS.index("hit")] > 0
    phase("volume", t0, (
        f"{name} {s.width}x{s.height}, grid {tuple(grid.shape)}, {params.nsteps} steps, "
        f"{len(params.iso_values)} isos, dvr {params.enable_dvr}, colour volume "
        f"{cvol is not None}, scene depth {scene_depth is not None}: ray table vs ray_setup 0 "
        f"differing words of {table.numel()} ({int(hit.sum())} rays hit); live samples "
        f"{work['samples']}, iso crossings {work['crossings']}; kernel vs plain max rgba err "
        f"{cmp['rgba_err']:.3g}, depth err {cmp['depth_err']:.3g} (decided pixels), undecided "
        f"{cmp['undecided']} ({cmp['undecided_off']} of them off); kernel {ms:.4f} ms (device, "
        f"queued; events around render {ms_call:.4f} ms), plain "
        f"(ray_setup + march_plain) {plain_ms:.1f} ms, plain/kernel {plain_ms / ms:.0f}x; fused "
        f"bound {b_ms:.4f} ms ({b_by}; {ops:.6g} operations, {nbytes} bytes), kernel at "
        f"{b_ms / ms * 100:.1f}% of it; march-alone bound {m_ms:.4f} ms ({m_by})"
    ))
    return dict(cmp, ms=ms, call_ms=ms_call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_march_ms=m_ms, work=work)


def screen_xy(x, view, proj, width: int, height: int):
    """(n, 2) pixel coordinates (column, image row; row 0 at NDC y = −1,
    the raster's convention) of world points x (n, 3)."""
    m = torch.as_tensor(np.asarray(proj, np.float64) @ np.asarray(view, np.float64),
                        dtype=torch.float32).to(x.device)
    h = x @ m[:3, :3].T + m[:3, 3]
    w = x @ m[3, :3] + m[3, 3]
    return torch.stack([(h[:, 0] / w + 1) * 0.5 * width - 0.5,
                        (h[:, 1] / w + 1) * 0.5 * height - 0.5], -1)


def sdf_view(dev, sys_, compiled, res, traj, width: int, height: int) -> dict:
    """The in-scene SDF view (density_volume.py:137-184, :266-302, session.py:
    917-995) of the headline result: the normalized `v`, frame 0's reference
    waters aligned into the volume's frame at 0.3 × vdW in CPK colours,
    rendered by render_molecules, the volume marched up to their depth
    (DVR + 2 isos), OVER-composited, then postprocess.execute with every
    pass (HBAO, motion blur from frames 0 → 1, bokeh DOF, ACES, FXAA,
    sharpen). → the stages' ms, the launch counts and the frame."""
    from viamd_tpu_torch.core.elements import VDW_RADII
    from viamd_tpu_torch.ops.sdf import sdf_reference_frames
    from viamd_tpu_torch.render.color import color_atoms_cpk

    rec = compiled.visualization["sdf"][0]
    extent = float(rec["extent"])
    atoms = np.concatenate(rec["structures"])
    cam = compute_optimal_view([-extent] * 3, [extent] * 3)
    view, proj = cam.view_matrix(), cam.proj_matrix(width, height)
    times = {}

    def stamp(key, t1):
        torch.cuda.synchronize()
        times[key] = (time.perf_counter() - t1) * 1e3

    def aligned(f):  # reference atoms of frame f in the volume's frame
        x, b = traj.device_frame(f)
        R, c = sdf_reference_frames(
            x, torch.as_tensor(rec["struct_idx"], device=dev),
            torch.as_tensor(rec["struct_w"], device=dev),
            torch.as_tensor(rec["ref_centered"], device=dev), b, inv_basis_of(b))
        owner = np.repeat(np.arange(len(rec["structures"])), [len(a) for a in rec["structures"]])
        own = torch.as_tensor(owner, device=dev)
        p = x[torch.as_tensor(atoms, device=dev)]
        return torch.einsum("nij,nj->ni", R[own], p - c[own])

    cuda_raster.launches = cuda_volume.launches = 0
    t1 = time.perf_counter()
    grid = torch.as_tensor(res.normalized_volume("v"), device=dev)
    vmax = float(grid.max()) or 1.0
    stamp("grid", t1)
    t1 = time.perf_counter()
    p0, p1 = aligned(0), aligned(1)
    stamp("align", t1)
    radii = torch.as_tensor(VDW_RADII[sys_.element[atoms]] * 0.3, device=dev)
    colors = torch.as_tensor(color_atoms_cpk(sys_)[atoms], device=dev)
    t1 = time.perf_counter()
    img, dep, pick = render_molecules(p0, radii, colors, view, proj,
                                      RasterSettings(width=width, height=height), device=dev)
    stamp("raster", t1)
    plasma = colormap("plasma", 2)
    s = VolumeRenderSettings(
        width=width, height=height, value_range=(0.0, vmax), enable_iso=True,
        iso_values=tuple(f * vmax for f in SDF_ISO_FRACTIONS),
        iso_colors=tuple((float(r), float(g), float(b), 0.8) for r, g, b in plasma),
    )
    vtf = torch.as_tensor(transfer_function("viridis", 256), device=dev)
    vmodel = model_matrix_from_extent(extent)
    t1 = time.perf_counter()
    vimg, _ = render_volume(grid, vtf, vmodel, view, proj, s, seed=0, scene_depth=dep, device=dev)
    stamp("volume", t1)
    t1 = time.perf_counter()
    va = vimg[..., 3:4]
    comp = torch.cat([vimg[..., :3] + img[..., :3] * img[..., 3:4] * (1.0 - va),
                      va + img[..., 3:4] * (1.0 - va)], -1)
    vel = postprocess.velocity_image(pick, screen_xy(p0, view, proj, width, height),
                                     screen_xy(p1, view, proj, width, height))
    stamp("compose", t1)
    pp = postprocess.PostprocessSettings(enable_dof=True, focus_depth=float(cam.distance()),
                                         enable_motion_blur=True, enable_sharpen=True)
    t1 = time.perf_counter()
    out = postprocess.execute(comp, dep, pp, velocity=vel, proj=proj)
    stamp("postprocess", t1)
    if not (out.shape == (height, width, 3) and bool(torch.isfinite(out).all())):
        raise AssertionError(("sdf view output", tuple(out.shape)))
    launches = dict(raster=cuda_raster.launches, volume=cuda_volume.launches)
    if launches != dict(raster=1, volume=1):
        raise AssertionError(f"sdf view launches {launches}, expected one of each")
    hit = float((pick >= 0).double().mean())
    vol = float((va > 0.01).double().mean())
    if not (hit > 0.001 and vol > 0.01):
        raise AssertionError(f"sdf view: {hit} of pixels hit an atom, {vol} see the volume")
    return dict(times=times, launches=launches, out=out, hit=hit, vol=vol, atoms=len(atoms),
                vmax=vmax, moved=float(vel.abs().max()),
                volume_inputs=(grid, vtf, vmodel, view, proj, s, dep.contiguous()))


def taa_frames(dev, sys_, traj, scene_in, width: int, height: int, n_frames: int) -> dict:
    """TAAReprojector over the render path's frames 0 … n_frames − 1
    (spacefill, the projection jittered by taa_jitter_sequence, velocity
    from each frame's picks through velocity_image): ms of each resolve
    (host clock to a synchronize), and the last output."""
    jit = taa_jitter_sequence(n_frames)
    taa = TAAReprojector()
    s = RasterSettings(width=width, height=height)
    view, proj0 = scene_in["view"], scene_in["proj"]
    prev_xy, ms = None, []
    for f in range(n_frames):
        x = traj.device_frame(f)[0]
        # datagen.render_inputs' projection, jittered as Camera.proj_matrix jitters
        proj = perspective(np.radians(45.0), width / height, 1.0, 500.0,
                           (2.0 * jit[f, 0] / width, 2.0 * jit[f, 1] / height))
        img, dep, pick = render_molecules(x, scene_in["radii"], scene_in["colors"], view, proj,
                                          s, device=dev)
        rgb = postprocess.execute(img, dep, postprocess.PostprocessSettings(), proj=proj)
        xy = screen_xy(x, view, proj0, width, height)
        vel = postprocess.velocity_image(pick, xy, xy if prev_xy is None else prev_xy)
        prev_xy = xy
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = taa.step(rgb, vel, dep, jitter_px=(float(jit[f, 0]), float(jit[f, 1])))
        torch.cuda.synchronize()
        if f:
            ms.append((time.perf_counter() - t1) * 1e3)
    if not (out.shape == (height, width, 3) and bool(torch.isfinite(out).all())):
        raise AssertionError(("taa output", tuple(out.shape)))
    return dict(ms=ms, frame=taa.frame, out=out)


def volume_chain(dev, width: int = 160, height: int = 120) -> str:
    """The volume + postprocess chain on a small scene, CUDA against the CPU
    (whose tests hold it to the JAX package, tests/test_torch_volume.py and
    tests/test_torch_postprocess_passes.py): the unjittered 32³ DVR + 2-iso
    render within VOL_TOL at decided pixels (torch's CPU sqrt and pow round
    apart from the card's), then execute with every pass within 1e-4 at 97%
    of pixels (FXAA's ties; the DOF's hash is the same on both)."""
    x = np.linspace(-1, 1, 32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    grid = (np.exp(-4 * ((X - 0.2) ** 2 + Y**2 + Z**2))
            + 0.7 * np.exp(-6 * (X**2 + (Y + 0.4) ** 2 + (Z - 0.3) ** 2))).astype(np.float32)
    tf = transfer_function("viridis", alpha_scale=0.6)
    cam = compute_optimal_view([-0.5] * 3, [0.5] * 3)
    view, proj = cam.view_matrix(), cam.proj_matrix(width, height)
    s = VolumeRenderSettings(width=width, height=height, jitter=False, enable_iso=True,
                             iso_values=(0.3, 0.7), iso_colors=((1, 0.6, 0.2, 0.5), (0.2, 0.5, 0.9, 0.8)))
    model = model_matrix_from_extent(0.5)
    res = {}
    for d in ("cpu", dev):
        img, dep = render_volume(grid, tf, model, view, proj, s, device=d)
        vel = torch.zeros((height, width, 2), device=d)
        vel[40:80, 50:110] = torch.tensor([4.0, -2.0], device=d)
        pp = postprocess.PostprocessSettings(enable_dof=True, dof_max_blur=6.0,
                                             focus_depth=float(cam.distance()),
                                             enable_motion_blur=True, enable_sharpen=True)
        out = postprocess.execute(img, dep, pp, velocity=vel, proj=proj)
        res[str(d)] = [v.cpu() for v in (img, dep, out)]
    (ci, cd, co), (gi, gd, go) = res["cpu"], res[str(dev)]
    rays = ray_setup(ray_params(grid.shape, model, view, proj, s), device="cpu")
    und = []
    cuda_volume.march_plain(torch.as_tensor(grid), torch.as_tensor(tf), None, rays, width, height,
                            march_params(grid.shape, s, False), undecided=und)
    dec = ~und[0]
    e = (ci - gi).abs().amax(-1)
    fin = torch.isfinite(cd) & torch.isfinite(gd) & dec
    derr = float((cd[fin] - gd[fin]).abs().max()) if bool(fin.any()) else 0.0
    if float(e[dec].max()) > VOL_TOL or derr > 1e-5 * float(cd[fin].abs().max()) or not torch.equal(
            torch.isinf(cd) | ~dec, torch.isinf(gd) | ~dec):
        raise AssertionError(f"small volume CUDA vs CPU: rgba {float(e[dec].max())}, depth {derr}")
    err = (co - go).abs().amax(-1)
    frac = float((err <= 1e-4).double().mean())
    if frac < 0.97:
        raise AssertionError(f"small volume chain: {frac} of pixels within 1e-4")
    return (f"volume rgba {float(e[dec].max()):.3g} depth {derr:.3g} at decided pixels "
            f"({int(und[0].sum())} undecided); chain within 1e-4 at {frac * 100:.2f}% "
            f"(max {float(err.max()):.3g})")


def volume_phase(dev, sys_, compiled, res, traj, scene_in) -> dict:
    """Phase 16, [volume]: the volume view at full width (the module
    docstring lists its parts). → the kernel's results for the JSON line."""
    t0 = time.perf_counter()
    ptxas = [ln.strip() for ln in cuda_build.build_info["volume"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    phase("volume", t0, "csrc/volume.cu ptxas: " + (" | ".join(ptxas) or "(build reused)"))
    grid_np, tf_np, model, view, proj, s = bench_volume()
    grid = torch.as_tensor(grid_np, device=dev)
    tf = torch.as_tensor(tf_np, device=dev)
    main = volume_check("bench.py 128³ DVR + 2 isos", dev, grid, tf, None, model, view, proj, s,
                        SEED, t0)
    # render_volume as a user calls it, a new jitter seed each frame
    render_volume(grid, tf, model, view, proj, s, seed=0, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_volume.launches = 0
    runs = []
    for _ in range(3):
        t1 = time.perf_counter()
        for f in range(VOL_FRAMES):
            img, dep = render_volume(grid, tf, model, view, proj, s, seed=f, device=dev)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t1) * 1e3 / VOL_FRAMES)
    launches = cuda_volume.launches  # read just after the main path
    peak = torch.cuda.max_memory_allocated() / 2**30
    grown = (torch.cuda.max_memory_allocated() - base) / 2**20
    table = len(cuda_volume.RAY_FIELDS) * WIDTH * HEIGHT * 4 / 2**20
    if launches != 3 * VOL_FRAMES:
        raise AssertionError(f"volume kernel launched {launches} times in {3 * VOL_FRAMES} frames")
    if grown >= table:  # two frames' outputs and a jitter draw fit under one ray table
        raise AssertionError(f"render_volume allocated {grown:.1f} MiB: a ray table ({table:.1f} MiB)?")
    if not (bool(torch.isfinite(img).all()) and float(img[..., 3].sum()) > 1.0):
        raise AssertionError("render_volume output")
    ms_setup = cuda_ms(lambda: ray_setup(ray_params(grid.shape, model, view, proj, s), None,
                                         device=dev))
    best = min(runs)
    phase("volume", t0, (
        f"render_volume {WIDTH}x{HEIGHT} frames 0-{VOL_FRAMES - 1}, ms/frame "
        + " | ".join(f"{r:.3f}" for r in runs) + f" (best {best:.3f}; vsync contract "
        f"{VOL_VSYNC_MS} ms: {'met' if best <= VOL_VSYNC_MS else 'missed'}); volume launches "
        f"{launches} (one a frame); peak mem {peak:.3f} GiB, {grown:.1f} MiB allocated over the "
        f"frames (a ray table would be {table:.1f} MiB: none); the plain ray_setup alone (not on "
        f"this path) {ms_setup:.4f} ms (events)"
    ))
    # the in-scene SDF view of the headline result
    t1 = time.perf_counter()
    sdf_view(dev, sys_, compiled, res, traj, WIDTH, HEIGHT)  # warm-up
    view_res = sdf_view(dev, sys_, compiled, res, traj, WIDTH, HEIGHT)
    phase("volume", t0, (
        f"in-scene SDF view {WIDTH}x{HEIGHT}: {view_res['atoms']} reference atoms, v max "
        f"{view_res['vmax']:.4g}, ms " + ", ".join(f"{k} {v:.3f}" for k, v in view_res["times"].items())
        + f"; launches {view_res['launches']}; {view_res['hit'] * 100:.2f}% of pixels on an atom, "
        f"{view_res['vol'] * 100:.2f}% see the volume; largest velocity {view_res['moved']:.3g} px; "
        f"output finite ({time.perf_counter() - t1:.2f} s for two views)"
    ))
    vgrid_in, vtf_in, vmodel_in, vview_in, vproj_in, vs_in, vdep_in = view_res["volume_inputs"]
    volume_check("in-scene SDF view", dev, vgrid_in, vtf_in, None, vmodel_in, vview_in, vproj_in,
                 vs_in, SEED + 2, t0, scene_depth=vdep_in)
    # branch coverage at 512²: a colour volume, a clip sub-box with a
    # background, isos only
    vgrid = torch.as_tensor(res.normalized_volume("v"), device=dev)
    vmax = float(vgrid.max()) or 1.0
    rec = compiled.visualization["sdf"][0]
    ext = float(rec["extent"])
    x0, b0 = traj.device_frame(0)
    near = (x0.abs() < 30.0).all(-1)  # a colour volume from the box's atoms
    pts = x0[near] - x0[near].mean(0)
    cols = torch.as_tensor(datagen.render_inputs(sys_, 8, 8)["colors"][:, :3], device=dev)[near]
    n = vgrid.shape[0]
    cvol, _ = density.splat_color_volume(pts, cols, torch.ones(pts.shape[0], device=dev), (n, n, n),
                                         torch.full((3,), -ext, device=dev),
                                         torch.full((3,), 2 * ext / n, device=dev), blur_sigma=1.0)
    cam = compute_optimal_view([-ext] * 3, [ext] * 3)
    sv, sp = cam.view_matrix(), cam.proj_matrix(VOL_SMALL, VOL_SMALL)
    sm = model_matrix_from_extent(ext)
    iso = dict(enable_iso=True, iso_values=(0.25 * vmax, 0.6 * vmax),
               iso_colors=((0.9, 0.4, 0.2, 0.6), (0.2, 0.5, 0.9, 0.8)))
    base = dict(width=VOL_SMALL, height=VOL_SMALL, value_range=(0.0, vmax))
    small_tf = torch.as_tensor(transfer_function("viridis", 256), device=dev)
    branches = {
        "colour volume": (cvol.contiguous(), VolumeRenderSettings(**base)),
        "clip sub-box + background": (None, VolumeRenderSettings(
            **base, clip_min=(0.2, 0.0, 0.3), clip_max=(0.9, 0.7, 1.0),
            background=(0.1, 0.2, 0.3, 0.7), **iso)),
        "isos only": (None, VolumeRenderSettings(**base, enable_dvr=False, **iso)),
    }
    for name, (cv, st) in branches.items():
        volume_check(name, dev, vgrid, small_tf, cv, sm, sv, sp, st, SEED + 1, t0)
    # TAA over the render path's frames, and the small chain on both devices
    taa = taa_frames(dev, sys_, traj, scene_in, WIDTH, HEIGHT, RENDER_FRAMES)
    phase("volume", t0, (
        f"TAA over the render path's frames 0-{RENDER_FRAMES - 1} at {WIDTH}x{HEIGHT} "
        f"(spacefill, Halton jitter): resolve ms/frame median {statistics.median(taa['ms']):.3f} "
        f"(min {min(taa['ms']):.3f}, max {max(taa['ms']):.3f}); small chain CUDA vs CPU: "
        f"{volume_chain(dev)}"
    ))
    return dict(main, launches=launches, render_ms=runs)


def helix_bundle(n_side: int = BUNDLE_SIDE, n_res: int = BUNDLE_RES,
                 spacing: float = BUNDLE_SPACING):
    """The protein views' scene: n_side² copies of polyala_helix(n_res)'s
    ideal helix on a square lattice `spacing` Å apart in x and y, one chain
    each, through build_system + postprocess (bonds, one backbone range a
    chain), aperiodic → (System, (n, 3) float32 ideal coordinates)."""
    one, _ = datagen.polyala_helix(n_res, n_frames=1)
    base = one.coords()
    k = one.natoms
    offsets = [(i * spacing, j * spacing, 0.0) for i in range(n_side) for j in range(n_side)]
    coords = np.concatenate([base + np.asarray(o, np.float32) for o in offsets])
    n_ch = len(offsets)
    sys_ = core_postprocess(build_system(
        coords=coords,
        atom_names=[one.atom_names[i] for i in one.atom_name_id] * n_ch,
        res_names=["ALA"] * (k * n_ch),
        res_ids=np.tile(np.asarray(one.res_id)[one.atom_res_idx], n_ch),
        chain_ids=[f"C{c}" for c in range(n_ch) for _ in range(k)],
        elements_z=np.tile(one.element, n_ch),
        cell=UnitCell.none(),
    ))
    return sys_, coords.astype(np.float32)


CARTOON_STAGES = ("ss", "colour", "mesh", "bin", "kernel", "tube_mesh", "tube", "composite")


def cartoon_frame(sys_, x, view, proj, width: int, height: int, dev, tables,
                  times=None) -> dict:
    """One frame of the protein views, stage by stage as a Session runs a
    cartoon rep and a tube rep (viamd_tpu_torch/app/session.py, render and
    _draw_rep): the frame to the device and current_ss_weights there; the
    secondary-structure colouring (host); the cartoon's view-space mesh
    through ribbon_view on the system's `tables` (csrc/ribbon.cu); the CA
    atoms' colours to the device, gathered per triangle, and the binning;
    the triangle kernel; the tube (backbone_tube on the host,
    render_molecules through raster.cu, picks mapped to CA atoms; the
    host's spline and the device's render as two stages); the depth
    composite. With `times`, adds each stage's seconds (host clock, a
    synchronize at each stage's end)."""
    p = np.asarray(proj, np.float32)
    p00, p11 = float(p[0, 0]), float(p[1, 1])
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        if times is not None:
            times[name] += now - t
        t = now

    x_t = torch.as_tensor(x, device=dev)
    ss = current_ss_weights(sys_, x_t, device=dev)
    ss_np = ss.cpu().numpy()
    lap("ss")
    cols = color_atoms_secondary_structure(sys_, ss_np)
    lap("colour")
    tv = ribbon_view(sys_, x_t, ss, view, tables, cartoon=True)
    lap("mesh")
    col_t = torch.as_tensor(cols[sys_.backbone.atom_ca], device=dev)[tables.res]
    src_t = tables.src
    start, lst = bin_triangles(tv, p00, p11, width, height)
    lap("bin")
    img, dep, pick = raster_triangles(tv, col_t, src_t, start, lst, width, height, p00, p11)
    lap("kernel")
    pts, radii, tsrc = backbone_tube(sys_, x, ss_weights=ss_np, radius=0.35)
    lap("tube_mesh")
    t_img, t_dep, t_pick = render_molecules(
        pts, radii, cols[tsrc], view, proj, RasterSettings(width=width, height=height),
        device=dev,
    )
    tsrc_t = torch.as_tensor(tsrc, device=dev)
    t_pick = torch.where(t_pick >= 0, tsrc_t[t_pick.clamp_min(0).long()], torch.full_like(t_pick, -1))
    lap("tube")
    closer = t_dep < dep
    img = torch.where(closer[..., None], t_img, img)
    pick = torch.where(closer, t_pick, pick)
    dep = torch.minimum(dep, t_dep)
    lap("composite")
    return dict(img=img, depth=dep, pick=pick, ss=ss, n_tris=tables.count,
                args=(tv, col_t, src_t, start, lst, width, height, p00, p11))


def brute_tri_pick(tv, src_t, ys, xs, width: int, height: int, p00: float, p11: float,
                   cand=None, chunk: int = 256) -> torch.Tensor:
    """Pick of pixels (ys, xs) from a cast over EVERY triangle of tv (or,
    with `cand` (P, k) ids and -1 padding, over each pixel's own
    candidates), in the plain version's float32 arithmetic (triangles.
    ray_test): the nearest hit, ties to the triangle first in the lists'
    order (ascending near depth, then triangle id)."""
    near = (-tv[..., 2]).clamp_min(1e-2).amin(1)
    rank = torch.empty_like(near, dtype=torch.long)
    rank[tri_mod._depth_order(near)] = torch.arange(near.shape[0], device=near.device)
    terms = tri_mod.triangle_terms(tv)
    out = []
    for b in range(0, ys.shape[0], chunk):
        y, x = ys[b : b + chunk], xs[b : b + chunk]
        dx, dy = pixel_rays(x, y, width, height, p00, p11)
        d = (dx[:, None], dy[:, None], torch.full_like(dx[:, None], -1.0))
        if cand is None:
            ids = torch.arange(near.shape[0], device=near.device)[None, :]
            valid = torch.ones_like(ids, dtype=torch.bool)
        else:
            ids = cand[b : b + chunk].clamp_min(0)
            valid = cand[b : b + chunk] >= 0
        at = {k: (tuple(c[ids] for c in v) if isinstance(v, tuple) else v[ids])
              for k, v in terms.items()}
        t, ok = tri_mod.ray_test(at, d)
        ok = ok & valid
        tt = torch.where(ok, t, torch.full_like(t, float("inf")))
        tmin = tt.amin(1, keepdim=True)
        key = torch.where(ok & (tt == tmin), rank[ids].expand_as(tt), torch.full_like(tt, 2**62, dtype=torch.long))
        tid = ids.expand_as(tt).gather(1, key.argmin(1, keepdim=True))[:, 0]
        out.append(torch.where(torch.isfinite(tmin[:, 0]), src_t[tid].int(), torch.full_like(tid, -1).int()))
    return torch.cat(out)


def tri_bound(args, hits: int) -> dict:
    """The triangle kernel's work on one frame's lists, and its bound: tests
    = list entries × 256 (every pixel of a tile against every candidate of
    its list); operations = tests × OPS_TRI_TEST + entries × OPS_TRI_STAGE
    + W·H × OPS_TRI_RAY + hits × OPS_TRI_SHADE over 67 TFLOP/s; bytes =
    triangles (36 + 16 + 4 a triangle) + lists + outputs (24 a pixel) over
    3.35 TB/s; the larger of the two."""
    tv, col_t, src_t, start, lst, W, H = args[:7]
    T, entries = tv.shape[0], lst.numel()
    tests = entries * cuda_triangles.TILE**2
    ops = tests * OPS_TRI_TEST + entries * OPS_TRI_STAGE + W * H * OPS_TRI_RAY + hits * OPS_TRI_SHADE
    nbytes = T * (36 + 16 + 4) + (entries + start.numel()) * 4 + W * H * 24
    b_ms, b_by = bound(ops, nbytes)
    return dict(tests=tests, entries=entries, ops=ops, nbytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def ribbon_check(sys_, x, view, dev, cartoon: bool = True, plain_reps: int = 3) -> dict:
    """csrc/ribbon.cu against its plain version on one frame, as
    Session.render calls it: the system's tables and the frame's
    current_ss_weights on the device, ribbon_view on the card (one launch,
    counted from 0) against view_transform(ribbon_mesh(...)) on the same
    inputs. Raises unless every float of every triangle is equal bit for
    bit and the tables' source atoms are ribbon_mesh's. Then the kernel's
    device time behind a queued sleep and with events around the call,
    the plain version's time (host mesh, upload and view product, events
    around the call), and the byte bound: the triangles written (36 bytes
    each), the CA, C and O coordinates, atom indices and SS weights read
    (48 + 12 + 12 bytes a residue), the chain table (12 a chain), and the
    float64 scratch row written and read back (2 × 40 bytes a residue),
    over 3.35 TB/s."""
    tables = ribbon_tables(sys_, device=dev)
    x_t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    ss = current_ss_weights(sys_, x_t, device=dev)
    ss_np = ss.cpu().numpy()

    def kernel():
        return ribbon_view(sys_, x_t, ss, view, tables, cartoon=cartoon)

    def plain():
        tris, _ = ribbon_mesh(sys_, x, ss_weights=ss_np, cartoon=cartoon)
        return view_transform(tris, view, device=dev)

    cuda_ribbon.launches = 0
    got = kernel()
    torch.cuda.synchronize()
    launches = cuda_ribbon.launches
    tris, src = ribbon_mesh(sys_, x, ss_weights=ss_np, cartoon=cartoon)
    want = view_transform(tris, view, device=dev)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"ribbon kernel: {tuple(got.shape)} {got.dtype} against the "
                             f"plain version's {tuple(want.shape)} {want.dtype}")
    differ = int((got.view(torch.int32) != want.view(torch.int32)).any(dim=(1, 2)).sum())
    err = float((got.double() - want.double()).abs().max())
    src_ok = np.array_equal(tables.src.cpu().numpy(), src)
    if launches != 1 or differ or not src_ok:
        raise AssertionError(f"ribbon kernel: {launches} launches, {differ} of {len(want)} "
                             f"triangles differ from the plain version (max |d| {err}), "
                             f"sources equal: {src_ok}")
    ms = cuda_ms(kernel, queued=True)
    call_ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=plain_reps, warmup=1)
    nbb, n_chains = sys_.backbone.count, tables.chains.shape[0]
    nbytes = tables.count * 36 + nbb * (48 + 12 + 12 + 2 * 40) + n_chains * 12
    bound_ms, bound_by = bound(0, nbytes)
    return dict(residues=nbb, chains=n_chains, triangles=tables.count, launches=launches,
                differ=differ, max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                nbytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def capsid_frame() -> tuple:
    """The stmv.cartoon deployment's system and base frame at CAPSID_SEED,
    made by the benchmark's frozen generator (portbench/capsid.py) and
    turned into a System as the cell's set-up does."""
    from portbench import capsid, run as portbench_run

    cfg = portbench_run.cell_files("stmv.cartoon")["config"]
    cap = capsid.capsid(cfg, CAPSID_SEED)
    sys_ = build_system(coords=cap.coords, atom_names=cap.atom_names, res_names=cap.res_names,
                        res_ids=cap.res_ids, chain_ids=cap.chain_ids, elements_z=cap.z,
                        cell=UnitCell.orthorhombic(cap.box, cap.box, cap.box))
    sys_.bonds = cap.bonds.copy()
    core_postprocess(sys_, infer_bonds=False)
    return sys_, np.asarray(cap.coords, np.float32)


def cartoon_phase(dev, smi: str, n_side: int = BUNDLE_SIDE, n_res: int = BUNDLE_RES,
                  n_frames: int = CARTOON_FRAMES, width: int = WIDTH, height: int = HEIGHT,
                  samples: int = CARTOON_SAMPLES) -> dict:
    """[cartoon] (phase 17): the protein views at full width. The bundle of
    helix_bundle, n_frames frames jittered from a numpy seed, under
    compute_optimal_view at width × height: every stage's ms a frame
    (cartoon_frame) over three runs with the launch counts set to 0 before
    and read after; the triangle kernel against its plain version on frame
    0 over the whole frame (rgba, depth, pick: 0 mismatches), its device
    time behind a queued sleep and by events, registers and spills, the
    plain time and the bound (tri_bound); sampled pixels against a
    brute-force cast over every triangle; the tiles over JAX's 64-slot cap
    and the sampled pixels a 64-cap would get wrong (informational); the
    ribbons mode once; an overlay frame over the cartoon (a box, a distance
    line and label, an angle arc, a filled triangle, a text label), its
    triangle launches held to the plain version."""
    t0 = time.perf_counter()
    sys_, base = helix_bundle(n_side, n_res)
    rng = np.random.RandomState(SEED)
    frames = (base[None] + rng.normal(scale=BUNDLE_SIGMA, size=(n_frames, *base.shape))).astype(np.float32)
    cam = compute_optimal_view(base.min(0), base.max(0))
    view, proj = cam.view_matrix(), cam.proj_matrix(width, height)
    tables = ribbon_tables(sys_, device=dev)
    cartoon_frame(sys_, frames[0], view, proj, width, height, dev, tables)  # warm-up
    runs = []
    cuda_triangles.launches = cuda_raster.launches = cuda_ribbon.launches = 0
    for _ in range(3):
        times = dict.fromkeys(CARTOON_STAGES, 0.0)
        for f in range(n_frames):
            out = cartoon_frame(sys_, frames[f], view, proj, width, height, dev, tables, times)
        runs.append({k: v * 1e3 / n_frames for k, v in times.items()})
    # just after
    tri_launches, tube_launches = cuda_triangles.launches, cuda_raster.launches
    mesh_launches = cuda_ribbon.launches
    if not tri_launches == tube_launches == mesh_launches == 3 * n_frames:
        raise AssertionError(f"cartoon path: {mesh_launches} ribbon, {tri_launches} triangle "
                             f"and {tube_launches} raster launches for {3 * n_frames} frames")
    img, dep, pick = out["img"], out["depth"], out["pick"]
    if not (img.shape == (height, width, 4) and bool(torch.isfinite(img).all())
            and int((pick >= 0).sum()) > 0.02 * width * height):
        raise AssertionError(("cartoon frame", tuple(img.shape), int((pick >= 0).sum())))
    per_frame = {k: statistics.median(r[k] for r in runs) for k in CARTOON_STAGES}
    phase("cartoon", t0, (
        f"{sys_.natoms} atoms, {sys_.backbone.count} backbone residues in "
        f"{len(sys_.backbone.ranges)} ranges, {out['n_tris']} cartoon triangles, "
        f"{width}x{height}, frames 0-{n_frames - 1}, three runs; ms a frame (median "
        f"of the runs): " + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items())
        + f"; sum {sum(per_frame.values()):.3f} (runs "
        + " / ".join(f"{sum(r.values()):.3f}" for r in runs)
        + f"); launches: ribbon {mesh_launches}, triangles {tri_launches}, raster "
        f"{tube_launches}; {smi}"
    ))

    # frame 0: the kernel against its plain version over the whole frame
    t0 = time.perf_counter()
    f0 = cartoon_frame(sys_, frames[0], view, proj, width, height, dev, tables)
    args = f0["args"]
    got = raster_triangles(*args)
    want = raster_triangles_plain(*args, tri_mod.LIGHT, True)
    torch.cuda.synchronize()
    mism = {name: int(((g != w).reshape(height, width, -1)).any(-1).sum())
            for name, g, w in zip(("rgba", "depth", "pick"), got, want)}
    if any(mism.values()):
        raise AssertionError(f"triangle kernel differs from its plain version: {mism}")
    hits = int((want[2] >= 0).sum())
    cnt = (args[3][1:] - args[3][:-1])
    bnd = tri_bound(args, hits)
    ms_k = cuda_ms(lambda: raster_triangles(*args), queued=True)
    ms_call = cuda_ms(lambda: raster_triangles(*args))
    ms_plain = cuda_ms(lambda: raster_triangles_plain(*args, tri_mod.LIGHT, True), reps=3, warmup=1)
    ptxas = [ln.strip() for ln in cuda_build.build_info["triangles"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    # sampled pixels against the brute force over every triangle, and what
    # JAX's 64-slot cap would have given them
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    kpick = got[2]
    hit_px = torch.nonzero(kpick >= 0).cpu()
    half = samples // 2
    sel = hit_px[torch.randperm(hit_px.shape[0], generator=gen)[:half]]
    rnd = torch.stack([torch.randint(0, height, (samples - sel.shape[0],), generator=gen),
                       torch.randint(0, width, (samples - sel.shape[0],), generator=gen)], 1)
    yx = torch.cat([sel, rnd]).to(kpick.device)
    ys, xs = yx[:, 0], yx[:, 1]
    tv, src_t, start, lst = args[0], args[2], args[3], args[4]
    brute = brute_tri_pick(tv, src_t, ys, xs, width, height, args[7], args[8])
    wrong = int((kpick[ys, xs] != brute).sum())
    if wrong:
        raise AssertionError(f"{wrong} of {samples} sampled pixels disagree with the brute force")
    tiles_x = -(-width // cuda_triangles.TILE)
    tile = (ys // cuda_triangles.TILE) * tiles_x + xs // cuda_triangles.TILE
    slot = torch.arange(JAX_TRI_CAP, device=ys.device)
    n_cand = cnt[tile].clamp(max=JAX_TRI_CAP)
    pos = (start[tile][:, None] + slot[None, :]).clamp(max=max(lst.numel() - 1, 0))
    cand = torch.where(slot[None, :] < n_cand[:, None], lst[pos].long(), torch.full_like(pos, -1).long())
    capped = brute_tri_pick(tv, src_t, ys, xs, width, height, args[7], args[8], cand=cand)
    cap_wrong = int((capped != brute).sum())
    over_cap = int((cnt > JAX_TRI_CAP).sum())
    # the ribbons mode once
    tv_r = ribbon_view(sys_, torch.as_tensor(frames[0], device=dev), f0["ss"], view, tables,
                       cartoon=False)
    cols_r = color_atoms_secondary_structure(sys_, f0["ss"].cpu().numpy())
    cols_r = torch.as_tensor(cols_r[sys_.backbone.atom_ca], device=dev)[tables.res]
    start_r, lst_r = bin_triangles(tv_r, args[7], args[8], width, height)
    args_r = (tv_r, cols_r, tables.src, start_r, lst_r, *args[5:])
    got_r = raster_triangles(*args_r)
    want_r = raster_triangles_plain(*args_r, tri_mod.LIGHT, True)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got_r, want_r)):
        raise AssertionError("ribbons: the triangle kernel differs from its plain version")
    phase("cartoon-kernel", t0, (
        f"triangles.cu on frame 0, {width}x{height}: {args[0].shape[0]} triangles, "
        f"{bnd['entries']} tile entries over {int((cnt > 0).sum())} covered tiles (mean "
        f"{bnd['entries'] / max(int((cnt > 0).sum()), 1):.1f}, max {int(cnt.max())}), "
        f"{bnd['tests']} ray tests; against the plain version mismatching pixels rgba "
        f"{mism['rgba']}, depth {mism['depth']}, pick {mism['pick']} ({hits} hit); "
        f"kernel {ms_k:.4f} ms (device, queued; events around the call {ms_call:.4f} ms), "
        f"plain {ms_plain:.4f} ms, plain/kernel {ms_plain / ms_k:.1f}x; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {bnd['ops']:.6g} operations, "
        f"{bnd['nbytes']} bytes), kernel at {bnd['bound_ms'] / ms_k * 100:.1f}% of the "
        f"bound; ptxas: {' | '.join(ptxas)}; {samples} sampled pixels against a brute "
        f"force over all {args[0].shape[0]} triangles: {wrong} wrong; tiles over JAX's "
        f"{JAX_TRI_CAP}-slot cap {over_cap}, sampled pixels a {JAX_TRI_CAP}-cap gets "
        f"wrong {cap_wrong}; ribbons mode {tv_r.shape[0]} triangles, kernel = plain"
    ))

    # the mesh kernel against its plain version: the bundle in both modes,
    # the capsid in cartoon mode
    t0 = time.perf_counter()
    ribbon = {"bundle, cartoon": ribbon_check(sys_, frames[0], view, dev),
              "bundle, ribbons": ribbon_check(sys_, frames[0], view, dev, cartoon=False)}
    cap_sys, cap_x = capsid_frame()
    cap_view = compute_optimal_view(cap_x.min(0), cap_x.max(0)).view_matrix()
    ribbon["capsid, cartoon"] = ribbon_check(cap_sys, cap_x, cap_view, dev, plain_reps=2)
    ptxas_r = [ln.strip() for ln in cuda_build.build_info["ribbon"]["log"].splitlines()
               if "registers" in ln or "spill" in ln]
    phase("cartoon-ribbon", t0, "; ".join(
        f"{name}: {r['chains']} chains, {r['residues']} residues, {r['triangles']} triangles, "
        f"{r['launches']} launch, {r['differ']} triangles differ from view_transform("
        f"ribbon_mesh(...)) (max |d| {r['max_abs_err']}), sources equal; kernel "
        f"{r['ms']:.4f} ms (device, queued; events around the call {r['call_ms']:.4f} ms), "
        f"plain {r['plain_ms']:.3f} ms, plain/kernel {r['plain_ms'] / r['ms']:.0f}x; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['nbytes']} bytes), kernel at "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound"
        for name, r in ribbon.items()) + f"; ptxas: {' | '.join(ptxas_r)}")

    # an overlay frame over the cartoon
    t0 = time.perf_counter()
    label_id, fill_id, x0 = 900_001, 900_002, frames[0]
    ca = sys_.backbone.atom_ca
    a, b, c = (x0[ca[i]].astype(np.float64) for i in (0, n_res // 2, n_res + n_res // 4))
    lo, hi = base.min(0).astype(np.float64), base.max(0).astype(np.float64)
    eye_dir = np.asarray(cam.eye, np.float64) - np.asarray(cam.center, np.float64)
    eye_dir /= np.linalg.norm(eye_dir)
    front = 0.5 * (lo + hi) + eye_dir * 0.6 * np.linalg.norm(hi - lo)
    up = np.cross(eye_dir, [0.0, 1.0, 0.0])

    def overlay():
        q = OverlayQueue()
        q.add_box(np.diag(hi - lo), origin=lo)
        q.add_line(a, b)
        q.add_text((a + b) * 0.5, f"{np.linalg.norm(b - a):.2f} Å")
        q.add_angle_arc(b, a, c)
        # opaque, so that it writes its depth and wins the composite
        q.add_triangle(front - up * 3, front + up * 3, front + [0.0, 4.0, 0.0],
                       (0.9, 0.4, 0.1, 1.0), pick_id=fill_id)
        q.add_text(front + [0.0, 6.0, 0.0], "bundle", pick_id=label_id)
        o_img, o_dep, o_pick = q.render(view, proj, width, height, device=dev)
        closer = o_dep < f0["depth"]
        return (torch.where(closer[..., None], o_img, f0["img"]),
                torch.where(closer, o_pick, f0["pick"]))

    captured = []
    real_raster = cuda_triangles.raster

    def capture(*a, **k):
        captured.append(a)
        return real_raster(*a, **k)

    with mock.patch.object(cuda_triangles, "raster", capture):
        ov_img, ov_pick = overlay()
    torch.cuda.synchronize()
    n_label, n_fill = int((ov_pick == label_id).sum()), int((ov_pick == fill_id).sum())
    if not (n_label > 0 and n_fill > 0 and bool(torch.isfinite(ov_img).all())):
        raise AssertionError(f"overlay: label pixels {n_label}, fill pixels {n_fill}")
    # the overlay's triangle launches against the plain version
    ov_mism = sum(int((g != w).sum()) for a in captured
                  for g, w in zip(real_raster(*a), raster_triangles_plain(*a)))
    if not captured or ov_mism:
        raise AssertionError(f"overlay: {len(captured)} triangle launches, {ov_mism} values "
                             "off the plain version")
    ov_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        overlay()
        torch.cuda.synchronize()
        ov_ms.append((time.perf_counter() - t1) * 1e3)
    phase("cartoon-overlay", t0, (
        f"box + distance line and label + angle arc + fill + label over the cartoon "
        f"frame: ms {' / '.join(f'{v:.3f}' for v in ov_ms)}; label pixels {n_label}, "
        f"fill pixels {n_fill}; its {len(captured)} triangle launch(es) equal the plain "
        f"version in every value"
    ))
    return dict(launches=tri_launches, max_abs_err=0.0, ms=ms_k, plain_ms=ms_plain,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], call_ms=ms_call,
                tests=bnd["tests"], ribbon=ribbon, ribbon_launches=mesh_launches)


def rama_phase(dev, n_side: int = BUNDLE_SIDE, n_res: int = BUNDLE_RES,
               n_frames: int = RAMA_FRAMES, n_cpu: int = RAMA_CPU_FRAMES) -> None:
    """[rama] (phase 18): the backbone analyses over the bundle × n_frames
    frames on the card (a DeviceTrajectory, frames jittered by a seeded
    torch generator there): the Ramachandran component's compute_angles and
    density (ACC_RES² with blur) in ms, three runs each; frames 0 to
    n_cpu − 1 against the port on the CPU (angles within 1e-4 rad, the
    tests' dihedral tolerance; shape weights within 1e-3, as `[default]`
    holds them: the float32 closed-form eigen solve of a 96 Å mass-weighted
    rod rounds its small eigenvalues apart on the two devices); the
    shape-space component over the chains as structures in frames/s, three
    runs."""
    t0 = time.perf_counter()
    sys_, base = helix_bundle(n_side, n_res)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base_t = torch.as_tensor(base, device=dev)
    stack = torch.randn((n_frames, *base.shape), generator=gen, device=dev)
    stack.mul_(BUNDLE_SIGMA).add_(base_t)
    cells = np.zeros((n_frames, 3, 3), np.float32)

    def session(traj):
        return SimpleNamespace(system=sys_, trajectory=traj, events=EventBus(), tasks=None,
                               stored_selections={})

    sess = session(DeviceTrajectory(stack, cells))
    cpu_sess = session(InMemoryTrajectory(stack[:n_cpu].cpu().numpy(), cells[:n_cpu]))
    rama = RamachandranComponent(sess, device=dev)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3)
        return out

    ms_angles = timed(rama.compute_angles)
    ms_density = timed(lambda: rama.density("general"))
    dens = rama.density("general")
    phi, psi = rama.angles()
    cphi, cpsi = RamachandranComponent(cpu_sess, device="cpu").compute_angles()

    def wrapped(a, b):
        d = (a[:n_cpu].cpu().double() - b.double()).abs()
        return float(torch.minimum(d, 2 * np.pi - d).max())

    err = max(wrapped(phi, cphi), wrapped(psi, cpsi))
    if not (err <= 1e-4 and phi.shape == (n_frames, sys_.backbone.count)
            and abs(float(dens.sum()) - 1.0) < 1e-4 and bool(torch.isfinite(dens).all())):
        raise AssertionError(f"rama: angles vs the CPU {err}, density sum {float(dens.sum())}")
    shape = ShapespaceComponent(sess, device=dev)
    ms_shape = timed(lambda: shape.evaluate("chains()"))
    res = shape.evaluate("chains()")
    want = ShapespaceComponent(cpu_sess, device="cpu").evaluate("chains()")
    shape_err = float(np.abs(res[:n_cpu] - want).max())
    if not (res.shape == (n_frames, n_side * n_side, 3) and np.isfinite(res).all()
            and shape_err <= 1e-3):
        raise AssertionError(f"shape space: {res.shape}, vs the CPU {shape_err}")
    phase("rama", t0, (
        f"{sys_.natoms} atoms x {n_frames} frames on the device "
        f"({stack.numel() * 4 / 1e6:.1f} MB), {sys_.backbone.count} backbone residues: "
        f"compute_angles ms {' / '.join(f'{v:.3f}' for v in ms_angles)}; density "
        f"({ACC_RES}², blur) ms {' / '.join(f'{v:.3f}' for v in ms_density)}; frames "
        f"0-{n_cpu - 1} vs the CPU: max angle diff {err:.3g} rad; shape space "
        f"({res.shape[1]} chains) frames/s "
        f"{' / '.join(f'{n_frames / (v / 1e3):.1f}' for v in ms_shape)}, vs the CPU max "
        f"diff {shape_err:.3g}"
    ))


def qm_molecule(n_res: int = QM_RES, seed: int = SEED):
    """[qm]'s molecule: polyala_helix(n_res) frame 0 in Bohr with the
    6-31G basis, seeded synthetic MO coefficients (the Q of a Gaussian
    matrix's QR), occupations 2.0 for the ΣZ/2 lowest, and one synthetic
    excited state (a normalized Gaussian occ×virt amplitude matrix) →
    (System, QMData)."""
    sys_, traj = datagen.polyala_helix(n_res, n_frames=1, seed=0)
    x = traj.load_frames([0])[0][0].astype(np.float64) * BOHR_PER_ANGSTROM
    shells = shells_from_label("6-31G", x, sys_.element)
    nb = sum((s.angular + 1) * (s.angular + 2) // 2 for s in shells)
    rng = np.random.RandomState(seed)
    C = np.linalg.qr(rng.standard_normal((nb, nb)))[0].astype(np.float32)
    n_occ = int(sys_.element.sum()) // 2
    occ = np.zeros(nb, np.float32)
    occ[:n_occ] = 2.0
    T = rng.standard_normal((n_occ, nb - n_occ))
    T /= np.linalg.norm(T)
    exc = ExcitedStates(energies_ev=np.array([4.2]), oscillator_strengths=np.array([0.31]),
                        rotatory_strengths=np.array([-1.7]),
                        transition_dms=T[None].astype(np.float32))
    qm = QMData.from_arrays(x, sys_.element, shells, C, mo_occupations=occ,
                            mo_energies=np.linspace(-20.0, 2.0, nb), excited=exc,
                            basis_label="6-31G")
    return sys_, qm


def device_and_host_ms(fn):
    """(fn's result, ms from CUDA events around the call, ms on the host
    clock to a synchronize after it)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t1) * 1e3


def gto_bound(pairs: np.ndarray, P: int, lmn: np.ndarray, M: int, density: bool) -> tuple:
    """(ms, bound_by, ops, bytes) of one grid of P points and M coefficient
    columns, over pairs[k] (voxel, primitive k) pairs: each pair's
    evaluation (its power multiplies counted from lmn) and its share of the
    contraction, ρ's per-column work per voxel; the grid written once, the
    inputs read once. pairs = P for every k counts all pairs."""
    K = lmn.shape[0]
    pw = np.maximum(lmn - 1, 0).sum(1)
    n = pairs.astype(np.int64)
    ops = int((n * (OPS_GTO_PRIM + pw)).sum()) + 2 * int(n.sum()) * M
    if density:
        ops += OPS_RHO_COL * P * M
    nbytes = P * 4 + K * (3 * 4 + 4 + 3 * 4 + M * 4)
    return (*bound(ops, nbytes), ops, nbytes)


def needed_pairs(points, basis, chunk: int = 16_384) -> np.ndarray:
    """(K,) count, per primitive, of the voxels where it is not exactly 0:
    α·r² < 40 in ops/gto.py::primitive_matrix's float32 operations. The
    least work of any exact implementation, whatever its blocking."""
    n = torch.zeros(basis.centers.shape[0], dtype=torch.int64, device=points.device)
    for c0 in range(0, points.shape[0], chunk):
        d = points[c0 : c0 + chunk, None, :] - basis.centers[None, :, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        ar2 = basis.exponents[None, :] * (dx * dx + dy * dy + dz * dz)
        n += (ar2 < cuda_gto.CUTOFF).sum(0)
    return n.cpu().numpy()


def screen_pairs(points, groups, basis, chunk: int = 2048) -> np.ndarray:
    """(K,) count, per primitive, of the voxels where the kernel evaluates
    it: cuda_gto.screen_keep over the kernel's voxel groups (brick_voxels of
    ψ's or ρ's bricks), in chunks of groups."""
    n = torch.zeros(basis.centers.shape[0], dtype=torch.int64, device=points.device)
    for g0 in range(0, groups.shape[0], chunk):
        g = groups[g0 : g0 + chunk]
        keep = cuda_gto.screen_keep(points, g, basis.centers, basis.exponents)
        n += (keep * (g >= 0).sum(1)[:, None]).sum(0)
    return n.cpu().numpy()


def plain_psi(basis, c, geo, chunk: int = gto.CHUNK):
    """The plain ψ grid on geo's device (primitive_matrix and _contract by
    chunks, the CPU route run on the card) → (ψ, Σ_k |φ_k·c_k|), flat."""
    pts = gto.grid_points(geo["origin"], geo["voxel"], geo["dims"], geo["orientation"],
                          device=geo["device"])
    psi = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    mag = torch.empty_like(psi)
    for c0 in range(0, pts.shape[0], chunk):
        phi = basis.phi(pts[c0 : c0 + chunk])
        psi[c0 : c0 + chunk] = gto._contract(phi, c)
        mag[c0 : c0 + chunk] = (phi * c[None, :]).abs().sum(1)
    return psi, mag


def plain_rho(basis, A, B, w, pts, T=None, chunk: int = gto.CHUNK) -> tuple:
    """The plain ρ = Σ_m w_m·(ΦA)_m·(ΦB)_m at pts (B = A when None; with T,
    ΦA is (Φ A) T, the transition density's order), primitive_matrix and
    matmuls by chunks on pts' device → (ρ, Σ_m |w_m|·(|Φ||A|)_m·(|Φ||B|)_m),
    the latter with |A| |T| for A when T is given."""
    rho = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    mag = torch.empty_like(rho)
    for c0 in range(0, pts.shape[0], chunk):
        phi = basis.phi(pts[c0 : c0 + chunk])
        a, pa = phi @ A, phi.abs() @ A.abs()
        if T is not None:
            a, pa = a @ T, pa @ T.abs()
        b, pb = (a, pa) if B is None else (phi @ B, phi.abs() @ B.abs())
        rho[c0 : c0 + chunk] = (a * b * w[None, :]).sum(1)
        mag[c0 : c0 + chunk] = (pa * pb * w.abs()[None, :]).sum(1)
    return rho, mag


def rho_check(got, want, mag, terms: int, name: str) -> tuple:
    """(max |Δ| over the largest |want|, the largest |Δ| over its float32
    bound 2·terms·2⁻²⁴·mag, max |Δ|) of a ρ grid against its plain version;
    raises unless within QM_RTOL and the bound."""
    d = (got - want).abs()
    err = float(d.max() / want.abs().max())
    ratio = float((d / (2 * terms * F32_U * mag).clamp_min(1e-38)).max())
    if not (err <= QM_RTOL and ratio <= 1.0):
        raise AssertionError(f"gto {name}: {err:.3g} of the largest, {ratio:.3g} of its bound")
    return err, ratio, float(d.max())


def qm_phase(dev, n_res: int = QM_RES, presets=QM_PRESETS, orbital_dims: int = QM_ORBITAL_DIMS,
             topo_dims: int = QM_TOPO_DIMS, width: int = WIDTH, height: int = HEIGHT,
             samples: int = QM_SAMPLES) -> dict:
    """[qm] (phase 19): the VeloxChem window (the module docstring lists its
    parts). → the export grids' figures."""
    t0 = time.perf_counter()
    sys_, qm = qm_molecule(n_res)
    sess = SimpleNamespace(system=sys_, events=EventBus(), coord_override=None)
    vlx = VeloxchemComponent(sess, device=dev)
    vlx.load(qm)
    homo = qm.n_occupied - 1
    centers, exps, lmn, _, _ = qm._expand()
    phis = [0]
    real_phi = gto.primitive_matrix

    def counted(*a, **k):
        phis[0] += 1
        return real_phi(*a, **k)

    phase("qm", t0, (
        f"polyala_helix({n_res}) frame 0, {sys_.natoms} atoms, 6-31G: {len(qm.shells)} shells, "
        f"{qm.mo_coeffs.shape[0]} cartesian functions, {centers.shape[0]} primitives, "
        f"{qm.n_occupied} occupied orbitals (synthetic coefficients on a real basis, geometry "
        f"and grid size); torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}"
    ))
    SCRATCH.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="qm-", dir=SCRATCH))
    grids = {}
    basis = gto._Basis(centers, exps, lmn, dev)
    K = centers.shape[0]
    cf = qm.primitives_for_orbital(homo)[2]
    c_homo = gto._f32(cf, dev)
    C_all = qm.primitives_all()[2]
    occ = np.asarray(qm.mo_occupations, np.float32)
    main_launches = 0
    try:
        for preset in presets:
            spa = vlx.RESOLUTION_SAMPLES_PER_ANG[preset]
            R, lo, voxel, dims = vlx.obb_geometry(spa)
            dims_t = tuple(int(d) for d in dims)
            P = int(np.prod(dims))
            geo = dict(origin=lo, voxel=voxel, dims=dims_t, orientation=R, device=dev)
            pts = gto.grid_points(lo, voxel, dims_t, R, device=dev)
            need = needed_pairs(pts, basis)
            for source, fn, M in (
                ("mo", lambda: gto.eval_gto_grid(centers, exps, cf, lmn, **geo), 1),
                ("electron_density", lambda: gto.density_grid(centers, exps, C_all, lmn,
                                                              occupations=occ, **geo),
                 int((occ != 0).sum())),
            ):
                fn()  # warm-up
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                runs = []
                for _ in range(2):
                    phis[0] = 0
                    n0 = cuda_gto.launches
                    with mock.patch.object(gto, "primitive_matrix", counted):
                        g, ms_dev, ms_host = device_and_host_ms(fn)
                    runs.append((ms_dev, ms_host))
                    launched = cuda_gto.launches - n0  # just after
                    if phis[0] or launched != 1:
                        raise AssertionError(f"qm {preset} {source}: {launched} gto launches "
                                             f"(want 1), {phis[0]} primitive_matrix builds")
                    main_launches += launched
                peak = (torch.cuda.max_memory_allocated() - base) / 2**20
                if not (g.shape == dims_t and bool(torch.isfinite(g).all())
                        and float(g.abs().max()) > 0):
                    raise AssertionError(f"qm {preset} {source} grid {tuple(g.shape)}")
                # the pairs any exact implementation evaluates, and the pairs
                # the kernel's brick screen keeps (ψ's bricks or ρ's)
                brick = cuda_gto.BRICK if source == "mo" else cuda_gto.RHO_BRICK
                done = screen_pairs(pts, cuda_gto.brick_voxels(dims_t, device=dev, brick=brick),
                                    basis)
                t1 = time.perf_counter()
                files = vlx.export_volume(str(work / f"{preset}-{source}.mhd"), source=source,
                                          fmt="mhd", resolution=preset)
                ms_export = (time.perf_counter() - t1) * 1e3
                hdr = Path(files[0]).read_text()
                raw = np.fromfile(files[1], np.float32)
                if not (f"DimSize = {dims[0]} {dims[1]} {dims[2]}" in hdr and raw.size == P
                        and np.isfinite(raw).all()):
                    raise AssertionError(f"qm export {preset} {source}")
                density = source != "mo"
                a_ms, a_by, a_ops, nbytes = gto_bound(np.full(K, P), P, lmn, M, density)
                n_ms, n_by, n_ops, _ = gto_bound(need, P, lmn, M, density)
                w_ms, w_by, w_ops, _ = gto_bound(done, P, lmn, M, density)
                best = min(r[0] for r in runs)
                grids[(preset, source)] = dict(ms=best, bound_ms=n_ms, bound_by=n_by,
                                               bound_all_ms=a_ms, bound_kernel_ms=w_ms,
                                               dims=dims_t, peak_mib=peak, grid=g,
                                               launches=len(runs))
                phase("qm", t0, (
                    f"export grid {preset} {dims_t} ({P} points) {source}: {M} column(s); ms "
                    f"(events / host) " + " | ".join(f"{a:.2f} / {b:.2f}" for a, b in runs)
                    + f"; gto launches a grid 1 ({'ψ' if source == 'mo' else 'ρ'} mode), "
                    f"primitive_matrix builds 0; peak mem +{peak:.1f} MiB; pairs {P * K}, of them "
                    f"not 0 (α·r² < 40) {int(need.sum())} ({need.sum() / (P * K) * 100:.2f}%), "
                    f"evaluated by the kernel's screen of {'x'.join(map(str, brick))} bricks "
                    f"{int(done.sum())} ({done.sum() / (P * K) * 100:.2f}%); bound over the pairs "
                    f"not 0 {n_ms:.3f} ms ({n_by}; {n_ops:.6g} operations, {nbytes} bytes), grid at "
                    f"{n_ms / best * 100:.1f}% of it; over the kernel's pairs {w_ms:.3f} ms ({w_by}; "
                    f"{w_ops:.6g} operations), {w_ms / best * 100:.1f}%; over all pairs {a_ms:.3f} ms "
                    f"({a_by}; {a_ops:.6g} operations), {a_ms / best * 100:.1f}%; export_volume (grid, copy, "
                    f".mhd/.raw/.xyz) {ms_export:.1f} ms, {raw.nbytes / 2**20:.1f} MiB written"
                ))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the kernel against its plain version on the card: ψ and ρ over the
    # whole first preset's grid, sampled chunks of the last preset's, a
    # transition density over the first preset's
    t1 = time.perf_counter()
    R, lo, voxel, dims = vlx.obb_geometry(vlx.RESOLUTION_SAMPLES_PER_ANG[presets[0]])
    geo = dict(origin=lo, voxel=voxel, dims=tuple(int(d) for d in dims), orientation=R, device=dev)
    want, mag = plain_psi(basis, c_homo, geo)
    got = grids[(presets[0], "mo")]["grid"].reshape(-1)
    psi_err = float((got - want).abs().max())
    psi_ratio = float(((got - want).abs() / (2 * K * F32_U * mag).clamp_min(1e-38)).max())
    if not bool(((got - want).abs() <= 2 * K * F32_U * mag).all()):
        raise AssertionError(f"gto ψ {presets[0]}: off its plain version by {psi_ratio:.3g} of "
                             "the bound")
    C_occ = gto._f32(C_all, dev)[:, torch.as_tensor(np.flatnonzero(occ), device=dev)].contiguous()
    occ_t = torch.as_tensor(occ[occ != 0], device=dev)
    M = C_occ.shape[1]
    pts = gto.grid_points(lo, voxel, geo["dims"], R, device=dev)
    rho_want, rho_mag = plain_rho(basis, C_occ, None, occ_t, pts)
    rho_got = grids[(presets[0], "electron_density")]["grid"].reshape(-1)
    rho_err, rho_ratio, rho_abs = rho_check(rho_got, rho_want, rho_mag, 2 * K + M + 8,
                                            f"density {presets[0]}")
    # a transition density (excited state 0) over the first preset's grid:
    # one launch on A = C_occ·T, B = C_virt, held to (Φ C_occ) T · (Φ C_virt)
    exc_T = np.asarray(qm.excited.transition_dms[0], np.float32)
    Co, Cv = vlx._split_occ_virt()
    _, _, Cop, _ = qm.primitives_for_vectors(Co)
    _, _, Cvp, _ = qm.primitives_for_vectors(Cv)
    n0, phis[0] = cuda_gto.launches, 0
    with mock.patch.object(gto, "primitive_matrix", counted):
        rt_got = gto.transition_density_grid(centers, exps, Cop, Cvp, exc_T, lmn, **geo).reshape(-1)
    rt_launches = cuda_gto.launches - n0
    if rt_launches != 1 or phis[0]:
        raise AssertionError(f"transition density: {rt_launches} gto launches, {phis[0]} "
                             "primitive_matrix builds")
    Cvp_t = gto._f32(Cvp, dev)
    rt_want, rt_mag = plain_rho(basis, gto._f32(Cop, dev), Cvp_t,
                                torch.ones(Cvp_t.shape[1], device=dev), pts,
                                T=gto._f32(exc_T, dev))
    rt_err, rt_ratio, rt_abs = rho_check(rt_got, rt_want, rt_mag,
                                         2 * K + Cop.shape[1] + Cvp.shape[1] + 8,
                                         f"transition density {presets[0]}")
    R, lo, voxel, dims = vlx.obb_geometry(vlx.RESOLUTION_SAMPLES_PER_ANG[presets[-1]])
    dims_t = tuple(int(d) for d in dims)
    pts = gto.grid_points(lo, voxel, dims_t, R, device=dev)
    grid_gp = cuda_gto.grid_block(lo, voxel, R)
    rng = np.random.RandomState(SEED)
    c0s = sorted(int(c) for c in rng.randint(0, pts.shape[0] - samples, QM_CHUNKS))
    high_psi = grids[(presets[-1], "mo")]["grid"].reshape(-1)
    high_rho = grids[(presets[-1], "electron_density")]["grid"].reshape(-1)
    high_err, high_rho_err, high_rho_ratio, high_rho_abs = 0.0, 0.0, 0.0, 0.0
    for c0 in c0s:
        phi = basis.phi(pts[c0 : c0 + samples])
        w = gto._contract(phi, c_homo)
        m = (phi * c_homo[None, :]).abs().sum(1)
        d = (high_psi[c0 : c0 + samples] - w).abs()
        if not bool((d <= 2 * K * F32_U * m).all()):
            raise AssertionError(f"gto ψ {presets[-1]} chunk {c0}: off its plain version")
        high_err = max(high_err, float(d.max()))
        want_c, mag_c = plain_rho(basis, C_occ, None, occ_t, pts[c0 : c0 + samples])
        e, r_, a_ = rho_check(high_rho[c0 : c0 + samples], want_c, mag_c, 2 * K + M + 8,
                              f"density {presets[-1]} chunk {c0}")
        high_rho_err, high_rho_ratio = max(high_rho_err, e), max(high_rho_ratio, r_)
        high_rho_abs = max(high_rho_abs, a_)
    rho_again = gto.density_grid(centers, exps, C_all, lmn, lo, voxel, dims_t, occupations=occ,
                                 orientation=R, device=dev).reshape(-1)
    if not torch.equal(rho_again, high_rho):
        raise AssertionError(f"gto density {presets[-1]}: two runs differ")
    # the plain ψ and ρ over the whole last preset's grid on the card (the
    # route the port took before the kernel), for the kernel line
    _, ms_plain, _ = device_and_host_ms(
        lambda: gto._over_chunks(lambda b: gto._contract(basis.phi(b), c_homo), lo, voxel,
                                 dims_t, R, gto.CHUNK, dev))
    ms_kernel = cuda_ms(lambda: cuda_gto.psi_grid(
        cuda_gto.prim_table(basis.centers, basis.exponents, basis.lmn, c_homo), grid_gp, dims_t),
        reps=5, warmup=1, queued=True)

    def rho_plain(block):
        psi = basis.phi(block) @ C_occ
        return (psi * psi * occ_t[None, :]).sum(1)

    _, ms_rho_plain, _ = device_and_host_ms(
        lambda: gto._over_chunks(rho_plain, lo, voxel, dims_t, R, gto.CHUNK, dev))
    table = cuda_gto.prim_table(basis.centers, basis.exponents, basis.lmn)
    ms_rho = cuda_ms(lambda: cuda_gto.rho_grid(table, C_occ, None, occ_t, grid_gp, dims_t),
                     reps=5, warmup=1, queued=True)
    phase("qm", t0, (
        f"gto.cu against its plain version on the card: ψ over the {presets[0]} grid "
        f"({int(np.prod(geo['dims']))} voxels) max |Δ| {psi_err:.3g}, at most {psi_ratio:.3g} of "
        f"its bound 2·K·2⁻²⁴·Σ|φc|; ρ: the {presets[0]} density {rho_err:.3g} of the largest "
        f"(max |Δ| {rho_abs:.3g}, at most {rho_ratio:.3g} of its float32 bound), the "
        f"{presets[0]} transition density (1 launch, no primitive_matrix build) {rt_err:.3g} "
        f"(max |Δ| {rt_abs:.3g}, {rt_ratio:.3g} of its bound), {QM_CHUNKS} chunks of {samples} "
        f"voxels of the {presets[-1]} density at {c0s} {high_rho_err:.3g} (max |Δ| "
        f"{high_rho_abs:.3g}, {high_rho_ratio:.3g} of its bound), tolerance {QM_RTOL:g}; ψ there "
        f"max |Δ| {high_err:.3g}, within its bound; two {presets[-1]} density runs bit-equal; "
        f"{presets[-1]} HOMO: kernel {ms_kernel:.3f} ms (device, queued), plain version "
        f"{ms_plain:.2f} ms (events); {presets[-1]} density: kernel {ms_rho:.3f} ms (device, "
        f"queued), plain version {ms_rho_plain:.2f} ms (events) "
        f"({time.perf_counter() - t1:.1f} s)"
    ))
    high = grids[(presets[-1], "electron_density")]
    out_kernel = dict(launches=main_launches, ms=ms_kernel, plain_ms=ms_plain,
                      bound_ms=grids[(presets[-1], "mo")]["bound_ms"],
                      bound_by=grids[(presets[-1], "mo")]["bound_by"],
                      bound_all_ms=grids[(presets[-1], "mo")]["bound_all_ms"],
                      bound_kernel_ms=grids[(presets[-1], "mo")]["bound_kernel_ms"],
                      max_abs_err=max(psi_err, high_err),
                      density=dict(launches=sum(grids[(p_, "electron_density")]["launches"]
                                                for p_ in presets),
                                   ms=ms_rho, plain_ms=ms_rho_plain, bound_ms=high["bound_ms"],
                                   bound_by=high["bound_by"], bound_all_ms=high["bound_all_ms"],
                                   bound_kernel_ms=high["bound_kernel_ms"],
                                   max_abs_err=max(rho_abs, high_rho_abs, rt_abs)))

    # the orbital window: the grid, then the ray-march through volume.cu
    (grid, _, _), ms_grid, host_grid = device_and_host_ms(
        lambda: vlx.orbital_grid(homo, dims=orbital_dims))
    stage = {}
    real_rv = vol_mod.render_volume

    def timed_rv(*a, **k):
        out, stage["ev"], stage["host"] = device_and_host_ms(lambda: real_rv(*a, **k))
        return out

    vlx.render_orbital(homo, dims=orbital_dims, width=width, height=height)  # warm-up
    cuda_volume.launches = 0
    with mock.patch.object(vol_mod, "render_volume", timed_rv):
        (img, depth), _, ms_total = device_and_host_ms(
            lambda: vlx.render_orbital(homo, dims=orbital_dims, width=width, height=height))
    vol_launches = cuda_volume.launches
    if vol_launches != 1 or not (bool(torch.isfinite(img).all()) and float(img[..., 3].max()) > 0):
        raise AssertionError(f"render_orbital: {vol_launches} volume launches")
    phase("qm", t0, (
        f"orbital_grid(HOMO {homo}, {orbital_dims}³) ms (events / host) {ms_grid:.2f} / "
        f"{host_grid:.2f}; render_orbital {width}x{height} (iso only) host {ms_total:.2f} ms, of "
        f"it render_volume {stage['ev']:.2f} ms (events) / {stage['host']:.2f} ms (host); volume "
        f"launches {vol_launches}; {float((img[..., 3] > 0.01).double().mean()) * 100:.1f}% of "
        f"pixels covered"
    ))

    # density topology: grid on the card, critical points and graph on the host
    (rho, origin, vox), ms_rho, host_rho = device_and_host_ms(lambda: vlx.density_grid(topo_dims))
    (pts, edges), _, ms_topo = device_and_host_ms(lambda: vlx.topology(topo_dims))
    rho_np = rho.cpu().numpy()
    t1 = time.perf_counter()
    cps = critical_points(rho_np, origin, vox, min_value=1e-3)
    bond_graph(cps, rho_np, origin, vox, threshold_frac=0.5)
    ms_host_topo = (time.perf_counter() - t1) * 1e3
    vlx.render_topology(topo_dims, width, height, points=pts, edges=edges)  # warm-up
    cuda_raster.launches = 0
    (timg, _, tpick), _, ms_render_topo = device_and_host_ms(
        lambda: vlx.render_topology(topo_dims, width, height, points=pts, edges=edges))
    raster_launches = cuda_raster.launches
    kinds = {k: sum(p.kind == k for p in pts) for k in ("max", "bond", "ring", "min")}
    if not (kinds["max"] > 0 and raster_launches == 1 and bool(torch.isfinite(timg).all())
            and int((tpick >= 0).sum()) > 0 and int(tpick.max()) < len(pts)):
        raise AssertionError(f"topology: {kinds}, raster launches {raster_launches}")
    phase("qm", t0, (
        f"topology of density_grid({topo_dims}³): {len(pts)} critical points {kinds}, "
        f"{len(edges)} edges; density_grid ms (events / host) {ms_rho:.2f} / {host_rho:.2f}; "
        f"topology() host {ms_topo:.1f} ms, of it critical_points + bond_graph (numpy) "
        f"{ms_host_topo:.1f} ms; render_topology {width}x{height} host {ms_render_topo:.2f} ms, "
        f"raster launches {raster_launches}, {int((tpick >= 0).sum())} pixels picked"
    ))

    # the excited state
    groups = sys_.atom_res_idx
    out, gto_calls = {}, {}
    for name, fn in (
        ("transition_density_grid", lambda: vlx.transition_density_grid(0, topo_dims)),
        ("nto_grid", lambda: vlx.nto_grid(0, 0, topo_dims)),
        ("attachment_detachment_grids", lambda: vlx.attachment_detachment_grids(0, topo_dims)),
        ("charge_transfer grid", lambda: vlx.charge_transfer(0, groups, topo_dims, "grid")),
        ("charge_transfer grid again", lambda: vlx.charge_transfer(0, groups, topo_dims, "grid")),
        ("charge_transfer mulliken", lambda: vlx.charge_transfer(0, groups, method="mulliken")),
    ):
        n0 = cuda_gto.launches
        out[name] = device_and_host_ms(fn)
        gto_calls[name] = cuda_gto.launches - n0
    # a transition density is one ρ launch, the attachment and detachment
    # densities one each
    if gto_calls["transition_density_grid"] != 1 or gto_calls["attachment_detachment_grids"] != 2:
        raise AssertionError(f"excited-state grids: gto launches {gto_calls}")
    ct1, ct2 = out["charge_transfer grid"][0], out["charge_transfer grid again"][0]
    for k in ("hole_per_atom", "part_per_atom", "matrix"):
        if not np.array_equal(ct1[k], ct2[k]):
            raise AssertionError(f"charge_transfer grid {k} differs between two CUDA runs")
    ctm = out["charge_transfer mulliken"][0]
    for ct in (ct1, ctm):
        if not (np.isfinite(ct["matrix"]).all() and ct["hole_charges"].sum() > 0
                and ct["part_charges"].sum() > 0):
            raise AssertionError("charge_transfer output")
    hole_g = ct1["hole_charges"] / ct1["hole_charges"].sum()
    hole_m = ctm["hole_charges"] / ctm["hole_charges"].sum()
    phase("qm", t0, (
        "excited state 0, " + f"{topo_dims}³: " + "; ".join(
            f"{k} ms (events / host) {v[1]:.2f} / {v[2]:.2f}" for k, v in out.items())
        + f"; gto launches {gto_calls}; grid charges of two CUDA runs bit-equal; hole shares by "
        + "residue, grid "
        + " ".join(f"{v:.3f}" for v in hole_g) + ", Mulliken "
        + " ".join(f"{v:.3f}" for v in hole_m)
    ))

    # checks against the CPU: sampled voxels of the "high" grid, attribution
    R, lo, voxel, dims = vlx.obb_geometry(vlx.RESOLUTION_SAMPLES_PER_ANG[presets[-1]])
    pts_dev = gto.grid_points(lo, voxel, dims, R, device=dev)
    pick = np.random.RandomState(SEED).choice(pts_dev.shape[0], samples, replace=False)
    sample = pts_dev[torch.as_tensor(pick, device=dev)]
    c_occ = qm.primitives_all()[2][:, : qm.n_occupied]
    errs = {}
    k_cpu = gto.eval_gto(sample.cpu(), centers, exps, cf, lmn, device="cpu").double()
    k_got = grids[(presets[-1], "mo")]["grid"].reshape(-1)[torch.as_tensor(pick, device=dev)]
    errs["HOMO grid"] = float((k_got.cpu().double() - k_cpu).abs().max() / k_cpu.abs().max())
    if not errs["HOMO grid"] <= QM_RTOL:
        raise AssertionError(f"gto.cu HOMO grid vs the CPU: {errs['HOMO grid']:.3g} of the largest")
    for name, coeffs, rho_of in (("HOMO", cf, False), ("density", c_occ, True)):
        vals = {}
        for d, p in ((dev, sample), ("cpu", sample.cpu())):
            v = gto.eval_gto(p, centers, exps, coeffs, lmn, device=d)
            vals[str(d)] = (2.0 * v * v).sum(1) if rho_of else v
        got, want = vals[str(dev)].cpu().double(), vals["cpu"].double()
        errs[name] = float((got - want).abs().max() / want.abs().max())
        if not errs[name] <= QM_RTOL:
            raise AssertionError(f"eval_gto {name} CUDA vs CPU: {errs[name]:.3g} of the largest")
    det, att, origin, vox = vlx.attachment_detachment_grids(0, topo_dims)
    radii = vdw_radius(np.asarray(qm.atom_numbers)) * BOHR_PER_ANGSTROM
    win_equal, q_err = True, 0.0
    for g in (det, att):
        w_gpu = gto.grid_winners(g.shape, origin, vox, qm.atom_coords, radii, device=dev)
        w_cpu = gto.grid_winners(g.shape, origin, vox, qm.atom_coords, radii, device="cpu")
        win_equal &= bool(torch.equal(w_gpu.cpu(), w_cpu))
        q_gpu = gto.attribute_grid_to_atoms(g, origin, vox, qm.atom_coords, radii, device=dev)
        q_cpu = gto.attribute_grid_to_atoms(g.cpu(), origin, vox, qm.atom_coords, radii,
                                            device="cpu")
        q_err = max(q_err, float((q_gpu.cpu().double() - q_cpu.double()).abs().max()
                                 / q_cpu.double().abs().max()))
    if not (win_equal and q_err <= QM_CHARGE_RTOL):
        raise AssertionError(f"attribution CUDA vs CPU: winners equal {win_equal}, charges {q_err}")
    phase("qm", t0, (
        f"eval_gto on {samples} sampled voxels of the {presets[-1]} grid, CUDA vs CPU: HOMO "
        f"{errs['HOMO']:.3g}, {qm.n_occupied}-orbital density {errs['density']:.3g} of the "
        f"largest |value|; gto.cu's {presets[-1]} HOMO grid there against the CPU "
        f"{errs['HOMO grid']:.3g} (tolerance {QM_RTOL:g}); attribute_grid_to_atoms on the {topo_dims}³ "
        f"attachment/detachment grids: winners equal {win_equal}, charges {q_err:.3g} relative "
        f"(tolerance {QM_CHARGE_RTOL:g})"
    ))
    return out_kernel


def density_volume_phase(dev, sys_, compiled, res, traj, width: int = WIDTH,
                         height: int = HEIGHT, small: int = VOL_SMALL,
                         check_waters: int = DV_CHECK_WATERS, check_wh=DV_CHECK_WH) -> None:
    """[density-volume] (phase 20): the SDF window over the headline result
    (the module docstring lists its parts)."""
    t0 = time.perf_counter()
    frame0 = traj.load_frame(0)[0]

    def session(res_, system=sys_, trajectory=traj, compiled_=compiled, coords=frame0):
        return SimpleNamespace(system=system, trajectory=trajectory, compiled=compiled_,
                               eval_result=res_, events=EventBus(),
                               current_coords=lambda: coords)

    dv = DensityVolumeComponent(session(res), device=dev)
    rec = dv.sdf_vis("v")
    dv.render_composite("v", 0, width, height, max_structures=DV_STRUCTURES)  # warm-up
    times = {}
    (_, times["reference_frames"], _) = device_and_host_ms(lambda: dv.reference_frames("v", 0))
    ((ref_img, ref_depth), _, times["render_references"]) = device_and_host_ms(
        lambda: dv.render_references("v", 0, width, height, max_structures=DV_STRUCTURES))
    (_, _, times["render"]) = device_and_host_ms(
        lambda: dv.render("v", width, height, scene_depth=ref_depth))
    cuda_raster.launches = cuda_volume.launches = 0
    (comp, _, times["render_composite"]) = device_and_host_ms(
        lambda: dv.render_composite("v", 0, width, height, max_structures=DV_STRUCTURES))
    launches = dict(raster=cuda_raster.launches, volume=cuda_volume.launches)
    if launches != dict(raster=1, volume=1):
        raise AssertionError(f"render_composite launches {launches}, expected one of each")
    hit = float(torch.isfinite(ref_depth).double().mean())
    seen = float((comp[..., 3] > 0.01).double().mean())
    if not (comp.shape == (height, width, 4) and bool(torch.isfinite(comp).all())
            and hit > 0.001 and seen > hit):
        raise AssertionError(f"render_composite: {hit} of pixels on an atom, {seen} covered")
    phase("density-volume", t0, (
        f"render_composite {width}x{height}, {len(rec['structures'][:DV_STRUCTURES])} reference "
        f"structures: host ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in times.items() if k != "reference_frames")
        + f" (reference_frames {times['reference_frames']:.2f} ms, events); launches "
        f"{launches}; {hit * 100:.2f}% of pixels on an atom, {seen * 100:.2f}% covered"
    ))
    # render alone: a blur, a clip sub-box with two isos, 512²
    alone = {}
    cuda_volume.launches = 0
    dv.blur_sigma = 1.0
    (_, _, alone["blur 1.0"]) = device_and_host_ms(lambda: dv.render("v", width, height))
    dv.blur_sigma = 0.0
    dv.clip_min, dv.clip_max = (0.2, 0.0, 0.3), (0.9, 0.7, 1.0)
    dv.set_isosurfaces(SDF_ISO_FRACTIONS)
    ((cimg, _), _, alone["clip + 2 isos"]) = device_and_host_ms(lambda: dv.render("v", width, height))
    dv.clip_min, dv.clip_max = (0.0,) * 3, (1.0,) * 3
    dv.set_isosurfaces(())
    ((simg, _), _, alone[f"{small}²"]) = device_and_host_ms(lambda: dv.render("v", small, small))
    if cuda_volume.launches != 3 or not (bool(torch.isfinite(cimg).all())
                                         and float(simg[..., 3].sum()) > 0):
        raise AssertionError(f"render alone: {cuda_volume.launches} volume launches")
    # the vis.sdf payload after a checkpoint round trip (by name)
    SCRATCH.mkdir(exist_ok=True)
    path = SCRATCH / "density-volume.npz"
    try:
        save_checkpoint(res, str(path))
        loaded = load_checkpoint(str(path))
    finally:
        path.unlink(missing_ok=True)
    dv2 = DensityVolumeComponent(session(loaded), device=dev)
    rec2 = dv2.sdf_vis("v")
    same = (rec2["extent"] == rec["extent"] and len(rec2["structures"]) == len(rec["structures"])
            and all(np.array_equal(a, b) for a, b in zip(rec2["structures"], rec["structures"]))
            and all(np.array_equal(np.asarray(rec2[k]), np.asarray(rec[k]))
                    for k in ("struct_idx", "struct_w", "ref_centered")))
    equal_render = bool(torch.equal(dv2.render("v", small, small)[0], simg))
    if loaded.property("v").spec.vis is not None or not (same and equal_render):
        raise AssertionError(f"sdf_vis after a checkpoint: payload equal {same}, render equal "
                             f"{equal_render}")
    phase("density-volume", t0, (
        "render alone, host ms: " + ", ".join(f"{k} {v:.2f}" for k, v in alone.items())
        + f" (volume launches 3); after a checkpoint round trip sdf_vis('v') comes back by name "
        f"(equal payload) and renders the same bits"
    ))
    check = density_volume_check(dev, check_waters, *check_wh)
    ds = DatasetComponent(SimpleNamespace(system=sys_, files={"system": "water_box"},
                                          num_frames=traj.num_frames, stored_selections={},
                                          events=EventBus()), device=dev)
    (summary, _, ms_summary) = device_and_host_ms(ds.summary)
    if summary["atoms"] != sys_.natoms or summary["water_atoms"] != sys_.natoms:
        raise AssertionError(f"dataset summary {summary}")
    phase("density-volume", t0, (
        f"small box CUDA vs CPU at {check_wh[0]}x{check_wh[1]}: {check}; dataset summary of the "
        f"{summary['atoms']}-atom box {ms_summary:.1f} ms ({summary['residues']} residues, "
        f"{summary['bonds']} bonds, {summary['frames']} frames)"
    ))


def density_volume_check(dev, n_waters: int, width: int, height: int) -> str:
    """The density-volume component on the card against the CPU over one
    small box's result (DV_SCRIPT on water_box(n_waters), evaluated on the
    CPU, whose tests hold the component to the JAX package), unjittered,
    with the reference structures at their ideal coordinates (the aligned
    waters: a well-conditioned Kabsch): the reference frames within
    DV_FRAME_RTOL of their largest entry; the references (raster.cu on frames the card's float32
    Kabsch rounds apart from the CPU's) with at most DV_REF_SHARE of the
    pixels off in coverage or in depth beyond TIE_RTOL, rgba within
    DV_REF_RGBA elsewhere; the volume alone within VOL_TOL at decided
    pixels, the composite within DV_REF_RGBA at 99% of pixels; and the dataset's
    remap_element on both devices (equal elements and bonds)."""
    import copy
    import functools

    small_sys, small_traj = water_box(n_waters, n_frames=2, seed=SEED)
    frames, cells = small_traj.load_frames([0, 1])
    cs = compile_script(DV_SCRIPT, small_sys, "cpu")
    r = Evaluator(cs, trajectory_from_numpy(frames, cells, "cpu"), chunk=2).run()
    marches = []
    real = cuda_volume.render

    def recorded(grid, tf, cvol, rays_, march, jitter=None, scene_depth=None, rays_out=None):
        if grid.device.type == "cpu":
            table = ray_setup(rays_, None, scene_depth, device="cpu")
            und = []
            cuda_volume.march_plain(grid, tf, cvol, table, rays_.width, rays_.height, march,
                                    undecided=und)
            marches.append(und[0])
        return real(grid, tf, cvol, rays_, march, jitter, scene_depth, rays_out)

    out = {}
    with mock.patch.object(vol_mod, "VolumeRenderSettings",
                           functools.partial(VolumeRenderSettings, jitter=False)), \
            mock.patch.object(cuda_volume, "render", recorded):
        for d in ("cpu", dev):
            sess = SimpleNamespace(system=small_sys, trajectory=small_traj, compiled=cs,
                                   eval_result=r, events=EventBus(),
                                   current_coords=small_sys.coords)
            comp = DensityVolumeComponent(sess, device=d)
            refs = comp.render_references("v", None, width, height, max_structures=DV_STRUCTURES)
            vol = comp.render("v", width, height)
            composite = comp.render_composite("v", None, width, height,
                                              max_structures=DV_STRUCTURES)
            out[str(d)] = [t.cpu() for t in (*refs, *vol, composite)] + [
                comp.reference_frames("v")]
    ri, rd, vi, vd, co, m_cpu = out["cpu"]
    gri, grd, gvi, gvd, gco, m_gpu = out[str(dev)]
    frame_err = float(np.abs(m_cpu - m_gpu).max() / np.abs(m_cpu).max())
    fin = torch.isfinite(rd) & torch.isfinite(grd)
    ref_off = (torch.isfinite(rd) != torch.isfinite(grd)) | (fin & ((rd - grd).abs() > TIE_RTOL * rd.abs()))
    ref_err = float((ri - gri).abs().amax(-1)[~ref_off].max())
    if (frame_err > DV_FRAME_RTOL or int(ref_off.sum()) > DV_REF_SHARE * ref_off.numel()
            or ref_err > DV_REF_RGBA):
        raise AssertionError(f"references CUDA vs CPU: frames {frame_err}, "
                             f"{int(ref_off.sum())} pixels off, rgba {ref_err}")
    und = marches[0]
    cmp = compare_volume((gvi, gvd), (vi, vd), und)
    e = (co - gco).abs().amax(-1)
    frac = float((e <= DV_REF_RGBA).double().mean())
    if frac < 0.99:
        raise AssertionError(f"composite CUDA vs CPU: {frac} of pixels within {DV_REF_RGBA:g}")
    remapped = {}
    for d in ("cpu", dev):
        s = copy.deepcopy(small_sys)
        n = DatasetComponent(SimpleNamespace(system=s, stored_selections={}, events=EventBus()),
                             device=d).remap_element("residue(1:10) and element('O')", "S")
        remapped[str(d)] = (n, s.element.copy(), s.bonds.copy())
    (n_c, el_c, b_c), (n_g, el_g, b_g) = remapped["cpu"], remapped[str(dev)]
    if not (n_c == n_g == 10 and np.array_equal(el_c, el_g) and np.array_equal(b_c, b_g)):
        raise AssertionError(f"remap_element CUDA vs CPU: {n_c} / {n_g} atoms")
    return (f"reference frames max diff {frame_err:.3g} of the largest entry; references {int(ref_off.sum())} pixels "
            f"off (depth beyond {TIE_RTOL:g} relative or coverage), rgba {ref_err:.3g} elsewhere; volume "
            f"rgba {cmp['rgba_err']:.3g} depth {cmp['depth_err']:.3g} at decided pixels "
            f"({cmp['undecided']} undecided); composite within {DV_REF_RGBA:g} at "
            f"{frac * 100:.2f}% (max {float(e.max()):.3g}); "
            f"remap_element on {small_sys.natoms} atoms: {n_g} remapped, elements and "
            f"{len(b_g)} bonds equal")


# [colors] (phase 23): the cells' colour launches. The capsid's are
# stmv.cartoon's (filter protein, chain 1's residues selected, SS weights of
# its base frame), the water box's water1m.view's (CPK, filter all, the
# first 2,000 waters selected, the radii)
COLORS_WATERS, COLORS_CAPSID_SELECTION, COLORS_WATER_SELECTION = (
    333_334, "residue(1:159)", "residue(1:2000)")


def host_colors(sys_, ss_np, mask, sel) -> np.ndarray:
    """The colours as Session made them on the host before csrc/colors.cu:
    color.py's numpy chain over every atom (SS blend or CPK, the filter,
    the selection's desaturation)."""
    cols = (color_atoms_secondary_structure(sys_, ss_np) if ss_np is not None
            else color_atoms_cpk(sys_))
    return desaturate_colors(filter_colors(cols, mask), ~sel)


def colors_case(dev, name, sys_, args, want_np, plain_reps: int = 5) -> dict:
    """One colours launch: against its plain version on the card (bit for
    bit) and the numpy chain (alpha and radii bit-equal, rgb within 1e-6),
    one launch a call, its device time behind a queued sleep and with
    events around the call, its host time behind a queued sleep, the byte
    bound, the plain version's time."""
    base, ss, bbres, mask, sel, subset, radius = args
    before = cuda_colors.launches
    got = cuda_colors.atom_colors(*args)
    per_call = cuda_colors.launches - before
    want = cuda_colors.colors_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
            raise AssertionError(f"colors {name}: the kernel differs from colors_plain")
    if per_call != 1:
        raise AssertionError(f"colors {name}: {per_call} launches a call, expected 1")
    cols = got[0].cpu().numpy()
    idx = np.arange(sys_.natoms) if subset is None else subset.cpu().numpy()
    ref = want_np[idx]
    err = float(np.abs(cols[:, :3] - ref[:, :3]).max())
    if not np.array_equal(cols[:, 3], ref[:, 3]) or err > 1e-6:
        raise AssertionError(f"colors {name}: {err:.3g} from the numpy chain, or alpha apart")
    if radius is not None:
        r_want = np.where(ref[:, 3] > 0, sys_.radius[idx], 0.0).astype(np.float32)
        if not np.array_equal(got[1].cpu().numpy(), r_want):
            raise AssertionError(f"colors {name}: radii differ from the numpy chain's")
    ms = cuda_ms(lambda: cuda_colors.atom_colors(*args), queued=True)
    call_ms = cuda_ms(lambda: cuda_colors.atom_colors(*args))
    host = host_ms(lambda: cuda_colors.atom_colors(*args), queued=True)
    if host > 0.5:
        raise AssertionError(f"colors {name}: {host:.4f} ms of host time behind a ~1 ms "
                             "queued sleep: the launch waits on the device")
    with uncounted():
        plain_ms = cuda_ms(lambda: cuda_colors.colors_plain(*args), reps=plain_reps, warmup=1)
    m, nw = idx.size, 2 * ((sys_.natoms + 63) // 64)
    nbytes = m * 16 + (m * 4 if subset is not None else 0)  # colours out, the subset in
    nbytes += m * 16 if base is not None else m * 4 + ss.numel() * 4  # table, or bbres + SS
    nbytes += sum(min(4 * nw, 4 * m) for t in (mask, sel) if t is not None)  # the bits' words
    nbytes += m * 8 if radius is not None else 0  # the radius in, the radius out
    b_ms, b_by = bound(0.0, nbytes)
    return dict(name=name, atoms=m, launches=per_call, max_abs_err=err, ms=ms, call_ms=call_ms,
                host_ms=host, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)


def colors_phase(dev, capsid=None, n_waters: int = COLORS_WATERS, host_reps: int = 3) -> dict:
    """[colors] (phase 23): csrc/colors.cu at the cells' sizes. The capsid
    (`capsid` = (system, frame), or capsid_frame()): SS colours over its
    9,540 CA atoms (stmv.cartoon's launch) and over every atom with the
    radii; a water box of n_waters: CPK colours with the radii
    (water1m.view's launch). Each case against the plain version and the
    numpy chain (`colors_case`); the numpy chain's host time with its
    upload, the route the session took before the kernel."""
    from viamd_tpu_torch.script import evaluate_filter

    t0 = time.perf_counter()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    cap_sys, cap_x = capsid if capsid is not None else capsid_frame()
    protein, _ = evaluate_filter("protein", cap_sys, device=dev)
    chain1, _ = evaluate_filter(COLORS_CAPSID_SELECTION, cap_sys, device=dev)
    ss = current_ss_weights(cap_sys, cap_x, device=dev).contiguous()
    ss_np = ss.cpu().numpy()
    cap_words = [t(cuda_colors.words(b)) for b in (protein, chain1)]
    bbres = t(cuda_colors.backbone_residues(cap_sys))
    cap_ca = t(np.asarray(cap_sys.backbone.atom_ca, np.int32))
    cap_r = t(np.asarray(cap_sys.radius, np.float32))
    cap_want = host_colors(cap_sys, ss_np, protein, chain1)
    wat_sys, _ = water_box(n_waters, n_frames=1, seed=SEED)
    every, _ = evaluate_filter("all", wat_sys, device=dev)
    first, _ = evaluate_filter(COLORS_WATER_SELECTION, wat_sys, device=dev)
    wat_args = [t(color_atoms_cpk(wat_sys)), None, None, t(cuda_colors.words(every)),
                t(cuda_colors.words(first)), None, t(np.asarray(wat_sys.radius, np.float32))]
    wat_want = host_colors(wat_sys, None, every, first)
    cases = [
        colors_case(dev, "capsid, SS, CA subset", cap_sys,
                    [None, ss, bbres, *cap_words, cap_ca, None], cap_want),
        colors_case(dev, "capsid, SS, all atoms, radii", cap_sys,
                    [None, ss, bbres, *cap_words, None, cap_r], cap_want),
        colors_case(dev, "water, CPK, all atoms, radii", wat_sys, wat_args, wat_want),
    ]

    def host_route(sys_, ss_np, mask, sel):  # the chain, the radii, their pageable upload
        cols = host_colors(sys_, ss_np, mask, sel)
        radii = np.where(cols[:, 3] > 0, sys_.radius, 0.0).astype(np.float32)
        return torch.as_tensor(cols, device=dev), torch.as_tensor(radii, device=dev)

    host = {"capsid": host_ms(lambda: host_route(cap_sys, ss_np, protein, chain1),
                              reps=host_reps),
            "water": host_ms(lambda: host_route(wat_sys, None, every, first), reps=host_reps)}
    phase("colors", t0, " || ".join(
        f"{c['name']} ({c['atoms']} atoms): equal to colors_plain bit for bit, within "
        f"{c['max_abs_err']:.3g} of the numpy chain (alpha and radii bit-equal); "
        f"{c['launches']} launch a call; device time (queued) {c['ms']:.4f} ms, events around "
        f"the call {c['call_ms']:.4f} ms, host {c['host_ms']:.4f} ms; bound {c['bound_ms']:.4f} "
        f"ms ({c['bound_by']}; {c['bytes']} bytes), the kernel at "
        f"{c['bound_ms'] / c['ms'] * 100:.1f}%; plain {c['plain_ms']:.3f} ms" for c in cases)
        + f" || the numpy chain + radii + upload (the session's route before the kernel): "
        f"capsid {host['capsid']:.1f} ms, water {host['water']:.1f} ms; ptxas: "
        + (" | ".join(ln.strip() for ln in cuda_build.build_info["colors"]["log"].splitlines()
                      if "registers" in ln or "spill" in ln) or "(build reused)"))
    return dict(cases=cases, host_ms=host)


SESSION_TAA_FRAMES, SESSION_OUTLINE = 16, "residue(1:2000)"
SESSION_STAGES = ("raster", "outline", "volume", "postprocess")
# the modules that declare a CUDA kernel library, each with its `launches`
KERNEL_MODULES = tuple(m for m in cuda_build.declared() if m.LIBRARY.compiler == "nvcc")


def reset_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.launches = 0


def read_launches() -> dict:
    return {mod.LIBRARY.name: mod.launches for mod in KERNEL_MODULES}


@contextlib.contextmanager
def uncounted():
    """A reference run inside a counted phase: every count is put back to
    what it was before, so that the phase counts only its own launches."""
    saved = [mod.launches for mod in KERNEL_MODULES]
    try:
        yield
    finally:
        for mod, n in zip(KERNEL_MODULES, saved):
            mod.launches = n


def staged_frame(s, **kw):
    """One Session.render(**kw) with each stage wrapped: → (result, {stage:
    [device ms by events, host ms to a synchronize]}). The stages are the
    representations' rasters (`_draw_rep`), the selection outlines, the
    in-scene volume and the postprocess chain; each is fenced before and
    after, so the host times add up to the frame's."""
    times = {k: [0.0, 0.0] for k in SESSION_STAGES}

    def timed(stage, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            out = fn(*a, **k)
            end.record()
            torch.cuda.synchronize()
            times[stage][0] += start.elapsed_time(end)
            times[stage][1] += (time.perf_counter() - t1) * 1e3
            return out
        return run

    with mock.patch.object(s, "_draw_rep", timed("raster", s._draw_rep)), \
            mock.patch.object(s, "_draw_selection_outline",
                              timed("outline", s._draw_selection_outline)), \
            mock.patch.object(s, "_render_volume_inscene",
                              timed("volume", s._render_volume_inscene)), \
            mock.patch.object(postprocess, "execute", timed("postprocess", postprocess.execute)):
        out = s.render(**kw)
    torch.cuda.synchronize()
    return out, times


# csrc/hbao.cu's float32 operations a pixel, counted from its source: the
# normal (positions, two differences, the cross product with 3 FMAs, the
# norm, 3 divisions), the radius and mip offset, each of the 16 samples
# (coordinates, level, fetch position, view vector, N·V, rsqrt, falloff,
# the weighted sum), the normalisation and power, and the blur's 6 taps
# an axis (difference, square, exp2f, two sums) with its quotient
HBAO_OPS_NORMAL, HBAO_OPS_SAMPLE, HBAO_OPS_PIXEL, HBAO_OPS_TAP = 52, 45, 20, 8
HBAO_COMPOSED_FRAMES = 5


def hbao_phase(dev, s, width: int, height: int) -> dict:
    """[hbao]: csrc/hbao.cu on Session `s`'s raw depth at width × height
    (its camera), against `hbao_plain` on the card; then the composed
    frame (the session's outline, volume `v`, postprocess) with the kernel
    and with the plain version in turns. Counts nothing of the session's
    launches (it runs inside `uncounted`)."""
    t0 = time.perf_counter()
    _, dep, _ = s.render(width, height)
    dep = dep.contiguous()
    proj = np.asarray(s.camera.proj_matrix(width, height), np.float32)
    before = cuda_hbao.launches
    got = hbao_mod.hbao(dep, proj)
    per_call = cuda_hbao.launches - before
    want = hbao_mod.hbao_plain(dep, proj)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = float((got == want).float().mean()) * 100
    # equal bit for bit outside the pixels a mip tie can move
    tie = cuda_hbao.tie_pixels(dep, proj)
    apart = got != want
    n_tie, n_apart, n_bad = int(tie.sum()), int(apart.sum()), int((apart & ~tie).sum())
    if per_call != 4:
        raise AssertionError(f"hbao: {per_call} launches a call, expected 4")
    if n_bad or n_tie > 0.01 * width * height:
        raise AssertionError(f"hbao: {n_bad} pixels differ from hbao_plain outside the "
                             f"{n_tie} tie-reachable pixels (max |diff| {err:.3g})")
    ms = cuda_ms(lambda: hbao_mod.hbao(dep, proj), queued=True)
    ms_noblur = cuda_ms(lambda: hbao_mod.hbao(dep, proj, blur=False), queued=True)
    ms_mips = cuda_ms(lambda: cuda_hbao.mips(dep), queued=True)
    ms_call = cuda_ms(lambda: hbao_mod.hbao(dep, proj))
    ms_host = host_ms(lambda: hbao_mod.hbao(dep, proj), queued=True)
    ms_plain = cuda_ms(lambda: hbao_mod.hbao_plain(dep, proj), reps=5, warmup=1)
    px = width * height
    ops = px * (HBAO_OPS_NORMAL + 16 * HBAO_OPS_SAMPLE + HBAO_OPS_PIXEL + 2 * (6 * HBAO_OPS_TAP + 2))
    nbytes = px * 4 * 2  # the depth read once, the AO written once
    b_ms, b_by = bound(ops, nbytes)
    ptxas = [ln.strip() for ln in cuda_build.build_info["hbao"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    # the composed frame, the kernel and the plain version in turns
    kw = dict(volume="v", postprocess=True)
    frames = {"kernel": [], "plain": []}
    for side in ("kernel", "plain", "plain", "kernel"):
        with (contextlib.nullcontext() if side == "kernel"
              else mock.patch.object(postprocess, "hbao", hbao_mod.hbao_plain)):
            s.render(width, height, **kw)  # warm-up
            for _ in range(HBAO_COMPOSED_FRAMES):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                s.render(width, height, **kw)
                torch.cuda.synchronize()
                frames[side].append((time.perf_counter() - t1) * 1e3)
    med = {k: statistics.median(v) for k, v in frames.items()}
    phase("hbao", t0, (
        f"{width}x{height}: kernel vs hbao_plain on the card max |diff| {err:.3g}, bit-equal "
        f"at {equal:.4f}% of pixels (tolerance: 0 outside the {n_tie} pixels a mip tie within "
        f"{cuda_hbao.TIE:g} can move, {n_apart} apart, all among them); {per_call} launches "
        f"a call; device time (queued) "
        f"{ms:.4f} ms (mips {ms_mips:.4f}, mips + occlusion {ms_noblur:.4f}, so the blur "
        f"{ms - ms_noblur:.4f}); events around the call {ms_call:.4f} ms, host "
        f"{ms_host:.4f} ms; bound {b_ms:.4f} ms ({b_by}; {ops:.6g} operations, {nbytes} "
        f"bytes), the kernel at {b_ms / ms * 100:.1f}%; plain {ms_plain:.3f} ms, "
        f"plain/kernel {ms_plain / ms:.0f}x; ptxas: {' | '.join(ptxas) or '(build reused)'}; "
        f"composed frame ms (kernel, plain, plain, kernel; {HBAO_COMPOSED_FRAMES} each): "
        f"kernel {' '.join(f'{t:.2f}' for t in frames['kernel'])} (median "
        f"{med['kernel']:.2f}), plain {' '.join(f'{t:.2f}' for t in frames['plain'])} "
        f"(median {med['plain']:.2f})"
    ))
    return dict(launches=per_call, max_abs_err=err, ms=ms, plain_ms=ms_plain, bound_ms=b_ms,
                bound_by=b_by, call_ms=ms_call, frame_ms=med["kernel"],
                frame_plain_ms=med["plain"])


def session_phase(dev, sys_, traj, res, main_fps: float, n_taa: int = SESSION_TAA_FRAMES,
                  width: int = WIDTH, height: int = HEIGHT, cli: bool = True,
                  demo_res: int = 64, qm_res: int = QM_RES) -> dict:
    """[session]: the app layer over the headline box, through the entry
    points a user calls (phase 21). `sys_`, `traj`, `res`: `[main]`'s
    system, device trajectory and result; `main_fps`: its best frames/s.
    → {"launches": each kernel's launches by the phase's Session calls,
    its reference runs not counted}."""
    t0 = time.perf_counter()
    SCRATCH.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="session-", dir=SCRATCH))
    try:
        return _session_phase(dev, sys_, traj, res, main_fps, n_taa, width, height, cli,
                              demo_res, qm_res, work, t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _session_phase(dev, sys_, traj, res, main_fps, n_taa, width, height, cli, demo_res,
                   qm_res, work: Path, t0) -> dict:
    from viamd_tpu_torch.app import Session
    from viamd_tpu_torch.app.viewer import ViewerServer
    from viamd_tpu_torch.io.cache import transcode
    from viamd_tpu_torch.render import color as color_mod
    from viamd_tpu_torch.render.camera import Camera

    n_frames = traj.num_frames
    gro, vtraj, via = str(work / "box.gro"), str(work / "box.vtraj"), str(work / "box.via")
    # -- 1. the box as files, written by the port: the system as a .gro, the
    # frames losslessly as a .vtraj; opened by Session.load
    t1 = time.perf_counter()
    write_gro(gro, sys_, sys_.coords())
    transcode(traj, vtraj)
    t_write = time.perf_counter() - t1
    reset_launches()
    s = Session(device=dev)
    try:
        t1 = time.perf_counter()
        s.load(gro)
        t_gro = time.perf_counter() - t1
        t1 = time.perf_counter()
        s.load(vtraj)
        staged = s.stage_to_device()
        s.trajectory.stack[-1, -1].sum().item()  # the staging copy has landed
        t_stage = time.perf_counter() - t1
        if not staged or s.num_frames != n_frames or s.system.natoms != sys_.natoms:
            raise AssertionError((staged, s.num_frames, s.system.natoms))
        # -- 2. the headline script through Session.evaluate
        t1 = time.perf_counter()
        s.set_script(HEADLINE)
        t_compile = time.perf_counter() - t1
        if s.script_errors or s.compiled.routes != ["rdf:cell_list", "sdf:pairs"]:
            raise AssertionError((s.script_errors, s.compiled.routes))
        s.evaluate(chunk=CHUNK).force()
        runs = []
        for _ in range(3):
            t1 = time.perf_counter()
            got = s.evaluate(chunk=CHUNK)
            got.force()
            runs.append(n_frames / (time.perf_counter() - t1))
        # [main]'s path (compile_script → Evaluator, chunk 64) on the same
        # loaded system and frames
        with uncounted():
            ref = Evaluator(compile_script(HEADLINE, s.system, dev), s.trajectory,
                            chunk=CHUNK).run()
        bad = equal_results(got, ref)
        if bad:
            raise AssertionError(f"Session.evaluate differs from the Evaluator in {bad}")
        # the frames are [main]'s bit for bit, so every property that reads
        # only them equals [main]'s; v's reference structures come from the
        # .gro's coordinates (0.001 nm), so v is held to the line above
        bad = [k for k in ("lin", "plan", "iso") if not np.array_equal(got.temporal[k], res.temporal[k])]
        if bad or not np.array_equal(got.distributions["r"], res.distributions["r"]):
            raise AssertionError(f"Session.evaluate differs from [main] in {bad or ['r']}")
        v_rel = float(np.abs(got.volumes["v"] - res.volumes["v"]).max() / np.abs(res.volumes["v"]).max())
        # -- 3. frame 0 at full width: raw spacefill against render_molecules,
        # then the composed frame (outline, in-scene volume, postprocess)
        s.set_frame(0.0)
        img, dep, pick = s.render(width, height)
        cam = s.camera
        cols = color_mod.color_atoms_cpk(s.system)
        radii = np.where(cols[:, 3] > 0, s.system.radius, 0.0).astype(np.float32)
        with uncounted():
            want = render_molecules(s.trajectory.device_frame(0)[0], radii, cols,
                                    cam.view_matrix(), cam.proj_matrix(width, height),
                                    RasterSettings(width=width, height=height), device=dev)
        if not all(torch.equal(a, b) for a, b in zip((img, dep, pick), want)):
            raise AssertionError("Session.render differs from render_molecules")
        s.select(SESSION_OUTLINE)
        s.render(width, height, volume="v", postprocess=True)  # warm-up
        composed = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = s.render(width, height, volume="v", postprocess=True)
            torch.cuda.synchronize()
            composed.append((time.perf_counter() - t1) * 1e3)
        frame = out[0]
        if frame.shape != (height, width, 4) or not bool(torch.isfinite(frame).all()):
            raise AssertionError(("composed frame", tuple(frame.shape)))
        _, stages = staged_frame(s, width=width, height=height, volume="v", postprocess=True)
        syncs = sync_points(lambda: s.render(width, height, volume="v", postprocess=True))
        with uncounted():
            hbao_res = hbao_phase(dev, s, width, height)
        # -- 4. a TAA movie over frames 0..n_taa-1
        s.selection.clear()
        list(s.render_frames(range(2), width, height, taa=True))  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        movie = [rgba for _, rgba in s.render_frames(range(n_taa), width, height, taa=True)]
        torch.cuda.synchronize()
        taa_ms = (time.perf_counter() - t1) * 1e3 / n_taa
        if not bool(torch.isfinite(movie[-1]).all()):
            raise AssertionError("TAA frame not finite")
        # -- 5. recentring: two calls, the same bits (com_segments sums in
        # fixed point); a float index_add_ (the parent's sum) beside it
        s.recenter("resname('SOL')")
        s.set_frame(0.5)
        a, b = s.current_coords(), s.current_coords()
        if not np.array_equal(a, b) or not np.isfinite(a).all():
            raise AssertionError("two recentred frames differ")
        x0 = s.device_coords()
        seg = torch.as_tensor(np.asarray(s.system.atom_res_idx, np.int64), device=dev)

        def atomic_seg_sum(x):
            out = torch.zeros((s.system.nres, 3), device=dev)
            return out.index_add_(0, seg, x)

        atomic = [atomic_seg_sum(x0) for _ in range(4)]
        atomic_differ = sum(not torch.equal(atomic[0], t) for t in atomic[1:])
        rec_ms = cuda_ms(s.device_coords, reps=5, warmup=1)
        # -- 6. a .via round trip: a new Session from the workspace renders
        # the same pixels. The camera is one that %f text and the
        # orientation quaternion carry exactly: integer eye and centre, the
        # identity orientation, a 0.75 rad field of view
        s.recenter(None)
        c = np.round(np.asarray(s.camera.center, np.float64))
        dist = float(np.round(np.linalg.norm(np.asarray(s.camera.eye, np.float64) - c)))
        s.camera = Camera(eye=(c + [0.0, 0.0, dist]).astype(np.float32), center=c.astype(np.float32),
                          up=np.array([0.0, 1.0, 0.0], np.float32), fovy=0.75)
        s.save_workspace(via)
        proc = None
        if cli:  # -- 7. the CLI, in a process of its own, meanwhile
            png = str(work / "demo.png")
            proc = subprocess.Popen(
                [sys.executable, "-m", "viamd_tpu_torch.app.cli", "render", "demo", "-o", png,
                 "--width", str(width), "--height", str(height), "--postprocess"],
                cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        t1 = time.perf_counter()
        s2 = Session(device=dev)
        try:
            s2.load_workspace(via)
            t_via = time.perf_counter() - t1
            s2.stage_to_device()
            a2 = s2.render(width, height)
            a1 = s.render(width, height, show_selection=False)
            if s2.frame != 0.5 or not all(torch.equal(p, q) for p, q in zip(a1, a2)):
                raise AssertionError("the .via round trip renders other pixels")
        finally:
            s2.shutdown()
        cli_msg = "not run"
        if proc is not None:
            out_txt = proc.communicate(timeout=600)[0]
            if proc.returncode != 0 or open(png, "rb").read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"the CLI exited {proc.returncode}: {out_txt[-2000:]}")
            cli_msg = f"exit 0, {os.path.getsize(png) / 2**20:.1f} MiB PNG"
        # -- 8. the viewer on an ephemeral port
        import urllib.request

        srv = ViewerServer(s, host="127.0.0.1", port=0).serve(blocking=False)
        try:
            base = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
            state = json.loads(urllib.request.urlopen(base + "/api/state", timeout=120).read())
            t1 = time.perf_counter()
            body = urllib.request.urlopen(base + f"/render?w={width}&h={height}", timeout=300).read()
            view_ms = (time.perf_counter() - t1) * 1e3
            eye0 = np.array(s.camera.eye)
            req = urllib.request.Request(base + "/api/orbit",
                                         data=json.dumps({"dx": 0.1, "dy": 0.0}).encode())
            orbit = json.loads(urllib.request.urlopen(req, timeout=120).read())
            if (state["natoms"] != sys_.natoms or body[:8] != b"\x89PNG\r\n\x1a\n" or orbit != {}
                    or np.allclose(eye0, s.camera.eye)):
                raise AssertionError(("viewer", state.get("natoms"), body[:8], orbit))
        finally:
            srv.close()
    finally:
        s.shutdown()
    # -- 9. the protein and QM views through a Session: the demo's cartoon
    # (triangles.cu) and an orbital composited in-scene (gto.cu → volume.cu)
    d = Session(device=dev)
    try:
        d.load_demo(n_res=demo_res)
        d.evaluate().force()
        d.representations[0].type = "cartoon"
        d.representations[0].color_mapping = "secondary_structure"
        _, qm = qm_molecule(qm_res)
        vlx = d.components["veloxchem"]
        vlx.load(qm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vol = vlx.orbital_scene_volume(dims=48)
        cart = d.render(width, height, volume=vol, postprocess=True)[0]
        torch.cuda.synchronize()
        protein_ms = (time.perf_counter() - t1) * 1e3
        if not bool(torch.isfinite(cart).all()):
            raise AssertionError("the cartoon + orbital frame is not finite")
    finally:
        d.shutdown()
    launches = read_launches()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the Session phase launched no {missing}")
    st = " | ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in stages.items())
    phase("session", t0, (
        f"{sys_.natoms} atoms x {n_frames} frames from files: wrote .gro + .vtraj "
        f"{t_write:.2f} s; Session.load .gro {t_gro:.2f} s, .vtraj + stage_to_device "
        f"{t_stage:.2f} s; set_script {t_compile:.2f} s"
    ))
    phase("session", t0, (
        f"Session.evaluate frames/s {' '.join(f'{f:.1f}' for f in runs)} (best "
        f"{max(runs):.1f}; [main]'s Evaluator best {main_fps:.1f}); r, v, lin, plan, iso equal "
        f"to compile_script + Evaluator (chunk {CHUNK}) on the loaded box bit for bit, r, "
        f"lin, plan, iso equal to [main]'s, v within {v_rel:.3g} of [main]'s largest voxel "
        f"(its reference structures from the .gro's 0.001 nm coordinates)"
    ))
    phase("session", t0, (
        f"render {width}x{height} frame 0 spacefill raw: rgba, depth, picks equal to "
        f"render_molecules; composed frame (outline of {SESSION_OUTLINE}, in-scene v, "
        f"postprocess) ms, host clock to a synchronize: "
        f"{' / '.join(f'{t:.3f}' for t in composed)} (best {min(composed):.3f}); by stage, "
        f"events / host ms, each fenced: {st}; sync points in render: {len(syncs)}"
        + (f" ({'; '.join(syncs[:6])})" if syncs else "")
    ))
    phase("session", t0, (
        f"render_frames(range({n_taa}), taa=True) {taa_ms:.3f} ms/frame; recenter "
        f"resname('SOL') at frame 0.5: two current_coords() equal bit for bit, "
        f"{rec_ms:.3f} ms by events; a float index_add_ segment sum of the same frame, 4 "
        f"runs: {atomic_differ} of 3 differ from the first"
    ))
    phase("session", t0, (
        f".via round trip (save, a new Session's load_workspace {t_via:.2f} s): the same "
        f"pixels; CLI render demo {width}x{height} --postprocess: {cli_msg}; viewer on "
        f"127.0.0.1: /api/state natoms {state['natoms']}, /render {view_ms:.1f} ms "
        f"({len(body) / 2**20:.1f} MiB PNG), /api/orbit moved the camera"
    ))
    phase("session", t0, (
        f"demo ({demo_res} residues) cartoon + orbital (qm_molecule({qm_res}), 48^3) "
        f"in-scene + postprocess {protein_ms:.1f} ms; launches by the Session and its "
        f"components (the reference runs not counted) "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
    ))
    return {"launches": launches, "hbao": hbao_res}


# [multi] (phase 22): multi-device evaluation with ranks sharing the card.
# The headline frames-sharded run takes all 384 frames on 2 ranks; dp × tp
# takes the first MULTI_TP_FRAMES on a 2 × 2 mesh: four processes share
# the card and the host's cores there, and every frame's RDF waits for a
# gloo sum on the host, so 128 frames keep the phase near 90 s.
MULTI_RANKS, MULTI_TP_FRAMES = 4, 128


def compute_mode() -> str:
    """The card's compute mode; an exclusive mode admits one process, and
    ranks that share the card cannot run under it."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if "exclusive" in mode.lower():
        raise AssertionError(f"compute mode {mode}: {MULTI_RANKS} ranks cannot share the card")
    return mode


def one_at_a_time(fn, world: int):
    """fn() on each rank in turn, the others waiting at a barrier, so that a
    rank's timing has the card to itself → this rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(world):
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def multi_rank(cases, n_waters: int, n_frames: int, tp_frames: int, chunk: int) -> dict:
    """What each rank of `[multi]` runs (the world is MULTI_RANKS ranks on
    one device type). → numpy results, times and counts of this rank:
    - "slabs": for each case (name, x, idx, basis, r_max, dims, fractional,
      radius; A against itself) and split 2 and world, this rank's rows,
      its kernel partial on them (pair_hist_cells(rows=)), its device time
      (alone on the card), and the histogram summed over the split
      (pair_dist_histogram_cl_sharded);
    - "all_reduce_ms": a 128-bin int32 sum over the world's atoms axis;
    - "frames": ranks 0-1 (a 2-rank frames mesh): the headline script over
      water_box_device(n_waters, n_frames), host seconds of one timed run
      after a warm-up chunk, its launches and results;
    - "tp": every rank (2 × 2, atom_shard=("atoms", 2)): frames
      0..tp_frames−1, seconds, launches, host waits for the device, frames
      this rank evaluated, results."""
    import torch.distributed as dist

    from viamd_tpu_torch.parallel.mesh import frames_mesh

    world = dist.get_world_size()
    mesh_all = frames_mesh()
    dev = mesh_all.device
    on_card = dev.type == "cuda"
    # the kernel on the card; its plain walk where a CPU rehearsal runs this
    walk = cuda_rdf.pair_hist_cells if on_card else cuda_rdf.pair_hist_cells_plain
    out = {"rank": mesh_all.rank, "device": str(dev), "backend": mesh_all.backend, "slabs": {}}
    for name, x, idx, basis, r_max, dims, frac, radius in cases:
        xt = torch.as_tensor(x, device=dev)
        b = torch.as_tensor(basis, device=dev)
        inv = inv_basis_of(b)
        ia = torch.as_tensor(idx, device=dev)
        a = cuda_rdf.cell_lists(xt, ia, b, inv, dims, frac)
        args = (*a, *a, b, inv, dims, NBINS, r_max, True, radius)
        for atoms in (2, world):
            mesh = frames_mesh(atoms=atoms)
            rows = cuda_rdf.slab_rows(mesh.axis_index("atoms"), atoms, dims[0])
            part = walk(*args, rows=rows)
            summed = cuda_rdf.pair_dist_histogram_cl_sharded(
                xt, ia, ia, b, inv, NBINS, r_max, dims, mesh, fractional=frac, radius=radius)
            ms = one_at_a_time(lambda: cuda_ms(lambda: walk(*args, rows=rows), queued=True)
                               if on_card else None, world)
            out["slabs"][(name, atoms)] = dict(rows=rows, part=part.cpu().numpy(),
                                               summed=summed.cpu().numpy(), ms=ms)
    mesh4 = frames_mesh(atoms=world)
    t = torch.zeros(NBINS, dtype=torch.int32, device=dev)
    out["all_reduce_ms"] = host_ms(lambda: mesh4.all_reduce(t, "atoms")) if on_card else None

    sys_, traj = water_box_device(n_waters, n_frames=n_frames, seed=SEED, device=dev)
    mesh2 = frames_mesh(2)  # ranks 2.. sit this one out
    if mesh2 is not None:
        ev = Evaluator(compile_script(HEADLINE, sys_, dev), traj, chunk=chunk, mesh=mesh2)
        ev.run(range(chunk)).force()  # warm-up
        dist.barrier(mesh2.groups[None])
        cuda_rdf.launches = 0
        t1 = time.perf_counter()
        res = ev.run()
        res.force()
        out["frames"] = dict(seconds=time.perf_counter() - t1, launches=cuda_rdf.launches,
                             temporal=res.temporal, r=res.distributions["r"],
                             v=res.volumes["v"], n=res.n_frames_done)
    dist.barrier()

    mesh22 = frames_mesh(atoms=2)
    compiled_tp = compile_script(HEADLINE, sys_, dev, atom_shard=("atoms", 2))
    ev_tp = Evaluator(compiled_tp, traj, chunk=chunk, mesh=mesh22)
    ev_tp.run(range(mesh22.size)).force()  # warm-up
    dist.barrier()
    waits0 = mesh22.host_waits
    block = ev_tp.block
    mine = [f for f in range(tp_frames)
            if (f % ev_tp.chunk) // block == mesh22.axis_index("frames")]
    cuda_rdf.launches = 0
    t1 = time.perf_counter()
    res_tp = ev_tp.run(range(tp_frames))
    res_tp.force()
    out["tp"] = dict(seconds=time.perf_counter() - t1, launches=cuda_rdf.launches,
                     host_waits=mesh22.host_waits - waits0, frames=len(mine),
                     routes=ev_tp.script.routes, temporal=res_tp.temporal,
                     r=res_tp.distributions["r"], v=res_tp.volumes["v"],
                     n=res_tp.n_frames_done)
    return out


def within_reassociation(got: np.ndarray, want: np.ndarray, n_frames: int) -> float:
    """Raises unless an accumulator of float32 frame sums taken in another
    order is within n_frames · 2⁻²⁴ of `want` relative, per element (its
    terms are not negative), and equal wherever `want` is below 2²⁴ and
    whole (counts, summed exactly); → the largest relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if (want < 0).any():
        raise AssertionError("the reassociation bound needs terms that are not negative")
    diff = np.abs(got - want)
    if (diff > n_frames * 2.0**-24 * want).any():
        raise AssertionError(f"sums differ beyond {n_frames}·2^-24 relative: max "
                             f"{float(diff.max())}")
    exact = (want < 2**24) & (want == np.round(want))
    if (diff[exact] != 0).any():
        raise AssertionError("whole counts below 2^24 differ")
    return float((diff / np.maximum(want, 1e-30)).max())


def multi_phase(dev, sys_, traj, res, tri, n_waters: int = N_WATERS,
                n_frames: int = N_FRAMES, tp_frames: int = MULTI_TP_FRAMES,
                chunk: int = CHUNK, r2_cutoff: float = R2_CUTOFF,
                r2_dims: tuple = R2_DIMS) -> dict:
    """[multi] (phase 22): the sharded paths with MULTI_RANKS ranks sharing
    the card (gloo: NCCL refuses two ranks on one device). `sys_`, `traj`,
    `res`: `[main]`'s box and its one-rank result over all frames; `tri`:
    `[kernel-tri]`'s. → the slab kernel's numbers and the sharded runs'
    launches."""
    t0 = time.perf_counter()
    mode = compute_mode() if dev.type == "cuda" else "(no card)"
    x0, basis = traj.device_frame(0)
    idx_o = np.nonzero(sys_.element == 8)[0].astype(np.int32)
    dims = choose_grid_r(sys_.cell.extent(), R_MAX, idx_o.size, radius=1)[0]
    xt, bt = tri["traj"].device_frame(0)
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    cases = [
        ("headline", np_(x0), idx_o, np_(basis), R_MAX, tuple(dims), False, 1),
        ("triclinic", np_(xt), idx_o, np_(bt), R_MAX, tuple(tri["dims"]), True, 1),
        ("radius-2", np_(x0), idx_o, np_(basis), r2_cutoff, tuple(r2_dims), False, 2),
    ]
    t_spawn = time.perf_counter()
    ranks = launch.spawn(multi_rank, MULTI_RANKS, dev.type, cases, n_waters, n_frames,
                         tp_frames, chunk, timeout=600)
    t_ranks = time.perf_counter() - t_spawn
    # the slab kernel: each rank's partial against the plain walk of its
    # rows, the summed histograms against the one-rank kernel, bit for bit
    slab_lines, per_rank, err_multi = [], {}, 0.0
    for name, x, idx, b, r_max, dims_c, frac, radius in cases:
        xd, bd = torch.as_tensor(x, device=dev), torch.as_tensor(b, device=dev)
        inv = inv_basis_of(bd)
        a = cuda_rdf.cell_lists(xd, torch.as_tensor(idx, device=dev), bd, inv, dims_c, frac)
        args = (*a, *a, bd, inv, dims_c, NBINS, r_max, True, radius)
        with uncounted():
            one = (cuda_rdf.pair_hist_cells(*args) if dev.type == "cuda"
                   else cuda_rdf.pair_hist_cells_plain(*args)).cpu().numpy()
        nbytes = sum(t.numel() * 4 for t in a) + 72 + NBINS * 4
        ops_pair = OPS_PAIR_TRI if frac else OPS_PAIR
        for atoms in (2, MULTI_RANKS):
            got = [r["slabs"][(name, atoms)] for r in ranks]
            rows = sorted({g["rows"] for g in got})
            plains = {}
            for rw in rows:
                work = {}
                plains[rw] = (cuda_rdf.pair_hist_cells_plain(*args, work=work, rows=rw)
                              .cpu().numpy(), work)
            for g in got:
                err_multi = max(err_multi, float(np.abs(g["part"] - plains[g["rows"]][0]).max()))
                if not np.array_equal(g["part"], plains[g["rows"]][0]):
                    raise AssertionError(f"{name}, rows {g['rows']}: the kernel's partial "
                                         "differs from the plain walk of its rows")
                if not np.array_equal(g["summed"], one):
                    raise AssertionError(f"{name}, {atoms} ranks: the summed histogram "
                                         "differs from the one-rank kernel")
            if not np.array_equal(sum(p for p, _ in plains.values()), one):
                raise AssertionError(f"{name}: the rows do not partition the grid")
            shares = []
            for g in got[:atoms]:  # one atoms line
                p, work = plains[g["rows"]]
                bms, bby = bound(work["pairs"] * ops_pair + float(p.sum()) / 2 * OPS_PAIR_HIT,
                                 nbytes)
                shares.append((g["rows"], g["ms"], bms, bby, work["pairs"]))
            per_rank[(name, atoms)] = shares
            slab_lines.append(
                f"{name} dims={dims_c} over {atoms}: " + ", ".join(
                    f"rows {lo}-{hi}: {pairs} candidates, "
                    + (f"{ms:.4f} ms (device, queued) vs its bound {bms:.4f} ms "
                       f"({bms / ms * 100:.1f}%)" if ms else f"bound {bms:.4f} ms")
                    for (lo, hi), ms, bms, _, pairs in shares))
    # the frames-sharded headline against [main]'s one-rank Evaluator
    fr = [r["frames"] for r in ranks if "frames" in r]
    if len(fr) != 2 or any(f["n"] != n_frames for f in fr):
        raise AssertionError(f"the 2-rank headline run: {[f['n'] for f in fr]}")
    same = lambda a, b: all(a[k].tobytes() == b[k].tobytes() for k in ("r", "v"))  # noqa: E731
    if not same(fr[0], fr[1]) or not all(same(t["tp"], ranks[0]["tp"]) for t in ranks):
        raise AssertionError("the ranks of a sharded run returned different results")
    rel = {}
    for f in fr:
        for k, v in res.temporal.items():
            if f["temporal"][k].tobytes() != v.tobytes():
                raise AssertionError(f"frames-sharded temporal {k} differs from one rank's")
        rel["r"] = within_reassociation(f["r"], res.distributions["r"], n_frames)
        rel["v"] = within_reassociation(f["v"], res.volumes["v"], n_frames)
    on_card = dev.type == "cuda"  # a CPU rehearsal launches no kernel
    if on_card and min(f["launches"] for f in fr) < n_frames // 2:
        raise AssertionError(f"frames-sharded launches {[f['launches'] for f in fr]}")
    # dp × tp against one rank over the same frames
    with uncounted():
        one_tp = Evaluator(compile_script(HEADLINE, sys_, dev), traj, chunk=chunk).run(
            range(tp_frames))
    tp = [r["tp"] for r in ranks]
    for t in tp:
        if t["routes"] != ["rdf:cell_list", "sdf:pairs"] or t["n"] != tp_frames:
            raise AssertionError((t["routes"], t["n"]))
        for k, v in one_tp.temporal.items():
            if t["temporal"][k].tobytes() != v.tobytes():
                raise AssertionError(f"dp×tp temporal {k} differs from one rank's")
        rel["tp_r"] = within_reassociation(t["r"], one_tp.distributions["r"], tp_frames)
        rel["tp_v"] = within_reassociation(t["v"], one_tp.volumes["v"], tp_frames)
        if t["frames"] == 0 or (on_card and t["launches"] < t["frames"]):
            raise AssertionError(f"dp×tp: a rank launched {t['launches']} times for "
                                 f"{t['frames']} frames")
    launches_frames = sum(f["launches"] for f in fr)
    launches_tp = sum(t["launches"] for t in tp)
    fps_frames = n_frames / max(f["seconds"] for f in fr)
    fps_tp = tp_frames / max(t["seconds"] for t in tp)
    waits = [t["host_waits"] / t["frames"] for t in tp]
    t_dry = time.perf_counter()
    dry = dryrun.dryrun_multichip(MULTI_RANKS, dev.type)
    if len(dry) != 6:
        raise AssertionError(f"the dry run printed {len(dry)} ok lines")
    t_dry = time.perf_counter() - t_dry
    head = per_rank[("headline", MULTI_RANKS)]
    slowest = max(head, key=lambda s: s[1] or 0.0)
    # the plain walk of the slowest rank's rows, on the parent's device
    x0_o = cuda_rdf.cell_lists(x0, torch.as_tensor(idx_o, device=dev), basis,
                               inv_basis_of(basis), tuple(dims))
    head_args = (*x0_o, *x0_o, basis, inv_basis_of(basis), tuple(dims), NBINS, R_MAX, True)
    plain_ms = cuda_ms(lambda: cuda_rdf.pair_hist_cells_plain(*head_args, rows=slowest[0]),
                       reps=3, warmup=1)
    phase("multi", t0, (
        f"compute mode {mode}; {MULTI_RANKS} ranks sharing one card ({ranks[0]['device']}), "
        f"backend {ranks[0]['backend']}; the ranks' launch and work {t_ranks:.1f} s; "
        + " | ".join(slab_lines) + "; every rank's partial equal to the plain walk of its "
        "rows, every summed histogram (2 and 4 ranks) equal to the one-rank kernel bit "
        f"for bit; the slowest rank's rows {slowest[0]} plain {plain_ms:.4f} ms; a 128-bin "
        f"int32 all_reduce over 4 ranks {ranks[0]['all_reduce_ms'] or float('nan'):.4f} ms "
        "(host clock; gloo stages CUDA tensors through the host)"
    ))
    phase("multi", t0, (
        f"headline script frames-sharded, 2 ranks sharing one card, {n_frames} frames: "
        f"{fps_frames:.1f} frames/s (ranks sharing one card: no speed-up is measurable), "
        f"launches {[f['launches'] for f in fr]}; temporal rows bit-equal to [main]'s "
        f"one-rank run, r within {rel['r']:.3g} and v within {rel['v']:.3g} relative "
        f"(bound {n_frames}·2^-24 = {n_frames * 2.0**-24:.3g}) | dp×tp 2×2 with "
        f"atom_shard=('atoms', 2), frames 0-{tp_frames - 1}: {fps_tp:.1f} frames/s (4 "
        f"ranks sharing one card), launches {[t['launches'] for t in tp]}, host waits a "
        f"frame {' '.join(f'{w:.3f}' for w in waits)} (the per-frame gloo sum of the RDF "
        f"partials; the run's end adds its gathers and sums), temporal bit-equal, r within "
        f"{rel['tp_r']:.3g}, v within {rel['tp_v']:.3g} relative of one rank's | dry run "
        f"({MULTI_RANKS} ranks) {t_dry:.1f} s, {len(dry)} ok lines"
    ))
    return dict(launches=launches_frames + launches_tp, launches_frames=launches_frames,
                launches_tp=launches_tp, ms=slowest[1], rows=slowest[0], bound_ms=slowest[2],
                bound_by=slowest[3], plain_ms=plain_ms, err=err_multi)


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
    cuda_build.build(mod.LIBRARY for mod in KERNEL_MODULES)
    lines = []
    for mod in KERNEL_MODULES:
        mod.LIBRARY.load()
        name = mod.LIBRARY.name
        secs = cuda_build.build_info[name]["seconds"]
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
    xs, ids, cell_start = cuda_rdf.cell_lists(x0, idx_o, basis, inv, dims)
    cells = (xs, ids, cell_start, xs, ids, cell_start, basis, inv, dims, NBINS, R_MAX, True)
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
    pairs = stencil_pairs(cell_start, dims)
    if bool((basis != torch.diag(box)).any()):
        raise AssertionError("the operation count assumes an orthorhombic box")
    # unordered pairs of distinct atoms: the stencil holds each atom itself
    needed = (pairs - idx_o_np.size) // 2
    if work["pairs"] != needed:
        raise AssertionError(f"the half-stencil walk tests {work['pairs']} pairs, "
                             f"expected {needed} unordered ones")
    nbytes_hist = xs.numel() * 4 + ids.numel() * 4 + cell_start.numel() * 4 + 72 + NBINS * 4
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
    fixed_sum = density.fixed_point_sum

    def atomic(n, flat, wts):  # float atomics, summed in thread order
        return torch.zeros(n, device=flat.device).index_add_(0, flat, wts)

    times = {"fixed": [], "index_add_": []}
    grids = {"fixed": [], "index_add_": []}
    for order in MAIN_SPLAT_ORDER:
        with (contextlib.nullcontext() if order == "fixed"
              else mock.patch.object(density, "fixed_point_sum", atomic)):
            t1 = time.perf_counter()
            run = ev.run()
            sum_ = run.force()
            times[order].append(time.perf_counter() - t1)
        grids[order].append(run.volumes["v"])
        if order == "fixed":
            res, checksum = run, sum_
    launches = cuda_rdf.launches  # read just after the main path
    if not all(np.array_equal(g, grids["fixed"][0]) for g in grids["fixed"]):
        raise AssertionError("the fixed-point splat differs between runs")
    atomic_diff = max(float(np.abs(g - grids["index_add_"][0]).max())
                      for g in grids["index_add_"])
    # both splat sums on frame 0's terms, device time
    terms = []

    def record(n, flat, wts):
        terms.append((n, flat, wts))
        return fixed_sum(n, flat, wts)

    with mock.patch.object(density, "fixed_point_sum", record):
        x, b = traj.device_frame(0)
        compiled.frame_fn(x, b, inv_basis_of(b))
    splat_ms = {name: sum(cuda_ms(lambda: fn(*t), queued=True) for t in terms)
                for name, fn in (("fixed", fixed_sum), ("index_add_", atomic))}
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
    fps = {k: [N_FRAMES / t for t in v] for k, v in times.items()}
    phase("main", t0, (
        f"{sys_.natoms} atoms x {N_FRAMES} frames, chunk {CHUNK}: "
        f"frames/s {' '.join(f'{f:.1f}' for f in fps['fixed'])} (best "
        f"{max(fps['fixed']):.1f}); with a float index_add_ splat, in turns "
        f"{' '.join(f'{f:.1f}' for f in fps['index_add_'])} (best "
        f"{max(fps['index_add_']):.1f}); splat of frame 0 "
        f"({sum(t[1].numel() for t in terms)} terms in {len(terms)} sums), device "
        f"ms fixed point {splat_ms['fixed']:.4f}, index_add_ {splat_ms['index_add_']:.4f}; "
        f"v of the fixed-point runs equal, of the index_add_ runs max diff "
        f"{atomic_diff:.3g}; "
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
    cuda_rdf.launches = cuda_raster.launches = cuda_hbao.launches = 0
    path = {rep: [render_frames(rep) for _ in range(3)] for rep in REPS}
    raster_launches = cuda_raster.launches  # read just after the render path
    hbao_launches = cuda_hbao.launches
    hist_launches_render = cuda_rdf.launches
    render_peak = torch.cuda.max_memory_allocated() / 2**30
    if raster_launches < len(REPS) * 3 * RENDER_FRAMES:
        raise AssertionError(f"raster launched {raster_launches} times in the render path")
    if hbao_launches != 4 * len(REPS) * 3 * RENDER_FRAMES:
        raise AssertionError(f"hbao launched {hbao_launches} times in the render path")
    for rep in REPS:
        best = min(path[rep], key=sum)
        phase("render", t0, (
            f"{rep} {WIDTH}x{HEIGHT} frames 0-{RENDER_FRAMES - 1}, ms/frame "
            f"raster + postprocess: " + " | ".join(
                f"{r:.3f} + {p:.3f}" for r, p in path[rep]
            ) + f" (best {best[0]:.3f} + {best[1]:.3f} = {sum(best):.3f})"
        ))
    phase("render", t0, (
        f"raster launches {raster_launches} (pair_hist {hist_launches_render}, hbao "
        f"{hbao_launches}); "
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

    # -- 9.-12. the triclinic mode, the breathing cell, radius 2, the other
    # routes
    tri = kernel_tri(sys_, traj, idx_o, idx_o_np, idx_b)
    launches_tri = main_tri(dev, tri, idx_o)
    r2 = kernel_r2(dev, sys_, traj, idx_o, idx_b)
    other_routes(dev, sys_, traj)

    # -- 13.-14. the reference's default script, the rest of the language
    default_phase(dev)
    lang_phase(dev, sys_, traj, ev)

    # -- 15. the analysis path from files
    io = io_phase(dev, headline=ev)

    # -- 16. the volume view
    vol = volume_phase(dev, sys_, compiled, res, traj, scene_in)

    # -- 17.-18. the protein views, the backbone analyses
    cartoon = cartoon_phase(dev, smi)
    rama_phase(dev)

    # -- 19.-20. the VeloxChem window, the SDF window
    qm = qm_phase(dev)
    density_volume_phase(dev, sys_, compiled, res, traj)

    # -- 21. the app layer: Session, the .via workspace, the CLI, the viewer
    session_res = session_phase(dev, sys_, traj, res, max(fps["fixed"]))
    session, hb = session_res["launches"], session_res["hbao"]

    # -- 22. multi-device evaluation, ranks sharing the card
    multi = multi_phase(dev, sys_, traj, res, tri)

    # -- 23. the per-atom colours at the cells' sizes
    col = colors_phase(dev)
    col_main = col["cases"][0]

    print(json.dumps({"kernels": [
        {
            "name": "pair_hist",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/pair_hist.cu",
            "replaces": "viamd_tpu/ops/pallas_rdf.py:58",
            "launches": launches,
            "launches_io": io["launches"],
            "launches_session": session["pair_hist"],
            "launches_multi": multi["launches"],
            "max_abs_err": err_same,
            "ms": ms_kernel,
            "plain_ms": ms_plain,
            "bound_ms": hist_bound,
            "bound_by": hist_bound_by,
            "library_ms": None,
        },
        {
            "name": "pair_hist (triclinic mode)",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/pair_hist.cu",
            "replaces": "viamd_tpu/ops/pallas_rdf.py:58",
            "launches": launches_tri,
            "max_abs_err": tri["err"],
            "ms": tri["ms"],
            "plain_ms": tri["plain_ms"],
            "bound_ms": tri["bound_ms"],
            "bound_by": tri["bound_by"],
            "library_ms": None,
        },
        {
            "name": "pair_hist (radius-2 stencil)",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/pair_hist.cu",
            "replaces": "viamd_tpu/ops/pallas_rdf.py:58",
            "launches": r2["launches"],
            "max_abs_err": r2["err"],
            "ms": r2["ms"],
            "plain_ms": r2["plain_ms"],
            "bound_ms": r2["bound_ms"],
            "bound_by": r2["bound_by"],
            "library_ms": None,
        },
        {
            "name": "pair_hist (slab-sharded, 4 ranks sharing the card)",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/pair_hist.cu",
            "replaces": "viamd_tpu/ops/pallas_rdf.py:58",
            "launches": multi["launches_tp"],
            "max_abs_err": multi["err"],
            "ms": multi["ms"],
            "plain_ms": multi["plain_ms"],
            "bound_ms": multi["bound_ms"],
            "bound_by": multi["bound_by"],
            "rows": list(multi["rows"]),
            "library_ms": None,
        },
        {
            "name": "raster",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/raster.cu",
            "replaces": "viamd_tpu/render/pallas_raster.py:58",
            "launches": raster_launches,
            "launches_session": session["raster"],
            "max_abs_err": max(raster[r]["max_abs_err"] for r in REPS),
            "ms": raster["spacefill"]["ms"],
            "plain_ms": raster["spacefill"]["plain_ms"],
            "bound_ms": raster["spacefill"]["bound_ms"],
            "bound_by": raster["spacefill"]["bound_by"],
            "bound_all_candidates_ms": raster["spacefill"]["bound_all_ms"],
            "library_ms": None,
        },
        {
            "name": "volume",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/volume.cu",
            "replaces": "viamd_tpu/render/volume.py:263",
            "launches": vol["launches"],
            "launches_session": session["volume"],
            "max_abs_err": vol["max_abs_err"],
            "ms": vol["ms"],
            "plain_ms": vol["plain_ms"],
            "bound_ms": vol["bound_ms"],
            "bound_by": vol["bound_by"],
            "bound_march_alone_ms": vol["bound_march_ms"],
            "call_ms": vol["call_ms"],
            "library_ms": None,
        },
        {
            "name": "triangles",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/triangles.cu",
            "replaces": "viamd_tpu/render/triangles.py:30",
            "launches": cartoon["launches"],
            "launches_session": session["triangles"],
            "max_abs_err": cartoon["max_abs_err"],
            "ms": cartoon["ms"],
            "plain_ms": cartoon["plain_ms"],
            "bound_ms": cartoon["bound_ms"],
            "bound_by": cartoon["bound_by"],
            "call_ms": cartoon["call_ms"],
            "tests": cartoon["tests"],
            "library_ms": None,
        },
        {
            "name": "ribbon",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/ribbon.cu",
            "replaces": "viamd_tpu_torch/render/ribbon_mesh.py:ribbon_mesh (numpy, host)",
            "launches": cartoon["ribbon_launches"],
            "launches_session": session["ribbon"],
            "max_abs_err": max(r["max_abs_err"] for r in cartoon["ribbon"].values()),
            "ms": cartoon["ribbon"]["capsid, cartoon"]["ms"],
            "plain_ms": cartoon["ribbon"]["capsid, cartoon"]["plain_ms"],
            "bound_ms": cartoon["ribbon"]["capsid, cartoon"]["bound_ms"],
            "bound_by": cartoon["ribbon"]["capsid, cartoon"]["bound_by"],
            "call_ms": cartoon["ribbon"]["capsid, cartoon"]["call_ms"],
            "triangles": cartoon["ribbon"]["capsid, cartoon"]["triangles"],
            "library_ms": None,
        },
        {
            "name": "gto",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/gto.cu",
            "replaces": "viamd_tpu/ops/gto.py:40",
            "launches": qm["launches"],
            "launches_session": session["gto"],
            "max_abs_err": qm["max_abs_err"],
            "ms": qm["ms"],
            "plain_ms": qm["plain_ms"],
            "bound_ms": qm["bound_ms"],
            "bound_by": qm["bound_by"],
            "bound_all_pairs_ms": qm["bound_all_ms"],
            "bound_kernel_pairs_ms": qm["bound_kernel_ms"],
            "library_ms": None,
        },
        {
            "name": "gto (density mode)",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/gto.cu",
            "replaces": "viamd_tpu/ops/gto.py:40",
            "launches": qm["density"]["launches"],
            "max_abs_err": qm["density"]["max_abs_err"],
            "ms": qm["density"]["ms"],
            "plain_ms": qm["density"]["plain_ms"],
            "bound_ms": qm["density"]["bound_ms"],
            "bound_by": qm["density"]["bound_by"],
            "bound_all_pairs_ms": qm["density"]["bound_all_ms"],
            "bound_kernel_pairs_ms": qm["density"]["bound_kernel_ms"],
            "library_ms": None,
        },
        {
            "name": "hbao",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/hbao.cu",
            "replaces": "viamd_tpu/render/hbao.py:_hbao_impl (XLA, no Pallas kernel)",
            "launches": hb["launches"],
            "launches_session": session["hbao"],
            "max_abs_err": hb["max_abs_err"],
            "ms": hb["ms"],
            "plain_ms": hb["plain_ms"],
            "bound_ms": hb["bound_ms"],
            "bound_by": hb["bound_by"],
            "call_ms": hb["call_ms"],
            "frame_ms": hb["frame_ms"],
            "frame_plain_ms": hb["frame_plain_ms"],
            "library_ms": None,
        },
        {
            "name": "colors",
            "route": "cuda",
            "source": "viamd_tpu_torch/csrc/colors.cu",
            "replaces": "render/color.py's numpy chain in Session._rep_colors (host)",
            "launches": sum(c["launches"] for c in col["cases"]),
            "launches_session": session["colors"],
            "max_abs_err": max(c["max_abs_err"] for c in col["cases"]),
            "ms": col_main["ms"],
            "plain_ms": col_main["plain_ms"],
            "bound_ms": col_main["bound_ms"],
            "bound_by": col_main["bound_by"],
            "call_ms": col_main["call_ms"],
            "cases": col["cases"],
            "host_route_ms": col["host_ms"],
            "library_ms": None,
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
