"""Session: the headless application core of the port.

Counterpart of viamd_tpu/app/session.py (the reference's ApplicationState +
app logic, VIAMD src/viamd.h:1026-1423, src/viamd.cpp — data load/free,
frame interpolation, stored selections, representations, script
compile/eval orchestration, recenter, picking, workspace persistence) over
the port's modules: the GUI main loop becomes method calls, components
subscribe to the same event vocabulary.

Every device computation runs on the session's device (`device="cuda"`
unless the caller asks for the CPU); nothing falls back to the CPU.
`render` returns its image, depth and picks as tensors on that device, and
so do `render_accumulated` and `render_frames`; `device_coords()` is the
playback frame as a tensor there, `current_coords()` the same coordinates
copied to the host (the JAX package's numpy contract, which the components
read). The device path of a frame: the trajectory (staged with
`stage_to_device`, or copied frame by frame from the host) → interpolation
(ops/interpolate.py) → recentring (ops/pbc.py::recenter_frame, order-free
segment sums) → the molecule raster (csrc/raster.cu), the triangle raster
(csrc/triangles.cu: cartoon, ribbons, overlay fills, dipole arrows), the
in-scene volume (csrc/volume.cu, fed by csrc/gto.cu for an orbital) → the
outlines, the composites and the postprocess chain in torch.

Differences from the JAX package, on purpose:
- the in-scene volume is ray-marched at every size: the JAX package
  switches to shear-warp from 256² pixels on, which the port does not have;
- the triangle raster's tile lists have no 64-slot cap (the JAX raster
  drops a tile's candidates past 64).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from viamd_tpu_torch.app.events import EventBus, EventType
from viamd_tpu_torch.app.tasks import TaskSystem
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.core.tracing import section, traced
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.eval import EvalResult, Evaluator
from viamd_tpu_torch.io import load_file
from viamd_tpu_torch.io.trajectory import CachedTrajectory, DeviceTrajectory, Trajectory
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.render import camera as cam_mod
from viamd_tpu_torch.script import ScriptError, compile_script, evaluate_filter
from viamd_tpu_torch.script.compiler import CompiledScript


@dataclass
class Representation:
    """A draw representation (viamd.h Representation analog)."""

    name: str = "rep"
    filter: str = "all"
    type: str = "spacefill"  # spacefill | licorice | ballstick | dipole
    color_mapping: str = "cpk"
    uniform_color: tuple = (0.6, 0.6, 0.9, 1.0)
    radius_scale: float = 1.0
    alpha: float = 1.0  # < 1 → drawn in the transparent pass, blended over
    enabled: bool = True
    # ColorMapping::Property (viamd.cpp:1375,1408-1445): color by the
    # current frame's value of an evaluated temporal property, remapped
    # through [map_beg, map_end] into `color_map`
    prop: str = ""
    map_beg: float = 0.0
    map_end: float = 1.0
    color_map: str = "viridis"
    # RepresentationType::DipoleMoment (main.cpp:6927-6955): arrow of one
    # dipole from the RepresentationInfo catalog
    dipole_key: str = "ground_state_dipole"
    dipole_scale: float = 1.0
    dipole_radius: float = 0.15
    dipole_offset: tuple = (0.0, 0.0, 0.0)
    # per-rep tint/saturation post-pass (viamd.cpp:1455-1466: applied
    # whenever tint_scale > 0 or saturation < 1)
    tint_color: tuple = (1.0, 1.0, 1.0, 1.0)
    tint_scale: float = 0.0
    saturation: float = 1.0
    # derived
    mask: Optional[Bitfield] = None
    dynamic: bool = False
    error: str = ""
    # the colours' inputs on the device (render/cuda_colors.py::ColorState)
    colors: Optional[object] = field(default=None, repr=False, compare=False)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


class Session:
    """Headless VIAMD session: load → select → script → eval → render, on
    one torch device."""

    def __init__(self, num_workers: int = 4, *, device="cuda"):
        # resolve "cuda" to the "cuda:N" tensors report; a device that is
        # not there raises here
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Session(device={str(device)!r}): torch.cuda.is_available() "
                               "is False (device='cpu' runs on the host)")
        self.device = torch.empty(0, device=device).device
        self.events = EventBus()
        self.tasks = TaskSystem(num_workers)
        self.system: Optional[System] = None
        self.trajectory: Optional[Trajectory] = None
        self.files: dict = {"system": None, "trajectory": None}
        # selections
        self.stored_selections: dict[str, Bitfield] = {}
        self.selection: Optional[Bitfield] = None
        self.highlight: Optional[Bitfield] = None
        # representations
        self.representations: list[Representation] = []
        # script
        self.script_text: str = ""
        self.compiled: Optional[CompiledScript] = None
        self.script_errors: list[str] = []
        self.eval_result: Optional[EvalResult] = None
        self.filtered_result: Optional[EvalResult] = None
        # IR fingerprint (md_script_ir_fingerprint, main.cpp:932-936):
        # the compiled IR is stale whenever the script text, the SYSTEM,
        # or any injected stored selection changed since compile — not
        # just the text. _system_rev bumps on every SYSTEM_INIT broadcast
        # (load, element remap) to catch in-place system mutation.
        self._compiled_fp: Optional[tuple] = None
        self._system_rev: int = 0
        self.events.subscribe(EventType.SYSTEM_INIT, self._bump_system_rev)
        # playback
        self.frame: float = 0.0
        # transient coordinate override (QM opt-step / normal-mode
        # animation); None = serve trajectory/system coords
        self.coord_override: Optional[np.ndarray] = None
        self.fps: float = 10.0  # animation playback rate (viamd.h animation)
        self.interpolation: str = "linear"  # nearest | linear | cubic
        # persisted render settings + user additions (.via sections
        # RenderSettings / UserBonds, viamd.cpp:1096-1102,1193-1199)
        self.visuals: dict = {}
        self.coarse_grained: bool = False
        self.user_bonds: list = []
        self.recenter_selection: Optional[str] = None
        self._recenter_cache: Optional[tuple] = None  # (key, weights, segments)
        self._ribbon_cache: Optional[tuple] = None  # (key, RibbonTables)
        self.camera: Optional[cam_mod.Camera] = None
        # component registry
        self.components: dict[str, object] = {}
        self._register_builtin_components()
        self.events.broadcast(EventType.INITIALIZE, self)

    # -- components ----------------------------------------------------------
    def _register_builtin_components(self):
        """Self-registering components (the static-instance pattern of
        ramachandran.cpp:1508 etc.), each on the session's device."""
        from viamd_tpu_torch.components import builtin_components

        for cls in builtin_components():
            comp = cls(self, device=self.device)
            self.components[comp.name] = comp

    # -- data loading --------------------------------------------------------
    def load(self, path: str, **kw) -> "Session":
        """Load a system and/or trajectory file (file_queue/load_data_from_file
        analog, viamd.cpp:667). Table files (.edr/.xvg/.csv) inject an
        `import(...)` statement into the script instead
        (viamd.h:86, viamd.cpp:2833-2858)."""
        ext = os.path.splitext(path)[1].lower()
        if ext in (".edr", ".xvg", ".csv"):
            name = os.path.splitext(os.path.basename(path))[0]
            name = "".join(c if c.isalnum() else "_" for c in name) or "table"
            stmt = f'{name} = import("{os.path.abspath(path)}");'
            self.script_text = (
                f"{stmt}\n{self.script_text}" if self.script_text else stmt
            )
            return self
        res = load_file(path, system=self.system, **kw)
        if res.system is not None:
            self.system = res.system
            # a new system invalidates the previous trajectory (the
            # reference frees it in load_data_from_file, viamd.cpp:667);
            # a same-file trajectory re-attaches below
            if res.trajectory is None and self.trajectory is not None:
                self.trajectory = None
                self.files["trajectory"] = None
            self.files["system"] = os.path.abspath(path)
            if self.system.natoms:
                lo, hi = self.system.aabb()
                self.camera = cam_mod.compute_optimal_view(lo, hi)
            self.selection = Bitfield(self.system.natoms)
            self.highlight = Bitfield(self.system.natoms)
            if not self.representations:
                self.representations.append(Representation())
            self._update_representations()
            self.events.broadcast(EventType.SYSTEM_INIT, self)
        if res.trajectory is not None:
            if self.system is None:
                raise ValueError("load a system before attaching a trajectory")
            self.trajectory = CachedTrajectory(res.trajectory)
            self.files["trajectory"] = os.path.abspath(path)
            self.events.broadcast(EventType.TRAJECTORY_INIT, self)
        return self

    def load_demo(self, n_res: int = 64, n_frames: int = 100) -> "Session":
        """Load the built-in demo: a poly-alanine helix trajectory + the
        reference's default script (main.cpp:513-530 ships 1ALA-500.pdb
        with exactly this script — selection, distance, angle, rdf, sdf
        and shape_weights as a standing smoke test)."""
        from viamd_tpu_torch.datagen import polyala_helix

        sys, traj = polyala_helix(n_res=n_res, n_frames=n_frames)
        self.attach(sys, traj, name="<demo:polyala>")
        self.set_script(
            's1 = resname("ALA")[2:8];\n'
            "d1 = distance(10,30);\n"
            'a1 = angle(2,1,3) in resname("ALA");\n'
            "r = rdf(element('C'), element('H'), 10.0);\n"
            "v = sdf(s1, element('H'), 10.0);\n"
            "{lin,plan,iso} = shape_weights(all);"
        )
        return self

    def attach(self, system: System, trajectory: Trajectory, name: str) -> "Session":
        """Attach a system built in memory and its trajectory, as a file
        load attaches what it read: the camera fitted to the system, an
        empty selection and highlight, the default representation if there
        is none, SYSTEM_INIT, then the trajectory. `name` stands in the
        place of the file name."""
        self.system = system
        self.files["system"] = name
        self.camera = cam_mod.compute_optimal_view(*system.aabb())
        self.selection = Bitfield(system.natoms)
        self.highlight = Bitfield(system.natoms)
        if not self.representations:
            self.representations.append(Representation())
        self._update_representations()
        self.events.broadcast(EventType.SYSTEM_INIT, self)
        self.set_trajectory(trajectory)
        return self

    def set_trajectory(self, traj: Trajectory):
        """Attach a trajectory; a DeviceTrajectory on the session's device
        stays there, any other one is read through a small frame cache."""
        self.trajectory = traj if self._on_device(traj) else CachedTrajectory(traj)
        self.events.broadcast(EventType.TRAJECTORY_INIT, self)

    def add_user_bonds(self, pairs) -> int:
        """Insert user-defined bonds (md_system_bond_insert with
        MD_BOND_FLAG_USER_DEFINED, the .via UserBonds load path,
        VIAMD src/viamd.cpp:1020-1031). Out-of-range and duplicate pairs
        are skipped. Returns the number inserted."""
        if self.system is None:
            return 0
        n = self.system.natoms
        existing = {tuple(sorted(b)) for b in self.system.bonds.tolist()}
        fresh = []
        for i, j in pairs:
            key = tuple(sorted((int(i), int(j))))
            if 0 <= key[0] < n and 0 <= key[1] < n and key not in existing:
                existing.add(key)
                fresh.append(key)
        if fresh:
            self.system.bonds = np.concatenate(
                [self.system.bonds, np.asarray(fresh, np.int32)]
            )
            for pair in fresh:
                if list(pair) not in [sorted(u) for u in self.user_bonds]:
                    self.user_bonds.append(pair)
        return len(fresh)

    def _on_device(self, traj) -> bool:
        return isinstance(traj, DeviceTrajectory) and traj.device == self.device

    def stage_to_device(self, max_bytes: int = 2 << 30) -> bool:
        """Stage the whole trajectory on the session's device for batch
        evaluation (`DeviceTrajectory.stage`: one copy from page-locked
        memory), the analog of the reference holding the working set in RAM
        for Eval Full (main.cpp:981). No-op if already staged or the
        trajectory exceeds `max_bytes` (coords only, f32). Returns True
        when device-resident."""
        t = self.trajectory
        if t is None:
            return False
        if self._on_device(t):
            return True
        if t.num_frames * t.num_atoms * 12 > max_bytes:
            return False
        self.trajectory = DeviceTrajectory.stage(t, self.device)
        return True

    # -- frames --------------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self.trajectory.num_frames if self.trajectory else 0

    def _frame(self, idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(coords (n, 3), basis (3, 3)) of trajectory frame `idx` as
        float32 tensors on the session's device."""
        t = self.trajectory
        if self._on_device(t):
            return t.device_frame(idx)
        x, cell = t.load_frame(idx)
        return (torch.as_tensor(_f32(x), device=self.device),
                torch.as_tensor(_f32(cell.basis), device=self.device))

    def device_coords(self) -> torch.Tensor:
        """Coordinates at the (possibly fractional) playback frame as an
        (n, 3) float32 tensor on the session's device, with the PBC-aware
        interpolation of the reference's hot loop (viamd.cpp:1846-1885) and
        the recentring of `recenter`. A `coord_override` (set by QM
        optimization-step playback / normal-mode animation, the reference's
        direct sys.atom writes at veloxchem.cpp:3250-3258, 4745-4755) takes
        precedence until cleared. Do not write into the result: it may be
        a view of a staged trajectory."""
        dev = self.device
        if self.coord_override is not None:
            return torch.as_tensor(_f32(self.coord_override), device=dev)
        if self.trajectory is None or self.num_frames == 0:
            return self._apply_recenter(torch.as_tensor(_f32(self.system.coords()), device=dev))
        from viamd_tpu_torch.ops import interpolate as interp

        f = float(np.clip(self.frame, 0, self.num_frames - 1))
        i0 = int(np.floor(f))
        t = f - i0
        if t < 1e-6 or self.interpolation == "nearest":
            return self._apply_recenter(self._frame(int(round(f)))[0])
        i1 = min(i0 + 1, self.num_frames - 1)
        x0, basis = self._frame(i0)
        x1, _ = self._frame(i1)
        inv = inv_basis_of(basis)
        if self.interpolation == "cubic":
            xm1, _ = self._frame(max(i0 - 1, 0))
            x2, _ = self._frame(min(i1 + 1, self.num_frames - 1))
            out = interp.interpolate_cubic(xm1, x0, x1, x2, t, basis, inv)
        else:
            out = interp.interpolate_linear(x0, x1, t, basis, inv)
        return self._apply_recenter(out)

    def current_coords(self) -> np.ndarray:
        """`device_coords()` copied to the host: (n, 3) float32 numpy."""
        return np.array(self.device_coords().cpu())

    def recenter(self, selection_expr: Optional[str] = "all"):
        """Enable PBC recentering on a selection (None disables) —
        the recenter_* capability (viamd.cpp:2162-2313); applied to every
        frame served by current_coords."""
        self.recenter_selection = selection_expr
        self.events.broadcast(EventType.SYSTEM_STATE_CHANGED, self)

    def _recenter_inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(selection mass weights (n,), residue ids (n,)) on the device,
        kept while the selection, the system and the stored selections
        stay the same."""
        sys = self.system
        key = (self.recenter_selection, id(sys), self._system_rev,
               tuple(sorted((k, hash(v)) for k, v in self.stored_selections.items())))
        if self._recenter_cache is None or self._recenter_cache[0] != key:
            mask, _ = evaluate_filter(self.recenter_selection, sys,
                                      self.stored_selections, device=self.device)
            w = np.zeros(sys.natoms, np.float32)
            idx = mask.indices()
            w[idx] = sys.mass[idx]
            self._recenter_cache = (
                key, torch.as_tensor(w, device=self.device),
                torch.as_tensor(np.asarray(sys.atom_res_idx, np.int64), device=self.device),
            )
        return self._recenter_cache[1], self._recenter_cache[2]

    def _ribbon_tables(self):
        """The system's ribbon mesh tables on the device
        (render/ribbon_mesh.py::ribbon_tables), kept while the system
        stays the same."""
        from viamd_tpu_torch.render.ribbon_mesh import ribbon_tables

        key = (id(self.system), self._system_rev)
        if self._ribbon_cache is None or self._ribbon_cache[0] != key:
            self._ribbon_cache = (key, ribbon_tables(self.system, device=self.device))
        return self._ribbon_cache[1]

    def _apply_recenter(self, coords: torch.Tensor) -> torch.Tensor:
        if self.recenter_selection is None or not self.system.cell.is_periodic:
            return coords
        from viamd_tpu_torch.ops.pbc import recenter_frame

        w, seg = self._recenter_inputs()
        basis = torch.as_tensor(_f32(self.system.cell.basis), device=self.device)
        return recenter_frame(coords, w, seg, self.system.nres, basis, inv_basis_of(basis))

    def _velocities(self, dt: float = 1.0) -> torch.Tensor:
        """(n, 3) velocities at the playback frame as a tensor on the
        device (see current_velocities)."""
        if self.trajectory is None or self.num_frames < 2:
            return torch.zeros((self.system.natoms, 3), dtype=torch.float32,
                               device=self.device)
        from viamd_tpu_torch.ops.pbc import min_image

        i1 = int(np.clip(round(self.frame), 1, self.num_frames - 1))
        x0, basis = self._frame(i1 - 1)
        x1, _ = self._frame(i1)
        return min_image(x1 - x0, basis, inv_basis_of(basis)) / dt

    def current_velocities(self, dt: float = 1.0) -> np.ndarray:
        """(n,3) per-atom velocities at the playback frame — finite
        difference of consecutive frames with min-image unwrapping (the
        velocity computation of update_md_buffers, main.cpp:6317-6397,
        feeding motion blur / velocity coloring) — on the host."""
        return np.array(self._velocities(dt).cpu())

    def current_cell(self) -> UnitCell:
        if self.trajectory is None or self.num_frames == 0:
            return self.system.cell
        return self.trajectory.load_frame(int(self.frame))[1]

    @traced("session.set_frame")
    def set_frame(self, frame: float):
        self.frame = frame
        self.events.broadcast(EventType.SYSTEM_STATE_CHANGED, self)

    # -- selections ----------------------------------------------------------
    def _filter(self, expr: str, coords=None):
        return evaluate_filter(expr, self.system, self.stored_selections,
                               coords=coords, device=self.device)

    def select(self, expr: str) -> Bitfield:
        """Evaluate a filter query into the active selection
        (the selection query path, main.cpp:3171)."""
        mask, _dynamic = self._filter(expr)
        self.selection = mask
        self.events.broadcast(EventType.SELECTION_CHANGED, self)
        return mask

    def grow_selection(
        self, by: str = "bonds", steps: int = 1, radius: float = 3.0
    ) -> Bitfield:
        """Expand the active selection by covalent bonds or by radius
        (the selection-grow capability of the reference UI)."""
        from viamd_tpu_torch.core import selection_utils as su

        if self.selection is None:
            raise ValueError("no active selection")
        if by == "bonds":
            self.selection = su.grow_by_bonds(self.selection, self.system.bonds, steps)
        elif by == "radius":
            self.selection = su.grow_by_radius(
                self.selection, self.current_coords(), radius, self.system.cell,
            )
        elif by == "instance":
            # expand_mask SelectionGranularity::Instance (viamd.h:1559-1566):
            # any touched instance range fills entirely
            inst = self.system.instances
            if inst is not None:
                sel = self.selection.to_bools()
                out = sel.copy()
                for k in range(inst.count):
                    b, e = (int(v) for v in inst.atom_ranges[k])
                    if sel[b:e].any():
                        out[b:e] = True
                self.selection = Bitfield.from_bools(out)
        else:
            raise ValueError("grow by 'bonds', 'radius' or 'instance'")
        self.events.broadcast(EventType.SELECTION_CHANGED, self)
        return self.selection

    def selection_to_script(self) -> list[str]:
        """Script expressions reproducing the active selection
        (generate_script_selection_suggestions, main.cpp:2530)."""
        from viamd_tpu_torch.core import selection_utils as su

        return su.selection_suggestions(self.system, self.selection)

    def store_selection(self, name: str, mask: Optional[Bitfield] = None):
        """Stored selections inject into scripts as identifiers
        (main.cpp:860-863)."""
        self.stored_selections[name] = mask if mask is not None else self.selection

    # -- representations -----------------------------------------------------
    def add_representation(self, **kw) -> Representation:
        rep = Representation(**kw)
        self.representations.append(rep)
        self._update_representations()
        self.events.broadcast(EventType.REPRESENTATION_CHANGED, self)
        return rep

    def _update_representations(self):
        """Re-evaluate rep filters (update_representation, viamd.cpp:1316)."""
        if self.system is None:
            return
        for rep in self.representations:
            try:
                rep.mask, rep.dynamic = self._filter(rep.filter)
                rep.error = ""
            except ScriptError as e:
                rep.mask = Bitfield(self.system.natoms)
                rep.error = str(e)

    # -- script --------------------------------------------------------------
    def _bump_system_rev(self, _event=None):
        self._system_rev += 1

    def _script_fingerprint(self) -> tuple:
        """Everything the compiled IR depends on (ir_fingerprint analog)."""
        sel = tuple(sorted((k, hash(v)) for k, v in self.stored_selections.items()))
        return (self.script_text, id(self.system), self._system_rev, sel)

    def set_script(self, text: str, compile: bool = True):
        self.script_text = text
        if compile:
            self.compile_script()

    def compile_script(self) -> bool:
        """Compile the script on the session's device
        (md_script_ir_compile_from_source path, main.cpp:866); errors land
        in script_errors."""
        self.script_errors = []
        if self.system is None:
            self.script_errors = ["no system loaded"]
            return False
        try:
            self.compiled = compile_script(
                self.script_text, self.system, self.device,
                identifiers=self.stored_selections,
            )
            self._compiled_text = self.script_text
            self._compiled_fp = self._script_fingerprint()
            self.events.broadcast(EventType.SCRIPT_COMPILED, self)
            return True
        except ScriptError as e:
            self.compiled = None
            self._compiled_fp = None
            self.script_errors = [str(e)]
            return False

    @traced("evaluate")
    def evaluate(
        self,
        frame_range=None,
        chunk: int = 16,
        mesh=None,
        progress=None,
        interrupt=None,
        filtered: bool = False,
    ) -> EvalResult:
        """Run the compiled script over the trajectory (the Eval Full /
        filtered-eval pair, main.cpp:981-1027) with the port's Evaluator:
        a staged trajectory is read where it lies, any other one streamed.
        The result's tensors stay on the device until first read. With a
        device `mesh` (parallel.frames_mesh; the session's device is the
        rank's), every rank of it calls this together and gets the same
        result."""
        with section("eval.build"):
            # recompile on ANY fingerprint change — text edits, but also a
            # newly loaded system or mutated stored selections (the
            # reference sets script.compile_ir on SystemInit,
            # viamd.cpp:565): evaluating an IR compiled against a previous
            # system would use stale gather indices silently
            if self.compiled is None or self._compiled_fp != self._script_fingerprint():
                if not self.compile_script():
                    raise ScriptError(self.script_errors[0])
            traj = self.trajectory
            if traj is None:
                from viamd_tpu_torch.io.trajectory import InMemoryTrajectory

                traj = InMemoryTrajectory(self.system.coords()[None], cell=self.system.cell)
            self.events.broadcast(EventType.EVAL_STARTED, self)
            ev = Evaluator(self.compiled, traj, chunk=chunk, mesh=mesh)

        def prog(f):
            self.events.broadcast(EventType.EVAL_PROGRESS, f)
            if progress:
                progress(f)

        res = ev.run(frame_range=frame_range, progress=prog, interrupt=interrupt)
        if filtered:
            self.filtered_result = res
        else:
            self.eval_result = res
        self.events.broadcast(EventType.EVAL_COMPLETE, res)
        return res

    def _property_colors(self, rep) -> tuple:
        """ColorMapping::Property (viamd.cpp:1408-1445): the current
        frame's value of `rep.prop`, lerped between the bracketing frames,
        normalized over [map_beg, map_end] and sampled from `color_map`.
        Per-structure properties (dim == number of `in`-context
        structures) color each structure by its own value. → (key, make):
        what the colours are made from, and the function that makes the
        (n, 4) float32 host colours."""
        from viamd_tpu_torch.render import color as color_mod

        sys = self.system
        res = self.eval_result
        if res is None or rep.prop not in (res.temporal or {}):
            rep.error = f"property '{rep.prop}' not evaluated"
            return (("uniform", tuple(rep.uniform_color)),
                    lambda: color_mod.color_atoms_uniform(sys, rep.uniform_color))
        vals = np.asarray(res.temporal[rep.prop], np.float64)
        F = vals.shape[0]
        f = float(np.clip(self.frame, 0, F - 1))
        i0 = int(np.clip(np.floor(f), 0, F - 1))
        i1 = int(np.clip(i0 + 1, 0, F - 1))
        tfrac = f - i0
        v = vals[i0] * (1.0 - tfrac) + vals[i1] * tfrac
        structures = None
        if self.compiled is not None:
            try:
                structures = self.compiled.property(rep.prop).structures
            except KeyError:
                pass
        key = ("property", np.asarray(v).tobytes(), rep.map_beg, rep.map_end, rep.color_map,
               id(self.compiled), self._compiled_fp)
        return key, lambda: color_mod.color_atoms_property(
            sys, v, (rep.map_beg, rep.map_end), rep.color_map, structures=structures,
        )

    def _fence(self):
        """Wait for the work queued on the session's device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate_async(self, **kw):
        """Background evaluation with interruption (the interactive pattern:
        interrupt-then-wait + progress overlay). The worker thread waits for
        its device work before it hands the result over."""

        def work(handle):
            res = self.evaluate(
                progress=handle.set_progress,
                interrupt=lambda: handle.interrupted,
                **kw,
            )
            self._fence()
            return res

        return self.tasks.enqueue("Eval Full", work)

    # -- view ----------------------------------------------------------------
    def _camera(self) -> cam_mod.Camera:
        return self.camera or cam_mod.compute_optimal_view(*self.system.aabb())

    def reset_view(self, target=None):
        """Fit the camera to the system — or to a subset (the reference's
        masked reset_view, viamd.cpp:2893-2930, and the ViewFit rounds
        highlight → selection → visible). `target`: None = whole system,
        a Bitfield / bool mask / filter-expression string, or one of
        "selection" / "highlight"."""
        mask = None
        if target is not None:
            if target == "selection":
                mask = self.selection
            elif target == "highlight":
                mask = self.highlight
            elif isinstance(target, str):
                mask, _ = self._filter(target, coords=self.current_coords())
            else:
                mask = target
        if mask is not None:
            sel = mask.to_bools() if hasattr(mask, "to_bools") else np.asarray(mask, bool)
            if sel.any():
                x = self.current_coords()[sel]
                pad = float(np.max(self.system.radius)) + 1.0
                lo = x.min(axis=0) - pad
                hi = x.max(axis=0) + pad
                self.camera = cam_mod.compute_optimal_view(lo, hi)
                return
        lo, hi = self.system.aabb()
        self.camera = cam_mod.compute_optimal_view(lo, hi)

    def _rep_colors(self, rep, ss_t, show_selection, *, subset=None, radii=False) -> tuple:
        """One representation's colours on the session's device → ((m, 4)
        float32 colours, (m,) float32 raster radii or None): the colour
        format of every draw. `subset`: an int32 tensor of the atoms to
        colour (None: all); `radii`: also each atom's radius, 0 where its
        alpha is 0. One launch of csrc/colors.cu on CUDA, its plain version
        on the CPU (render/cuda_colors.py), over inputs that this
        representation's ColorState uploads only when what they are made
        from changes: the mapping's table (or the backbone residue of each
        atom, for the secondary structure's weights `ss_t`), the radii, the
        filter and the selection."""
        from viamd_tpu_torch.render import color as color_mod
        from viamd_tpu_torch.render import cuda_colors

        sys = self.system
        if rep.colors is None or rep.colors.device != self.device:
            rep.colors = cuda_colors.ColorState(self.device)
        st = rep.colors
        sk = (id(sys), self._system_rev)
        base = ss = bbres = None
        mapping = color_mod.COLOR_MAPPINGS.get(rep.color_mapping)
        if rep.color_mapping == "secondary_structure" and ss_t is not None:
            ss = ss_t.contiguous()
            bbres = st.table("bbres", sk, lambda: cuda_colors.backbone_residues(sys))
        elif rep.color_mapping == "property":
            key, make = self._property_colors(rep)
            base = st.table("base", (*sk, *key), make)
        elif mapping:
            base = st.table("base", (*sk, rep.color_mapping), lambda: mapping(sys))
        else:
            base = st.table("base", (*sk, "uniform", tuple(rep.uniform_color)),
                            lambda: color_mod.color_atoms_uniform(sys, rep.uniform_color))
        mask = sel = radius = None
        if rep.mask is not None:
            mask = st.table("mask", (rep.mask,), lambda: cuda_colors.words(rep.mask))
        if show_selection and self.selection and self.selection.popcount():
            # selection visuals (main.cpp:6612-6700): non-selected
            # atoms desaturate; the outline draws after compositing
            sel = st.table("selection", (self.selection,),
                           lambda: cuda_colors.words(self.selection))
        if radii:
            radius = st.table("radius", sk, lambda: np.asarray(sys.radius, np.float32))
        # per-rep tint/saturation (viamd.cpp:1455-1466)
        return cuda_colors.atom_colors(base, ss, bbres, mask, sel, subset, radius,
                                       tint=rep.tint_color, tint_scale=rep.tint_scale,
                                       saturation=rep.saturation)

    def _draw_rep(self, rep, cols, radii, coords, coords_np, ss_w, ss_t, cam, width, height,
                  jitter):
        """One representation → (rgba, depth, pick) tensors, or None when
        the rep failed (its `error` says why). `cols` and `radii` are
        `_rep_colors`' output for the rep's draw; `ss_t` is the secondary
        structure's weights on the device, `ss_w` the same on the host (the
        tube's alone)."""
        from viamd_tpu_torch.render import raster

        dev = self.device
        sys = self.system
        proj = cam.proj_matrix(width, height, jitter)
        if rep.type == "dipole":
            # RepresentationType::DipoleMoment (main.cpp:6927-6955):
            # arrow = cylinder body (80%) + cone head (1.5× radius)
            # from the RepresentationInfo dipole catalog
            from viamd_tpu_torch.render.triangles import (
                arrow_mesh, render_triangles, view_transform,
            )

            try:
                info = self.components["veloxchem"].representation_info()
            except ValueError as e:
                # no QM data loaded: fail this rep, not the frame —
                # same contract as the dip-not-found case below
                rep.error = str(e)
                return None
            dip = next((d for d in info.dipole_moments if d.key == rep.dipole_key), None)
            if dip is None:
                rep.error = f"no dipole '{rep.dipole_key}'"
                return None
            org = np.asarray(dip.origin, np.float64) + np.asarray(rep.dipole_offset, np.float64)
            vec = np.asarray(dip.vec, np.float64) * rep.dipole_scale
            tris = arrow_mesh(org, org + vec, rep.dipole_radius)
            tv = view_transform(tris, cam.view_matrix(), device=dev)
            col = _f32(rep.uniform_color)
            out = render_triangles(
                tv, np.tile(col, (len(tris), 1)), np.full(len(tris), -1, np.int32),
                proj, width, height, device=dev,
            )
            rep.error = ""  # arrow drew — clear any stale failure
            return out
        if rep.type in ("ribbons", "cartoon"):
            # true peptide-plane-oriented flat ribbon mesh with sheet
            # arrowheads (md_gl RIBBONS/CARTOON, viamd.h:161-169); on a CUDA
            # device csrc/ribbon.cu builds it in view space, so neither the
            # mesh nor the coordinates cross the bus
            from viamd_tpu_torch.render.ribbon_mesh import ribbon_view
            from viamd_tpu_torch.render.triangles import render_triangles

            tables = self._ribbon_tables()
            with section("cartoon.mesh"):
                tv = ribbon_view(sys, coords, ss_t, cam.view_matrix(), tables,
                                 cartoon=rep.type == "cartoon", width_scale=rep.radius_scale)
            with section("cartoon.gather"):
                # the CA atoms' colours, gathered per triangle on the device
                tri_cols = cols[tables.res]
            return render_triangles(tv, tri_cols, tables.src, proj, width, height, device=dev)
        if rep.type == "tube":
            from viamd_tpu_torch.render.backbone_rep import backbone_tube

            pts, radii_t, src = backbone_tube(sys, coords_np, ss_weights=ss_w,
                                              cartoon=False, radius=0.35 * rep.radius_scale)
            settings = raster.RasterSettings(width=width, height=height)
            src_t = torch.as_tensor(np.asarray(src, np.int64), device=dev)
            rgba, d, p = raster.render_molecules(
                pts, radii_t, cols[src_t], cam.view_matrix(), proj, settings, device=dev,
            )
            # picking: map tube-point hits back to their CA atoms
            return rgba, d, self._map_picks(p, src)
        settings = raster.RasterSettings(width=width, height=height, rep=rep.type,
                                         radius_scale=rep.radius_scale)
        draw_x, draw_r, draw_c = coords, radii, cols
        draw_bonds = sys.bonds if rep.type != "spacefill" else None
        src = None
        if sys.instances is not None and sys.instances.nontrivial:
            # instanced draw (md_gfx instance ranges+transforms,
            # viamd.cpp:611-613): expand assembly copies, gather
            # per-atom attributes, remap bonds per instance
            draw_x, src = sys.instances.expansion(coords_np)
            src_t = torch.as_tensor(np.asarray(src, np.int64), device=dev)
            draw_r, draw_c = radii[src_t], cols[src_t]
            if draw_bonds is not None and len(draw_bonds):
                bb = []
                ofs = 0
                for k in range(sys.instances.count):
                    b, e = (int(v) for v in sys.instances.atom_ranges[k])
                    inside = (
                        (draw_bonds[:, 0] >= b) & (draw_bonds[:, 0] < e)
                        & (draw_bonds[:, 1] >= b) & (draw_bonds[:, 1] < e)
                    )
                    bb.append(draw_bonds[inside] - b + ofs)
                    ofs += e - b
                draw_bonds = np.concatenate(bb, axis=0) if bb else draw_bonds
        rgba, d, p = raster.render_molecules(
            draw_x, draw_r, draw_c, cam.view_matrix(), proj, settings,
            bonds=draw_bonds, device=dev,
        )
        if src is not None:
            # picking reports BASE atom ids for every copy
            p = self._map_picks(p, src)
        return rgba, d, p

    def _map_picks(self, p: torch.Tensor, src) -> torch.Tensor:
        """Picks of drawn primitives → the atoms they stand for."""
        src_t = torch.as_tensor(np.asarray(src, np.int32), device=p.device)
        return torch.where(p >= 0, src_t[p.clamp_min(0).long()], torch.full_like(p, -1))

    @traced("render")
    def render(
        self,
        width: int = 512,
        height: int = 512,
        rep_index: Optional[int] = None,
        show_box: bool = False,
        show_script_vis: bool = False,
        overlay=None,
        jitter=(0.0, 0.0),
        show_selection: bool = True,
        postprocess=None,
        volume=None,
    ):
        """Render enabled representations → (rgba (H, W, 4), depth (H, W),
        picking (H, W) int32), tensors on the session's device.

        The md_gl_draw path (main.cpp:6991) as one call; picking output is
        the per-pixel atom id surface (viamd.h picking capability).

        `postprocess`: None/False = raw gbuffer output (default);
        True = run the full postprocess chain (HBAO, tonemap, bokeh DOF
        if enabled, FXAA 3.11 — the reference's always-on viewport
        pipeline, postprocessing_utils.cpp:1938) with default settings;
        or pass a `render.postprocess.PostprocessSettings`. The returned
        rgba is then the display-ready composite (alpha 1).

        `volume`: name of a volume property from the last evaluation (or
        True for the first one), or an explicit {"grid", "model", …}
        volume — it is ray-marched IN-SCENE over the molecule like the
        reference's RenderTransparent volume pass (density_volume.cpp:761,
        veloxchem volumes): the grid is placed in world space through the
        inverse reference frame of its first matched structure, the march
        is clamped against the molecular depth buffer (an atom inside the
        volume truncates it), and the result composites over the opaque
        image."""
        from viamd_tpu_torch.render.overlay import OverlayQueue

        dev = self.device
        sys = self.system
        reps = (
            [self.representations[rep_index]]
            if rep_index is not None
            else [r for r in self.representations if r.enabled]
        )
        with section("render.coords"):
            coords = self.device_coords()
            # host coordinates only where host code needs them
            need_host = show_script_vis or any(
                r.dynamic or r.type == "tube" for r in reps
            ) or (sys.instances is not None and sys.instances.nontrivial)
            coords_np = np.array(coords.cpu()) if need_host else None
        cam = self._camera()
        img = depth = pick = None
        transparent = []
        ss_w = ss_t = None
        for rep in reps:
            with section("render.colors"):
                if rep.dynamic:
                    # dynamic filters (within/x/y/z) track the playback frame
                    try:
                        rep.mask, _ = self._filter(rep.filter, coords=coords_np)
                    except ScriptError:
                        pass
                if rep.color_mapping == "secondary_structure" or rep.type in (
                    "tube", "ribbons", "cartoon",
                ):
                    from viamd_tpu_torch.render.backbone_rep import current_ss_weights

                    with section("cartoon.ss"):
                        if sys.backbone is not None:
                            ss_t = current_ss_weights(sys, coords, device=dev)
                            # the tube's mesh is built on the host
                            ss_w = ss_t.cpu().numpy() if rep.type == "tube" else None
                cols = radii = None
                if rep.type in ("ribbons", "cartoon"):
                    # the CA atoms' colours alone, one a backbone residue
                    cols, _ = self._rep_colors(rep, ss_t, show_selection,
                                               subset=self._ribbon_tables().atoms[0])
                elif rep.type != "dipole":
                    # the raster's radii too: zero-alpha atoms are culled by
                    # radius 0
                    cols, radii = self._rep_colors(rep, ss_t, show_selection,
                                                   radii=rep.type != "tube")
            with section("render.draw"):
                out = self._draw_rep(rep, cols, radii, coords, coords_np, ss_w, ss_t, cam, width,
                                     height, jitter)
            if out is None:
                continue
            rgba, d, p = out
            if rep.alpha < 1.0:
                transparent.append((rep.alpha, rgba, d, p))
            elif img is None:
                img, depth, pick = rgba, d, p
            else:  # depth-composite subsequent opaque reps
                with section("render.composite"):
                    closer = d < depth
                    img = torch.where(closer[..., None], rgba, img)
                    pick = torch.where(closer, p, pick)
                    depth = torch.minimum(depth, d)
        with section("render.composite"):
            # transparent pass (the reference's RenderTransparent stage,
            # main.cpp:6612-6700): blend where the transparent rep is nearer
            # than the opaque depth; picking/depth stay opaque-only
            for a, rgba, d, p in transparent:
                if img is None:
                    img = torch.cat([rgba[..., :3] * a, rgba[..., 3:] * a], dim=-1)
                    depth = torch.full(d.shape, float("inf"), dtype=torch.float32, device=dev)
                    pick = torch.full(d.shape, -1, dtype=torch.int32, device=dev)
                    continue
                vis = (rgba[..., 3] > 0) & (d < depth)
                w = (a * vis).to(torch.float32)[..., None]
                img = torch.cat(
                    [rgba[..., :3] * w + img[..., :3] * (1 - w), torch.maximum(img[..., 3:], w)],
                    dim=-1,
                )
            # overlay pass: simulation box, script geometry, user primitives
            q = overlay if overlay is not None else OverlayQueue()
            if show_box and sys.cell.is_periodic:
                q.add_box(np.asarray(sys.cell.basis))
            if show_script_vis and self.compiled is not None:
                q.add_script_visualization(self.compiled.visualization, coords_np)
            if not q.is_empty():
                o_img, o_depth, o_pick = q.render(
                    cam.view_matrix(), cam.proj_matrix(width, height, jitter), width, height,
                    device=dev,
                )
                if img is None:
                    img, depth, pick = o_img, o_depth, o_pick
                else:
                    closer = o_depth < depth
                    img = torch.where(closer[..., None], o_img, img)
                    pick = torch.where(closer, o_pick, pick)
                    depth = torch.minimum(depth, o_depth)
        with section("render.outline"):
            if show_selection and img is not None and self.selection and self.selection.popcount():
                img = self._draw_selection_outline(img, pick, self.selection)
            if show_selection and img is not None and self.highlight and self.highlight.popcount():
                img = self._draw_selection_outline(img, pick, self.highlight,
                                                   color=(1.0, 0.85, 0.3))
        if volume and img is not None:
            with section("render.volume"):
                img = self._render_volume_inscene(volume, img, depth, width, height, jitter)
        if postprocess and img is not None:
            from viamd_tpu_torch.render import postprocess as pp

            with section("render.postprocess"):
                settings = (
                    postprocess if isinstance(postprocess, pp.PostprocessSettings)
                    else pp.PostprocessSettings()
                )
                rgb = pp.execute(img, depth, settings,
                                 proj=_f32(cam.proj_matrix(width, height, jitter)))
                img = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        self.events.broadcast(EventType.RENDER, self)
        return img, depth, pick

    @staticmethod
    def _draw_selection_outline(img, pick, mask, color=(1.0, 0.6, 0.1)):
        """Screen-space outline of the atoms in `mask` (the selection
        stencil pass): boundary pixels of the selected-coverage mask, on
        the image's device."""
        dev = img.device
        bools = torch.as_tensor(mask.to_bools(), device=dev)
        sel = (pick >= 0) & bools[pick.clamp_min(0).long()]
        edge = torch.zeros_like(sel)
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            edge |= sel != torch.roll(sel, sh, dims=ax)
        edge &= sel | (torch.roll(sel, 1, 0) | torch.roll(sel, -1, 0)
                       | torch.roll(sel, 1, 1) | torch.roll(sel, -1, 1))
        img = img.to(torch.float32)
        return torch.stack(
            [torch.where(edge, float(c), img[..., i]) for i, c in enumerate((*color, 1.0))],
            dim=-1,
        )

    def _composite_volume(self, grid, tf, model, settings, img, depth, width, height, jitter):
        """Ray-march `grid` clamped against the scene depth and composite it
        (premultiplied) over the opaque image, on the device."""
        from viamd_tpu_torch.render import volume as vol_mod

        cam = self._camera()
        vimg, _ = vol_mod.render_volume(
            grid, tf, model, _f32(cam.view_matrix()),
            _f32(cam.proj_matrix(width, height, jitter)), settings,
            scene_depth=depth, device=self.device,
        )
        va = vimg[..., 3:4]
        base = img.to(torch.float32)
        rgb = vimg[..., :3] + base[..., :3] * (1.0 - va)
        a = va + base[..., 3:4] * (1.0 - va)
        return torch.cat([rgb, a], dim=-1)

    def _render_volume_inscene(self, volume, img, depth, width, height, jitter):
        """Ray-march a volume property into the scene (RenderTransparent
        analog): place the grid in world space via the inverse reference
        frame of its first matched structure, clamp the march against the
        molecular depth buffer, composite over the opaque image."""
        from viamd_tpu_torch.render import colormap as cmap_mod
        from viamd_tpu_torch.render import volume as vol_mod

        comp = self.components["density_volume"]
        if isinstance(volume, dict):
            # explicit scene volume (the veloxchem RenderTransparent
            # analog, veloxchem.cpp:617-700): {"grid", "model", and
            # optional "tf"/"value_range"/"iso_values"/"iso_colors"} —
            # e.g. VeloxchemComponent.orbital_scene_volume
            return self._composite_scene_volume(volume, img, depth, width, height, jitter)
        names = comp.volume_properties()
        if not names:
            raise ValueError("no volume properties in the last evaluation")
        prop = names[0] if volume is True else str(volume)
        if prop not in names:
            raise KeyError(f"volume property {prop!r} not in {names}")
        res = comp._last_result or self.eval_result
        meta = res.property(prop)
        extent = meta.spec.extent
        grid = res.normalized_volume(prop)
        vmax = float(grid.max()) or 1.0
        tex2ref = vol_mod.model_matrix_from_extent(extent)
        try:
            M = comp.reference_frames(prop)  # (S, 4, 4) world → reference
            model = np.linalg.inv(M[0]) @ tex2ref
        except (KeyError, ValueError):
            # no vis.sdf payload: center the box on the system
            lo, hi = self.system.aabb()
            model = tex2ref.copy()
            model[:3, 3] += (np.asarray(lo) + np.asarray(hi)) * 0.5
        tf = cmap_mod.transfer_function(comp.colormap, 256, alpha_scale=comp.alpha_scale)
        settings = vol_mod.VolumeRenderSettings(
            width=width, height=height,
            value_range=(0.0, vmax),
            enable_iso=bool(comp.iso_values),
            iso_values=tuple(v * vmax for v in comp.iso_values),
            iso_colors=comp.iso_colors,
            clip_min=tuple(comp.clip_min),
            clip_max=tuple(comp.clip_max),
        )
        return self._composite_volume(grid, tf, model, settings, img, depth, width, height, jitter)

    def _composite_scene_volume(self, vd: dict, img, depth, width, height, jitter):
        """Composite an explicit {grid, model, …} volume over the opaque
        image with the scene-depth-clamped march (the veloxchem orbital
        volumes on RenderTransparent, veloxchem.cpp:617-700). The grid may
        be a tensor on the device."""
        from viamd_tpu_torch.render import colormap as cmap_mod
        from viamd_tpu_torch.render import volume as vol_mod

        grid = torch.as_tensor(vd["grid"], dtype=torch.float32, device=self.device)
        model = _f32(vd["model"])
        span = float(grid.abs().max()) or 1.0
        vr = tuple(vd.get("value_range", (-span, span)))
        tf = vd.get("tf")
        if tf is None:
            tf = cmap_mod.transfer_function("cool", 128, alpha_scale=0.0)
        iso_values = tuple(vd.get("iso_values", (0.05 * span, -0.05 * span)))
        iso_colors = tuple(vd.get("iso_colors", (
            (0.9, 0.3, 0.2, 0.6), (0.2, 0.4, 0.95, 0.6),
        )))
        settings = vol_mod.VolumeRenderSettings(
            width=width, height=height,
            value_range=vr,
            enable_dvr=bool(vd.get("enable_dvr", False)),
            enable_iso=bool(iso_values),
            iso_values=iso_values,
            iso_colors=iso_colors,
        )
        return self._composite_volume(grid, tf, model, settings, img, depth, width, height, jitter)

    def render_accumulated(self, width: int = 512, height: int = 512, samples: int = 8, **kw):
        """TAA-converged screenshot render (the accumulation path of
        create_screenshot, main.cpp:6794-6820): average `samples` renders
        under the Halton(2,3) sub-pixel jitter sequence → antialiased
        (rgba, depth, picking) tensors. Depth/picking come from the
        centered sample (sample 0's jitter is forced to (0,0))."""
        jit = cam_mod.taa_jitter_sequence(samples)
        jit[0] = 0.0
        acc = None
        depth = picking = None
        for i in range(samples):
            rgba, d, p = self.render(width, height, jitter=tuple(jit[i]), **kw)
            rgba = rgba.to(torch.float64)
            acc = rgba if acc is None else acc + rgba
            if i == 0:
                depth, picking = d, p
        return (acc / samples).to(torch.float32), depth, picking

    def render_frames(
        self,
        frames,
        width: int = 512,
        height: int = 512,
        motion_blur: bool = False,
        taa: bool = False,
        dt: float = 1.0,
        progress=None,
        **kw,
    ):
        """Offline movie rendering: yield (frame, rgba tensor) over playback
        positions (the reference's interactive playback + screenshot
        path as a batch job). `frames` may be fractional (interpolated).
        `motion_blur` smears along per-atom screen velocities
        (velocity/* buffers + temporal.frag's motion-blur half).
        `taa` runs the full velocity-reprojected temporal resolve
        (temporal.frag:374-535 via render/taa.py): each frame renders
        under the cycling Halton jitter, per-pixel velocities combine
        atom motion AND camera motion (the camera may be mutated between
        yielded frames — an orbit stays temporally stable instead of
        ghosting), and with `motion_blur` the velocity-trust blend of
        the reference replaces the plain smear."""
        from viamd_tpu_torch.render import postprocess as pp

        frames = list(frames)
        if taa:
            from viamd_tpu_torch.render.taa import TAAReprojector

            reproj = TAAReprojector()
            jit_seq = cam_mod.taa_jitter_sequence(8)
            prev_view = None  # (view_matrix, proj_matrix, coords)
        for k, f in enumerate(frames):
            self.set_frame(float(f))
            if taa:
                jitter = tuple(jit_seq[k % len(jit_seq)])
                rgba, depth, pick = self.render(width, height, jitter=jitter, **kw)
                cam = self._camera()
                vm = _f32(cam.view_matrix())
                pr = _f32(cam.proj_matrix(width, height))
                x = self.device_coords()
                cur_xy = self._project_screen(x, vm, pr, width, height)
                if prev_view is None:
                    vel = torch.zeros((height, width, 2), dtype=torch.float32,
                                      device=self.device)
                else:
                    pvm, ppr, px = prev_view
                    prev_xy = self._project_screen(px, pvm, ppr, width, height)
                    vel = pp.velocity_image(pick, cur_xy, prev_xy)
                prev_view = (vm, pr, x)
                rgb = reproj.step(rgba[..., :3], vel, depth, jitter_px=jitter,
                                  motion_blur=motion_blur)
                rgba = torch.cat([rgb, rgba[..., 3:]], dim=-1)
            else:
                rgba, depth, pick = self.render(width, height, **kw)
                if motion_blur:
                    cur, prev = self._screen_positions(width, height, dt)
                    vel = pp.velocity_image(pick, cur, prev)
                    rgb = pp.motion_blur(rgba[..., :3], vel)
                    rgba = torch.cat([rgb, rgba[..., 3:]], dim=-1)
            if progress:
                progress((k + 1) / len(frames))
            yield float(f), rgba

    @staticmethod
    def _project_screen(x: torch.Tensor, vm: np.ndarray, pr: np.ndarray, width, height):
        """Per-atom screen positions under an explicit view/projection —
        the velocity gbuffer source including CAMERA motion (the
        blit_velocity pass reprojects with prev-frame matrices)."""
        m = torch.as_tensor(vm, device=x.device)
        pv = x @ m[:3, :3].T + m[:3, 3]
        cw = torch.clamp_min(-pv[:, 2], 1e-6)
        sx = (float(pr[0, 0]) * pv[:, 0] / cw * 0.5 + 0.5) * width
        sy = (float(pr[1, 1]) * pv[:, 1] / cw * 0.5 + 0.5) * height
        return torch.stack([sx, sy], 1)

    def _screen_positions(self, width: int, height: int, dt: float = 1.0):
        """(current, previous) per-atom screen positions — the velocity
        gbuffer source (velocity/* blit passes)."""
        cam = self._camera()
        vm = _f32(cam.view_matrix())
        pr = _f32(cam.proj_matrix(width, height))
        x = self.device_coords()
        v = self._velocities(dt)
        return (self._project_screen(x, vm, pr, width, height),
                self._project_screen(x - v * dt, vm, pr, width, height))

    def pick(self, x: int, y: int, width: int = 512, height: int = 512) -> int:
        """Atom index under a pixel (the async PBO picking readback,
        viamd.cpp:2359-2545, as a direct query)."""
        _, _, picking = self.render(width, height)
        return int(picking[y, x].item())

    def select_at(
        self, x: int, y: int, level: str = "atom",
        width: int = 512, height: int = 512, mode: str = "replace",
    ) -> Bitfield:
        """Select the atom/residue/chain under a pixel (the click-select +
        granularity popup behavior, main.cpp draw_context_popup:2747).
        `mode`: replace | add | remove (the reference's click modifiers)."""
        idx = self.pick(x, y, width, height)
        mask = Bitfield(self.system.natoms)
        if idx >= 0:
            if level == "atom":
                mask.set_bit(idx)
            elif level == "residue":
                r = int(self.system.atom_res_idx[idx])
                mask = Bitfield.from_bools(np.asarray(self.system.atom_res_idx) == r)
            elif level == "chain":
                ch = np.asarray(self.system.atom_chain_idx)
                mask = Bitfield.from_bools(ch == int(ch[idx]))
            elif level == "instance":
                # SelectionGranularity::Instance (viamd.h:1559-1566):
                # grow to the owning instance's atom range
                inst = self.system.instances
                k = inst.find_by_atom(idx) if inst is not None else -1
                if k >= 0:
                    b, e = (int(v) for v in inst.atom_ranges[k])
                    sel = np.zeros(self.system.natoms, bool)
                    sel[b:e] = True
                    mask = Bitfield.from_bools(sel)
                else:
                    mask.set_bit(idx)
            else:
                raise ValueError(f"unknown level '{level}'")
        return self._combine_selection(mask, mode)

    def select_rect(
        self, x0: int, y0: int, x1: int, y1: int,
        width: int = 512, height: int = 512, mode: str = "replace",
    ) -> Bitfield:
        """Region (drag-rectangle) selection from the picking buffer —
        the interaction surface's region-select (viamd.h:1739-1763):
        every atom whose impostor is visible inside the rect."""
        _, _, picking = self.render(width, height)
        xa, xb = sorted((int(x0), int(x1)))
        ya, yb = sorted((int(y0), int(y1)))
        ids = picking[ya : yb + 1, xa : xb + 1]
        ids = torch.unique(ids[ids >= 0]).cpu().numpy().astype(np.int64)
        sel = np.zeros(self.system.natoms, bool)
        sel[ids] = True
        return self._combine_selection(Bitfield.from_bools(sel), mode)

    def _combine_selection(self, mask: Bitfield, mode: str) -> Bitfield:
        if mode == "replace":
            self.selection = mask
        elif mode == "add":
            self.selection = (self.selection | mask) if self.selection else mask
        elif mode == "remove":
            if self.selection:
                self.selection = self.selection.andnot(mask)
        else:
            raise ValueError(f"unknown selection mode '{mode}'")
        self.events.broadcast(EventType.SELECTION_CHANGED, self)
        return self.selection

    # -- tick (main-loop analog) ---------------------------------------------
    def tick(self):
        """Process queued events + pinned tasks (one main-loop iteration's
        bookkeeping, main.cpp:1186-1187)."""
        self.events.broadcast(EventType.FRAME_TICK, self)
        self.events.process_queue()
        self.tasks.run_main_queue()

    # -- workspace -----------------------------------------------------------
    def save_workspace(self, path: str):
        from viamd_tpu_torch.app.workspace import save_workspace

        save_workspace(self, path)

    def load_workspace(self, path: str):
        from viamd_tpu_torch.app.workspace import load_workspace

        load_workspace(self, path)

    def shutdown(self):
        self.events.broadcast(EventType.SHUTDOWN, self)
        self.tasks.shutdown()
