"""VIAMD script → per-frame torch function.

Counterpart of viamd_tpu.script.compiler (md_script_ir_compile_from_source +
md_script_eval_*, VIAMD src/main.cpp:866,959-1035).

- Frame-independent work — selections, structure packing, capacity sizing,
  index tensors — happens once per call site (cached by AST node) and lives
  on the compile device.
- `frame_fn(x, basis, inv_basis) → (temporal, accum)` walks the statements
  on one frame's tensors; the evaluator calls it frame by frame and sums the
  distribution/volume accumulators.
- Compiling runs one frame — the system's own coordinates — to type-check
  the script by example and produce the PropertyMeta list.

Ported so far: the builtins `element`, `residue`, `all`, `rdf`, `sdf`,
`shape_weights`, and `distance`, `angle`, `dihedral` in their atom-index
form; range literals and subscripts, `{a, b, c} = …` destructuring.

`rdf` and `sdf` of static selections take the JAX package's routes, by its
rules (viamd_tpu/script/compiler.py:1367-1728), named in
`CompiledScript.routes`:
- rdf:cell_list (periodic orthorhombic, n ≥ 4096) and
  rdf:cell_list_triclinic (periodic triclinic, n ≥ 4096): the pair_hist
  kernel over a radius-1 cell grid, min(dims) ≥ 3; rdf:cell_list_r2, an
  orthorhombic box under 3 cutoffs across: the kernel over a radius-2 grid
  (cells half the cutoff wide), min(dims) ≥ 5 (rdf:cell_list_triclinic_r2
  for frames whose basis is skewed); rdf:dense otherwise, the all-pairs
  histogram.
- sdf:pairs (periodic, n ≥ 8192, S·n_t ≤ 1.5e8; a triclinic cell sizes
  its capacities on a box of equal volume), sdf:cell_list (periodic,
  n ≥ 8192, S·n_t > 1.5e8, while the pruned stencil fits the grid),
  sdf:dense otherwise.
A cell-list site's grid is sized from the cells it will see: `frame_fn`
and `routes` use the system's cell; `fitted(widths, orthorhombic)` binds
grids for the smallest perpendicular widths of a trajectory's frames (the
Evaluator's), so a frame whose box shrank still has cells at least the
reach wide; a site whose grid no longer fits takes the dense route. (The
JAX package sizes its grids from the system's cell only.)

Every other builtin, operator, form and route raises
ScriptError("... not yet ported to viamd_tpu_torch"); none silently takes
another path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.core import system as S
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.ops import covariance as cov_ops
from viamd_tpu_torch.ops import geometry as geom_ops
from viamd_tpu_torch.ops import sdf as sdf_ops
from viamd_tpu_torch.ops.cuda_rdf import pair_dist_histogram_cl
from viamd_tpu_torch.ops.neighbors import choose_grid, choose_grid_r, perpendicular_widths
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import pair_dist_histogram_scatter_idx
from viamd_tpu_torch.script import parser as P
from viamd_tpu_torch.script.parser import ScriptError
from viamd_tpu_torch.script.values import (
    AccumSpec,
    AccumValue,
    DynValue,
    FRange,
    IRange,
    PropertyMeta,
    Selection,
)

RDF_BINS = 128
SDF_DIMS = 64
RAD2DEG = 57.29577951308232
SDF_PAIRS_MAX = 150_000_000  # S·n_t above which sdf takes the cell list

# builtins of viamd_tpu.script.compiler that this package does not have yet
NOT_PORTED = frozenset(
    "atoms residues chains water ion protein nucleic backbone sidechain "
    "hetero name type label resname resid chain atom within x y z count "
    "distance_min distance_max distance_pair com "
    "plane rmsd pow atan2 dot cross vec2 vec3 vec4 mul import sqrt cbrt abs "
    "floor ceil cos sin tan asin acos atan log exp log2 exp2 log10".split()
)


def _not_ported(what: str, node) -> ScriptError:
    return ScriptError(
        f"{what} not yet ported to viamd_tpu_torch",
        getattr(node, "line", 0), getattr(node, "col", 0),
    )


@dataclass(frozen=True)
class Grid:
    """The grid a cell-list call site uses for a set of cells: the route
    its frames take, and for a cell-list route the cell grid, whether atoms
    are binned in fractional space, the stencil's reach in cells, and (sdf)
    the slot capacity and stencil offsets."""

    route: str
    dims: tuple = (1, 1, 1)
    fractional: bool = False
    radius: int = 1
    capacity: int = 0
    stencil: Any = None

    @property
    def dense(self) -> bool:
        return self.route.endswith(":dense")


@dataclass(frozen=True)
class FittedScript:
    """A CompiledScript bound to the grids of one trajectory's cells."""

    frame_fn: Callable  # (x, basis, inv_basis) -> (temporal, accum) dicts
    routes: list
    grids: list  # one Grid per cell-list call site


@dataclass
class CompiledScript:
    """Result of compiling a script against a system on one device."""

    frame_fn: Callable  # (x, basis, inv_basis) -> (temporal, accum) dicts
    properties: list[PropertyMeta]
    selections: dict[str, Selection]
    source: str
    device: torch.device
    warnings: list[str] = field(default_factory=list)
    visualization: dict = field(default_factory=dict)
    # route taken by each accumulating call, in script order, at the
    # system's cell
    routes: list[str] = field(default_factory=list)
    # the cell-list call sites, and the grid frame_fn gives each
    grid_sites: list = field(default_factory=list)
    grids: list = field(default_factory=list)
    # (x, basis, inv_basis, grids) -> frame_fn's result on other grids
    run_frame: Callable = field(default=None, repr=False)

    def property(self, name: str) -> PropertyMeta:
        for p in self.properties:
            if p.name == name:
                return p
        raise KeyError(name)

    def fitted(self, widths, orthorhombic: bool) -> FittedScript:
        """The script on grids sized for frames whose perpendicular widths
        (ops.neighbors.perpendicular_widths) are at least `widths` (3,);
        `orthorhombic`: every frame's basis is diagonal. A site whose grid
        no longer fits takes the dense route. Host work only. Frames whose
        box is smaller than `widths` on an axis may lose pairs: the
        Evaluator fits to its whole trajectory."""
        widths = np.asarray(widths, np.float64)
        grids = [site.grid(widths, orthorhombic) for site in self.grid_sites]
        routes = list(self.routes)
        for site, g in zip(self.grid_sites, grids):
            routes[site.route_index] = g.route
        return FittedScript(functools.partial(self.run_frame, grids=grids), routes, grids)


class _RdfSite:
    """An rdf cell-list call site: cells at least the cutoff wide (radius
    1); in an orthorhombic box under 3 cutoffs across, cells at least half
    of it wide (radius 2, JAX compiler.py:1444-1451); dense when neither
    grid fits. Binned in fractional space on a triclinic system cell, or
    once any frame's basis has off-diagonal entries."""

    def __init__(self, cutoff: float, n_a: int, triclinic: bool):
        self.cutoff, self.n_a, self.triclinic = cutoff, n_a, triclinic

    def grid(self, widths, orthorhombic: bool) -> Grid:
        fractional = self.triclinic or not orthorhombic
        route = "rdf:cell_list_triclinic" if fractional else "rdf:cell_list"
        # choose_grid_r on the perpendicular widths: choose_grid_triclinic
        # for a triclinic cell
        dims = choose_grid_r(widths, self.cutoff, self.n_a, radius=1)[0]
        if min(dims) >= 3:
            return Grid(route, dims, fractional, 1)
        if not self.triclinic:
            dims = choose_grid(widths, self.cutoff, self.n_a)[0]
            if min(dims) >= 5:
                return Grid(route + "_r2", dims, fractional, 2)
        return Grid("rdf:dense")


class _SdfSite:
    """An sdf cell-list call site (ops.sdf.sdf_cell_grid); dense for a
    zero (aperiodic) cell or when the stencil spans more cells than an
    axis has."""

    def __init__(self, extent: float, frac0: np.ndarray, triclinic: bool, device):
        self.extent, self.frac0, self.device = extent, frac0, device
        self.triclinic = triclinic

    def grid(self, widths, orthorhombic: bool) -> Grid:
        if min(widths) <= 0:
            return Grid("sdf:dense")
        fractional = self.triclinic or not orthorhombic
        dims, capacity, stencil = sdf_ops.sdf_cell_grid(
            widths, self.extent, self.frac0, fractional
        )
        if int(stencil.max() - stencil.min()) + 1 > min(dims):
            return Grid("sdf:dense")
        stencil = torch.as_tensor(stencil, dtype=torch.int64, device=self.device)
        return Grid("sdf:cell_list", dims, fractional, 1, capacity, stencil)


def compile_script(src: str, system: S.System, device) -> CompiledScript:
    """Compile script text against `system`; all tensors live on `device`."""
    # resolve "cuda" to the current "cuda:N", the device tensors report
    device = torch.empty(0, device=device).device
    comp = _Compiler(system, device)
    return comp.compile(P.parse(src), src)


class _Compiler:
    def __init__(self, system: S.System, device: torch.device):
        self.sys = system
        self.n = system.natoms
        self.device = device
        self.x0 = np.ascontiguousarray(system.coords(), dtype=np.float32)
        self.masses = system.mass.astype(np.float32)
        self.basis0 = np.asarray(system.cell.basis, np.float32)
        # per-call-site host work (selections, index tensors, capacities),
        # keyed by AST node: computed on the first walk, reused every frame
        self.static_cache: dict[int, Any] = {}
        self.env: dict[str, Any] = {}
        self.warnings: list[str] = []
        self.routes: list[str] = []
        self.grid_sites: list = []
        self._grids: list = []  # the grids of the walk in progress
        self.vis: dict = {"lines": [], "angles": [], "dihedrals": [], "sdf": []}
        self._x = self._basis = self._inv = None

    def tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- public -------------------------------------------------------------
    def compile(self, stmts: list[P.Assign], src: str) -> CompiledScript:
        def run_frame(x, basis, inv_basis, grids):
            temporal, accum, _ = self._run(stmts, x, basis, inv_basis, grids)
            t_out = {
                k: torch.atleast_1d(v.data).reshape(-1).to(torch.float32)
                for k, v in temporal.items()
            }
            return t_out, {k: v.data for k, v in accum.items()}

        b0 = self.tensor(self.basis0)
        # the walk registers each cell-list site and its grid for the
        # system's cell (grid_site)
        grids0: list = []
        temporal, accum, selections = self._run(
            stmts, self.tensor(self.x0), b0, inv_basis_of(b0), grids0
        )
        props = [
            PropertyMeta(
                name=k, kind="temporal", dim=int(v.data.numel()),
                unit=v.unit, structures=v.structures,
            )
            for k, v in temporal.items()
        ]
        props += [
            PropertyMeta(
                name=k, kind=v.spec.kind, dim=v.spec.nbins or v.spec.dims,
                unit=v.spec.x_unit, spec=v.spec,
            )
            for k, v in accum.items()
        ]
        return CompiledScript(
            frame_fn=functools.partial(run_frame, grids=grids0),
            properties=props,
            selections=selections,
            source=src,
            device=self.device,
            warnings=list(self.warnings),
            visualization={k: list(v) for k, v in self.vis.items()},
            routes=self.routes,
            grid_sites=self.grid_sites,
            grids=grids0,
            run_frame=run_frame,
        )

    # -- walking ------------------------------------------------------------
    def _run(self, stmts, x, basis, inv_basis, grids):
        self.env = {}
        self._x, self._basis, self._inv = x, basis, inv_basis
        self._grids = grids
        temporal: dict[str, DynValue] = {}
        accum: dict[str, AccumValue] = {}
        selections: dict[str, Selection] = {}
        for stmt in stmts:
            val = self.eval(stmt.expr)
            names = stmt.targets
            for nm, v in zip(names, self._destructure(val, names, stmt)):
                self.env[nm] = v
                if nm.startswith("$"):
                    continue
                if isinstance(v, Selection):
                    selections[nm] = v
                elif isinstance(v, DynValue):
                    temporal[nm] = v
                elif isinstance(v, AccumValue):
                    accum[nm] = v
                elif isinstance(v, (int, float)):
                    temporal[nm] = DynValue(self.tensor(v, torch.float32))
        return temporal, accum, selections

    def _destructure(self, val, names, stmt):
        if len(names) == 1:
            return [val]
        if isinstance(val, DynValue):
            d = val.data
            if d.ndim and d.shape[-1] == len(names):
                return [
                    DynValue(d[..., i], val.unit, structures=val.structures)
                    for i in range(len(names))
                ]
        raise ScriptError(
            f"cannot destructure value into {len(names)} names",
            stmt.line, stmt.col,
        )

    def eval(self, node: P.Node):
        method = getattr(self, f"_eval_{type(node).__name__}", None)
        if method is None:
            raise _not_ported(f"'{type(node).__name__}' expressions", node)
        return method(node)

    def _eval_Num(self, node: P.Num):
        return node.value

    def _eval_Str(self, node: P.Str):
        return node.value

    def _eval_Ident(self, node: P.Ident):
        name = node.name
        if name in self.env:
            return self.env[name]
        fn = NULLARY.get(name)
        if fn is not None:
            return self._cached(node, lambda: fn(self, node))
        if name in NOT_PORTED:
            raise _not_ported(f"'{name}'", node)
        if name in BUILTINS:
            raise ScriptError(
                f"'{name}' requires arguments", node.line, node.col
            )
        raise ScriptError(f"undefined identifier '{name}'", node.line, node.col)

    def _eval_RangeLit(self, node: P.RangeLit):
        beg = self.eval(node.beg) if node.beg is not None else None
        end = self.eval(node.end) if node.end is not None else None
        if isinstance(beg, float) or isinstance(end, float):
            return FRange(beg, end)
        return IRange(beg, end)

    def _eval_Subscript(self, node: P.Subscript):
        base = self.eval(node.base)
        idx = self.eval(node.index)
        if isinstance(base, Selection):
            s = base.structures
            if isinstance(idx, IRange):
                beg = (idx.beg or 1) - 1
                end = idx.end if idx.end is not None else len(s)
                sub = s[beg:end]
            elif isinstance(idx, int):
                if not (1 <= idx <= len(s)):
                    raise ScriptError(
                        f"index {idx} out of range [1,{len(s)}]",
                        node.line, node.col,
                    )
                sub = [s[idx - 1]]
            else:
                raise ScriptError("bad selection index", node.line, node.col)
            if not sub:
                raise ScriptError("empty selection slice", node.line, node.col)
            mask = Bitfield.from_indices(self.n, np.concatenate(sub))
            return Selection(mask, sub, base.level, base.dynamic)
        raise _not_ported("subscripts of non-selections", node)

    def _eval_Call(self, node: P.Call):
        fn = BUILTINS.get(node.func)
        if fn is None:
            if node.func in NOT_PORTED:
                raise _not_ported(f"'{node.func}'", node)
            raise ScriptError(
                f"unknown function '{node.func}'", node.line, node.col
            )
        if node.func in STATIC_BUILTINS:
            # frame-independent selections: evaluate once per call site
            return self._cached(node, lambda: self._call(fn, node))
        return self._call(fn, node)

    def _call(self, fn, node: P.Call):
        args = [self.eval(a) for a in node.args]
        try:
            return fn(self, node, args)
        except ScriptError:
            raise
        except (TypeError, ValueError, IndexError) as e:
            raise ScriptError(f"{node.func}: {e}", node.line, node.col) from e

    def _cached(self, node, make):
        key = id(node)
        if key not in self.static_cache:
            self.static_cache[key] = make()
        return self.static_cache[key]

    # -- helpers -------------------------------------------------------------
    def _as_selection(self, v, node) -> Selection:
        if isinstance(v, Selection):
            return v
        raise ScriptError(
            "expected an atom selection", getattr(node, "line", 0),
            getattr(node, "col", 0),
        )

    def residue_selection(self, res_mask: np.ndarray) -> Selection:
        offs = self.sys.res_offsets
        structures = [
            np.arange(offs[r], offs[r + 1], dtype=np.int32)
            for r in np.nonzero(res_mask)[0]
        ]
        mask = Bitfield.from_indices(
            self.n, np.concatenate(structures) if structures else []
        )
        return Selection(mask, structures, "residue")

    def atom_selection(self, atom_mask: np.ndarray) -> Selection:
        bf = Bitfield.from_bools(atom_mask)
        return Selection(bf, [bf.indices()] if bf.any() else [], "atom")

    def grid_site(self, site) -> Grid:
        """Register a cell-list call site (its route is the next in
        `routes`); → its grid for the system's cell, which joins the
        compile walk's grids."""
        site.route_index = len(self.routes)
        self.grid_sites.append(site)
        grid = site.grid(perpendicular_widths(self.basis0)[0], self.sys.cell.is_orthorhombic)
        self._grids.append(grid)
        self.routes.append(grid.route)
        return grid

    def dense_weights(self, sel: Selection, masses=True) -> np.ndarray:
        w = np.zeros(self.n, np.float32)
        idx = sel.mask.indices()
        w[idx] = self.masses[idx] if masses else 1.0
        return w


def _require_atoms(name: str, node, *sels):
    for s in sels:
        if s.mask.popcount() == 0:
            raise ScriptError(
                f"{name}: selection matches no atoms", node.line, node.col
            )


def _require_static(name: str, node, *sels):
    for s in sels:
        if s.dynamic:
            raise _not_ported(f"{name} of a dynamic selection", node)


# ---------------------------------------------------------------------------
# builtin registry
# ---------------------------------------------------------------------------

BUILTINS: dict[str, Callable] = {}
NULLARY: dict[str, Callable] = {}
STATIC_BUILTINS = frozenset({"element", "residue"})


def builtin(name):
    def deco(fn):
        BUILTINS[name] = fn
        return fn

    return deco


def nullary(name):
    def deco(fn):
        NULLARY[name] = fn
        return fn

    return deco


@nullary("all")
def _all(c: _Compiler, node):
    return Selection(
        Bitfield.full(c.n), [np.arange(c.n, dtype=np.int32)], "system"
    )


@builtin("element")
def _element(c: _Compiler, node, args):
    zs = set()
    for a in args:
        if isinstance(a, str):
            z = E.symbol_to_z(a) or E.name_to_z(a)
            if not z:
                raise ScriptError(f"unknown element '{a}'", node.line, node.col)
            zs.add(z)
        elif isinstance(a, int):
            zs.add(a)
        else:
            raise ScriptError("element: expects symbols", node.line, node.col)
    return c.atom_selection(np.isin(c.sys.element, list(zs)))


@builtin("residue")
def _residue(c: _Compiler, node, args):
    """1-based residue *sequence* indices (not author resid)."""
    res_mask = np.zeros(c.sys.nres, bool)
    for a in args:
        if isinstance(a, int):
            if not (1 <= a <= c.sys.nres):
                raise ScriptError(
                    f"residue index {a} out of range", node.line, node.col
                )
            res_mask[a - 1] = True
        elif isinstance(a, IRange):
            beg = (a.beg or 1) - 1
            end = a.end if a.end is not None else c.sys.nres
            res_mask[beg:end] = True
        else:
            raise ScriptError("residue: expects ints/ranges", node.line, node.col)
    return c.residue_selection(res_mask)


@builtin("shape_weights")
def _shape_weights(c: _Compiler, node, args):
    def prepare():
        sel = c._as_selection(args[0], node)
        _require_atoms("shape_weights", node, sel)
        _require_static("shape_weights", node, sel)
        if sel.n_structures > 1:
            idx, w = sel.packed(c.masses)
            return c.tensor(idx, torch.int64), c.tensor(w)
        return None, c.tensor(c.dense_weights(sel))

    idx, w = c._cached(node, prepare)
    x = c._x if idx is None else c._x[idx]  # (n, 3) or (S, K, 3)
    return DynValue(cov_ops.shape_weights(x, w, c._basis, c._inv), unit="")


def _atom_indices(c: _Compiler, node, args, arity: int, name: str) -> list:
    """The atom-index form of a geometry builtin (JAX `_mapped_indices`
    outside an `in` context): 1-based atom indices → one (1,) int64 index
    tensor per argument. Other argument forms are not yet ported."""
    if not all(type(a) is int for a in args):
        raise _not_ported(
            f"'{name}' of positions or selections (only its atom-index form "
            "is ported)", node
        )
    if len(args) != arity:
        raise ScriptError(f"expected {arity} atom indices", node.line, node.col)
    for a in args:
        if not 1 <= a <= c.n:
            raise ScriptError(
                f"atom index {a} out of range [1,{c.n}]", node.line, node.col
            )
    return [c.tensor([a - 1], torch.int64) for a in args]


def _geometry(name: str, arity: int, vis: str, fn, scale: float, unit: str):
    def builtin_fn(c: _Compiler, node, args):
        if name == "distance" and len(args) != 2:
            raise ScriptError("distance(a, b)", node.line, node.col)

        def prepare():
            idx = _atom_indices(c, node, args, arity, name)
            c.vis[vis].append(tuple(a - 1 for a in args))
            return idx

        v = fn(c._x, *c._cached(node, prepare), c._basis, c._inv)
        return DynValue(v[0] * scale, unit=unit)

    BUILTINS[name] = builtin_fn


_geometry("distance", 2, "lines", geom_ops.distance, 1.0, "Å")
_geometry("angle", 3, "angles", geom_ops.angle, RAD2DEG, "deg")
_geometry("dihedral", 4, "dihedrals", geom_ops.dihedral, RAD2DEG, "deg")


@builtin("rdf")
def _rdf(c: _Compiler, node, args):
    if len(args) != 3:
        raise ScriptError("rdf(sel_a, sel_b, cutoff)", node.line, node.col)
    cutoff = float(args[2])

    def prepare():
        a = c._as_selection(args[0], node)
        b = c._as_selection(args[1], node)
        _require_static("rdf", node, a, b)
        idx_a, idx_b = a.mask.indices(), b.mask.indices()
        ia = c.tensor(idx_a, torch.int32)
        # one tensor for a same-selection rdf: the kernel wrapper then
        # builds one cell list for both sides
        ib = ia if np.array_equal(idx_a, idx_b) else c.tensor(idx_b, torch.int32)
        ones = (c.tensor(np.ones(idx_a.size, np.float32)),
                c.tensor(np.ones(idx_b.size, np.float32)))
        cell = c.sys.cell
        site = None
        if cell.is_periodic and c.n >= 4096:
            site = len(c.grid_sites)
            c.grid_site(_RdfSite(cutoff, idx_a.size, not cell.is_orthorhombic))
        else:
            c.routes.append("rdf:dense")
        spec = AccumSpec(
            kind="distribution", nbins=RDF_BINS, r_min=0.0, r_max=cutoff,
            x_unit="Å", count_a=float(idx_a.size), count_b=float(idx_b.size),
        )
        return ia, ib, ones, site, spec

    ia, ib, ones, site, spec = c._cached(node, prepare)
    grid = None if site is None else c._grids[site]
    if grid is None or grid.dense:
        hist = pair_dist_histogram_scatter_idx(
            c._x, ia, ib, *ones, c._basis, c._inv, RDF_BINS, cutoff
        )
    else:
        hist = pair_dist_histogram_cl(
            c._x, ia, ib, c._basis, c._inv, RDF_BINS, cutoff, grid.dims,
            fractional=grid.fractional, radius=grid.radius,
        )
    return AccumValue(hist, spec)


@builtin("sdf")
def _sdf(c: _Compiler, node, args):
    if len(args) != 3:
        raise ScriptError("sdf(ref_sel, target_sel, extent)", node.line, node.col)
    extent = float(args[2])

    def prepare():
        ref_sel = c._as_selection(args[0], node)
        target = c._as_selection(args[1], node)
        _require_static("sdf", node, ref_sel, target)
        structs = [np.asarray(s) for s in ref_sel.structures]
        idx, w, refc = sdf_ops.make_structure_inputs(structs, c.masses, c.x0)
        c.vis["sdf"].append({
            "extent": extent, "structures": structs, "struct_idx": idx,
            "struct_w": w, "ref_centered": refc,
        })
        idx_t = target.mask.indices()
        xt0 = c.x0[idx_t]
        cell = c.sys.cell
        big = cell.is_periodic and c.n >= 8192
        tri = not cell.is_orthorhombic
        # the capacity sizers' box: a triclinic cell's cube of equal volume
        B0 = np.asarray(cell.basis, np.float64) if tri else None
        box = np.full(3, cell.volume() ** (1.0 / 3.0)) if tri else cell.extent()
        site = pair_cap = compact_cap = None
        if big and 0 < len(structs) * int(idx_t.size) <= SDF_PAIRS_MAX:
            cnt0 = sdf_ops.sdf_frame0_ball_count(
                xt0, c.x0, idx, w, box, extent, SDF_DIMS, basis=B0
            )
            pair_cap = sdf_ops.sdf_pair_capacity(
                len(structs), int(idx_t.size), box, extent, SDF_DIMS,
                per_struct_count=cnt0,
            )
            c.routes.append("sdf:pairs")
        elif big:
            frac0 = xt0 @ np.linalg.inv(B0) if tri else xt0 / box
            site = len(c.grid_sites)
            c.grid_site(_SdfSite(extent, frac0, tri, c.device))
        else:
            c.routes.append("sdf:dense")
        if big:  # the pairs and cell-list routes compact before the splat
            support0 = sdf_ops.sdf_frame0_support_count(
                xt0, c.x0, idx, w, refc, box, extent, SDF_DIMS, basis=B0
            )
            compact_cap = sdf_ops.sdf_compact_capacity(
                len(structs), int(idx_t.size), box, extent, SDF_DIMS,
                support_count=support0,
            )
        spec = AccumSpec(
            kind="volume", dims=SDF_DIMS, extent=extent, x_unit="Å",
            n_structures=len(structs), vis=c.vis["sdf"][-1],
        )
        tensors = (
            c.tensor(c.dense_weights(target, masses=False)),
            c.tensor(idx, torch.int64), c.tensor(w), c.tensor(refc),
            c.tensor(idx_t, torch.int64),
        )
        return tensors, pair_cap, compact_cap, site, spec

    tensors, pair_cap, compact_cap, site, spec = c._cached(node, prepare)
    args_ = (c._x, *tensors[:4], extent, SDF_DIMS, c._basis, c._inv, tensors[4])
    cells = None if site is None else c._grids[site]
    if pair_cap is not None:
        vol = sdf_ops.sdf_accumulate_pairs(*args_, pair_cap, compact_cap=compact_cap)
    elif cells is not None and not cells.dense:
        vol = sdf_ops.sdf_accumulate_cl(
            *args_, cells.dims, cells.capacity, cells.stencil,
            compact_cap=compact_cap, fractional=cells.fractional,
        )
    else:
        vol = sdf_ops.sdf_accumulate(*args_)
    return AccumValue(vol, spec)
