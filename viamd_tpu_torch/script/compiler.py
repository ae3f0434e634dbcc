"""VIAMD script → per-frame torch function.

Counterpart of viamd_tpu.script.compiler (md_script_ir_compile_from_source +
md_script_eval_*, VIAMD src/main.cpp:866,959-1035), at its semantics:
every builtin and nullary it registers (`import` reads its table through
the port's io/), the operators, `in` contexts, subscripts, array
literals, `{a, b, c} = …` destructuring, injected identifiers, and
dynamic selections (`within`, `x`, `y`, `z` and their boolean
combinations), which consumers that take per-frame weights (count, com,
rdf, distance_min/max, positions) evaluate on each frame's coordinates.

- Frame-independent work happens once: every node whose value is static —
  a selection, number, string, range or array — is evaluated on the first
  walk and its value reused (`_Compiler.eval`); index tensors, weights and
  masks are built once per call site or selection and live on the compile
  device; a dynamic selection's `mask_fn(x, basis, inv_basis) → (n,) bool`
  is a closure over such tensors, so `frame_fn` never copies from the host
  or waits on the device.
- `frame_fn(x, basis, inv_basis) → (temporal, accum)` walks the statements
  on one frame's tensors; the evaluator calls it frame by frame and sums the
  distribution/volume accumulators.
- Compiling runs one frame — the system's own coordinates — to type-check
  the script by example and produce the PropertyMeta list and warnings.

`rdf` and `sdf` of static selections take the JAX package's routes, by its
rules (viamd_tpu/script/compiler.py:1367-1728), named in
`CompiledScript.routes`:
- rdf:cell_list (periodic orthorhombic, n ≥ 4096) and
  rdf:cell_list_triclinic (periodic triclinic, n ≥ 4096): the pair_hist
  kernel over a radius-1 cell grid, min(dims) ≥ 3; rdf:cell_list_r2, an
  orthorhombic box under 3 cutoffs across: the kernel over a radius-2 grid
  (cells half the cutoff wide), min(dims) ≥ 5 (rdf:cell_list_triclinic_r2
  for frames whose basis is skewed); rdf:dense otherwise, the all-pairs
  histogram; rdf:dynamic for a side with a per-frame mask: the all-pairs
  histogram with that frame's weights, normalised per frame.
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
With `atom_shard=(axis, n)` the cell-list rdf routes split their A cell
rows over an axis of the current device mesh (parallel/mesh.py) and sum
the partials; every other route is unchanged.
"""

from __future__ import annotations

import fnmatch
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.core import system as S
from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.tracing import section
from viamd_tpu_torch.ops import com as com_ops
from viamd_tpu_torch.ops import covariance as cov_ops
from viamd_tpu_torch.ops import geometry as geom_ops
from viamd_tpu_torch.ops import pbc as pbc_ops
from viamd_tpu_torch.ops import rmsd as rmsd_ops
from viamd_tpu_torch.ops import sdf as sdf_ops
from viamd_tpu_torch.ops.cuda_rdf import pair_dist_histogram_cl, pair_dist_histogram_cl_sharded
from viamd_tpu_torch.ops.neighbors import choose_grid, choose_grid_r, perpendicular_widths
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import (
    pair_dist_histogram_dynamic,
    pair_dist_histogram_scatter_idx,
)
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
DISTANCE_PAIR_MAX = 65536  # pairs a distance_pair property may hold

# builtins of viamd_tpu.script.compiler that this package does not have yet
NOT_PORTED = frozenset()

# values that do not depend on the frame: a node that gives one keeps it
_STATIC = (Selection, str, int, float, IRange, FRange, np.ndarray, np.generic)
_MISS = object()


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
    # (mesh, axis) of compile_script(atom_shard=): frame_fn sums over it
    atom_shard: Optional[tuple] = field(default=None, repr=False)

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


def compile_script(
    src: str,
    system: S.System,
    device,
    identifiers: Optional[dict[str, Bitfield]] = None,
    atom_shard: Optional[tuple] = None,
) -> CompiledScript:
    """Compile script text against `system`; all tensors live on `device`.

    `identifiers` injects stored selections as script identifiers
    (VIAMD src/main.cpp:860-863).

    `atom_shard=(axis, n)`: intra-frame parallelism over the axis `axis`,
    of n ranks, of the current device mesh (parallel.mesh.frames_mesh): the
    cell-list RDF splits its A cell rows over the axis and sums the partials
    (ops/cuda_rdf.py::pair_dist_histogram_cl_sharded); the dense routes are
    unchanged. Every frame_fn call, the compile's own walk included, is then
    a collective of the axis' ranks: they compile and evaluate together."""
    # resolve "cuda" to the current "cuda:N", the device tensors report
    device = torch.empty(0, device=device).device
    comp = _Compiler(system, device, identifiers, _shard_axis(atom_shard))
    return comp.compile(P.parse(src), src)


def _shard_axis(atom_shard: Optional[tuple]):
    """(mesh, axis) of atom_shard=(axis, n) on the current mesh, or None;
    a ScriptError unless that mesh has the axis with n ranks (JAX
    compiler.py:186-193, pallas_rdf.py:636-641)."""
    if atom_shard is None:
        return None
    from viamd_tpu_torch.parallel.mesh import current_mesh

    axis, n = atom_shard
    mesh = current_mesh()
    if mesh is None:
        raise ScriptError(f"atom_shard declares {n} devices on axis '{axis}' but there "
                          "is no device mesh (parallel.frames_mesh)")
    if mesh.shape.get(axis) != int(n):
        raise ScriptError(f"atom_shard declares {n} devices on axis '{axis}' but the "
                          f"mesh has {mesh.shape.get(axis, 0)}")
    return mesh, axis


class _Compiler:
    def __init__(
        self,
        system: S.System,
        device: torch.device,
        identifiers: Optional[dict[str, Bitfield]] = None,
        atom_shard: Optional[tuple] = None,  # (mesh, axis)
    ):
        self.sys = system
        self.n = system.natoms
        self.device = device
        self.atom_shard = atom_shard
        self.x0 = np.ascontiguousarray(system.coords(), dtype=np.float32)
        self.masses = system.mass.astype(np.float32)
        self.basis0 = np.asarray(system.cell.basis, np.float32)
        self.inv_basis0 = np.asarray(system.cell.inv_basis, np.float32)
        self.injected = {
            name: Selection(bf, [bf.indices()], "atom")
            for name, bf in (identifiers or {}).items()
        }
        # the values of static nodes, keyed by AST node: computed on the
        # first walk, reused every frame
        self.value_cache: dict[int, Any] = {}
        # per-call-site host work (index tensors, capacities), by AST node
        self.static_cache: dict[int, Any] = {}
        # device constants of static values: (id(value), tag) → (value, tensor)
        self._memo: dict = {}
        self.env: dict[str, Any] = {}
        self.context: Optional[Selection] = None
        self.warnings: list[str] = []
        self.routes: list[str] = []
        self.grid_sites: list = []
        self._grids: list = []  # the grids of the walk in progress
        self.vis: dict = {"lines": [], "angles": [], "dihedrals": [], "sdf": []}
        self._x = self._basis = self._inv = None

    def tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def memo(self, obj, tag, make):
        """A device constant derived from the static value `obj`, made once
        (static values are cached by node, so `obj` stays alive)."""
        key = (id(obj), tag)
        hit = self._memo.get(key)
        if hit is None or hit[0] is not obj:
            hit = self._memo[key] = (obj, make())
        return hit[1]

    @functools.cached_property
    def masses_t(self) -> torch.Tensor:
        return self.tensor(self.masses)

    @functools.cached_property
    def all_atoms(self) -> torch.Tensor:
        return torch.arange(self.n, dtype=torch.int64, device=self.device)

    def const(self, v, dtype=None) -> torch.Tensor:
        """A static number or array as a device tensor, made once: of
        `dtype`, or float64 → float32 and int64 → int32, as the JAX package
        holds them."""

        def make():
            a = np.asarray(v, dtype)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.int64:
                a = a.astype(np.int32)
            return self.tensor(a)

        return self.memo(v, ("const", dtype), make)

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
            visualization={
                k: dict(v) if isinstance(v, dict) else list(v)
                for k, v in self.vis.items()
            },
            routes=self.routes,
            grid_sites=self.grid_sites,
            grids=grids0,
            run_frame=run_frame,
            atom_shard=self.atom_shard,
        )

    # -- walking ------------------------------------------------------------
    def _run(self, stmts, x, basis, inv_basis, grids):
        self.env = dict(self.injected)
        self.context = None
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
                    if v.spec is not None and v.spec.vis is not None:
                        # name-keyed vis.sdf mirror: the call-ordered list
                        # desynchronizes under property reassignment
                        self.vis.setdefault("sdf_by_name", {})[nm] = v.spec.vis
                elif isinstance(v, (int, float, np.ndarray)):
                    temporal[nm] = DynValue(self.const(v, np.float32))
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
        key = id(node)
        hit = self.value_cache.get(key, _MISS)
        if hit is not _MISS:
            return hit
        val = getattr(self, f"_eval_{type(node).__name__}")(node)
        if isinstance(val, _STATIC):
            self.value_cache[key] = val
        return val

    # -- literals / identifiers ---------------------------------------------
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
            return fn(self, node)
        if name in BUILTINS or name in NOT_PORTED:
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

    def _eval_ArrayLit(self, node: P.ArrayLit):
        items = [self.eval(i) for i in node.items]
        if all(isinstance(i, (int, float)) for i in items):
            return np.asarray(items, np.float32)
        if all(isinstance(i, DynValue) for i in items):
            try:
                return DynValue(torch.stack([i.data for i in items], -1))
            except RuntimeError as e:
                raise ScriptError(f"array literal: {e}", node.line, node.col) from e
        raise ScriptError("mixed array literal", node.line, node.col)

    # -- operators -----------------------------------------------------------
    def _eval_UnOp(self, node: P.UnOp):
        v = self.eval(node.operand)
        if node.op == "-":
            if isinstance(v, (int, float, np.ndarray)):
                return -v
            if isinstance(v, DynValue):
                return DynValue(-v.data, v.unit)
        if node.op == "not":
            sel = self._as_selection(v, node)
            inv = ~sel.mask
            mfn = None
            if sel.mask_fn is not None:
                inner = sel.mask_fn
                mfn = lambda x, b, i: ~inner(x, b, i)  # noqa: E731
            if self.context is not None:
                inv = inv & self.context.mask
                if mfn is not None:
                    ctx = self.bools(self.context)
                    inner2 = mfn
                    mfn = lambda x, b, i: inner2(x, b, i) & ctx  # noqa: E731
            return self._regroup(inv, dynamic=sel.dynamic, mask_fn=mfn)
        raise ScriptError(f"bad operand for {node.op}", node.line, node.col)

    def _eval_BinOp(self, node: P.BinOp):
        op = node.op
        lhs = self.eval(node.lhs)
        rhs = self.eval(node.rhs)
        if op in ("and", "or"):
            a = self._as_selection(lhs, node)
            b = self._as_selection(rhs, node)
            m = a.mask & b.mask if op == "and" else a.mask | b.mask
            return self._regroup(
                m, dynamic=a.dynamic or b.dynamic,
                mask_fn=_compose_mask_fns(self, op, a, b),
            )
        dyn = isinstance(lhs, DynValue) or isinstance(rhs, DynValue)

        # arithmetic / comparisons on numbers, arrays and per-frame values
        def as_data(v):
            if isinstance(v, DynValue):
                return v.data
            if isinstance(v, (int, float, np.ndarray)):
                # a tensor operand takes arrays as device constants
                return self.const(v) if dyn and isinstance(v, np.ndarray) else v
            raise ScriptError(
                f"operator '{op}' not applicable", node.line, node.col
            )

        a, b = as_data(lhs), as_data(rhs)
        if not dyn:
            return _BINOPS[op](a, b)
        try:
            out = _BINOPS[op](a, b)
        except RuntimeError as e:
            raise ScriptError(f"operator '{op}': {e}", node.line, node.col) from e
        unit = lhs.unit if isinstance(lhs, DynValue) else rhs.unit
        return DynValue(out.to(torch.float32), unit)

    def _eval_InExpr(self, node: P.InExpr):
        ctx = self._as_selection(self.eval(node.context), node)
        if ctx.dynamic:
            # structure contexts are frozen at compile time; a per-frame
            # context would change the structure count (JAX compiler.py:427)
            raise ScriptError(
                "'in' context must be static: dynamic selections "
                "(within/x/y/z) cannot form structure contexts — bind the "
                "selection statically or use it directly in "
                "count/com/rdf/distance_min/distance_max",
                node.line, node.col,
            )
        if ctx.n_structures == 0:
            raise ScriptError("'in' context matches nothing", node.line, node.col)
        prev = self.context
        self.context = ctx
        try:
            val = self.eval(node.expr)
        finally:
            self.context = prev
        if (
            isinstance(val, DynValue)
            and val.structures is None
            and val.data.ndim
            and val.data.shape[0] == ctx.n_structures
        ):
            # one value per context structure → carry the atom groups for
            # the Property color mapping (viamd.cpp:1408-1445)
            val = DynValue(
                val.data, val.unit, val.is_coord,
                structures=list(ctx.structures),
            )
        return val

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
        if isinstance(base, DynValue):
            if isinstance(idx, int):
                return DynValue(base.data[..., idx - 1], base.unit)
            if isinstance(idx, IRange):
                beg = (idx.beg or 1) - 1
                end = idx.end if idx.end is not None else base.data.shape[-1]
                return DynValue(base.data[..., beg:end], base.unit)
        if isinstance(base, np.ndarray):
            if isinstance(idx, int):
                return base[..., idx - 1]
            if isinstance(idx, IRange):
                beg = (idx.beg or 1) - 1
                end = idx.end if idx.end is not None else base.shape[-1]
                return base[..., beg:end]
        raise ScriptError("subscript not supported here", node.line, node.col)

    def _eval_Call(self, node: P.Call):
        fn = BUILTINS.get(node.func)
        if fn is None and node.func not in NOT_PORTED:
            raise ScriptError(
                f"unknown function '{node.func}'", node.line, node.col
            )
        args = [self.eval(a) for a in node.args]
        if fn is None:  # after its arguments, whose errors come first
            raise _not_ported(f"'{node.func}'", node)
        try:
            # static values are cached by node on the first walk, so a
            # frame's walk spans only its per-frame builtins
            with section(_span_name(node.func)):
                return fn(self, node, args)
        except ScriptError:
            raise
        except (TypeError, ValueError, IndexError, RuntimeError) as e:
            # RuntimeError: torch's form of a shape mismatch
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

    def bools(self, sel: Selection) -> torch.Tensor:
        """(n,) bool device mask of a selection's static mask."""
        return self.memo(sel, "bools", lambda: self.tensor(sel.mask.to_bools()))

    def indices(self, sel: Selection) -> torch.Tensor:
        """int64 device indices of a selection's static mask."""
        return self.memo(sel, "idx", lambda: self.tensor(sel.mask.indices(), torch.int64))

    def _regroup(self, mask: Bitfield, dynamic=False, mask_fn=None) -> Selection:
        """Selection from a raw mask: one flat structure."""
        idx = mask.indices()
        return Selection(mask, [idx] if idx.size else [], "atom", dynamic,
                         mask_fn)

    def residue_selection(self, res_mask: np.ndarray, dynamic=False) -> Selection:
        """Selection at residue granularity from a per-residue bool mask."""
        offs = self.sys.res_offsets
        structures = [
            np.arange(offs[r], offs[r + 1], dtype=np.int32)
            for r in np.nonzero(res_mask)[0]
        ]
        mask = Bitfield.from_indices(
            self.n, np.concatenate(structures) if structures else []
        )
        return self._clip_to_context(Selection(mask, structures, "residue", dynamic))

    def atom_selection(
        self, atom_mask: np.ndarray, dynamic=False, mask_fn=None
    ) -> Selection:
        bf = Bitfield.from_bools(atom_mask)
        sel = Selection(bf, [bf.indices()] if bf.any() else [], "atom",
                        dynamic, mask_fn)
        return self._clip_to_context(sel)

    def _clip_to_context(self, sel: Selection) -> Selection:
        """Inside an `in` context, selections restrict to the context mask
        (per structure at residue level); a per-frame mask intersects the
        context's on the device."""
        if self.context is None:
            return sel
        m = sel.mask & self.context.mask
        mfn = None
        if sel.mask_fn is not None:
            ctx = self.bools(self.context)
            inner = sel.mask_fn
            mfn = lambda x, b, i: inner(x, b, i) & ctx  # noqa: E731
        if sel.level == "residue":
            keep = m.to_bools()
            structures = [s[keep[s]] for s in sel.structures]
            structures = [s for s in structures if s.size]
            return Selection(m, structures, sel.level, sel.dynamic, mfn)
        idx = m.indices()
        return Selection(m, [idx] if idx.size else [], sel.level,
                         sel.dynamic, mfn)

    def frame_mask(self, sel: Selection) -> torch.Tensor:
        """(n,) bool mask of a dynamic selection on the frame being walked."""
        return sel.mask_fn(self._x, self._basis, self._inv)

    def position_of(self, v, node) -> torch.Tensor:
        """An argument as a (3,) position on this frame: an int is a 1-based
        atom index (outside `in`), a selection its mass-weighted COM (per
        frame for a dynamic selection), a coordinate DynValue itself."""
        x = self._x
        if isinstance(v, int):
            return x[self._resolve_atom_index(v, node)]
        if isinstance(v, Selection):
            if not (v.dynamic and v.mask_fn is not None):
                self.static_warn(v, "position")
            return self.com_of(v)
        if isinstance(v, DynValue) and v.is_coord:
            return v.data
        raise ScriptError(
            "expected an atom index, selection, or position",
            node.line, node.col,
        )

    def _resolve_atom_index(self, i: int, node) -> int:
        if self.context is not None:
            raise ScriptError(
                "atom-index arguments inside 'in' must be used by a mappable "
                "function (distance/angle/dihedral)",
                node.line, node.col,
            )
        if not (1 <= i <= self.n):
            raise ScriptError(
                f"atom index {i} out of range [1,{self.n}]", node.line, node.col
            )
        return i - 1

    def com_of(self, sel: Selection) -> torch.Tensor:
        """Mass-weighted PBC-aware COM (3,) of a selection on this frame: of
        its per-frame mask when it has one (dense over every atom, as the
        JAX package sums), else of its atoms, gathered."""
        x, b, ib = self._x, self._basis, self._inv
        if sel.dynamic and sel.mask_fn is not None:
            w = self.frame_mask(sel).to(torch.float32) * self.masses_t
            return com_ops.com(x, w, b, ib)
        idx, w = self.gathered(sel)
        return com_ops.com(x[idx], w, b, ib)

    def gathered(self, sel: Selection):
        """(idx (k,) int64, masses (k,)) device tensors of a static
        selection's atoms."""

        def make():
            idx = sel.mask.indices()
            return self.tensor(idx, torch.int64), self.tensor(self.masses[idx])

        return self.memo(sel, "gathered", make)

    def dense_weights(self, sel: Selection, masses=True) -> np.ndarray:
        w = np.zeros(self.n, np.float32)
        idx = sel.mask.indices()
        w[idx] = self.masses[idx] if masses else 1.0
        return w

    def side(self, sel: Selection):
        """(idx, mask) of a selection as one side of an all-pairs reduction:
        a dynamic selection is every atom and this frame's mask, a static
        one its atoms and no mask."""
        if sel.dynamic and sel.mask_fn is not None:
            return self.all_atoms, self.frame_mask(sel)
        return self.indices(sel), None

    def static_warn(self, sel: Selection, what: str):
        """Record that a dynamic selection is consumed by a static-only
        path (reference-frame freeze)."""
        if sel.dynamic:
            msg = (f"{what}: dynamic selection evaluated on the reference "
                   "frame (static path)")
            if msg not in self.warnings:
                self.warnings.append(msg)

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


_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def _compose_mask_fns(c: _Compiler, op: str, a: Selection, b: Selection):
    """Per-frame mask for a boolean combination of selections, when at
    least one side recomputes per frame; a static side takes part as its
    device mask."""
    if a.mask_fn is None and b.mask_fn is None:
        return None

    def side(s: Selection):
        if s.mask_fn is not None:
            return s.mask_fn
        const = c.bools(s)
        return lambda x, bs, i: const

    fa, fb = side(a), side(b)
    if op == "and":
        return lambda x, bs, i: fa(x, bs, i) & fb(x, bs, i)
    return lambda x, bs, i: fa(x, bs, i) | fb(x, bs, i)


def _require_atoms(name: str, node, *sels):
    """Empty selections are rejected at compile time with a located error
    (the reductions would give inf / garbage on zero atoms)."""
    for s in sels:
        if s.mask.popcount() == 0:
            raise ScriptError(
                f"{name}: selection matches no atoms", node.line, node.col
            )


# ---------------------------------------------------------------------------
# builtin registry
# ---------------------------------------------------------------------------

BUILTINS: dict[str, Callable] = {}
NULLARY: dict[str, Callable] = {}
_SPAN_NAMES: dict[str, str] = {}


def _span_name(func: str) -> str:
    """'script.<func>', made once per builtin name, so a call's span
    allocates nothing while tracing is off."""
    name = _SPAN_NAMES.get(func)
    if name is None:
        name = _SPAN_NAMES[func] = "script." + func
    return name


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


# -- nullary selections ------------------------------------------------------


@nullary("all")
def _all(c: _Compiler, node):
    if c.context is not None:
        return c.context
    return Selection(
        Bitfield.full(c.n), [np.arange(c.n, dtype=np.int32)], "system"
    )


@nullary("atoms")
def _atoms_all(c: _Compiler, node):
    base = c.context.mask.indices() if c.context else np.arange(c.n)
    return Selection(
        Bitfield.from_indices(c.n, base),
        [np.asarray([i], np.int32) for i in base],
        "atom",
    )


@nullary("residues")
def _residues_all(c: _Compiler, node):
    return c.residue_selection(np.ones(c.sys.nres, bool))


@nullary("chains")
def _chains_all(c: _Compiler, node):
    offs = c.sys.chain_offsets
    structures = [
        np.arange(offs[ci], offs[ci + 1], dtype=np.int32)
        for ci in range(c.sys.nchains)
    ]
    return c._clip_to_context(Selection(Bitfield.full(c.n), structures, "chain"))


def _flag_nullary(flag):
    def fn(c: _Compiler, node):
        return c.atom_selection((c.sys.flags & flag) != 0)

    return fn


NULLARY["water"] = _flag_nullary(S.FLAG_WATER)
NULLARY["ion"] = _flag_nullary(S.FLAG_ION)
NULLARY["protein"] = _flag_nullary(S.FLAG_AMINO)
NULLARY["nucleic"] = _flag_nullary(S.FLAG_NUCLEIC)
NULLARY["backbone"] = _flag_nullary(S.FLAG_BACKBONE)
NULLARY["sidechain"] = _flag_nullary(S.FLAG_SIDECHAIN)
NULLARY["hetero"] = _flag_nullary(S.FLAG_HETERO)


# -- selection functions -----------------------------------------------------


def _match_labels(table, patterns) -> set[int]:
    """Label-table ids matching any of the (glob-capable) string patterns."""
    out = set()
    for pat in patterns:
        if not isinstance(pat, str):
            raise TypeError(f"expected string, got {pat!r}")
        for i, lab in enumerate(table.labels):
            if lab == pat or fnmatch.fnmatchcase(lab.upper(), pat.upper()):
                out.add(i)
    return out


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


@builtin("name")
def _name(c: _Compiler, node, args):
    ids = _match_labels(c.sys.atom_names, args)
    return c.atom_selection(np.isin(c.sys.atom_name_id, list(ids)))


BUILTINS["type"] = _name
BUILTINS["label"] = _name


@builtin("resname")
def _resname(c: _Compiler, node, args):
    ids = _match_labels(c.sys.res_names, args)
    return c.residue_selection(np.isin(c.sys.res_name_id, list(ids)))


@builtin("resid")
def _resid(c: _Compiler, node, args):
    res_mask = np.zeros(c.sys.nres, bool)
    rid = c.sys.res_id
    for a in args:
        if isinstance(a, int):
            res_mask |= rid == a
        elif isinstance(a, IRange):
            beg = a.beg if a.beg is not None else int(rid.min())
            end = a.end if a.end is not None else int(rid.max())
            res_mask |= (rid >= beg) & (rid <= end)
        else:
            raise ScriptError("resid: expects ints/ranges", node.line, node.col)
    return c.residue_selection(res_mask)


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


def _chain_selection(c: _Compiler, chosen: np.ndarray, dynamic=False) -> Selection:
    offs = c.sys.chain_offsets
    structures = [
        np.arange(offs[ci], offs[ci + 1], dtype=np.int32)
        for ci in np.nonzero(chosen)[0]
    ]
    mask = Bitfield.from_indices(
        c.n, np.concatenate(structures) if structures else []
    )
    return c._clip_to_context(Selection(mask, structures, "chain", dynamic))


@builtin("chain")
def _chain(c: _Compiler, node, args):
    chosen = np.zeros(c.sys.nchains, bool)
    for a in args:
        if isinstance(a, str):
            ids = _match_labels(c.sys.chain_labels, [a])
            chosen |= np.isin(c.sys.chain_id, list(ids))
        elif isinstance(a, int):
            if 1 <= a <= c.sys.nchains:
                chosen[a - 1] = True
        elif isinstance(a, IRange):
            beg = (a.beg or 1) - 1
            end = a.end if a.end is not None else c.sys.nchains
            chosen[beg:end] = True
    return _chain_selection(c, chosen)


@builtin("atom")
def _atom(c: _Compiler, node, args):
    """1-based atom indices/ranges (context-relative inside `in`)."""
    mask = np.zeros(c.n, bool)
    if c.context is None:
        for a in args:
            if isinstance(a, int):
                mask[c._resolve_atom_index(a, node)] = True
            elif isinstance(a, IRange):
                beg = (a.beg or 1) - 1
                end = a.end if a.end is not None else c.n
                mask[beg:end] = True
    else:
        for s in c.context.structures:
            for a in args:
                if isinstance(a, int):
                    if 1 <= a <= len(s):
                        mask[s[a - 1]] = True
                elif isinstance(a, IRange):
                    beg = (a.beg or 1) - 1
                    end = a.end if a.end is not None else len(s)
                    mask[s[beg:end]] = True
    bf = Bitfield.from_bools(mask)
    return Selection(bf, [bf.indices()] if bf.any() else [], "atom")


@builtin("atoms")
def _atoms(c: _Compiler, node, args):
    """atoms(sel|indices): one structure per atom, so `prop in atoms(...)`
    maps per atom (VIAMD ext/ImGuiColorTextEdit/TextEditor.cpp:3320)."""
    dynamic = False
    if not args:
        mask = np.ones(c.n, bool)
    else:
        mask = np.zeros(c.n, bool)
        rest = []
        for a in args:
            if isinstance(a, Selection):
                mask |= a.mask.to_bools()
                dynamic |= a.dynamic
            else:
                rest.append(a)
        if rest:
            mask |= _atom(c, node, rest).mask.to_bools()
    bf = Bitfield.from_bools(mask)
    sel = Selection(
        bf, [np.array([i], np.int32) for i in bf.indices()], "atom", dynamic
    )
    return c._clip_to_context(sel)


def _promoted_res_mask(c: _Compiler, sel: Selection) -> np.ndarray:
    res_mask = np.zeros(c.sys.nres, bool)
    idx = sel.mask.indices()
    if idx.size:
        res_mask[c.sys.atom_res_idx[idx]] = True
    return res_mask


@builtin("residues")
def _residues(c: _Compiler, node, args):
    """residues(sel|indices): the residues touched, one structure each; a
    selection promotes to whole residues, ranges behave like residue()."""
    if not args:
        return c.residue_selection(np.ones(c.sys.nres, bool))
    res_mask = np.zeros(c.sys.nres, bool)
    dynamic = False
    rest = []
    for a in args:
        if isinstance(a, Selection):
            res_mask |= _promoted_res_mask(c, a)
            dynamic |= a.dynamic
        else:
            rest.append(a)
    if rest:
        res_mask |= _promoted_res_mask(c, _residue(c, node, rest))
    return c.residue_selection(res_mask, dynamic=dynamic)


@builtin("chains")
def _chains(c: _Compiler, node, args):
    """chains(sel|ids|indices): the chains touched, one structure each; a
    selection promotes to whole chains, the rest behave like chain()."""
    chosen = np.zeros(c.sys.nchains, bool)
    dynamic = False
    rest = []
    if not args:
        chosen[:] = True
    for a in args:
        if isinstance(a, Selection):
            ci = c.sys.atom_chain_idx[a.mask.indices()]
            chosen[ci[ci >= 0]] = True
            dynamic |= a.dynamic
        else:
            rest.append(a)
    if rest:
        ci = c.sys.atom_chain_idx[_chain(c, node, rest).mask.indices()]
        chosen[ci[ci >= 0]] = True
    return _chain_selection(c, chosen, dynamic)


# -- dynamic selections --------------------------------------------------------


def _within_reference(c: _Compiler, idx: np.ndarray, cut: float) -> np.ndarray:
    """(n,) bool: atoms within `cut` of the atoms `idx` on the reference
    frame, on the host — a periodic KD-tree on an orthorhombic cell, else a
    float64 pass chunked at (1 << 24) // |idx| queries (JAX
    compiler.py:1048-1079)."""
    x = c.x0
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if c.sys.cell.is_orthorhombic and cKDTree is not None:
        box = np.asarray(c.sys.cell.extent(), np.float64)
        xw = np.mod(x.astype(np.float64), box)  # boxsize requires [0, L)
        # np.mod(-1e-16, L) == L exactly — boxsize requires strictly < L
        xw[xw >= box] = 0.0
        tree = cKDTree(xw[idx], boxsize=box)
        return np.asarray(tree.query_ball_point(xw, r=cut, return_length=True)) > 0
    mask = np.zeros(c.n, bool)
    xs = x[idx].astype(np.float64)
    B = np.asarray(c.basis0, np.float64)
    Iv = np.asarray(c.inv_basis0, np.float64)
    periodic = bool(np.abs(np.linalg.det(B)) > 1e-12)
    chunk = max(1, (1 << 24) // max(idx.size, 1))
    for beg in range(0, c.n, chunk):
        d = x[beg : beg + chunk, None, :].astype(np.float64) - xs[None]
        if periodic:
            f = d @ Iv
            f -= np.round(f)
            d = f @ B
        mask[beg : beg + chunk] = (d * d).sum(-1).min(axis=1) <= cut * cut
    return mask


@builtin("within")
def _within(c: _Compiler, node, args):
    """within(cutoff, sel): atoms within cutoff Å of sel. Dynamic: the
    static mask is the reference frame's (structure decomposition); with a
    static target, `mask_fn` re-evaluates it on each frame on the device
    (geometry.within_mask, float32 d² <= cut², as JAX compiler.py:678-709)."""
    if len(args) != 2:
        raise ScriptError("within(cutoff, selection)", node.line, node.col)
    cutoff, sel = args
    if isinstance(sel, (int, float)) and isinstance(cutoff, Selection):
        cutoff, sel = sel, cutoff
    if not isinstance(sel, Selection) or not isinstance(cutoff, (int, float)):
        raise ScriptError("within(cutoff, selection)", node.line, node.col)
    idx = sel.mask.indices()
    if not idx.size:
        return c.atom_selection(np.zeros(c.n, bool), dynamic=True)
    cut = float(cutoff)
    mask = _within_reference(c, idx, cut)
    if sel.dynamic:
        # a per-frame target would need a per-frame candidate set: the
        # target stays the reference frame's
        c.warnings.append(
            "within(): dynamic target selection — target evaluated on the "
            "reference frame"
        )
        mfn = None
    else:
        tgt = c.tensor(idx, torch.int64)
        mfn = lambda x, b, i: geom_ops.within_mask(x, tgt, cut, b, i)  # noqa: E731
    return c.atom_selection(mask, dynamic=True, mask_fn=mfn)


def _axis_sel(axis):
    def fn(c: _Compiler, node, args):
        if len(args) != 1 or not isinstance(args[0], (IRange, FRange)):
            raise ScriptError(
                f"{'xyz'[axis]}(min:max) expects a range", node.line, node.col
            )
        r = args[0]
        v = c.x0[:, axis]
        lo = r.beg if r.beg is not None else -np.inf
        hi = r.end if r.end is not None else np.inf
        flo, fhi = float(np.float32(lo)), float(np.float32(hi))
        mfn = lambda x, b, i: (x[:, axis] >= flo) & (x[:, axis] <= fhi)  # noqa: E731
        return c.atom_selection((v >= lo) & (v <= hi), dynamic=True, mask_fn=mfn)

    return fn


BUILTINS["x"] = _axis_sel(0)
BUILTINS["y"] = _axis_sel(1)
BUILTINS["z"] = _axis_sel(2)


@builtin("count")
def _count(c: _Compiler, node, args):
    sel = c._as_selection(args[0] if args else None, node)
    if sel.dynamic and sel.mask_fn is not None:
        # per frame, e.g. count(within(5, resname("LIG")))
        return DynValue(c.frame_mask(sel).to(torch.float32).sum())
    c.static_warn(sel, "count")
    return DynValue(c.memo(sel, "count", lambda: c.tensor(np.float32(sel.mask.popcount()))))


# -- geometry ----------------------------------------------------------------


def _mapped_indices(c: _Compiler, args, node, arity):
    """Atom-index arguments → `arity` (S,) global index arrays: one per
    context structure inside `in` (1-based within each structure), else
    one; None when the arguments are not all atom indices."""
    if not all(isinstance(a, int) for a in args):
        return None
    if len(args) != arity:
        raise ScriptError(f"expected {arity} atom indices", node.line, node.col)
    if c.context is None:
        return [np.asarray([c._resolve_atom_index(a, node)], np.int32) for a in args]
    out = [[] for _ in range(arity)]
    for s in c.context.structures:
        for k, a in enumerate(args):
            if not (1 <= a <= len(s)):
                raise ScriptError(
                    f"relative atom index {a} out of range for a structure "
                    f"of {len(s)} atoms",
                    node.line, node.col,
                )
            out[k].append(s[a - 1])
    return [np.asarray(o, np.int32) for o in out]


def _index_form(c: _Compiler, node, args, arity: int, vis: str):
    """The index tensors of a geometry call in its atom-index form (with
    its visualisation entries), or None for the position form; once per
    call site."""

    def prepare():
        idx = _mapped_indices(c, args, node, arity)
        if idx is None:
            return None
        c.vis[vis].extend(zip(*(i.tolist() for i in idx)))
        return [c.tensor(i, torch.int64) for i in idx]

    return c._cached(node, prepare)


def _one_or_all(v: torch.Tensor) -> torch.Tensor:
    return v[0] if v.shape[0] == 1 else v


@builtin("distance")
def _distance(c: _Compiler, node, args):
    if len(args) != 2:
        raise ScriptError("distance(a, b)", node.line, node.col)
    x, b, ib = c._x, c._basis, c._inv
    idx = _index_form(c, node, args, 2, "lines")
    if idx is not None:
        return DynValue(_one_or_all(geom_ops.distance(x, *idx, b, ib)), unit="Å")
    dv = pbc_ops.min_image(c.position_of(args[0], node) - c.position_of(args[1], node),
                           b, ib)
    return DynValue(torch.sqrt((dv * dv).sum().clamp_min(0.0)), unit="Å")


def _distance_extreme(name: str, which: int):
    def fn(c: _Compiler, node, args):
        a = c._as_selection(args[0], node)
        bsel = c._as_selection(args[1], node)
        _require_atoms(name, node, a, bsel)
        (ia, ma), (ib, mb) = c.side(a), c.side(bsel)
        d = geom_ops.distance_min_max(c._x, ia, ib, c._basis, c._inv, ma, mb)
        return DynValue(d[which], unit="Å")

    BUILTINS[name] = fn


_distance_extreme("distance_min", 0)
_distance_extreme("distance_max", 1)


@builtin("distance_pair")
def _distance_pair(c: _Compiler, node, args):
    a = c._as_selection(args[0], node)
    bsel = c._as_selection(args[1], node)
    _require_atoms("distance_pair", node, a, bsel)
    c.static_warn(a, "distance_pair")
    c.static_warn(bsel, "distance_pair")
    na, nb = a.mask.popcount(), bsel.mask.popcount()
    if na * nb > DISTANCE_PAIR_MAX:
        raise ScriptError(
            f"distance_pair: {na}×{nb} pairs is too many for a "
            f"temporal property (cap {DISTANCE_PAIR_MAX})",
            node.line, node.col,
        )
    x = c._x
    d = pbc_ops.pair_distances(x[c.indices(a)], x[c.indices(bsel)], c._basis, c._inv)
    return DynValue(d.reshape(-1), unit="Å")


def _positions(c: _Compiler, node, args, arity: int) -> list:
    """The position form's `arity` points. Past the arguments given, the
    last one repeats: the JAX package gathers them from a stack, and its
    gather clamps the index."""
    p = torch.stack([c.position_of(a, node) for a in args])
    return [p[min(k, p.shape[0] - 1)] for k in range(arity)]


@builtin("angle")
def _angle(c: _Compiler, node, args):
    b, ib = c._basis, c._inv
    idx = _index_form(c, node, args, 3, "angles")
    if idx is None:
        p = _positions(c, node, args, 3)
        a = geom_ops.vector_angle(pbc_ops.min_image(p[0] - p[1], b, ib),
                                  pbc_ops.min_image(p[2] - p[1], b, ib))
        return DynValue(a * RAD2DEG, unit="deg")
    return DynValue(_one_or_all(geom_ops.angle(c._x, *idx, b, ib) * RAD2DEG), unit="deg")


@builtin("dihedral")
def _dihedral(c: _Compiler, node, args):
    b, ib = c._basis, c._inv
    idx = _index_form(c, node, args, 4, "dihedrals")
    if idx is None:
        p = _positions(c, node, args, 4)
        d = geom_ops.bond_dihedral(*(pbc_ops.min_image(p[k + 1] - p[k], b, ib)
                                     for k in range(3)))
        return DynValue(d * RAD2DEG, unit="deg")
    return DynValue(_one_or_all(geom_ops.dihedral(c._x, *idx, b, ib) * RAD2DEG),
                    unit="deg")


@builtin("com")
def _com(c: _Compiler, node, args):
    # com(): all (the context inside `in`), one Selection per call site
    sel = c._as_selection(
        args[0] if args else c.memo(node, "all", lambda: NULLARY["all"](c, node)), node
    )
    _require_atoms("com", node, sel)
    x, b, ib = c._x, c._basis, c._inv
    if c.context is not None and c.context.n_structures > 1:
        # per context structure: the COM of (structure ∩ sel)
        def prepare():
            idx, w = Selection(sel.mask, c.context.structures, "atom").packed(c.masses)
            w = w * sel.mask.to_bools()[idx]
            c.static_warn(sel, "com (structure context)")
            return c.tensor(idx, torch.int64), c.tensor(w)

        idx, w = c._cached(node, prepare)
        return DynValue(com_ops.com(x[idx], w, b, ib), unit="Å", is_coord=True)
    return DynValue(c.com_of(sel), unit="Å", is_coord=True)


@builtin("plane")
def _plane(c: _Compiler, node, args):
    """Best-fit plane of a selection → (nx, ny, nz, d) coefficients."""
    sel = c._as_selection(args[0], node)
    _require_atoms("plane", node, sel)
    c.static_warn(sel, "plane")
    idx, w = c.gathered(sel)
    cm, _, vecs = cov_ops.principal_axes(c._x[idx], w, c._basis, c._inv)
    normal = vecs[:, 2]  # smallest-eigenvalue axis
    return DynValue(torch.cat([normal, -(normal * cm).sum()[None]]), unit="")


@builtin("rmsd")
def _rmsd(c: _Compiler, node, args):
    """Mass-weighted RMSD against the reference frame after Kabsch
    superposition: one per context structure inside `in` (one batched
    closed-form solve), else one over the selection."""
    sel = c._as_selection(args[0], node)
    _require_atoms("rmsd", node, sel)
    c.static_warn(sel, "rmsd")

    def prepare():
        if c.context is not None and c.context.n_structures > 1:
            idx, w = Selection(sel.mask, c.context.structures, "atom").packed(c.masses)
        else:
            i = sel.mask.indices()
            idx, w = i[None], c.masses[i][None]
        return (c.tensor(idx, torch.int64), c.tensor(w),
                c.tensor(c.x0[idx]), idx.shape[0] == 1)

    idx, w, ref, single = c._cached(node, prepare)
    v = rmsd_ops.rmsd(c._x[idx], ref, w, align=True)
    return DynValue(v[0] if single else v, unit="Å")


@builtin("shape_weights")
def _shape_weights(c: _Compiler, node, args):
    sel = c._as_selection(args[0], node)
    _require_atoms("shape_weights", node, sel)
    c.static_warn(sel, "shape_weights")

    def prepare():
        structs = sel.structures if sel.n_structures > 1 else None
        if c.context is not None and c.context.n_structures > 1:
            structs = c.context.structures
        if structs is None:
            return None, c.tensor(c.dense_weights(sel))
        idx, w = Selection(sel.mask, structs, sel.level).packed(c.masses)
        return c.tensor(idx, torch.int64), c.tensor(w)

    idx, w = c._cached(node, prepare)
    x = c._x if idx is None else c._x[idx]  # (n, 3) or (S, K, 3)
    return DynValue(cov_ops.shape_weights(x, w, c._basis, c._inv), unit="")


@builtin("rdf")
def _rdf(c: _Compiler, node, args):
    if len(args) != 3:
        raise ScriptError("rdf(sel_a, sel_b, cutoff)", node.line, node.col)
    a = c._as_selection(args[0], node)
    b = c._as_selection(args[1], node)
    cutoff = float(args[2])
    if any(s.dynamic and s.mask_fn is not None for s in (a, b)):
        return _rdf_dynamic(c, node, a, b, cutoff)

    def prepare():
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
    elif c.atom_shard is not None:
        hist = pair_dist_histogram_cl_sharded(
            c._x, ia, ib, c._basis, c._inv, RDF_BINS, cutoff, grid.dims,
            *c.atom_shard, fractional=grid.fractional, radius=grid.radius,
        )
    else:
        hist = pair_dist_histogram_cl(
            c._x, ia, ib, c._basis, c._inv, RDF_BINS, cutoff, grid.dims,
            fractional=grid.fractional, radius=grid.radius,
        )
    return AccumValue(hist, spec)


def _rdf_dynamic(c: _Compiler, node, a: Selection, b: Selection, cutoff: float):
    """rdf with a per-frame side: the all-pairs histogram of this frame's
    0/1 weights (a dynamic side is every atom and its mask, a static side
    its atoms), normalised by the frame's own pair count, so the spec's
    counts are 1 (JAX compiler.py:1374-1400)."""

    def prepare():
        c.routes.append("rdf:dynamic")
        spec = AccumSpec(
            kind="distribution", nbins=RDF_BINS, r_min=0.0, r_max=cutoff,
            x_unit="Å", count_a=1.0, count_b=1.0,
        )
        return spec

    spec = c._cached(node, prepare)
    sides = []
    for s in (a, b):
        idx, m = c.side(s)
        w = (m.to(torch.float32) if m is not None
             else c.memo(s, "ones", lambda s=s: c.tensor(np.ones(s.mask.popcount(), np.float32))))
        sides.append((idx, w))
    (ia, wa), (ib, wb) = sides
    hist = pair_dist_histogram_dynamic(
        c._x, ia, ib, wa, wb, c._basis, c._inv, RDF_BINS, cutoff
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
        c.static_warn(ref_sel, "sdf (reference structures)")
        c.static_warn(target, "sdf (target)")
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


# -- math --------------------------------------------------------------------


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: the real cube root through float64
    return (torch.sign(v) * v.abs().to(torch.float64).pow(1.0 / 3.0)).to(v.dtype)


def _math1(tfn, nfn):
    def fn(c: _Compiler, node, args):
        (v,) = args
        if isinstance(v, (int, float, np.ndarray)):
            return nfn(v)
        if isinstance(v, DynValue):
            return DynValue(tfn(v.data), v.unit)
        raise ScriptError("expected numeric argument", node.line, node.col)

    return fn


for _nm, _tf, _nf in [
    ("sqrt", torch.sqrt, np.sqrt),
    ("cbrt", _cbrt, np.cbrt),
    ("abs", torch.abs, np.abs),
    ("floor", torch.floor, np.floor),
    ("ceil", torch.ceil, np.ceil),
    ("cos", torch.cos, np.cos),
    ("sin", torch.sin, np.sin),
    ("tan", torch.tan, np.tan),
    ("asin", torch.asin, np.arcsin),
    ("acos", torch.acos, np.arccos),
    ("atan", torch.atan, np.arctan),
    ("log", torch.log, np.log),
    ("exp", torch.exp, np.exp),
    ("log2", torch.log2, np.log2),
    ("exp2", torch.exp2, np.exp2),
    ("log10", torch.log10, np.log10),
]:
    BUILTINS[_nm] = _math1(_tf, _nf)


def _operand(c: _Compiler, v, like: torch.Tensor) -> torch.Tensor:
    """A builtin's argument as a tensor beside a per-frame value `like`."""
    if isinstance(v, DynValue):
        return v.data
    if isinstance(v, np.ndarray):
        return c.const(v)
    return like.new_full((), float(v))


def _math2(tfn, nfn):
    def fn(c: _Compiler, node, args):
        a, b = args
        if isinstance(a, DynValue) or isinstance(b, DynValue):
            like = (a if isinstance(a, DynValue) else b).data
            return DynValue(tfn(_operand(c, a, like), _operand(c, b, like)))
        return nfn(a, b)

    return fn


BUILTINS["pow"] = _math2(torch.pow, np.power)
BUILTINS["atan2"] = _math2(torch.atan2, np.arctan2)
BUILTINS["mul"] = _math2(torch.mul, np.multiply)


@builtin("import")
def _import(c: _Compiler, node, args):
    """import("table.xvg"/".csv"/".edr") → static (ncols, nrows) float32
    column array (VIAMD viamd.h:86 SCRIPT_IMPORT_FILE_EXTENSIONS,
    viamd.cpp:2833-2858)."""
    (path,) = args
    if not isinstance(path, str):
        raise ScriptError("import(path)", node.line, node.col)
    if path.endswith(".edr"):
        from viamd_tpu_torch.io.edr import read_edr

        cols, _names = read_edr(path)
    elif path.endswith(".xvg"):
        from viamd_tpu_torch.io.xvg import read_xvg

        cols, _meta = read_xvg(path)
    elif path.endswith(".csv"):
        from viamd_tpu_torch.io.csv import read_csv

        cols, _hdr = read_csv(path)
    else:
        raise ScriptError(f"import: unsupported file '{path}'", node.line, node.col)
    return np.asarray(cols, np.float32)


def _vector_args(c: _Compiler, node, args):
    """The two arguments of dot/cross as float32 tensors; static ones are
    device constants."""
    a, b = args
    out = []
    for v in (a, b):
        if isinstance(v, DynValue):
            out.append(v.data.to(torch.float32))
        else:
            out.append(c.const(v, np.float32))
    return out


@builtin("dot")
def _dot(c, node, args):
    av, bv = _vector_args(c, node, args)
    prod = av * bv
    if prod.ndim == 0:
        raise ValueError("dot: expects vectors")
    return DynValue(prod.sum(-1))


@builtin("cross")
def _cross(c, node, args):
    av, bv = _vector_args(c, node, args)
    if av.ndim == 0 or bv.ndim == 0 or av.shape[-1] not in (2, 3) or bv.shape[-1] != av.shape[-1]:
        raise ValueError("cross: expects two vectors of 2 or 3 components")
    if av.shape[-1] == 2:
        return DynValue(av[..., 0] * bv[..., 1] - av[..., 1] * bv[..., 0])
    av, bv = torch.broadcast_tensors(av, bv)
    return DynValue(torch.linalg.cross(av, bv))


def _vecn(n):
    def fn(c, node, args):
        if len(args) != n:
            raise ScriptError(f"vec{n} expects {n} args", node.line, node.col)
        like = next((a.data for a in args if isinstance(a, DynValue)), None)
        if like is None:  # all static: one device constant
            vals = np.stack([np.float32(a) for a in args], axis=-1)
            return DynValue(c._cached(node, lambda: c.tensor(vals)), is_coord=(n == 3))
        vals = [_operand(c, a, like).to(torch.float32) for a in args]
        return DynValue(torch.stack(vals, dim=-1), is_coord=(n == 3))

    return fn


BUILTINS["vec2"] = _vecn(2)
BUILTINS["vec3"] = _vecn(3)
BUILTINS["vec4"] = _vecn(4)
