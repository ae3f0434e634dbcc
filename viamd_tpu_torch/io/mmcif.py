"""PDBx/mmCIF structure loader — numpy copy of viamd_tpu.io.mmcif.

Capability mirror of mdlib's md_mmcif.h (dispatched at
VIAMD src/loader.cpp (cif → System|MM)).

Parses the `_atom_site` loop (the structural payload) plus the `_cell`
block for the unit cell. Columns are resolved by tag name so any column
order works; quoted tokens and multi-line values are handled for the
fields that matter here.
"""

from __future__ import annotations

import shlex

import numpy as np

from viamd_tpu_torch.core.system import System, build_system, postprocess
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.core import elements as E


def _split_cif_line(line: str) -> list[str]:
    """CIF tokenization: whitespace-separated, '...'/"..." quoting."""
    if "'" not in line and '"' not in line:
        return line.split()
    try:
        lex = shlex.shlex(line, posix=True)
        lex.whitespace_split = True
        lex.commenters = "#"
        return list(lex)
    except ValueError:
        return line.split()


def parse_mmcif(text: str | bytes) -> System:
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    lines = text.splitlines()

    cell_vals: dict[str, float] = {}
    atom_cols: list[str] = []
    atom_rows: list[list[str]] = []
    # assembly machinery (mmCIF path of the reference loader,
    # loader.cpp:141 → md_mmcif; instances per viamd.h:1560-1570)
    _ASM_CATS = ("_pdbx_struct_assembly_gen", "_pdbx_struct_oper_list")
    asm_loops: dict[str, tuple[list[str], list[list[str]]]] = {}
    asm_kv: dict[str, str] = {}  # single-row (non-loop) presentation

    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if line.startswith("_cell."):
            parts = line.split(None, 1)
            if len(parts) == 2:
                try:
                    cell_vals[parts[0]] = float(parts[1].split("(")[0])
                except ValueError:
                    pass
            i += 1
        elif line.startswith(_ASM_CATS) and "." in line:
            parts = _split_cif_line(line)
            if len(parts) >= 2:
                asm_kv[parts[0]] = parts[1]
            i += 1
        elif line == "loop_":
            # collect tags
            i += 1
            tags = []
            while i < n and lines[i].strip().startswith("_"):
                tags.append(lines[i].strip().split()[0])
                i += 1
            cat = tags[0].split(".", 1)[0] if tags and "." in tags[0] else ""
            if tags and (tags[0].startswith("_atom_site.")
                         or cat in _ASM_CATS):
                cols = [t.split(".", 1)[1] if "." in t else t for t in tags]
                rows: list[list[str]] = []
                while i < n:
                    row = lines[i].strip()
                    if (
                        not row
                        or row.startswith("#")
                        or row.startswith("_")
                        or row == "loop_"
                        or row.startswith("data_")
                    ):
                        break
                    toks = _split_cif_line(row)
                    if len(toks) >= len(cols):
                        rows.append(toks[: len(cols)])
                    i += 1
                if tags[0].startswith("_atom_site."):
                    atom_cols, atom_rows = cols, rows
                else:
                    asm_loops[cat] = (cols, rows)
            # else: skip other loops' data rows
        else:
            i += 1

    if not atom_rows:
        raise ValueError("mmCIF: no _atom_site loop found")

    col = {c: k for k, c in enumerate(atom_cols)}

    def get(row, *names, default=""):
        for nm in names:
            if nm in col:
                v = row[col[nm]]
                if v not in (".", "?"):
                    return v
        return default

    natoms = len(atom_rows)
    xyz = np.empty((natoms, 3), np.float32)
    names, resnames, chains, label_asyms = [], [], [], []
    resids = np.empty(natoms, np.int32)
    zs = np.zeros(natoms, np.int32)
    occ = np.ones(natoms, np.float32)
    bfac = np.zeros(natoms, np.float32)
    for k, row in enumerate(atom_rows):
        xyz[k, 0] = float(get(row, "Cartn_x", default="0"))
        xyz[k, 1] = float(get(row, "Cartn_y", default="0"))
        xyz[k, 2] = float(get(row, "Cartn_z", default="0"))
        names.append(get(row, "label_atom_id", "auth_atom_id"))
        resnames.append(get(row, "label_comp_id", "auth_comp_id"))
        chains.append(get(row, "auth_asym_id", "label_asym_id"))
        label_asyms.append(get(row, "label_asym_id", "auth_asym_id"))
        rid = get(row, "auth_seq_id", "label_seq_id", default="0")
        try:
            resids[k] = int(rid)
        except ValueError:
            resids[k] = 0
        sym = get(row, "type_symbol")
        if sym:
            zs[k] = E.symbol_to_z(sym)
        try:
            occ[k] = float(get(row, "occupancy", default="1"))
            bfac[k] = float(get(row, "B_iso_or_equiv", default="0"))
        except ValueError:
            pass

    cell = UnitCell.none()
    if "_cell.length_a" in cell_vals:
        cell = UnitCell.from_lengths_angles(
            cell_vals.get("_cell.length_a", 0.0),
            cell_vals.get("_cell.length_b", 0.0),
            cell_vals.get("_cell.length_c", 0.0),
            cell_vals.get("_cell.angle_alpha", 90.0),
            cell_vals.get("_cell.angle_beta", 90.0),
            cell_vals.get("_cell.angle_gamma", 90.0),
        )

    sys = build_system(
        coords=xyz,
        atom_names=names,
        res_names=resnames,
        res_ids=resids,
        chain_ids=chains,
        elements_z=zs,
        cell=cell,
        occupancy=occ,
        bfactor=bfac,
    )
    sys.instances = _build_instances(asm_loops, asm_kv, label_asyms)
    return postprocess(sys)


def _rows_of(asm_loops, asm_kv, cat: str) -> list[dict[str, str]]:
    """Category rows from either loop_ or single-row key-value form."""
    if cat in asm_loops:
        cols, rows = asm_loops[cat]
        return [dict(zip(cols, r)) for r in rows]
    kv = {
        k.split(".", 1)[1]: v
        for k, v in asm_kv.items()
        if k.startswith(cat + ".")
    }
    return [kv] if kv else []


def _expand_oper_expression(expr: str) -> list[str]:
    """Operator id list from a _pdbx_struct_assembly_gen.oper_expression.

    Handles "1", "1,2,5", "(1-4)", "(1,3)". Cartesian products
    "(1-8)(9-16)" collapse to the FIRST factor (the reference's md_mmcif
    has the same practical ceiling for generated assemblies)."""
    expr = expr.strip()
    if ")(" in expr:
        expr = expr.split(")(", 1)[0]
    expr = expr.strip("()")
    out: list[str] = []
    for part in expr.split(","):
        part = part.strip()
        if "-" in part:
            try:
                a, b = part.split("-", 1)
                out.extend(str(k) for k in range(int(a), int(b) + 1))
                continue
            except ValueError:
                pass
        if part:
            out.append(part)
    return out


def _build_instances(asm_loops, asm_kv, label_asyms):
    """InstanceTable from _pdbx_struct_assembly_gen × _pdbx_struct_oper_list
    (the mmCIF assembly path of loader.cpp:141; instance table semantics of
    viamd.h:1560-1570). Returns None when the file carries no assembly."""
    from viamd_tpu_torch.core.system import InstanceTable, LabelTable

    gens = _rows_of(asm_loops, asm_kv, "_pdbx_struct_assembly_gen")
    opers = _rows_of(asm_loops, asm_kv, "_pdbx_struct_oper_list")
    if not gens or not opers:
        return None

    mats: dict[str, np.ndarray] = {}
    for row in opers:
        oid = row.get("id", "1")
        T = np.eye(4, dtype=np.float32)
        try:
            for r in range(3):
                for c in range(3):
                    T[r, c] = float(row[f"matrix[{r+1}][{c+1}]"])
                T[r, 3] = float(row[f"vector[{r+1}]"])
        except (KeyError, ValueError):
            pass  # identity fallback for incomplete operators
        mats[oid] = T

    # first declared assembly only (the reference's default-assembly pick)
    first_asm = gens[0].get("assembly_id", "1")
    gens = [g for g in gens if g.get("assembly_id", "1") == first_asm]

    # contiguous runs of each label_asym_id (mmCIF guarantees grouping)
    asym_arr = np.asarray(label_asyms)
    runs: dict[str, list[tuple[int, int]]] = {}
    beg = 0
    for k in range(1, len(asym_arr) + 1):
        if k == len(asym_arr) or asym_arr[k] != asym_arr[beg]:
            runs.setdefault(str(asym_arr[beg]), []).append((beg, k))
            beg = k

    ranges, transforms, label_ids = [], [], []
    labels = LabelTable()
    for g in gens:
        asym_list = [
            a.strip() for a in g.get("asym_id_list", "").split(",") if a.strip()
        ]
        oper_ids = _expand_oper_expression(g.get("oper_expression", "1"))
        for oid in oper_ids:
            T = mats.get(oid)
            if T is None:
                continue
            for asym in asym_list:
                for b, e in runs.get(asym, []):
                    ranges.append((b, e))
                    transforms.append(T)
                    label_ids.append(labels.intern(f"{asym}·{oid}"))
    if not ranges:
        return None
    return InstanceTable(
        atom_ranges=np.asarray(ranges, np.int32),
        transforms=np.asarray(transforms, np.float32),
        label_id=np.asarray(label_ids, np.int32),
        labels=labels,
    )


def load_mmcif(path: str) -> System:
    with open(path, "r") as f:
        return parse_mmcif(f.read())
