"""Workspace (.via) persistence — reference-format compatible.

A numpy copy of viamd_tpu/app/workspace.py (host code, no device work)
over the port's Session: it writes the same bytes, so a workspace saved by
either package loads in the other.

Rebuild of the reference's workspace serialization in its EXACT dialect
(save_workspace VIAMD src/viamd.cpp:1042-1199, load_workspace
viamd.cpp:726-1040, format helpers serialization_utils.cpp):

- `[Section]` headers + `Ident=arg` lines; banner/comment lines skipped.
- Multiline string args escaped with \"\"\" fences spanning lines
  (write_str / next_entry, serialization_utils.cpp:10,40-54,95-101).
- Sections + idents written byte-for-byte like the reference writer:
  Files (MoleculeFile/TrajectoryFile/CoarseGrained), Animation
  (Frame/Fps/Interpolation), RenderSettings (Ssao*/Dof*), Camera
  (Position/Orientation/Distance/Mode), Representation (Name/Filter/
  Enabled/Type/ColorMapping/BaseColor/Saturation/Param/DynamicEval),
  Script (Text), Selection (Label/Mask), UserBonds (atoms=i,j per bond).
- Floats print with the reference's printf "%f" (6 decimals).
- Deprecated/renamed idents the reference loader still accepts are
  accepted here too (File, StaticColor, Radius/Width/Thickness, Rotation,
  AtomElementMapping), plus this rebuild's legacy round-1 dialect
  (Name= selections, base64 Script, eye/center/up Camera).

Selection masks: the reference stores `md_bitfield_serialize` output
(viamd.cpp:1184-1190). mdlib is an EMPTY submodule in the snapshot, so
that wire format is [reconstructed]: this build writes
base64("MDBF" + u32 num_bits LE + packed LSB-first bit bytes) and accepts
the ###base64### `write_bitfield` wrapper and round-1 plain base64 on
load; an undecodable mask logs a warning and skips the selection (the
reference's own failure path, serialization_utils.cpp:214-218).
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np

from viamd_tpu_torch.app.events import EventType
from viamd_tpu_torch.app.session import Representation
from viamd_tpu_torch.core import vlog
from viamd_tpu_torch.core.bitfield import Bitfield

ESC = '"""'

# RepresentationType (viamd.h:161-169; MD_GL_REP_* values [reconstructed]
# from mdlib md_gl.h ordering = representation_type_str order, viamd.h:184)
REP_TYPE_TO_INT = {
    "spacefill": 0, "licorice": 1, "ballstick": 2, "ribbons": 3,
    "cartoon": 4, "tube": 3,  # tube serializes as Ribbons
}
REP_INT_TO_TYPE = {
    0: "spacefill", 1: "licorice", 2: "ballstick", 3: "ribbons",
    4: "cartoon", 5: "spacefill", 6: "spacefill",  # 5/6: ES/dipole — no
    # QM draw pipeline on the headless session; nearest geometry
}
# ColorMapping (viamd.h:105-117)
COLOR_TO_INT = {
    "uniform": 0, "cpk": 1, "idx": 2, "resname": 3, "resid": 4,
    "residue": 5, "chain": 7, "secondary_structure": 8, "property": 9,
}
COLOR_INT_TO_STR = {
    0: "uniform", 1: "cpk", 2: "idx", 3: "resname", 4: "resid",
    5: "residue", 6: "chain", 7: "chain", 8: "secondary_structure",
    9: "property",
}
INTERP_TO_INT = {"nearest": 0, "linear": 1, "cubic": 2}
INTERP_INT_TO_STR = {0: "nearest", 1: "linear", 2: "cubic"}

HEADER = """\
#01010110#01001001#01000001#01001101#01000100#01001101#01000001#01001001#01010110#
#                                                                                #
#     viamd_tpu — TPU-native rebuild of VIAMD (workspace format-compatible)      #
#                                                                                #
#01010110#01001001#01000001#01001101#01000100#01001101#01000001#01001001#01010110#
"""


def _rel(path, base):
    if not path:
        return ""
    try:
        return os.path.relpath(path, base)
    except ValueError:
        return path


def _fmt(v: float) -> str:
    return f"{float(v):f}"  # printf %f — 6 decimals, reference writer


# -- bitfield mask wire format (reconstructed, see module docstring) ---------

def serialize_mask(bf: Bitfield) -> str:
    packed = np.packbits(bf.to_bools().astype(np.uint8), bitorder="little")
    raw = b"MDBF" + struct.pack("<I", len(bf)) + packed.tobytes()
    return base64.b64encode(raw).decode("ascii")


def deserialize_mask(arg: str, natoms: int | None = None) -> Bitfield | None:
    """Accepts this build's MDBF base64, the reference's ###...###
    write_bitfield wrapper, and round-1 plain base64 masks."""
    s = arg.strip()
    if s.startswith("###") and s.endswith("###"):
        s = s[3:-3]
    try:
        raw = base64.b64decode(s, validate=True)
    except Exception:
        return None
    if raw[:4] == b"MDBF" and len(raw) >= 8:
        (nbits,) = struct.unpack("<I", raw[4:8])
        bits = np.unpackbits(
            np.frombuffer(raw[8:], np.uint8), bitorder="little"
        )
        if bits.size < nbits:
            return None
        return Bitfield.from_bools(bits[:nbits].astype(bool))
    # round-1 dialect: Bitfield.to_base64 payload
    try:
        return Bitfield.from_base64(arg)
    except Exception:
        return None


# -- writer (serialization_utils.cpp write_* analogs) -------------------------

class WorkspaceWriter:
    def __init__(self):
        self.parts: list[str] = [HEADER]

    def section(self, name: str):
        self.parts.append(f"\n[{name}]\n")

    def write_str(self, ident: str, s: str):
        if "\n" in s:
            self.parts.append(f"{ident}={ESC}{s}{ESC}\n")
        else:
            self.parts.append(f"{ident}={s}\n")

    def write_int(self, ident: str, v: int):
        self.parts.append(f"{ident}={int(v)}\n")

    def write_bool(self, ident: str, v: bool):
        self.write_int(ident, int(bool(v)))

    def write_flt(self, ident: str, v: float):
        self.parts.append(f"{ident}={_fmt(v)}\n")

    def write_flt_vec(self, ident: str, vals):
        self.parts.append(
            f"{ident}=" + ",".join(_fmt(v) for v in vals) + "\n"
        )

    def write_int_vec(self, ident: str, vals):
        self.parts.append(
            f"{ident}=" + ",".join(str(int(v)) for v in vals) + "\n"
        )

    # round-1 compat shim (components append via .entry)
    def entry(self, ident: str, *args):
        self.parts.append(f"{ident}=" + ",".join(str(a) for a in args) + "\n")

    def text(self) -> str:
        return "".join(self.parts)


# -- parser (next_section_header / next_entry analogs) ------------------------

class Entries(dict):
    """ident→last-arg dict; `.pairs` keeps every (ident, arg) in order
    (UserBonds repeats `atoms=`)."""

    def __init__(self):
        super().__init__()
        self.pairs: list[tuple[str, str]] = []

    def add(self, ident: str, arg: str):
        self[ident] = arg
        self.pairs.append((ident, arg))


def parse_workspace(text: str) -> list[tuple[str, Entries]]:
    sections: list[tuple[str, Entries]] = []
    cur: Entries | None = None
    i = 0
    n = len(text)
    while i < n:
        nl = text.find("\n", i)
        if nl < 0:
            nl = n
        line = text[i:nl].strip()
        i = nl + 1
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = Entries()
            sections.append((line[1:-1], cur))
            continue
        eq = line.find("=")
        if eq < 0 or cur is None:
            continue
        ident = line[:eq].strip()
        arg = line[eq + 1 :].strip()
        if arg.startswith(ESC):
            # multiline string: scan forward for the closing fence
            # (next_entry, serialization_utils.cpp:40-54)
            start = text.find(ESC, i - (len(line) - eq - 1) - 1) + len(ESC)
            end = text.find(ESC, start)
            if end < 0:
                vlog.error("workspace: unbalanced multiline escape")
                break
            arg = text[start:end]
            i = text.find("\n", end + len(ESC))
            i = n if i < 0 else i + 1
        cur.add(ident, arg)
    return sections


# -- camera orientation <-> quaternion ----------------------------------------

def _quat_from_lookat(eye, center, up):
    fwd = np.asarray(center, np.float64) - np.asarray(eye, np.float64)
    dist = float(np.linalg.norm(fwd))
    if dist < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0]), 0.0
    fwd = fwd / dist
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    rn = np.linalg.norm(right)
    right = (
        right / rn if rn > 1e-12 else np.array([1.0, 0.0, 0.0])
    )
    true_up = np.cross(right, fwd)
    # camera-to-world basis, -z forward (the reference camera convention)
    m = np.stack([right, true_up, -fwd], axis=1)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        )
    else:
        k = int(np.argmax(np.diag(m)))
        i, j, l = k, (k + 1) % 3, (k + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[l, l], 0.0)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[l] = (m[l, i] + m[i, l]) / s
        q[3] = (m[l, j] - m[j, l]) / s
    return q, dist


def _lookat_from_quat(position, q, dist):
    x, y, z, w = [float(v) for v in q]
    nrm = np.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / nrm, y / nrm, z / nrm, w / nrm
    m = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    fwd = -m[:, 2]
    up = m[:, 1]
    pos = np.asarray(position, np.float64)
    return pos, pos + fwd * max(dist, 1e-6), up


# -- save ----------------------------------------------------------------------

def save_workspace(session, path: str):
    base = os.path.dirname(os.path.abspath(path))
    w = WorkspaceWriter()

    w.section("Files")
    w.write_str("MoleculeFile", _rel(session.files.get("system"), base))
    w.write_str("TrajectoryFile", _rel(session.files.get("trajectory"), base))
    w.write_int("CoarseGrained", int(getattr(session, "coarse_grained", False)))

    w.section("Animation")
    w.write_flt("Frame", session.frame)  # write_dbl — same %f text
    w.write_flt("Fps", getattr(session, "fps", 10.0))
    w.write_int(
        "Interpolation", INTERP_TO_INT.get(session.interpolation, 1)
    )

    vis = getattr(session, "visuals", {}) or {}
    w.section("RenderSettings")
    w.write_bool("SsaoEnabled", vis.get("ssao_enabled", True))
    w.write_flt("SsaoIntensity", vis.get("ssao_intensity", 3.0))
    w.write_flt("SsaoRadius", vis.get("ssao_radius", 6.0))
    w.write_bool("DofEnabled", vis.get("dof_enabled", False))
    w.write_flt("DofFocusScale", vis.get("dof_focus_scale", 10.0))

    if session.camera is not None:
        c = session.camera
        q, dist = _quat_from_lookat(c.eye, c.center, c.up)
        w.section("Camera")
        w.write_flt_vec("Position", np.asarray(c.eye, np.float64))
        w.write_flt_vec("Orientation", q)
        w.write_flt("Distance", dist)
        w.write_int("Mode", 0)  # CameraMode::Perspective
        w.write_flt("Fov", c.fovy)  # extra ident; reference loader ignores

    for rep in session.representations:
        w.section("Representation")
        w.write_str("Name", rep.name)
        w.write_str("Filter", rep.filter)
        w.write_bool("Enabled", rep.enabled)
        w.write_int("Type", REP_TYPE_TO_INT.get(rep.type, 0))
        w.write_int(
            "ColorMapping", COLOR_TO_INT.get(rep.color_mapping, 1)
        )
        col = list(rep.uniform_color[:3]) + [rep.alpha]
        w.write_flt_vec("BaseColor", col)
        w.write_flt("Saturation", getattr(rep, "saturation", 1.0))
        w.write_flt_vec("Param", [rep.radius_scale, 1.0, 1.0, 1.0])
        w.write_bool("DynamicEval", rep.dynamic)

    w.section("Script")
    w.write_str("Text", session.script_text)

    for name, bf in session.stored_selections.items():
        w.section("Selection")
        w.write_str("Label", name)
        w.write_str("Mask", serialize_mask(bf))

    user_bonds = getattr(session, "user_bonds", [])
    if user_bonds:
        w.section("UserBonds")
        for i, j in user_bonds:
            w.write_int_vec("atoms", (i, j))

    session.events.broadcast(EventType.SERIALIZE, w)

    with open(path, "w") as f:
        f.write(w.text())


# -- load ----------------------------------------------------------------------

def _floats(arg: str, n: int) -> list[float] | None:
    try:
        vals = [float(t) for t in arg.split(",")][:n]
        return vals if len(vals) == n else None
    except ValueError:
        return None


def load_workspace(session, path: str):
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        sections = parse_workspace(f.read())

    session.stored_selections = {}
    pending_traj = None
    new_frame = 0.0
    reps_loaded: list[Representation] = []
    user_bonds: list[tuple[int, int]] = []
    cam_pos = cam_quat = cam_dist = cam_fov = None
    legacy_cam = {}
    for name, entries in sections:
        if name in ("Files", "File"):
            mol = entries.get("MoleculeFile", "")
            trj = entries.get("TrajectoryFile", "")
            session.coarse_grained = bool(
                int(entries.get("CoarseGrained", "0") or 0)
            )
            if mol:
                session.load(os.path.join(base, mol))
            if trj and trj != mol:
                pending_traj = os.path.join(base, trj)
        elif name == "Animation":
            new_frame = float(entries.get("Frame", "0") or 0)
            if "Fps" in entries:
                session.fps = float(entries["Fps"])
            if "Interpolation" in entries:
                session.interpolation = INTERP_INT_TO_STR.get(
                    int(float(entries["Interpolation"])), "linear"
                )
        elif name == "RenderSettings":
            vis = getattr(session, "visuals", None)
            if vis is None:
                vis = session.visuals = {}
            for ident, key, conv in (
                ("SsaoEnabled", "ssao_enabled", lambda s: bool(int(s))),
                ("SsaoIntensity", "ssao_intensity", float),
                ("SsaoRadius", "ssao_radius", float),
                ("SsaoBias", "ssao_bias", float),
                ("DofEnabled", "dof_enabled", lambda s: bool(int(s))),
                ("DofFocusScale", "dof_focus_scale", float),
            ):
                if ident in entries:
                    try:
                        vis[key] = conv(entries[ident])
                    except ValueError:
                        pass
        elif name == "Camera":
            if "Position" in entries:
                cam_pos = _floats(entries["Position"], 3)
            for key in ("Orientation", "Rotation"):  # Rotation: deprecated
                if key in entries and cam_quat is None:
                    cam_quat = _floats(entries[key], 4)
            if "Distance" in entries:
                cam_dist = float(entries["Distance"])
            if "Fov" in entries:
                cam_fov = float(entries["Fov"])
            for key in ("Focus", "Up"):  # round-1 dialect
                if key in entries:
                    legacy_cam[key] = _floats(entries[key], 3)
        elif name == "Representation":
            rep = Representation(
                name=entries.get("Name", "rep"),
                filter=entries.get("Filter", "all"),
                enabled=bool(int(entries.get("Enabled", "1") or 1)),
            )
            t = entries.get("Type", "0")
            rep.type = (
                REP_INT_TO_TYPE.get(int(t), "spacefill")
                if t.lstrip("-").isdigit()
                else t  # round-1 dialect stored strings
            )
            cm = entries.get("ColorMapping", "1")
            rep.color_mapping = (
                COLOR_INT_TO_STR.get(int(cm), "cpk")
                if cm.lstrip("-").isdigit()
                else cm
            )
            col = _floats(
                entries.get("BaseColor", entries.get("StaticColor", "")), 4
            )
            if col:
                rep.uniform_color = (col[0], col[1], col[2], 1.0)
                rep.alpha = col[3]
            param = _floats(entries.get("Param", ""), 4)
            if param:
                rep.radius_scale = param[0]
            for dep in ("Radius", "Width"):  # deprecated scalar forms
                if dep in entries:
                    rep.radius_scale = float(entries[dep])
            if "RadiusScale" in entries:  # round-1 dialect
                rep.radius_scale = float(entries["RadiusScale"])
            if "Alpha" in entries:
                rep.alpha = float(entries["Alpha"])
            if "UniformColor" in entries:
                c4 = _floats(entries["UniformColor"], 4)
                if c4:
                    rep.uniform_color = tuple(c4)
            reps_loaded.append(rep)
        elif name == "Selection":
            nm = entries.get("Label", entries.get("Name", "sel"))
            mask = entries.get("Mask", "")
            bf = deserialize_mask(mask) if mask else None
            if bf is not None:
                session.stored_selections[nm] = bf
            elif mask:
                vlog.warning(f"workspace: undecodable selection mask '{nm}'")
        elif name == "Script":
            t = entries.get("Text", "")
            if "\n" not in t and t:
                # round-1 dialect stored base64; telltale: decodes AND
                # re-encodes to itself
                try:
                    dec = base64.b64decode(t, validate=True)
                    if base64.b64encode(dec).decode("ascii") == t:
                        t = dec.decode("utf-8")
                except Exception:
                    pass
            session.script_text = t
        elif name == "UserBonds":
            for ident, arg in entries.pairs:
                if ident == "atoms":
                    try:
                        i, j = (int(v) for v in arg.split(",")[:2])
                    except ValueError:
                        continue
                    if i >= 0 and j >= 0:
                        user_bonds.append((i, j))
        elif name == "AtomElementMapping":
            lbl = entries.get("Label", "")
            elem = int(entries.get("Element", "0") or 0)
            if lbl and elem and session.system is not None:
                ds = session.components.get("dataset")
                if ds is not None and hasattr(ds, "remap_element"):
                    from viamd_tpu_torch.core import elements as E

                    try:
                        ds.remap_element(
                            f"name('{lbl}')", E.SYMBOLS[elem]
                        )
                    except Exception as e:
                        vlog.warning(f"workspace: element remap failed: {e}")

    if pending_traj:
        session.load(pending_traj)
    session.frame = new_frame
    if cam_pos is not None:
        from viamd_tpu_torch.render.camera import Camera

        if cam_quat is not None and cam_dist is not None:
            eye, center, up = _lookat_from_quat(cam_pos, cam_quat, cam_dist)
        else:  # round-1 dialect
            eye = np.asarray(cam_pos, np.float64)
            center = np.asarray(
                legacy_cam.get("Focus") or [0, 0, 0], np.float64
            )
            up = np.asarray(legacy_cam.get("Up") or [0, 1, 0], np.float64)
        session.camera = Camera(
            eye=eye.astype(np.float32),
            center=np.asarray(center, np.float32),
            up=np.asarray(up, np.float32),
            fovy=cam_fov if cam_fov is not None else np.radians(45.0),
        )
    if reps_loaded:
        session.representations = reps_loaded
    if user_bonds and session.system is not None:
        session.user_bonds = user_bonds
        session.add_user_bonds(user_bonds)
    session._update_representations()
    if session.script_text and session.system is not None:
        session.compile_script()
    session.events.broadcast(EventType.DESERIALIZE, sections)
