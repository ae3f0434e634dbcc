"""The system under test: a `viamd_tpu_torch` Session over the benchmark's
generated water box.

This is the one module of the harness that imports the program. It turns
the arrays of `portbench/inputs.py` into the program's System and
DeviceTrajectory and attaches them to a Session the way
`Session.load_demo` attaches its generated system: the Session has no
public call for that (PERF.md, Open questions).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench.inputs import WaterBox


def session(wb: WaterBox, stack: torch.Tensor, script: str, device):
    """A Session on `device` holding the water box, its staged frames and
    the compiled script; nothing read from a file, no bond inference."""
    from viamd_tpu_torch.app import Session
    from viamd_tpu_torch.app.events import EventType
    from viamd_tpu_torch.app.session import Representation
    from viamd_tpu_torch.core import elements as E
    from viamd_tpu_torch.core.bitfield import Bitfield
    from viamd_tpu_torch.core.system import FLAG_WATER, build_system
    from viamd_tpu_torch.core.unitcell import UnitCell
    from viamd_tpu_torch.io.trajectory import DeviceTrajectory
    from viamd_tpu_torch.render import camera as cam_mod

    n = wb.n_atoms
    cell = UnitCell.orthorhombic(wb.box, wb.box, wb.box)
    sys_ = build_system(
        coords=wb.coords,
        atom_names=["OW", "HW1", "HW2"] * wb.n_waters,
        res_names=["SOL"] * n,
        res_ids=wb.res_ids,
        elements_z=wb.z,
        cell=cell,
    )
    sys_.radius = E.VDW_RADII[sys_.element].astype(np.float32)
    sys_.mass = E.MASSES[sys_.element].astype(np.float32)
    sys_.flags[:] = FLAG_WATER
    sys_.bonds = wb.bonds.copy()
    cells = np.broadcast_to(cell.basis.astype(np.float32), (stack.shape[0], 3, 3)).copy()
    traj = DeviceTrajectory(stack, cells)

    s = Session(device=device)
    s.system = sys_
    s.files["system"] = "<portbench water box>"
    s.camera = cam_mod.compute_optimal_view(*sys_.aabb())
    s.selection = Bitfield(n)
    s.highlight = Bitfield(n)
    s.representations.append(Representation())
    s._update_representations()
    s.events.broadcast(EventType.SYSTEM_INIT, s)
    s.set_trajectory(traj)
    s.set_script(script)
    if s.script_errors:
        raise RuntimeError(f"the script does not compile: {s.script_errors}")
    return s


def camera(eye, center, up, fovy: float, znear: float, zfar: float):
    """The program's camera for one frame's view."""
    from viamd_tpu_torch.render.camera import Camera

    return Camera(eye=np.asarray(eye, np.float32), center=np.asarray(center, np.float32),
                  up=np.asarray(up, np.float32), fovy=float(fovy), znear=float(znear),
                  zfar=float(zfar))



def kernel_launches() -> int:
    """Launches of the program's hand-written kernels so far: the sum of
    the `launches` counters of its loaded modules."""
    return sum(m.launches for name, m in list(sys.modules.items())
               if name.startswith("viamd_tpu_torch.")
               and type(getattr(m, "launches", None)) is int)
