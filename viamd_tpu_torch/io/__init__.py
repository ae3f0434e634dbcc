"""File-format loaders and trajectory containers.

Counterpart of viamd_tpu.io: system loaders (PDB, GRO, XYZ/XMOL/ARC,
mmCIF, LAMMPS data), trajectory readers (PDB, XYZ, XTC, TRR, DCD, LAMMPS
dump), the packed `.vtraj` frame cache, table readers for the script's
`import` (XVG, CSV, EDR), and trajectories held on an explicit torch
device (`trajectory.DeviceTrajectory`).
"""

from viamd_tpu_torch.io.loader import LoaderFlags, load_file, loader_for_path

__all__ = ["load_file", "loader_for_path", "LoaderFlags"]
