"""The electron-density grids of csrc/gto.cu on one NVIDIA GPU, against
another checkout's.

    python -m viamd_tpu_torch.profile_gto [--other DIR] [--reps 5]

The molecule is chip_smoke.py's `[qm]` one, built here from the port's own
modules: polyala_helix(8) frame 0 in 6-31G (944 primitives), the Q of a
seeded Gaussian matrix's QR as MO coefficients, 140 occupied orbitals. The
grids are the Export window's "mid" and "high" OBB grids, through
ops/gto.py::density_grid, timed by CUDA events around the call (the median
of `reps` calls after a warm-up). Every line it prints is one JSON object
with the card's name and power limit.

Without `--other`: one run on this tree. With `--other` (the root of
another checkout of the repository, e.g. an unpacked `git archive` of an
earlier commit), runs other, this, this, other, each a process of its own
with one tree on its path. A run gives per grid the median and every
call's time, the gto launches of one call and the device memory one call
adds at its peak. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

# one measurement process, run with one tree's root as the working
# directory and the only tree on the path; argv: label, reps
WORKER = r'''
import json, statistics, subprocess, sys
from types import SimpleNamespace

import numpy as np
import torch

from viamd_tpu_torch import datagen
from viamd_tpu_torch.app.events import EventBus
from viamd_tpu_torch.components import VeloxchemComponent
from viamd_tpu_torch.io.vlx import BOHR_PER_ANGSTROM, QMData, shells_from_label
from viamd_tpu_torch.ops import cuda_gto, gto

if not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is False")
dev = torch.device("cuda")
sys_, traj = datagen.polyala_helix(8, n_frames=1, seed=0)
x = traj.load_frames([0])[0][0].astype(np.float64) * BOHR_PER_ANGSTROM
shells = shells_from_label("6-31G", x, sys_.element)
nb = sum((s.angular + 1) * (s.angular + 2) // 2 for s in shells)
C = np.linalg.qr(np.random.RandomState(3).standard_normal((nb, nb)))[0].astype(np.float32)
occ = np.zeros(nb, np.float32)
occ[:int(sys_.element.sum()) // 2] = 2.0
qm = QMData.from_arrays(x, sys_.element, shells, C, mo_occupations=occ,
                        mo_energies=np.linspace(-20.0, 2.0, nb), basis_label="6-31G")
vlx = VeloxchemComponent(SimpleNamespace(system=sys_, events=EventBus(), coord_override=None),
                         device=dev)
vlx.load(qm)
centers, exps, lmn, _, _ = qm._expand()
C = qm.primitives_all()[2]


def density_times(preset, reps):
    """{dims, ms, ms_all, launches, peak_mib} of density_grid at the
    preset's OBB grid."""
    R, lo, voxel, dims = vlx.obb_geometry(vlx.RESOLUTION_SAMPLES_PER_ANG[preset])
    dims = tuple(int(d) for d in dims)

    def fn():
        return gto.density_grid(centers, exps, C, lmn, lo, voxel, dims, occupations=occ,
                                orientation=R, device=dev)

    fn()
    torch.cuda.synchronize()
    n0 = cuda_gto.launches
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    launches = cuda_gto.launches - n0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"dims": dims, "ms": statistics.median(times), "ms_all": times,
                  "launches": launches, "peak_mib": peak}


label, reps = sys.argv[1], int(sys.argv[2])
out = {"label": label}
for preset in ("mid", "high"):
    out[preset] = density_times(preset, reps)
out["card"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip()
print(json.dumps(out))
'''


def run(label: str, root: Path, reps: int) -> None:
    """One measurement process on the tree at `root`; exits if it fails."""
    env = dict(os.environ, PYTHONPATH=str(root))
    rc = subprocess.run([sys.executable, "-c", WORKER, label, str(reps)], cwd=root,
                        env=env).returncode
    if rc != 0:
        raise SystemExit(f"the {label} run on {root} failed with exit code {rc}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of another checkout to time in turns")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    this = Path(__file__).resolve().parents[1]
    if args.other is None:
        run("this", this, args.reps)
        return
    other = args.other.resolve()
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        run(label, root, args.reps)


if __name__ == "__main__":
    main()
