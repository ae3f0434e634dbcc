"""Interactive playback of a protein deployment in cartoon: each frame
advances the playback position, orbits the camera and renders the composed
frame through `Session.render`, the view kind's loop over the capsid of
`portbench/capsid.py`.

A traffic file of this kind gives what a view mix gives (frame size,
playback step, orbit, the outlined selection, the volume: none) and the
one representation drawn: its `representation` type, `filter` and
`color_mapping`. Set-up attaches the generated system with
`Session.attach` and renders two frames. The timing, the window and the
kept frames are the view kind's own (`portbench/kinds/view.py`).
"""

from __future__ import annotations

import numpy as np

from portbench import capsid
from portbench.kinds.view import (  # noqa: F401  (the kind's window, timing and release)
    Cell, camera_args, end_to_end, release, render, sampled_frame, view_params, window,
)


def setup(config: dict, traffic: dict, seed: int, device) -> Cell:
    """The Session over the seed's capsid, the mix's representation, the
    selection made, and two frames rendered."""
    from viamd_tpu_torch.app import Session
    from viamd_tpu_torch.core.system import build_system, postprocess
    from viamd_tpu_torch.core.unitcell import UnitCell
    from viamd_tpu_torch.io.trajectory import DeviceTrajectory

    # a program without the call fails here, before the inputs are made
    attach = Session.attach
    cap, stack = capsid.make(config, seed, device)
    sys_ = build_system(coords=cap.coords, atom_names=cap.atom_names, res_names=cap.res_names,
                        res_ids=cap.res_ids, chain_ids=cap.chain_ids, elements_z=cap.z,
                        cell=UnitCell.orthorhombic(cap.box, cap.box, cap.box))
    sys_.bonds = cap.bonds.copy()
    postprocess(sys_, infer_bonds=False)
    bb = sys_.backbone
    lengths = (np.diff(bb.ranges, axis=1)[:, 0] if bb is not None else np.zeros(0)).tolist()
    if lengths != [cap.residues_per_chain] * cap.n_chains:
        raise RuntimeError(f"the program found backbone ranges of {lengths} residues, not "
                           f"{cap.n_chains} of {cap.residues_per_chain}")
    cells = np.broadcast_to(cap.basis, (stack.shape[0], 3, 3)).copy()
    s = Session(device=device)
    attach(s, sys_, DeviceTrajectory(stack, cells), name="<portbench capsid>")
    s.representations.clear()
    s.add_representation(type=traffic["representation"], filter=traffic["filter"],
                         color_mapping=traffic["color_mapping"])
    s.select(traffic["selection"])
    cell = Cell(config, traffic, cap, s)
    for k in (-2, -1):  # every shape the window renders, before it starts
        render(cell, view_params(traffic, cap, config["n_frames"], k))
    return cell


def check(cell: Cell, seed: int, device, limits: dict) -> tuple:
    """The kept frames against the plain reference → ({name: worst value
    over the frames}, the reference's Scene, the frames with a number over
    its limit)."""
    from portbench.reference import cartoon as ref

    tr, cfg = cell.traffic, cell.config
    stack = capsid.frames(cell.wb, cfg["n_frames"], cfg["jitter_A"], seed, device)
    scene = ref.Scene(cell.wb, stack, cfg, tr)
    out: dict = {}
    failed = 0
    for fr in cell.kept:
        got = ref.compare(fr.out, scene.frame(fr.t, camera_args(tr, cell.wb, fr.eye)))
        failed += any(got[k] > lim for k, lim in limits.items())
        for name, v in got.items():
            out[name] = max(out.get(name, 0.0), v)
    return out, scene, failed


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control: the reference's bfloat16 chain in the program's place,
    held to the reference by `check`'s numbers over two frames of the mix
    as a window keeps them (the sampled one, and one `min_frames` later)
    → {name: worst value}."""
    from portbench.reference import cartoon as ref

    sample = sampled_frame(traffic, seed)
    cap, stack = capsid.make(config, seed, device)
    want = ref.Scene(cap, stack, config, traffic)
    got = ref.Scene(cap, stack, config, traffic, control=True)
    out: dict = {}
    for k in (sample, sample + traffic["min_frames"]):
        fr = view_params(traffic, cap, config["n_frames"], k)
        cam = camera_args(traffic, cap, fr.eye)
        for name, v in ref.compare(got.frame(fr.t, cam), want.frame(fr.t, cam)).items():
            out[name] = max(out.get(name, 0.0), v)
    return out
