"""Helpers for the parity tests between viamd_tpu (JAX, the reference) and
viamd_tpu_torch (the PyTorch/CUDA port): the same seeded numpy data goes
through both packages, and the port's objects are built from it with
viamd_tpu_torch.interop."""

from __future__ import annotations

import dataclasses

import numpy as np

_LABEL_FIELDS = ("atom_names", "res_names", "chain_labels")


def system_fields(sys) -> tuple[dict, np.ndarray]:
    """A viamd_tpu.core.system.System → (numpy field dict, (3, 3) basis),
    the input of viamd_tpu_torch.interop.system_from_numpy."""
    fields = {}
    for f in dataclasses.fields(sys):
        v = getattr(sys, f.name)
        if f.name == "cell":
            continue
        if f.name in _LABEL_FIELDS:
            fields[f.name] = np.asarray(v.labels, dtype=str)
        elif f.name == "backbone":
            fields[f.name] = None if v is None else {
                k.name: np.asarray(getattr(v, k.name))
                for k in dataclasses.fields(v)
            }
        elif f.name == "instances":
            fields[f.name] = None if v is None else {
                "atom_ranges": np.asarray(v.atom_ranges),
                "transforms": np.asarray(v.transforms),
                "label_id": np.asarray(v.label_id),
                "labels": np.asarray(v.labels.labels, dtype=str),
            }
        else:
            fields[f.name] = None if v is None else np.asarray(v)
    return fields, np.asarray(sys.cell.basis, np.float32)


def port_system(sys):
    """The port's System holding the same topology and cell as `sys`."""
    from viamd_tpu_torch.interop import system_from_numpy

    return system_from_numpy(*system_fields(sys))


def water_render_inputs(n_waters: int, seed: int, width: int, height: int,
                        eye_dir=(0.0, 0.0, 1.6)):
    """One render scene as numpy arrays, the same for both packages: frame 0
    of water_box(n_waters, seed) and datagen.render_inputs (CPK colours,
    O–H bonds, bench.py's camera for the default eye_dir), built with the
    port's numpy copies, which the tests hold equal to the JAX package's.
    → dict(positions, radii, colors, bonds, view, proj)."""
    from viamd_tpu_torch.datagen import render_inputs, water_box

    sys, traj = water_box(n_waters, n_frames=1, seed=seed)
    frames, _ = traj.load_frames([0])
    return dict(render_inputs(sys, width, height, eye_dir), positions=frames[0])
