"""Move system and render state between viamd_tpu and viamd_tpu_torch as
numpy data.

The system has no weights: its state is the topology, the cell and the
frames; the renderer's is the temporal history of its TAA reprojector; the
quantum-chemistry window's is a checkpoint's `QMData`. These functions
build the port's objects from plain numpy arrays — the form in which the
JAX package's `System` fields, trajectories, TAA history and `QMData` can
be handed over without either package importing the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from viamd_tpu_torch.core.system import Backbone, InstanceTable, LabelTable, System
from viamd_tpu_torch.core.unitcell import UnitCell
from viamd_tpu_torch.io import vlx
from viamd_tpu_torch.io.trajectory import DeviceTrajectory
from viamd_tpu_torch.render.taa import TAAReprojector

_LABEL_FIELDS = ("atom_names", "res_names", "chain_labels")


def system_from_numpy(fields: dict, basis: np.ndarray) -> System:
    """Port `System` from the JAX package's `System` dataclass fields.

    `fields` maps field names to numpy arrays; the label tables
    (`atom_names`, `res_names`, `chain_labels`) are arrays of strings,
    `backbone` (optional) is a dict of the Backbone fields, `instances`
    (optional) a dict of the InstanceTable fields with `labels` an array of
    strings, `cell` is ignored in favour of `basis` ((3, 3) row-vector
    basis, zeros when aperiodic).
    """
    kw = {}
    for f in dataclasses.fields(System):
        name = f.name
        if name == "cell":
            kw[name] = UnitCell.from_basis(np.asarray(basis, np.float32))
        elif name in _LABEL_FIELDS:
            tab = LabelTable()
            for s in np.asarray(fields[name]).tolist():
                tab.intern(str(s))
            kw[name] = tab
        elif name == "instances":
            kw[name] = _instances(fields.get(name))
        elif name == "backbone":
            bb = fields.get(name)
            kw[name] = None if bb is None else Backbone(
                **{k: np.asarray(v) for k, v in bb.items()}
            )
        elif name in fields:
            v = fields[name]
            kw[name] = None if v is None else np.asarray(v).copy()
        elif f.default is dataclasses.MISSING:
            raise KeyError(f"system field '{name}' missing")
    return System(**kw)


def _instances(inst: dict | None) -> InstanceTable | None:
    if inst is None:
        return None
    labels = LabelTable()
    for s in np.asarray(inst["labels"]).tolist():
        labels.intern(str(s))
    return InstanceTable(
        atom_ranges=np.asarray(inst["atom_ranges"], np.int32).copy(),
        transforms=np.asarray(inst["transforms"], np.float32).copy(),
        label_id=np.asarray(inst["label_id"], np.int32).copy(),
        labels=labels,
    )


def trajectory_from_numpy(
    frames: np.ndarray, cells: np.ndarray, device
) -> DeviceTrajectory:
    """(F, n, 3) f32 frames + (F, 3, 3) f32 cell bases → DeviceTrajectory on
    `device`."""
    stack = torch.as_tensor(
        np.asarray(frames, np.float32), device=torch.device(device)
    )
    return DeviceTrajectory(stack, np.asarray(cells, np.float32))


def taa_state_from_numpy(history, frame: int, device, feedback_min: float = 0.88,
                         feedback_max: float = 0.97):
    """Port `TAAReprojector` carrying on a JAX `TAAReprojector`'s sequence:
    its `history` ((H, W, 3) float32, or None before the first frame), its
    `frame` count and feedback bounds → a reprojector whose next `step`
    resolves against that history on `device`."""
    hist = None if history is None else torch.as_tensor(
        np.array(history, np.float32), device=torch.device(device))  # a writable copy
    return TAAReprojector(feedback_min=feedback_min, feedback_max=feedback_max,
                          history=hist, frame=int(frame))



_QM_SECTIONS = {
    "excited": vlx.ExcitedStates,
    "vib": vlx.VibrationalData,
    "opt": vlx.OptimizationData,
    "scf_history": vlx.ScfHistory,
    "rsp_samples": vlx.ResponseSamples,
}


def qmdata_from_numpy(fields: dict) -> vlx.QMData:
    """Port `QMData` from the JAX package's `QMData` dataclass fields.

    `fields` maps field names to numpy arrays or scalars; `shells` is a
    list of (center, angular, exponents, contraction) tuples; the sections
    `excited`, `vib`, `opt`, `scf_history` and `rsp_samples` are dicts of
    their dataclass fields (or None); `atom_properties` a dict of arrays.
    Fields left out take the dataclass defaults; `_prims` (the lazily built
    primitive expansion) is always rebuilt by the port.
    """
    kw = {}
    for f in dataclasses.fields(vlx.QMData):
        name = f.name
        if name == "_prims" or name not in fields:
            if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise KeyError(f"QMData field '{name}' missing")
            continue
        v = fields[name]
        if name == "shells":
            v = [vlx.Shell(center=np.array(c, np.float32), angular=int(a),
                           exponents=np.array(e, np.float32),
                           contraction=np.array(k, np.float32)) for c, a, e, k in v]
        elif name in _QM_SECTIONS and v is not None:
            v = _QM_SECTIONS[name](**{k: _copy(x) for k, x in v.items()})
        elif name == "atom_properties" and v is not None:
            v = {str(k): np.array(x) for k, x in v.items()}
        else:
            v = _copy(v)
        kw[name] = v
    return vlx.QMData(**kw)


def _copy(v):
    return np.array(v) if isinstance(v, np.ndarray) else v
