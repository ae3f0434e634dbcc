"""Dataset component: system summary + element remapping.

Port of viamd_tpu/components/dataset.py (VIAMD
src/components/dataset/dataset.cpp: the dataset summary window with
atom/residue/chain/bond counts per kind, and the periodic-table element
remap that re-derives radii/masses and re-infers bonds, :137, :350). Host
numpy, but for the remap's filter, which is evaluated on the component's
device.

The session: the component reads `session.system`, `.files`,
`.num_frames`, `.stored_selections` and `.events`; no other member.
"""

from __future__ import annotations

import numpy as np
import torch

from viamd_tpu_torch.app.events import EventType
from viamd_tpu_torch.core import elements as E
from viamd_tpu_torch.core import system as S


class DatasetComponent:
    name = "dataset"

    def __init__(self, session, *, device="cuda"):
        self.session = session
        self.device = torch.device(device)

    def summary(self) -> dict:
        """Counts shown in the dataset window (init_dataset_items:137)."""
        sys = self.session.system
        if sys is None:
            return {}
        flags = sys.flags
        element_counts = {}
        for z in np.unique(sys.element):
            element_counts[E.SYMBOLS[z]] = int((sys.element == z).sum())
        return {
            "file": self.session.files.get("system"),
            "atoms": sys.natoms,
            "residues": sys.nres,
            "chains": sys.nchains,
            "instances": sys.ninstances,
            "bonds": sys.nbonds,
            "frames": self.session.num_frames,
            "water_atoms": int(((flags & S.FLAG_WATER) != 0).sum()),
            "ion_atoms": int(((flags & S.FLAG_ION) != 0).sum()),
            "protein_atoms": int(((flags & S.FLAG_AMINO) != 0).sum()),
            "backbone_residues": (
                sys.backbone.count if sys.backbone else 0
            ),
            "elements": element_counts,
            "cell": sys.cell.lengths_angles() if sys.cell.is_periodic else None,
        }

    def remap_element(self, filter_expr: str, element_symbol: str):
        """Set the element of matched atoms and re-derive radii, masses and
        bonds (the PeriodicTableResult apply path, dataset.cpp:350)."""
        sys = self.session.system
        z = E.symbol_to_z(element_symbol)
        if not z:
            raise ValueError(f"unknown element '{element_symbol}'")
        from viamd_tpu_torch.script import evaluate_filter

        mask, _ = evaluate_filter(
            filter_expr, sys, self.session.stored_selections, device=self.device
        )
        idx = mask.indices()
        sys.element[idx] = z
        sys.radius = E.VDW_RADII[sys.element].astype(np.float32)
        sys.mass = E.MASSES[sys.element].astype(np.float32)
        from viamd_tpu_torch.ops.bonds import infer_covalent_bonds

        sys.bonds = infer_covalent_bonds(sys.coords(), sys.element, sys.cell)
        self.session.events.broadcast(EventType.SYSTEM_INIT, self.session)
        return idx.size
