"""Built-in components of the port — the plugin layer.

Counterpart of viamd_tpu/components (the reference's self-registering
EventHandler components, src/components/): each subscribes to session
events in its constructor and exposes its analysis and rendering surface
as methods, computing on the device it is given (`device="cuda"` unless
the caller asks for the CPU). Each reads only the session members its
docstring lists, so a `types.SimpleNamespace` over the port's objects
serves as a session; `app.session.Session` registers every class of
`builtin_components()` with its own device.
"""

from viamd_tpu_torch.components.dataset import DatasetComponent
from viamd_tpu_torch.components.density_volume import DensityVolumeComponent
from viamd_tpu_torch.components.ramachandran import RamachandranComponent
from viamd_tpu_torch.components.shapespace import ShapespaceComponent
from viamd_tpu_torch.components.veloxchem import VeloxchemComponent



def builtin_components() -> list:
    """The component classes a Session registers, in the JAX package's
    order (viamd_tpu/components/__init__.py)."""
    return [
        DatasetComponent,
        RamachandranComponent,
        ShapespaceComponent,
        DensityVolumeComponent,
        VeloxchemComponent,
    ]


__all__ = [
    "builtin_components",
    "DatasetComponent",
    "DensityVolumeComponent",
    "RamachandranComponent",
    "ShapespaceComponent",
    "VeloxchemComponent",
]
