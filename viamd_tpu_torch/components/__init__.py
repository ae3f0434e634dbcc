"""Built-in components of the port — the plugin layer.

Counterpart of viamd_tpu/components (the reference's self-registering
EventHandler components, src/components/): each subscribes to session
events in its constructor and exposes its analysis surface as methods.
Ported so far: Ramachandran and shape space, which read only a session's
system, trajectory, events, tasks and stored selections. `density_volume`,
`dataset` and `veloxchem` are not ported yet.
"""

from viamd_tpu_torch.components.ramachandran import RamachandranComponent
from viamd_tpu_torch.components.shapespace import ShapespaceComponent

__all__ = ["RamachandranComponent", "ShapespaceComponent"]
