"""viamd_tpu_torch — the PyTorch/CUDA port of viamd_tpu.

A second package beside `viamd_tpu` (the JAX/TPU reference, which stays as
it is). It mirrors that package's layout — `core/`, `script/`, `ops/`,
`eval/`, `io/`, `datagen.py` — so each module's counterpart sits under the
same relative path; hand-written CUDA kernels live in `csrc/`.

The package imports torch and numpy only: never jax, and never anything
under `viamd_tpu` (whose package import pulls in jax). Host-only modules it
needs are carried as numpy copies, its host C++ codecs (`csrc/host/`) as
copies built by `cuda_build.py`.

Covered so far: file loading (`io.load_file`), the script language
(`script.compile_script`), evaluation over staged or streamed
trajectories with checkpoints (`eval.Evaluator`), the render paths
(`render/`), the components, and the app layer over them
(`app.Session`, the `.via` workspace, the CLI and the browser viewer),
each on an explicit torch device.
"""

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.system import System
from viamd_tpu_torch.core.unitcell import UnitCell

__all__ = ["Bitfield", "System", "UnitCell"]
