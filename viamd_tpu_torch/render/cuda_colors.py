"""Per-atom colours of one representation on the device: the CUDA kernel
wrapper (csrc/colors.cu), its plain version, and the cached device inputs.

`atom_colors` is the one route: CUDA tensors launch the kernel (`colors`),
CPU tensors take `colors_plain`. Both compute the chain of
render/color.py's numpy functions as Session used to run it on the host
(`Session._rep_colors`), in its order:

    base    (n, 4) f32      a colour a system atom (a mapping's table), or
                            None with `ss` and `bbres`: the blend of the
                            (coil, helix, sheet) weights `ss` (nbb, 3) f32
                            of each atom's backbone residue `bbres` (n,)
                            int32 with color.SS_COLORS, coil where -1
    tint                    rgba, applied at `tint_scale` when above 0
    saturation              below 1: desaturated by 1 - saturation
    mask    words or None   the filter: alpha 0 where the atom's bit is clear
    selection words or None desaturated by SELECTION_AMOUNT where clear
    subset  (m,) int32      the atoms to write (None: all n)
    radius  (n,) f32        when given, also the raster radii: the atom's
                            radius where its alpha is above 0, else 0

Masks are `words(bitfield)`: the Bitfield's packed bits as int32 words, bit
a of word a // 32. Output: ((m, 4) float32 colours, (m,) float32 radii or
None). The kernel equals the plain version bit for bit (both float32 in
the same order, the tint's sum in float64 as numpy's). Against the numpy
chain, alpha and every atom that only a table, the tint or the filter
touched are bit-equal; luminances and the secondary-structure blend may
differ in the last bit, since numpy's float32 matrix products do not sum
in sequential order.

`ColorState` holds one representation's inputs on a device, each uploaded
only when the key of what it was made from changes; `uploads` counts the
uploads. The launch copies nothing to the card and waits on nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.cuda_build import Library, check_tensor as _check
from viamd_tpu_torch.render.color import SS_COLORS

__all__ = ["LIBRARY", "ColorState", "atom_colors", "backbone_residues", "colors",
           "colors_plain", "launches", "uploads", "words"]

# kernel launches since import, and the tables ColorState uploaded (reset
# freely by callers that count a run)
launches = 0
uploads = 0

# color.py::desaturate_colors's weights and default amount (the selection's)
LUMINANCE = np.array([0.2126, 0.7152, 0.0722], np.float32)
SELECTION_AMOUNT = 0.7

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = Library("colors", ("colors.cu",), {
    "colors_launch": (_i, [_p] * 9 + [_i, _p, _p, _i, _f, _p, _i, _f, _f, _f, _f, _p]),
})


def words(mask) -> np.ndarray:
    """A Bitfield's packed bits as int32 words (bit a in word a // 32)."""
    return mask.words.view(np.int32)


def backbone_residues(sys) -> np.ndarray:
    """(n,) int32: the backbone residue of each atom's residue, -1 where it
    has none (color.py::color_atoms_secondary_structure's assignment)."""
    res_bb = np.full(sys.nres, -1, np.int32)
    if sys.backbone is not None:
        res_bb[sys.backbone.res_idx] = np.arange(sys.backbone.count, dtype=np.int32)
    return np.repeat(res_bb, np.diff(np.asarray(sys.res_offsets, np.int64)))


def _scalars(tint, tint_scale: float, saturation: float) -> dict:
    """The float32 factors numpy's chain multiplies by (a Python number
    times a float32 array rounds the number to float32 first)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    amount = 1.0 - saturation
    return dict(
        tint=tint_scale > 0.0, tint_keep=f32(1 - tint_scale),
        tint_add=np.asarray(tint)[:3] * tint_scale,
        sat=saturation < 1.0, sat_keep=f32(1 - amount), sat_amount=f32(amount),
        sel_keep=f32(1 - SELECTION_AMOUNT), sel_amount=f32(SELECTION_AMOUNT),
    )


def _shapes(base, ss, bbres, mask, selection, subset, radius) -> int:
    """Raise unless the inputs have the dtypes and shapes the kernel takes
    (devices aside); → the system's atom count."""
    if base is None and (ss is None or bbres is None):
        raise ValueError("colours need a base table, or SS weights and bbres")
    n = base.shape[0] if base is not None else bbres.shape[0]
    dev = (base if base is not None else bbres).device
    if base is not None:
        _check(base, "base", torch.float32, (n, 4), dev)
    else:
        _check(bbres, "bbres", torch.int32, (n,), dev)
        _check(ss, "ss", torch.float32, (ss.shape[0], 3), dev)
    nw = 2 * ((n + 63) // 64)
    for t, name in ((mask, "mask"), (selection, "selection")):
        if t is not None:
            _check(t, name, torch.int32, (nw,), dev)
    if subset is not None:
        _check(subset, "subset", torch.int32, (subset.shape[0],), dev)
    if radius is not None:
        _check(radius, "radius", torch.float32, (n,), dev)
    return n


def colors(base, ss, bbres, mask, selection, subset, radius, *, tint=(1.0, 1.0, 1.0, 1.0),
           tint_scale: float = 0.0, saturation: float = 1.0):
    """One launch of csrc/colors.cu on CUDA tensors → (colours, radii or
    None). Raises on what the kernel does not take, or if the launch
    fails. Subset entries must lie in [0, n)."""
    global launches
    n = _shapes(base, ss, bbres, mask, selection, subset, radius)
    dev = (base if base is not None else bbres).device
    if dev.type != "cuda":
        raise ValueError(f"the colours kernel runs on CUDA tensors, not {dev}")
    if base is not None and base.data_ptr() % 16:
        raise ValueError("base: the kernel reads 16-byte aligned rows")
    m = n if subset is None else subset.shape[0]
    out = torch.empty((m, 4), dtype=torch.float32, device=dev)
    radii = None if radius is None else torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return out, radii
    sc = _scalars(tint, tint_scale, saturation)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = LIBRARY.load().colors_launch(
        ptr(base), ptr(ss), ptr(bbres), ptr(mask), ptr(selection), ptr(subset), ptr(radius),
        out.data_ptr(), ptr(radii), m, (_f * 12)(*SS_COLORS.reshape(-1).tolist()),
        (_f * 3)(*LUMINANCE.tolist()), int(sc["tint"]), sc["tint_keep"],
        (ctypes.c_double * 3)(*sc["tint_add"].tolist()), int(sc["sat"]), sc["sat_keep"],
        sc["sat_amount"], sc["sel_keep"], sc["sel_amount"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"colours kernel launch failed: CUDA error {err}")
    launches += 1
    return out, radii


def _bits(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return ((w[a >> 5] >> (a & 31)) & 1).bool()


def _desaturate(rgb: torch.Tensor, keep: float, amount: float) -> torch.Tensor:
    lum = (rgb[:, 0] * float(LUMINANCE[0]) + rgb[:, 1] * float(LUMINANCE[1])
           + rgb[:, 2] * float(LUMINANCE[2]))
    return rgb * keep + lum[:, None] * amount


def colors_plain(base, ss, bbres, mask, selection, subset, radius, *,
                 tint=(1.0, 1.0, 1.0, 1.0), tint_scale: float = 0.0, saturation: float = 1.0):
    """The kernel's plain version, on any device: the same arguments and
    output, the same float32 operations in the same order."""
    n = _shapes(base, ss, bbres, mask, selection, subset, radius)
    dev = (base if base is not None else bbres).device
    a = torch.arange(n, device=dev) if subset is None else subset.long()
    if base is not None:
        c = base[a]
    else:
        k = bbres[a].long()
        w = ss[k.clamp_min(0)]
        s = SS_COLORS.tolist()
        blend = torch.stack([(w[:, 0] * s[0][j] + w[:, 1] * s[1][j]) + w[:, 2] * s[2][j]
                             for j in range(4)], dim=1)
        c = torch.where((k >= 0)[:, None], blend, torch.tensor(s[0], device=dev))
    rgb, alpha = c[:, :3], c[:, 3]
    sc = _scalars(tint, tint_scale, saturation)
    if sc["tint"]:
        add = torch.as_tensor(sc["tint_add"], dtype=torch.float64, device=dev)
        rgb = ((rgb * sc["tint_keep"]).double() + add).float()
    if sc["sat"]:
        rgb = _desaturate(rgb, sc["sat_keep"], sc["sat_amount"])
    if mask is not None:
        alpha = torch.where(_bits(mask, a), alpha, torch.zeros_like(alpha))
    if selection is not None:
        rgb = torch.where(_bits(selection, a)[:, None], rgb,
                          _desaturate(rgb, sc["sel_keep"], sc["sel_amount"]))
    out = torch.cat([rgb, alpha[:, None]], dim=1).contiguous()
    radii = None
    if radius is not None:
        radii = torch.where(alpha > 0, radius[a], torch.zeros_like(alpha))
    return out, radii


def atom_colors(base, ss, bbres, mask, selection, subset, radius, **style):
    """The colours on the inputs' device: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = (base if base is not None else bbres).device
    if dev.type == "cuda":
        return colors(base, ss, bbres, mask, selection, subset, radius, **style)
    if dev.type != "cpu":
        raise ValueError(f"no colours for device {dev}")
    return colors_plain(base, ss, bbres, mask, selection, subset, radius, **style)


class ColorState:
    """One representation's colour inputs on `device`: each table is made
    on the host and uploaded only when the key of what it was made from
    differs from the one it was made with."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._held: dict = {}  # slot → (key, tensor)

    def table(self, slot: str, key: tuple, make) -> torch.Tensor:
        """The tensor in `slot` for `key`: `make()` (a numpy array) uploaded
        when the held key differs. A Bitfield in the key is compared bit for
        bit, and a copy of it is held."""
        global uploads
        held = self._held.get(slot)
        if held is None or held[0] != key:
            frozen = tuple(Bitfield(k.count, k.words.copy()) if isinstance(k, Bitfield) else k
                           for k in key)
            held = self._held[slot] = (frozen, torch.as_tensor(make(), device=self.device))
            uploads += 1
        return held[1]
