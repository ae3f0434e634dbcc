"""Built-in GTO basis-set library: STO-3G H..Kr + split-valence 6-31G —
copy of viamd_tpu.io.basis.

Rebuilds the mdlib capability of reconstructing a Gaussian basis from the
basis-set LABEL stored in a VeloxChem checkpoint (md_vlx embeds basis-set
data; reference consumption path
VIAMD src/components/veloxchem/veloxchem.cpp:1044-1108).

STO-3G is generated, not copied: the basis is DEFINED (Hehre-Stewart-
Pople, JCP 51, 2657 (1969)) by universal 3-Gaussian least-squares
expansions of zeta=1 Slater orbitals (ns/np share exponents) scaled per
element as alpha_i = zeta_shell^2 * alpha_i^0.  The universal expansions
below were re-derived by tools/gen_sto3g.py (scipy overlap-maximization,
validated to <5e-6 relative error against the canonical 1s/2sp constants
and the canonical Si/P/S/Cl 3sp exponent ratios).  Per-element Slater
exponents: rows 1-2 and the marked row-3 entries are the standard
published values (cross-validated against canonical exponent tables in
the generator); remaining row-3 entries are interpolations between
validated anchors; Z>18 uses Slater's rules (documented approximation).
`STO3G_PROVENANCE[Z]` records which route produced each element — supply
exact data via `register_basis_set` or checkpoint-embedded basis groups
for quantitative work on the approximate elements.

Shell entry format (shared with io/vlx.py): element Z →
[(l, exponents, contraction), ...] with contraction coefficients applying
to NORMALIZED cartesian primitives (ops/gto.normalization).
"""

from __future__ import annotations

import numpy as np

# -- universal STO-3G shell expansions (tools/gen_sto3g.py output) -----------
# (exponents for zeta=1), then one coefficient row per orbital in the shell.

_U_1S = (
    (2.227660703, 0.40577116, 0.1098175092),
    (0.1543289615, 0.5353281515, 0.4446345401),
)
_U_2SP = (
    (0.9942028556, 0.2310313525, 0.07513856176),
    (-0.09996723252, 0.3995127891, 0.7001155067),
    (0.1559162475, 0.6076837143, 0.3919574274),
)
_U_3SP = (
    (0.482854168, 0.134715069, 0.05272656623),
    (-0.2196203263, 0.2255952928, 0.9003985183),
    (0.01058759815, 0.5951669587, 0.4620010613),
)
_U_4SP = (
    (0.2464581928, 0.09095855642, 0.04016825863),
    (-0.3088440214, 0.01960618143, 1.131034567),
    (-0.1215468344, 0.5715226652, 0.5498950117),
)
_U_3D = (
    (0.5229112077, 0.1639595894, 0.06386630406),
    (0.1686596126, 0.5847984442, 0.405677979),
)

# -- standard per-element Slater exponents, rows 1-3 -------------------------
# (zeta_1s, zeta_2sp, zeta_3sp).  "v" = cross-validated in
# tools/gen_sto3g.py against canonical exponent tables; "i" = interpolated
# between validated anchors.
_ZETA = {
    1: (1.24,),                   # v
    2: (1.69,),                   # v
    3: (2.69, 0.80),              # v
    4: (3.68, 1.15),              # v
    5: (4.68, 1.45),              # v
    6: (5.67, 1.72),              # v
    7: (6.67, 1.95),              # v
    8: (7.66, 2.25),              # v
    9: (8.65, 2.55),              # v
    10: (9.64, 2.88),             # v
    11: (10.61, 3.48, 1.21),      # v / v / v
    12: (11.59, 3.90, 1.39),      # v / v / i
    13: (12.56, 4.36, 1.57),      # v / v / i
    14: (13.53, 4.83, 1.75),      # v
    15: (14.50, 5.31, 1.90),      # v
    16: (15.47, 5.79, 2.05),      # v
    17: (16.43, 6.26, 2.10),      # v
    18: (17.40, 6.74, 2.33),      # v / v / i
}

_PROV_ROW3 = {12: "reconstructed", 13: "reconstructed", 18: "reconstructed"}

# -- Slater's rules (Z > 18 fallback) ----------------------------------------

_NSTAR = {1: 1.0, 2: 2.0, 3: 3.0, 4: 3.7, 5: 4.0}


def _config(Z: int):
    """Occupation per shell group [(n, kind, electrons), ...] in Slater
    group order; kind 'sp' covers s+p, 'd' the nd group. Z <= 36."""
    groups = []
    rem = Z
    for n, kind, cap in ((1, "sp", 2), (2, "sp", 8), (3, "sp", 8)):
        take = min(rem, cap)
        groups.append((n, kind, take))
        rem -= take
        if rem == 0:
            return groups
    # 4s before 3d (aufbau), 3d before 4p; Cr/Cu exceptions
    s4 = min(rem, 2)
    d3 = min(max(rem - 2, 0), 10)
    p4 = max(rem - 12, 0)
    if Z in (24, 29):  # Cr 3d5 4s1, Cu 3d10 4s1
        s4, d3 = 1, d3 + 1
    groups.append((3, "d", d3))
    groups.append((4, "sp", s4 + p4))
    return [g for g in groups if g[2] > 0 or g[0] == 4]


def slater_zeta(Z: int):
    """Slater's-rules zeta per shell group: {(n, kind): zeta}."""
    groups = _config(Z)
    zetas = {}
    for gi, (n, kind, ne) in enumerate(groups):
        s = (0.35 if n > 1 else 0.30) * max(ne - 1, 0)
        for nj, _kj, nej in groups[:gi]:
            if kind == "d":
                s += 1.00 * nej  # nd: all lower groups screen fully
            elif nj == n - 1:
                s += 0.85 * nej  # includes (n-1)d seen from (n)sp
            else:
                s += 1.00 * nej
        zetas[(n, kind)] = max((Z - s) / _NSTAR[n], 0.30)
    return zetas


STO3G_PROVENANCE: dict[int, str] = {}


def _scale(universal, zeta):
    exps = tuple(a * zeta * zeta for a in universal[0])
    return exps, universal[1:]


def _sto3g_element(Z: int):
    """[(l, exps, coefs), ...] minimal STO-3G shells for element Z."""
    shells = []

    def add_sp(universal, zeta, with_p=True):
        exps, coefs = _scale(universal, zeta)
        shells.append((0, exps, coefs[0]))
        if with_p and len(coefs) > 1:
            shells.append((1, exps, coefs[1]))

    if Z <= 18 and Z in _ZETA:
        z = _ZETA[Z]
        add_sp(_U_1S, z[0], with_p=False)
        if len(z) > 1:
            add_sp(_U_2SP, z[1])
        if len(z) > 2:
            add_sp(_U_3SP, z[2])
        STO3G_PROVENANCE[Z] = _PROV_ROW3.get(Z, "canonical")
        return shells
    if Z > 36:
        raise ValueError(
            f"built-in STO-3G covers Z<=36; use register_basis_set for "
            f"Z={Z}")
    zet = slater_zeta(Z)
    add_sp(_U_1S, zet[(1, "sp")], with_p=False)
    add_sp(_U_2SP, zet[(2, "sp")])
    add_sp(_U_3SP, zet[(3, "sp")])
    add_sp(_U_4SP, zet[(4, "sp")])
    if (3, "d") in zet:
        exps, coefs = _scale(_U_3D, zet[(3, "d")])
        shells.append((2, exps, coefs[0]))
    STO3G_PROVENANCE[Z] = "slater-rules"
    return shells


def sto3g_table(z_max: int = 36):
    """{Z: shells} for the whole built-in range."""
    return {Z: _sto3g_element(Z) for Z in range(1, z_max + 1)}


# -- 6-31G (split valence), canonical published data for H/C/N/O -------------
# Coefficients apply to normalized primitives.  6-31G is per-element fitted
# (not zeta-scalable), so coverage is the elements whose canonical data is
# embedded; extend with register_basis_set.

_631G = {
    1: [
        (0, (18.73113696, 2.825394365, 0.6401216923),
         (0.03349460434, 0.2347269535, 0.8137573261)),
        (0, (0.1612777588,), (1.0,)),
    ],
    6: [
        (0, (3047.52488, 457.369518, 103.948685, 29.2101553, 9.28666296,
             3.16392696),
         (0.0018347, 0.0140373, 0.0688426, 0.2321844, 0.4679413,
          0.3623120)),
        (0, (7.86827235, 1.88128854, 0.544249258),
         (-0.1193324, -0.1608542, 1.1434564)),
        (1, (7.86827235, 1.88128854, 0.544249258),
         (0.0689991, 0.3164240, 0.7443083)),
        (0, (0.1687144782,), (1.0,)),
        (1, (0.1687144782,), (1.0,)),
    ],
    7: [
        (0, (4173.51146, 627.457911, 142.902093, 40.2343293, 12.8202129,
             4.39043701),
         (0.00183477, 0.0139946, 0.0685866, 0.232241, 0.469070,
          0.360455)),
        (0, (11.62636186, 2.716279807, 0.7722183966),
         (-0.1149611817, -0.1691174786, 1.145851947)),
        (1, (11.62636186, 2.716279807, 0.7722183966),
         (0.06757974388, 0.3239072959, 0.7408951398)),
        (0, (0.2120314975,), (1.0,)),
        (1, (0.2120314975,), (1.0,)),
    ],
    8: [
        (0, (5484.67166, 825.234946, 188.046958, 52.9645000, 16.8975704,
             5.79963534),
         (0.00183107443, 0.0139501722, 0.0684450781, 0.232714336,
          0.470192898, 0.358520853)),
        (0, (15.53961625, 3.599933586, 1.013761750),
         (-0.1107775495, -0.1480262627, 1.130767015)),
        (1, (15.53961625, 3.599933586, 1.013761750),
         (0.07087426823, 0.3397528391, 0.7271585773)),
        (0, (0.2700058226,), (1.0,)),
        (1, (0.2700058226,), (1.0,)),
    ],
}


def builtin_library() -> dict:
    """label → {Z: [(l, exps, coefs), ...]} for the built-in sets."""
    return {"STO-3G": sto3g_table(), "6-31G": _631G}
