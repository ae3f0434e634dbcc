"""The benchmark's inputs, made from a seed: a periodic box of three-site
waters and its frames.

A frozen copy of the port's water-box recipe (a base lattice with a random
offset and rotation per water, then N(0, jitter) per atom and frame), so
that no change to the program can change what the benchmark measures. The
same seed gives the same arrays; every seed gives the same sizes.

Nothing here imports the program: the harness turns these arrays into the
program's objects (`portbench/program.py`), and the reference reads them
as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# the two elements of a water, by atomic number, as the program's tables
# hold them: mass, van der Waals radius, CPK colour 0xRRGGBB
MASS = {8: 15.999, 1: 1.008}
VDW_RADIUS = {8: 1.52, 1: 1.10}
CPK = {8: 0xFF0D0D, 1: 0xFFFFFF}

# the site geometry of one water in its own frame, Å
WATER_SITES = np.array([[0.0, 0.0, 0.0], [0.9572, 0.0, 0.0], [-0.24, 0.9266, 0.0]])


@dataclass
class WaterBox:
    """A periodic cube of `n_waters` waters (O, H, H per residue)."""

    n_waters: int
    box: float  # edge, Å
    coords: np.ndarray  # (n, 3) float32 base configuration
    z: np.ndarray  # (n,) int32 atomic numbers
    res_ids: np.ndarray  # (n,) int32, 1-based, one residue per water
    bonds: np.ndarray  # (2 · n_waters, 2) int32: O–H1, O–H2

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[0]

    @property
    def basis(self) -> np.ndarray:
        return np.diag(np.full(3, self.box)).astype(np.float32)

    def masses(self) -> np.ndarray:
        return np.where(self.z == 8, MASS[8], MASS[1]).astype(np.float32)

    def radii(self) -> np.ndarray:
        return np.where(self.z == 8, VDW_RADIUS[8], VDW_RADIUS[1]).astype(np.float32)

    def colors(self) -> np.ndarray:
        """(n, 4) float32 CPK colours, alpha 1."""
        packed = np.where(self.z == 8, CPK[8], CPK[1]).astype(np.uint32)
        rgb = np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], -1)
        rgb = rgb.astype(np.float32) / 255.0
        return np.concatenate([rgb, np.ones((self.n_atoms, 1), np.float32)], -1)


def host_seed(seed: int) -> int:
    """The seed as numpy's RandomState takes it (below 2**32)."""
    return int(seed) % (1 << 32)


def water_box(n_waters: int, density_atoms_per_A3: float, seed: int) -> WaterBox:
    """Grid-packed waters in a cube holding `density` atoms per Å³: lattice
    sites with a N(0, 0.1 cell) offset and a random rotation about z each."""
    rng = np.random.RandomState(host_seed(seed))
    n_atoms = n_waters * 3
    box = float(np.cbrt(n_atoms / density_atoms_per_A3))
    g = int(np.ceil(n_waters ** (1 / 3)))
    cell_w = box / g
    gg = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
    centers = (gg[:n_waters] + 0.5) * cell_w
    centers += rng.normal(scale=0.1 * cell_w, size=centers.shape)
    th = rng.uniform(0, 2 * np.pi, n_waters)
    c, s = np.cos(th), np.sin(th)
    offs = WATER_SITES
    ox = offs[None, :, 0] * c[:, None] - offs[None, :, 1] * s[:, None]
    oy = offs[None, :, 0] * s[:, None] + offs[None, :, 1] * c[:, None]
    coords = np.empty((n_waters, 3, 3), np.float32)
    coords[:, :, 0] = centers[:, None, 0] + ox
    coords[:, :, 1] = centers[:, None, 1] + oy
    coords[:, :, 2] = centers[:, None, 2] + offs[None, :, 2]
    o = np.arange(0, n_atoms, 3, dtype=np.int32)
    return WaterBox(
        n_waters=n_waters,
        box=box,
        coords=coords.reshape(-1, 3),
        z=np.tile(np.array([8, 1, 1], np.int32), n_waters),
        res_ids=np.repeat(np.arange(1, n_waters + 1, dtype=np.int32), 3),
        bonds=np.concatenate([np.stack([o, o + 1], 1), np.stack([o, o + 2], 1)]),
    )


def frames(wb: WaterBox, n_frames: int, jitter: float, seed: int, device) -> torch.Tensor:
    """(n_frames, n, 3) float32 frames on `device`: the base configuration
    plus jitter · N(0, 1) drawn there by a `torch.Generator` seeded with
    `seed`, in one call, so the same seed and device give the same bits."""
    device = torch.device(device)
    base = torch.as_tensor(wb.coords, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    stack = torch.randn((n_frames, *base.shape), generator=gen, dtype=torch.float32,
                        device=device)
    return stack.mul_(jitter).add_(base)


def make(config: dict, seed: int, device) -> tuple[WaterBox, torch.Tensor]:
    """The water box and frames a configuration file describes."""
    wb = water_box(config["n_waters"], config["density_atoms_per_A3"], seed)
    return wb, frames(wb, config["n_frames"], config["jitter_A"], seed, device)
