"""Evaluation engine: drive a CompiledScript over a trajectory.

Counterpart of viamd_tpu.eval.engine (md_script_eval_frame_range,
VIAMD src/main.cpp:959-1035). Frames are walked in chunks, one `frame_fn`
call per frame, on the compiled script's device: temporal values are
stacked per chunk, distribution and volume accumulators are summed over
frames in float32 — within a chunk first, then into the running total, the
order the JAX package sums in. Results stay on the device until first read.

The Evaluator takes any port `Trajectory`:
- a `DeviceTrajectory` (frames already on the device, e.g. staged with
  `DeviceTrajectory.stage`) is read as zero-copy views;
- any other trajectory is streamed a chunk at a time (`ChunkStream`): one
  host thread loads chunk k+1 into one of two staging buffers while the
  caller's thread launches chunk k; on a CUDA device the buffers are
  page-locked and each chunk is copied on a stream of its own, which the
  compute stream waits on through an event, so the launching thread never
  waits for a disk read, a pageable copy or the device. The same
  coordinates reach the same `frame_fn` in the same order as staged.

The trajectory's cells (known at open) are moved to the device once, when
the Evaluator is built, and it keeps the script bound to grids sized for
the smallest perpendicular widths over all frames (`CompiledScript.fitted`,
its `script`), so a frame whose box shrank loses no pair. The
CompiledScript itself is not changed.

`run` is interruptible between chunks, reports progress, and resumes from
an earlier (possibly loaded) result: its completed frames are skipped and
the two results merged (`merge_results`). `save_checkpoint` /
`load_checkpoint` use the JAX package's `.npz` keys, so a checkpoint
written by either package loads in the other.

With a device mesh (`mesh=`, parallel/mesh.py), each rank of the frames
axis evaluates its block of every chunk (the chunk a multiple of the mesh's
ranks, as in the JAX package); the ranks of one atoms line evaluate the
same frames, so a script compiled with `atom_shard` is evaluated on the
mesh it was compiled on (or with no mesh: every rank then evaluates every
frame). Accumulators are summed on each rank and over the frames axis
once at the end; the temporal rows are gathered on the host, through a
gloo group, into frame order (gloo cannot gather CUDA tensors, and a sum
into zeros would turn a −0 into +0). Every rank takes every chunk step —
`interrupt()` is asked on the mesh's first rank and its answer broadcast —
and returns the same EvalResult.

Not ported: the JAX engine's batch modes (unroll/vmap/dispatch) and
VIAMD_TPU_PROP_BARRIER — PyTorch runs eagerly, frame by frame.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from viamd_tpu_torch.core.bitfield import Bitfield
from viamd_tpu_torch.core.tracing import section, traced
from viamd_tpu_torch.io.trajectory import DeviceTrajectory, Trajectory
from viamd_tpu_torch.ops.neighbors import diagonal_cells, perpendicular_widths
from viamd_tpu_torch.ops.pbc import inv_basis_of
from viamd_tpu_torch.ops.rdf import rdf_normalize
from viamd_tpu_torch.script.compiler import CompiledScript, FittedScript
from viamd_tpu_torch.script.values import AccumSpec, PropertyMeta

_eval_generation = itertools.count(1)
_SPEC_FIELDS = ("kind", "nbins", "r_min", "r_max", "x_unit",
                "count_a", "count_b", "dims", "extent", "n_structures")


@dataclasses.dataclass
class EvalResult:
    """Evaluated properties over a frame range; tensors convert to numpy
    lazily (and once) on first access."""

    frame_indices: np.ndarray  # (F,) evaluated frame indices
    times: np.ndarray  # (F,) frame times
    frame_mask: Bitfield  # completed frames over the whole trajectory
    properties: list
    n_frames_done: int = 0
    interrupted: bool = False
    _temporal_dev: list = dataclasses.field(default_factory=list)  # per chunk
    _dist_dev: dict = dataclasses.field(default_factory=dict)
    _vol_dev: dict = dataclasses.field(default_factory=dict)
    _temporal_np: Optional[dict] = None
    _dist_np: Optional[dict] = None
    _vol_np: Optional[dict] = None
    _dist_weights: dict = dataclasses.field(default_factory=dict)
    # eval generation (md_script_eval fingerprints, main.cpp:1490-1517):
    # every completed, merged or loaded result gets a fresh value
    fingerprint: int = 0

    def _leaves(self) -> list:
        leaves = list(self._dist_dev.values()) + list(self._vol_dev.values())
        for chunk in self._temporal_dev:
            leaves += list(chunk.values())
        return leaves

    @traced("result.force")
    def force(self) -> float:
        """Wait for all device work behind this result; returns a checksum
        (the sum of every value)."""
        leaves = self._leaves()
        if not leaves:
            return 0.0
        if leaves[0].is_cuda:
            torch.cuda.synchronize(leaves[0].device)
        return float(sum(v.to(torch.float32).sum() for v in leaves))

    @property
    def temporal(self) -> dict:
        if self._temporal_np is None:
            out = {}
            if self._temporal_dev:
                for k in self._temporal_dev[0]:
                    v = torch.cat([c[k] for c in self._temporal_dev])
                    out[k] = v.reshape(v.shape[0], -1).cpu().numpy()
            self._temporal_np = out
        return self._temporal_np

    @property
    def distributions(self) -> dict:
        if self._dist_np is None:
            self._dist_np = {k: v.cpu().numpy() for k, v in self._dist_dev.items()}
        return self._dist_np

    @property
    def volumes(self) -> dict:
        if self._vol_np is None:
            self._vol_np = {k: v.cpu().numpy() for k, v in self._vol_dev.items()}
        return self._vol_np

    def property(self, name: str) -> PropertyMeta:
        for p in self.properties:
            if p.name == name:
                return p
        raise KeyError(name)

    # -- derived views (the DisplayProperty family, main.cpp:1247-1489) ------
    def aggregate(self, name: str) -> dict:
        """Population mean/var/min/max over the dim axis per frame."""
        v = self.temporal[name]
        return {
            "mean": v.mean(axis=1),
            "var": v.var(axis=1),
            "min": v.min(axis=1),
            "max": v.max(axis=1),
        }

    def histogram(
        self, name: str, bins: int = 128, vrange: Optional[tuple] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Distribution of a temporal property over evaluated frames
        (the re-binning of update_display_properties, main.cpp:1490-1517)."""
        v = self.temporal[name].reshape(-1)
        lo, hi = vrange if vrange else (float(v.min()), float(v.max()))
        if hi <= lo:
            hi = lo + 1.0
        hist, edges = np.histogram(v, bins=bins, range=(lo, hi))
        return hist.astype(np.float32), edges

    def rebin(
        self,
        name: str,
        num_bins: int,
        weights: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Re-bin a distribution property to `num_bins` display bins with
        the reference's downsample semantics (downsample_histogram,
        main.cpp:232-250): each destination bin is the weight-normalized sum
        of `factor = num_src // num_dst` consecutive source bins,
        dst[j] = Σ src[j·f+i] / Σ w[j·f+i]. `weights` defaults to the
        property's stored per-bin weights (set_distribution_weights), else
        1.0 per source bin."""
        src = np.asarray(self.distributions[name], np.float64).reshape(-1)
        if weights is None:
            weights = self._dist_weights.get(name)
        nsrc = src.shape[0]
        if num_bins > nsrc:
            raise ValueError(
                f"rebin: {num_bins} display bins > {nsrc} source bins"
            )
        factor = max(1, nsrc // num_bins)
        dst = np.zeros(num_bins, np.float64)
        wsum = np.zeros(num_bins, np.float64)
        idx = np.arange(num_bins) * factor
        for i in range(factor):
            dst += src[idx + i]
            if weights is not None:
                wsum += np.asarray(weights, np.float64).reshape(-1)[idx + i]
            else:
                wsum += 1.0
        out = np.divide(dst, wsum, out=np.zeros_like(dst), where=wsum != 0)
        return out.astype(np.float32)

    def set_distribution_weights(self, name: str, weights) -> None:
        """Attach per-bin weights to a distribution property (the
        md_script_property_data_t `weights` the reference's display
        re-binning honors, main.cpp:1508)."""
        self.property(name)  # raises KeyError for unknown properties
        self._dist_weights[name] = np.asarray(weights, np.float32)

    def normalized_distribution(self, name: str, volume: float) -> np.ndarray:
        """g(r) for an rdf property."""
        p = self.property(name)
        return rdf_normalize(
            torch.as_tensor(self.distributions[name]),
            p.spec.count_a, p.spec.count_b, volume, p.spec.r_max,
            max(self.n_frames_done, 1),
        ).numpy()

    def normalized_volume(self, name: str) -> np.ndarray:
        """Mean per-frame per-structure occupancy grid for an sdf property."""
        p = self.property(name)
        denom = max(self.n_frames_done, 1) * max(p.spec.n_structures, 1)
        return self.volumes[name] / denom


class ChunkStream:
    """Feeds chunks of a host trajectory to a device: two staging buffers
    (page-locked on CUDA) filled by one loader thread, each chunk copied to
    the device on a copy stream of its own.

    `start(chunks)` begins loading the first chunk; each `next()` — the
    staging step — waits for that chunk's host load, starts the load of
    the next one into the other buffer, enqueues the copy and makes the
    current (compute) stream wait for it through an event, and returns the
    chunk on the device. Before refilling a buffer the loader waits for
    that buffer's last copy only, never for compute; the chunk tensor is
    kept from reuse until the compute stream's work on it is done
    (`record_stream`). On a CPU device the buffers are ordinary memory and
    a chunk is a copy of its buffer. `close()` waits for the loader."""

    def __init__(self, traj: Trajectory, device: torch.device, chunk: int):
        self.traj, self.device = traj, device
        self._cuda = device.type == "cuda"
        shape = (chunk, traj.num_atoms, 3)
        self._bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=self._cuda)
                      for _ in range(2)]
        self._copied: list = [None, None]  # each buffer's last copy (event)
        self._copy_stream = torch.cuda.Stream(device) if self._cuda else None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._chunks: list = []
        self._k = 0
        self._pending = None  # (chunk indices, buffer, future) of chunk k

    def _load(self, idx: np.ndarray, b: int, copied) -> None:
        if copied is not None:
            copied.synchronize()  # this buffer's last copy has left it
        self.traj.load_frames_into(idx, self._bufs[b][: idx.size].numpy())

    def _submit(self) -> None:
        if self._k >= len(self._chunks):
            self._pending = None
            return
        idx, b = self._chunks[self._k], self._k % 2
        self._pending = (idx, b, self._pool.submit(self._load, idx, b, self._copied[b]))

    def start(self, chunks: list) -> None:
        self.close()
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="chunk-loader")
        self._chunks, self._k = list(chunks), 0
        self._submit()

    def ready(self) -> None:
        """Block until the next chunk's host load has finished."""
        if self._pending is not None:
            self._pending[2].result()

    def next(self) -> tuple[np.ndarray, torch.Tensor]:
        """The staging step → (the chunk's frame indices, (B, n, 3) float32
        coordinates on the device)."""
        idx, b, fut = self._pending
        fut.result()
        self._k += 1
        self._submit()  # the next chunk loads into the other buffer
        src = self._bufs[b][: idx.size]
        if not self._cuda:
            return idx, src.clone()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            x = src.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._copied[b] = done
        compute.wait_event(done)
        x.record_stream(compute)
        return idx, x

    def close(self) -> None:
        """Stop loading: a chunk not loaded yet is dropped (after an
        interrupt nothing reads it), one being loaded is waited for."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool, self._pending = None, None


class Evaluator:
    """Chunked, interruptible evaluation of a compiled script over any
    Trajectory: a DeviceTrajectory on the script's device is read in place,
    any other trajectory is streamed (ChunkStream). With `mesh`, this rank's
    share of it (module docstring)."""

    def __init__(self, compiled: CompiledScript, traj: Trajectory, chunk: int = 16,
                 mesh=None, frames_axis: str = "frames"):
        if not isinstance(traj, Trajectory):
            raise TypeError(f"Evaluator needs a Trajectory, got {type(traj).__name__}")
        device = compiled.device
        if isinstance(traj, DeviceTrajectory):
            if traj.device != device:
                raise ValueError(
                    f"trajectory on {traj.device}, script compiled for {device}"
                )
            cells = traj.cells
        else:
            cells = torch.as_tensor(
                np.array(traj.cells, np.float32).reshape(-1, 3, 3), device=device
            )
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.block = chunk  # the frames of a chunk this rank evaluates
        if compiled.atom_shard is not None and mesh is not None:
            # frame_fn sums over a line of the compile's mesh: its ranks
            # must evaluate the same frames
            shard_mesh, shard_axis = compiled.atom_shard
            if mesh is not shard_mesh:
                raise ValueError(
                    f"script compiled with atom_shard on the mesh {shard_mesh.shape}, "
                    f"evaluated on the mesh {mesh.shape}: evaluate it on its own mesh "
                    "(or with none)"
                )
            if shard_axis == frames_axis:
                raise ValueError(f"atom_shard's axis '{shard_axis}' is the frames axis")
        if mesh is not None:
            if mesh.device != device:
                raise ValueError(f"mesh rank on {mesh.device}, script compiled for {device}")
            # a chunk a multiple of the mesh's ranks (JAX engine.py:280-283)
            chunk = max(chunk, mesh.size) // mesh.size * mesh.size
            self.block = chunk // mesh.shape[frames_axis]
        self.compiled = compiled
        self.traj = traj
        self.chunk = chunk
        self.mesh = mesh
        self.frames_axis = frames_axis
        self._cells = cells
        self._inv = inv_basis_of(cells)  # (F, 3, 3), once
        # the cells, read to the host once: every cell-list grid is sized
        # for the smallest perpendicular widths over all frames, so no
        # frame's cells are narrower than the grid's reach
        cells_np = cells.cpu().numpy()
        self.script: FittedScript = compiled.fitted(
            perpendicular_widths(cells_np).min(axis=0),
            bool(diagonal_cells(cells_np).all()),
        )
        self._stream: Optional[ChunkStream] = None

    def stream(self) -> ChunkStream:
        """The ChunkStream a host trajectory runs through (made once)."""
        if isinstance(self.traj, DeviceTrajectory):
            raise TypeError("a DeviceTrajectory is read in place, not streamed")
        if self._stream is None:
            self._stream = ChunkStream(self.traj, self.compiled.device, self.block)
        return self._stream

    def run(
        self,
        frame_range: Optional[Iterable[int]] = None,
        progress: Optional[Callable[[float], None]] = None,
        interrupt: Optional[Callable[[], bool]] = None,
        resume_from: Optional[EvalResult] = None,
    ) -> EvalResult:
        """Evaluate `frame_range` (all frames by default). `interrupt()` is
        asked before each chunk and stops the run (the result says
        `interrupted`); `progress(done / total)` follows each chunk. With
        `resume_from`, its completed frames are skipped and the results
        merged (the md_script_eval_frame_mask resume path)."""
        traj, mesh = self.traj, self.mesh
        indices = (
            np.asarray(list(frame_range), np.int64)
            if frame_range is not None
            else np.arange(traj.num_frames, dtype=np.int64)
        )
        if resume_from is not None:
            done_mask = resume_from.frame_mask
            indices = np.asarray(
                [i for i in indices if not done_mask.test_bit(int(i))], np.int64
            )
        n_total = indices.size
        chunks = [indices[b : b + self.chunk] for b in range(0, n_total, self.chunk)]
        # this rank's frames of each chunk, as positions in `indices`
        k = 0 if mesh is None else mesh.axis_index(self.frames_axis)
        mine = [np.arange(b + k * self.block, min(b + (k + 1) * self.block, b + c.size))
                for b, c in zip(range(0, n_total, self.chunk), chunks)]
        frame_fn = self.script.frame_fn
        t_chunks: list = []
        evaluated: list = []  # the positions of this rank's evaluated frames
        acc: Optional[dict] = None
        done, interrupted = 0, False
        stream = None if isinstance(traj, DeviceTrajectory) else self.stream()
        try:
            if stream is not None:
                stream.start([indices[m] for m in mine if m.size])
            for chunk_idx, pos in zip(chunks, mine):
                if self._stop(interrupt):
                    interrupted = True
                    break
                if pos.size:
                    with section("eval.chunk"):
                        xs = None if stream is None else stream.next()[1]
                        rows, chunk_sum = [], None
                        for j, fi in enumerate(indices[pos]):
                            fi = int(fi)
                            x = traj.stack[fi] if xs is None else xs[j]
                            with section("eval.frame"):
                                t, a = frame_fn(x, self._cells[fi], self._inv[fi])
                            rows.append(t)
                            chunk_sum = (
                                a if chunk_sum is None
                                else {n: chunk_sum[n] + a[n] for n in a}
                            )
                        t_chunks.append({n: torch.stack([r[n] for r in rows]) for n in rows[0]})
                        if acc is None:
                            acc = {n: torch.zeros_like(v, dtype=torch.float32)
                                   for n, v in chunk_sum.items()}
                        acc = {n: acc[n] + chunk_sum[n] for n in acc}
                    evaluated.append(pos)
                done += chunk_idx.size
                if progress is not None:
                    progress(done / n_total)
        finally:
            if stream is not None:
                stream.close()
        with section("eval.result"):
            if mesh is not None:
                pos = np.concatenate(evaluated) if evaluated else np.zeros(0, np.int64)
                t_chunks, acc = self._combine(pos, t_chunks, acc)
            acc = acc or {}
            completed = indices[:done]
            frame_mask = Bitfield(traj.num_frames)
            for fi in completed:
                frame_mask.set_bit(int(fi))
            result = EvalResult(
                frame_indices=completed,
                times=np.asarray(traj.frame_times)[completed],
                frame_mask=frame_mask,
                properties=self.compiled.properties,
                n_frames_done=done,
                interrupted=interrupted,
                _temporal_dev=t_chunks,
                _dist_dev={k: v for k, v in acc.items() if v.ndim == 1},
                _vol_dev={k: v for k, v in acc.items() if v.ndim > 1},
                fingerprint=next(_eval_generation),
            )
            if resume_from is not None:
                result = merge_results(resume_from, result)
            return result

    def _stop(self, interrupt) -> bool:
        """Whether to stop before the next chunk: `interrupt()`, on a mesh
        asked on its first rank and broadcast to every rank."""
        mesh = self.mesh
        if mesh is None:
            return interrupt is not None and bool(interrupt())
        first = mesh.rank == int(mesh.ranks.flat[0])
        return bool(mesh.broadcast_object(first and interrupt is not None and bool(interrupt())))

    def _combine(self, pos: np.ndarray, t_chunks: list, acc: Optional[dict]):
        """This rank's rows (at positions `pos` of the run's frames) and
        accumulators → the whole frames axis': the rows gathered on the
        host into frame order (one chunk on the device), the accumulators
        summed over the axis."""
        mesh, axis = self.mesh, self.frames_axis
        rows = {n: torch.cat([c[n] for c in t_chunks]).cpu().numpy() for n in t_chunks[0]} \
            if t_chunks else {}
        shapes = None if acc is None else [(n, tuple(v.shape)) for n, v in acc.items()]
        parts = mesh.all_gather_object((pos.astype(np.int64), rows, shapes), axis)
        # positions across the axis are 0 .. done−1, each once
        n_rows = sum(p[0].size for p in parts)
        temporal = {}
        for p_pos, p_rows, _ in parts:
            for n, v in p_rows.items():
                if n not in temporal:
                    temporal[n] = np.empty((n_rows,) + v.shape[1:], v.dtype)
                temporal[n][p_pos] = v
        dev = self.compiled.device
        t_out = [{n: torch.as_tensor(v, device=dev) for n, v in temporal.items()}] \
            if temporal else []
        shapes = next((p[2] for p in parts if p[2] is not None), None)
        if shapes is None:
            return t_out, None
        if acc is None:
            acc = {n: torch.zeros(shape, dtype=torch.float32, device=dev) for n, shape in shapes}
        return t_out, {n: mesh.all_reduce(acc[n], axis) for n, _ in shapes}


def evaluate(
    compiled: CompiledScript,
    traj: Trajectory,
    frame_range: Optional[Iterable[int]] = None,
    chunk: int = 16,
    progress: Optional[Callable[[float], None]] = None,
    interrupt: Optional[Callable[[], bool]] = None,
    mesh=None,
) -> EvalResult:
    """One-shot evaluation (the Shift+Enter path, main.cpp:949-985); with
    `mesh`, this rank's share of a sharded one."""
    return Evaluator(compiled, traj, chunk=chunk, mesh=mesh).run(frame_range, progress, interrupt)


def merge_results(a: EvalResult, b: EvalResult) -> EvalResult:
    """Merge two evaluations of disjoint frame sets (resume bookkeeping):
    temporal rows in frame order, accumulators `b + a`."""
    idx = np.concatenate([a.frame_indices, b.frame_indices])
    order = np.argsort(idx, kind="stable")
    temporal = {}
    for k in set(a.temporal) | set(b.temporal):
        va = a.temporal.get(k)
        vb = b.temporal.get(k)
        if va is None or vb is None:
            temporal[k] = va if vb is None else vb
        else:
            temporal[k] = np.concatenate([va, vb])[order]
    dist = dict(b.distributions)
    for k, v in a.distributions.items():
        dist[k] = dist[k] + v if k in dist else v
    vol = dict(b.volumes)
    for k, v in a.volumes.items():
        vol[k] = vol[k] + v if k in vol else v
    merged = EvalResult(
        frame_indices=idx[order],
        times=np.concatenate([a.times, b.times])[order],
        frame_mask=a.frame_mask | b.frame_mask,
        properties=b.properties or a.properties,
        n_frames_done=a.n_frames_done + b.n_frames_done,
        interrupted=b.interrupted,
        fingerprint=next(_eval_generation),
    )
    merged._temporal_np = temporal
    merged._dist_np = dist
    merged._vol_np = vol
    return merged


def save_checkpoint(result: EvalResult, path: str):
    """Persist an evaluation (possibly partial) for a later resume: the
    completed-frame mask and the accumulators, in the JAX package's keys."""
    payload = {
        "frame_indices": result.frame_indices,
        "times": result.times,
        "mask_words": result.frame_mask.words,
        "mask_count": np.asarray([result.frame_mask.count]),
        "n_done": np.asarray([result.n_frames_done]),
    }
    for k, v in result.temporal.items():
        payload[f"t::{k}"] = v
    for k, v in result.distributions.items():
        payload[f"d::{k}"] = v
    for k, v in result.volumes.items():
        payload[f"v::{k}"] = v
    meta = []
    for p in result.properties:
        spec = None
        if p.spec is not None:
            spec = {f: getattr(p.spec, f) for f in _SPEC_FIELDS}
        meta.append(
            {"name": p.name, "kind": p.kind, "dim": p.dim, "unit": p.unit,
             "spec": spec}
        )
    payload["props_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str) -> EvalResult:
    z = np.load(path)
    meta = json.loads(bytes(z["props_json"]).decode())
    props = [
        PropertyMeta(
            name=m["name"], kind=m["kind"], dim=m["dim"], unit=m["unit"],
            spec=AccumSpec(**m["spec"]) if m["spec"] else None,
        )
        for m in meta
    ]
    mask = Bitfield(int(z["mask_count"][0]), z["mask_words"].copy())
    res = EvalResult(
        frame_indices=z["frame_indices"],
        times=z["times"],
        frame_mask=mask,
        properties=props,
        n_frames_done=int(z["n_done"][0]),
        fingerprint=next(_eval_generation),
    )
    res._temporal_np = {k[3:]: z[k] for k in z.files if k.startswith("t::")}
    res._dist_np = {k[3:]: z[k] for k in z.files if k.startswith("d::")}
    res._vol_np = {k[3:]: z[k] for k in z.files if k.startswith("v::")}
    return res
