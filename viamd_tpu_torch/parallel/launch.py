"""Start the ranks of a mesh: one process a rank, on one host.

`spawn(fn, n_ranks, device, *args, timeout=)` runs `fn(*args)` in
`n_ranks` fresh processes (the *spawn* start method: a rank imports the
module of `fn` anew, so `fn` lives in a module that imports no JAX, never
in a test module). The ranks meet through a `FileStore` in a new temporary
directory — no TCP port, so concurrent launches cannot collide — and join
the default process group with `mesh.init_rank` (backend by
`mesh.backend_for`, collectives bounded by `timeout`). It returns each
rank's result, in rank order; a result must pickle.

If a rank raises, dies, or the ranks are not done within `timeout`
seconds, the surviving ranks are killed (none is left waiting in a
collective) and `spawn` raises with the failed rank's traceback. It
counterparts the JAX package's virtual CPU devices and its dry-run
subprocess (`__graft_entry__.py:86-132`).
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from viamd_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["RankError", "spawn"]


class RankError(RuntimeError):
    """A rank raised or died, or the ranks ran out of time."""


def _rank_main(rank, world, device_type, store_path, timeout, fn, args, results):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)  # ranks share the host's cores
        # every rank runs on this host: gloo's transport goes over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        mesh_mod.init_rank(rank, world, device_type,
                           dist.FileStore(store_path, world), timeout)
        msg = (rank, True, pickle.dumps(fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        msg = (rank, False, traceback.format_exc())
    results.put(msg)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, device, *args, timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `n_ranks` ranks of `device`'s type ("cuda" or
    "cpu") → [rank 0's result, ...]. Raises RankError on a rank's failure
    or after `timeout` seconds, with every rank process ended."""
    device_type = torch.device(device).type
    for r in range(n_ranks):  # fails here, before any process starts
        mesh_mod.rank_device(r, device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="viamd-mesh-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"rank-{r}",
                        args=(r, n_ranks, device_type, store, timeout, fn, args, results))
            for r in range(n_ranks)
        ]
        try:
            for p in procs:
                p.start()
            out = _collect(procs, results, deadline, timeout)
            for p in procs:  # they have reported; let them leave the group
                p.join(max(1.0, min(10.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
            results.close()
    return out


def _collect(procs, results, deadline: float, timeout: float) -> list:
    out: dict = {}
    while len(out) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(len(procs)) if r not in out]
            raise RankError(f"ranks {missing} not done within {timeout} s")
        try:
            rank, ok, payload = results.get(timeout=min(0.5, left))
        except queue_mod.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            if dead:
                try:  # a message may still be in the pipe
                    rank, ok, payload = results.get(timeout=2.0)
                except queue_mod.Empty:
                    r, code = dead[0]
                    raise RankError(f"rank {r} died with exit code {code}") from None
            else:
                continue
        if not ok:
            raise RankError(f"rank {rank} of {len(procs)} failed:\n{payload}")
        out[rank] = pickle.loads(payload)
    return [out[r] for r in range(len(procs))]
