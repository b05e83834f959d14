"""Process group, the 1-D "data" mesh and the row helpers (counterpart of
ocl_tpu/parallel/mesh.py).

ocl_tpu's mesh is a `jax.sharding.Mesh` over devices of one process. Here
each device of the mesh is a process, a rank of `torch.distributed`, and
`launch` starts them: under `torchrun` it joins the group the environment
describes (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT); otherwise it spawns
W local processes (start method "spawn", which CUDA requires) that meet
through a `FileStore` in a fresh temporary directory, so groups started side
by side never share a port. Rank r runs on cuda:(r % device_count), or on
the CPU under --device cpu.

Backend: NCCL when every rank has a card of its own, gloo when ranks share a
card or run on the CPU (NCCL refuses two ranks on one GPU). gloo takes CUDA
tensors for `all_reduce`, `broadcast` and `all_gather`, staging them through
the host; those are the only collectives used here.

A rank that raises ends the launch: `launch` stops the other ranks and
raises in the caller (under torchrun, torchrun does), and a collective that
waits longer than the group's timeout raises on its rank. No rank goes on
alone. Ranks that wait for a slower one (the CLI's ranks while rank 0 trains
a task, which may take hours) wait in `Mesh.wait_all`, on the store and with
no limit, and only then enter the collective.

`shard_batch` (`Mesh.rows`) is the counterpart of a `P("data")` sharding of
a batch axis: rank r takes rows [r n / W, (r + 1) n / W); an axis that W
does not divide raises ValueError, as the JAX sharding does; `gather_batch`
joins the ranks' rows back. ocl_tpu's replicated placement is a broadcast
from rank 0 (`Mesh.broadcast_tensors_`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 600   # a collective or the rendezvous that waits longer raises
# a spawned launch that outlasts this stops its ranks and raises (None: no
# limit, as a run of the CLI may last hours)
LAUNCH_TIMEOUT_S = None

_CURRENT = None         # this process's Mesh, once `init` has run


@dataclass
class Mesh:
    """One rank's view of the 1-D mesh named "data"."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None          # the process group of the mesh's one axis
    store: Any = None          # the rendezvous store (wait_all's counters)
    device_mesh: Any = None    # torch.distributed.device_mesh.DeviceMesh, ("data",)
    # collectives issued and the host seconds spent in them (each waits for
    # its result): what the distribution costs a step
    calls: int = 0
    seconds: float = 0.0
    waits: int = 0             # wait_all calls so far (each has its own counter)

    # ------------------------------------------------------------ rows

    def rows(self, n: int, what: str = "rows") -> slice:
        """This rank's rows of an axis of n (a P("data") sharding)."""
        if n % self.size:
            raise ValueError("{} {} cannot be split over {} ranks: {} is not a multiple of "
                             "{}".format(n, what, self.size, n, self.size))
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def span(self, n: int) -> slice:
        """This rank's contiguous share of n rows when W need not divide n
        (the first n % W ranks take one row more)."""
        per, extra = divmod(n, self.size)
        lo = self.rank * per + min(self.rank, extra)
        return slice(lo, lo + per + (self.rank < extra))

    def local(self, t, axis: int = 0, what: str = "rows"):
        """This rank's rows of `t` along `axis`."""
        s = self.rows(t.shape[axis], what)
        return t.narrow(axis, s.start, s.stop - s.start)

    # ------------------------------------------------- collectives (no grad)

    def _timed(self, op, *args):
        t0 = time.perf_counter()
        op(*args, group=self.group)
        self.calls += 1
        self.seconds += time.perf_counter() - t0

    def all_reduce_(self, t):
        """Sum of `t` over the ranks, in place; returns t."""
        self._timed(dist.all_reduce, t)
        return t

    def broadcast_(self, t, src: int = 0):
        """Rank `src`'s `t` on every rank, in place; returns t."""
        self._timed(dist.broadcast, t, src)
        return t

    def all_gather(self, t, axis: int = 0):
        """Every rank's `t` (equal shapes), joined along `axis` in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        self._timed(dist.all_gather, out, t)
        return torch.cat(out, dim=axis)

    def broadcast_tensors_(self, tensors, src: int = 0) -> None:
        """Rank `src`'s values of `tensors` on every rank, in place: one
        collective per dtype (the tensors flattened into one buffer)."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            self.broadcast_(flat, src)
            with torch.no_grad():
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

    def barrier(self) -> None:
        self.all_reduce_(torch.zeros(1, device=self.device))

    def wait_all(self) -> None:
        """Return once every rank has reached its matching call, waiting on
        the store with no limit: a collective would time out on a rank
        that waits longer than the group's timeout for a slower one. A rank
        that dies meanwhile ends the launch from outside (`launch`, or
        torchrun), so no rank waits for ever."""
        self.waits += 1
        key = "wait_all/{}".format(self.waits)
        if self.store.add(key, 1) == self.size:   # the last to come says so
            self.store.set(key + "/all", "1")
        while not self.store.check([key + "/all"]):
            time.sleep(0.01)


def current() -> Mesh | None:
    """This process's mesh (set by `launch` in each rank), or None in a
    single process."""
    return _CURRENT


def rank_device(rank: int, device: str) -> torch.device:
    """Rank r's device: cuda:(r % device_count) for a CUDA spec, else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def pick_backend(world_size: int, device: str) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def layout_line(world_size: int, device_type: str, backend: str) -> str:
    if device_type != "cuda":
        return "[parallel] {} ranks on the CPU, backend {}".format(world_size, backend)
    cards = torch.cuda.device_count()
    used = {r % cards for r in range(world_size)}
    per = ", ".join("cuda:{} x{}".format(c, sum(r % cards == c for r in range(world_size)))
                    for c in sorted(used))
    return "[parallel] {} ranks on {} card(s) ({}), backend {}".format(
        world_size, len(used), per, backend)


def init(rank: int, world_size: int, device: str, backend: str | None = None,
         store=None, timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """Join the process group as `rank` of `world_size` (through `store`, or
    the environment's address when None) and build the "data" mesh."""
    global _CURRENT
    from torch.distributed.device_mesh import init_device_mesh

    backend = backend or pick_backend(world_size, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is None:
        kw["init_method"] = "env://"
    else:
        kw["store"] = store
    if dev.type == "cuda" and backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    if store is None:   # the one env:// made
        store = dist.distributed_c10d._get_default_store()
    dm = init_device_mesh(dev.type, (world_size,), mesh_dim_names=("data",))
    _CURRENT = Mesh(rank=rank, size=world_size, device=dev, backend=backend,
                    group=dm.get_group("data"), device_mesh=dm, store=store)
    return _CURRENT


def shutdown() -> None:
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def _worker(rank, fn, args, world_size, store_path, device, backend, out_dir, threads):
    torch.set_num_threads(threads)
    init(rank, world_size, device, backend, store=dist.FileStore(store_path, world_size))
    if rank:
        sys.stdout = open(os.devnull, "w")   # rank 0 alone prints
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, "rank{}.pkl".format(rank)), "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown()


def launch(fn: Callable, args=(), world_size: int = 2, device: str = "cuda",
           backend: str | None = None) -> list:
    """`fn(*args)` on `world_size` ranks; returns each rank's return value,
    in rank order (under torchrun: this rank's alone, in a list of one).

    `fn` must be importable by name (a module-level function) and return
    something picklable. Each rank's torch runs on its share of the
    caller's threads. A rank that raises, or a launch that outlasts
    LAUNCH_TIMEOUT_S, stops every rank and raises here."""
    if under_torchrun():
        init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device, backend)
        try:
            return [fn(*args)]
        finally:
            shutdown()
    import torch.multiprocessing as mp

    backend = backend or pick_backend(world_size, device)
    print(layout_line(world_size, torch.device(device).type, backend), flush=True)
    threads = max(1, torch.get_num_threads() // world_size)
    tmp = tempfile.mkdtemp(prefix="ocl_tpu_torch_ranks_")
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, args, world_size, os.path.join(tmp, "store"), device, backend,
                           tmp, threads),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if LAUNCH_TIMEOUT_S is None else time.time() + LAUNCH_TIMEOUT_S
        while not ctx.join(timeout=1):
            if deadline is not None and time.time() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError("{} ranks of {} did not finish within {} s".format(
                    world_size, getattr(fn, "__name__", fn), LAUNCH_TIMEOUT_S))
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, "rank{}.pkl".format(r)), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_batch(mesh: Mesh, t, axis: int = 0):
    """This rank's rows of `t`'s batch axis (ocl_tpu's P("data") sharding)."""
    return mesh.local(t, axis, "test batch rows" if axis == 1 else "batch rows")


def gather_batch(mesh: Mesh, t, axis: int = 0):
    """The whole batch axis back from every rank's rows (shard_batch's
    inverse)."""
    return mesh.all_gather(t, axis)


def get_mesh(n_devices: int = 0) -> Mesh:
    """The current mesh (ocl_tpu's get_mesh over the first n devices): the
    ranks exist only inside `launch`, so `n_devices` must be 0 or the
    group's size."""
    mesh = current()
    if mesh is None:
        raise RuntimeError("no process group: run inside parallel.launch (or torchrun)")
    if n_devices and n_devices != mesh.size:
        raise ValueError("a mesh of {} ranks was asked for inside a group of {}".format(
            n_devices, mesh.size))
    return mesh
