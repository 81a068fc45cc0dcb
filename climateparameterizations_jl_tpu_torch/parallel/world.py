"""The world of ranks the parallel layer runs on: joining it, spawning it, gathering from it, and its collectives.

The JAX package runs one controller, and GSPMD inserts the collectives from
sharding annotations. Here one process runs per device, and every collective
of the parallel modules is written out through the wrappers below
(:func:`all_reduce`, :func:`all_gather`, :func:`all_to_all`,
:func:`broadcast`, :func:`exchange`). Each wrapper records its op and the
elements of the buffer it fills in the :class:`CollectiveLog` that
:func:`recording` made active, so a run can show which collectives it issued
and how large they were (the counterpart of reading the compiled HLO in the
JAX package's ``tests/test_collective_audit.py``).

A world is joined from the usual environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them) or from a file
store (:func:`join_world`), or spawned, one process per rank
(:func:`spawn_world`). NCCL on cards, gloo on the CPU, and no fallback from
one to the other.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world, or,
where no process group is initialized, the one ``torch.device`` every tensor
lies on (:func:`axis_of` reads both).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# joining and spawning a world
# ---------------------------------------------------------------------------

TIMEOUT_S = 600


def join_world(backend: str | None = None, init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> int:
    """Initialize the default process group; returns this process's rank.

    Without ``init_method`` the group is joined from the environment that
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); ``init_method="file:///path"`` joins through a file
    store with the given ``rank`` and ``world_size``. ``backend`` defaults to
    NCCL where a card is present and gloo otherwise. Under NCCL the process
    uses ``cuda:LOCAL_RANK`` (``cuda:rank`` where ``LOCAL_RANK`` is unset).
    A process already in a group stays in it.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"join_world: {', '.join(missing)} unset; start the ranks with torchrun "
                               "(torchrun --nproc-per-node N -m climateparameterizations_jl_tpu_torch.cli ...) or "
                               "pass init_method='file:///path' with rank and world_size")
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank()


def world_from_env(backend: str | None = None) -> bool:
    """Join the world this process was started in (``torchrun``): True where it has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    join_world(backend)
    return True


def local_device(device=None) -> torch.device:
    """The device of this rank's tensors: ``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo, else ``device``."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    from climateparameterizations_jl_tpu_torch.device import resolve_device

    return resolve_device(device)


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str, args: bytes, results) -> None:
    try:
        join_world(backend, f"file://{store}", rank, world_size)
        # Pickled by value: tensors sent through a torch.multiprocessing queue travel as shared-memory handles,
        # which die with the rank that made them.
        results.put((rank, True, pickle.dumps(fn(*pickle.loads(args)))))
    except BaseException:  # noqa: BLE001 - the parent re-raises it with this rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world_size: int, args: tuple = (), backend: str = "gloo", timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks joined in one group; returns their results in rank order.

    Each rank is a ``torch.multiprocessing`` process of the spawn context,
    joined through a file store in a temporary directory; ``fn`` must be
    importable by name and its result picklable. Under NCCL rank ``r`` uses
    ``cuda:r``. A rank that raises fails the whole world: the others are
    stopped and a ``RuntimeError`` carries the rank's traceback. Every
    process is joined or killed before this returns.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="world_")
    results = ctx.Queue()
    payload = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, os.path.join(tmp, "store"), payload,
                                                  results)) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_world: rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"spawn_world: no result from ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"after {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn_world: rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its process group (``None`` off a world), rank and size."""

    group: object
    rank: int
    size: int

    def global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def axis_of(mesh, name: str | None = None) -> Axis:
    """The axis ``name`` of ``mesh`` (its only axis for ``None``); a ``torch.device`` is one rank of one."""
    if isinstance(mesh, torch.device) or mesh is None:
        return Axis(None, 0, 1)
    names = mesh.mesh_dim_names or ()
    if name is None:
        if mesh.ndim != 1:
            raise ValueError(f"axis_of: a {mesh.ndim}-D mesh needs an axis name, one of {names}")
        name = names[0] if names else None
    group = mesh.get_group(name) if name is not None else mesh.get_group()
    return Axis(group, dist.get_rank(group), dist.get_world_size(group))


def device_of(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``."""
    if isinstance(mesh, torch.device):
        return mesh
    return torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")


# ---------------------------------------------------------------------------
# the log of collectives
# ---------------------------------------------------------------------------


class CollectiveLog:
    """The collectives a run issued, in order: ``(op, elements)`` per call."""

    def __init__(self):
        self.records: list[tuple[str, int]] = []

    def add(self, op: str, elements: int) -> None:
        self.records.append((op, int(elements)))

    def summary(self) -> list[dict]:
        """``[{"op", "elements", "count"}]``: the calls grouped by op and element count, in first-call order."""
        counts: dict = {}
        for rec in self.records:
            counts[rec] = counts.get(rec, 0) + 1
        return [{"op": op, "elements": n, "count": c} for (op, n), c in counts.items()]


_ACTIVE: list[CollectiveLog] = []


@contextlib.contextmanager
def recording():
    """Make a fresh :class:`CollectiveLog` active for the block; yields it."""
    log = CollectiveLog()
    _ACTIVE.append(log)
    try:
        yield log
    finally:
        _ACTIVE.pop()


def _record(op: str, elements: int) -> None:
    for log in _ACTIVE:
        log.add(op, elements)


# ---------------------------------------------------------------------------
# collectives (each a no-op off a world; every call is logged)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over the axis, in place; returns ``t``. Every rank gets the same bits."""
    if axis.group is None:
        return t
    _record("all_reduce", t.numel())
    dist.all_reduce(t, group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``(size, *t.shape)``: every rank's ``t`` stacked in rank order."""
    if axis.group is None:
        return t[None]
    out = torch.empty((axis.size * t.numel(),), dtype=t.dtype, device=t.device)
    _record("all_gather", out.numel())
    # all_gather_single is all_gather_into_tensor's newer name.
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, t.contiguous().reshape(-1), group=axis.group)
    return out.view(axis.size, *t.shape)


def all_to_all(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Block transpose: ``t`` is ``(size, ...)`` and block ``j`` goes to rank ``j``; returns the blocks received,
    block ``i`` from rank ``i``."""
    if axis.group is None:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    _record("all_to_all", out.numel())
    dist.all_to_all_single(out, t.contiguous(), group=axis.group)
    return out


def broadcast(t: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (in place); returns ``t``."""
    if axis.group is None:
        return t
    _record("broadcast", t.numel())
    dist.broadcast(t, src=axis.global_rank(src), group=axis.group)
    return t


def exchange(send: torch.Tensor, to: int | None, frm: int | None, axis: Axis) -> torch.Tensor | None:
    """Send ``send`` to rank ``to`` and receive a tensor of its shape from rank ``frm``; returns the received one.

    Either peer may be ``None`` (a wall: nothing sent, or ``None``
    returned). Logged as ``"sendrecv"`` with the elements received. A rank
    that is its own peer (``to == frm == rank``, a periodic axis of one rank)
    copies its own rows: ``torch.distributed`` sends nothing to oneself.
    """
    if to == axis.rank and frm == axis.rank:
        return send.clone()
    ops, recv = [], None
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), axis.global_rank(to), axis.group))
    if frm is not None:
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
        _record("sendrecv", recv.numel())
        ops.append(dist.P2POp(dist.irecv, recv, axis.global_rank(frm), axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv
