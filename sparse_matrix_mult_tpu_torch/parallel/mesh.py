"""The row mesh, multi-process initialisation, and the ring transport.

Counterpart of :mod:`sparse_matrix_mult_tpu.parallel.mesh`.  JAX's ``Mesh``
is single-controller: one process sees every device, ``shard_map`` runs a
body on each, ``lax.ppermute`` moves blocks between them, and a multi-host
run calls the same functions in every process, each holding only its
addressable shards.  The port keeps that contract with three pieces:

* :class:`RowMesh` -- an ordered tuple of **slots**, each ``(torch.device,
  owner rank)``, holding one row shard; the axis name
  (``Config.mesh_axis``); and the process group (``None`` for one
  process).  A device may appear in several slots, the counterpart of
  XLA's ``--xla_force_host_platform_device_count``: the CPU tests run an
  8-slot mesh on ``"cpu"`` against JAX's 8 virtual CPU devices, and a
  machine with one card runs a mesh of several slots on ``cuda:0``.  The
  rings loop over the slots this process owns, in slot order, where
  ``shard_map`` runs its bodies in parallel.
* :func:`init_distributed` -- ``torch.distributed.init_process_group`` over
  TCP at ``coordinator``, once per process; :func:`row_mesh` then orders
  every rank's local slots rank-major into one global mesh.
* :func:`ring_shift` -- the transport every ring calls in place of
  ``lax.ppermute``: slot ``d`` receives slot ``(d + shift) % S``'s block.
  Between slots on one device the block is handed over (no copy); to
  another local device it is copied on a side stream of that device,
  ordered by events (never ``torch.cuda.synchronize``) and kept from early
  reuse by ``record_stream``; to a slot of another rank it travels by
  ``dist.batch_isend_irecv``.  Every block of a ring has the same shapes on
  every slot (the containers pad to static capacities), so a receiver
  allocates its buffer from its own block.  The call returns at once; the
  rings issue step ``t + 1``'s transfers before step ``t``'s contraction
  and wait for them after it, as JAX's ``_ring_accumulate`` orders its
  permutes.

``row_sharding`` / ``replicated_sharding`` (JAX ``NamedSharding`` helpers)
have no counterpart: a :class:`RowMesh` is its own placement.

gloo sends and receives CPU tensors only, so across processes the CPU tests
run gloo on CPU slots; NCCL (the default backend when ``Config.device`` is
CUDA) carries CUDA slots.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import get_config

__all__ = ["RowMesh", "row_mesh", "init_distributed", "ring_shift", "reduce_max"]


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """An ordered tuple of row-shard slots ``(torch.device, owner rank)``
    over one axis; ``group`` is the process group (``None``: one process)
    and ``rank`` this process's rank in it."""

    slots: tuple
    axis: str = "rows"
    group: object = None
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> tuple:
        return tuple(dev for dev, _ in self.slots)

    def owner(self, s: int) -> int:
        return self.slots[s][1]

    def is_local(self, s: int) -> bool:
        return self.slots[s][1] == self.rank

    def local_slots(self) -> tuple:
        """The slots this process owns, in slot order."""
        return tuple(s for s in range(self.size) if self.is_local(s))


def _normalise(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def row_mesh(devices: Optional[Sequence] = None, axis: str | None = None) -> RowMesh:
    """A row mesh with one slot per entry of ``devices`` (default: every
    local CUDA device; ``RuntimeError`` when there is none -- a mesh never
    falls back to the CPU, which callers ask for with ``["cpu"] * S``).
    Under an initialised ``torch.distributed`` group every rank's local
    slots are gathered into one global order, rank-major."""
    axis = axis or get_config().mesh_axis
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "row_mesh: no CUDA device; pass the slots' devices, for example ['cpu'] * 8")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_normalise(d) for d in devices]
    if not devices:
        raise ValueError("row_mesh needs at least one device")
    if dist.is_available() and dist.is_initialized():
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in devices])
        slots = tuple((torch.device(d), r) for r, names in enumerate(gathered) for d in names)
        return RowMesh(slots, axis, dist.group.WORLD, dist.get_rank())
    return RowMesh(tuple((d, 0) for d in devices), axis)


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    **kw,
) -> None:
    """Initialise the process group: ``torch.distributed.init_process_group``
    with a TCP init method at ``coordinator`` (``host:port``), world size
    ``num_processes`` and rank ``process_id``.  Call once per process before
    building a mesh; a no-op when a group is already initialised.
    ``backend`` defaults to ``"nccl"`` when ``Config.device`` is CUDA and to
    ``"gloo"`` otherwise.  Errors propagate: a multi-process failure must be
    loud."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(get_config().device).type == "cuda" else "gloo"
    kwargs = dict(kw)
    if coordinator is not None:
        kwargs["init_method"] = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _copy_to(block: tuple, src: torch.device, dst: torch.device):
    """Copy ``block`` from ``src`` to ``dst`` once its producers on ``src``'s
    stream are done.  A copy between devices runs on the source device's
    current stream and fences the destination's current stream, so both are
    side streams here: the compute streams keep running.  Returns the copies
    and the event that marks their end."""
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(src))
    src_side, dst_side = _side_stream(src), _side_stream(dst)
    src_side.wait_event(ready)
    with torch.cuda.stream(src_side), torch.cuda.stream(dst_side):
        out = tuple(torch.empty_like(t, device=dst).copy_(t, non_blocking=True) for t in block)
    for t in block:
        t.record_stream(src_side)
    done = torch.cuda.Event()
    done.record(dst_side)
    return out, done


class RingTransfer:
    """Blocks in flight; :meth:`wait` returns each slot's new block (``None``
    for slots another rank owns)."""

    def __init__(self, out: list, requests: list, copies: list, keep: list):
        self._out, self._requests, self._copies, self._keep = out, requests, copies, keep

    def wait(self) -> list:
        for req in self._requests:
            req.wait()
        for dst, done, out in self._copies:
            consumer = torch.cuda.current_stream(dst)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
        self._keep.clear()
        return self._out


def ring_shift(mesh: RowMesh, blocks: list, shift: int, channel: int = 0) -> RingTransfer:
    """Start moving ``blocks`` (a list over slots of tuples of tensors,
    ``None`` where another rank owns the slot) so that slot ``d`` receives
    slot ``(d + shift) % S``'s block.  ``channel`` tells apart transfers in
    flight at once between the same ranks (the two directions of a
    bidirectional ring).  Returns at once; :meth:`RingTransfer.wait` gives
    the new list."""
    size = mesh.size
    local = mesh.local_slots()
    out = [None] * size
    ops, copies, keep = [], [], []
    for d in local:
        src = (d + shift) % size
        dev = mesh.slots[d][0]
        if mesh.is_local(src):
            block = blocks[src]
            src_dev = mesh.slots[src][0]
            if src_dev == dev:
                out[d] = block
            else:
                out[d], done = _copy_to(block, src_dev, dev)
                copies.append((dev, done, out[d]))
            continue
        out[d] = tuple(torch.empty_like(t) for t in blocks[d])
        ops += [dist.P2POp(dist.irecv, buf, mesh.owner(src), mesh.group,
                           _tag(channel, size, d, i, len(out[d])))
                for i, buf in enumerate(out[d])]
    for s in local:
        dest = (s - shift) % size
        if not mesh.is_local(dest):
            keep.append(blocks[s])
            ops += [dist.P2POp(dist.isend, t, mesh.owner(dest), mesh.group,
                               _tag(channel, size, dest, i, len(blocks[s])))
                    for i, t in enumerate(blocks[s])]
    requests = dist.batch_isend_irecv(ops) if ops else []
    return RingTransfer(out, requests, copies, keep)


def _tag(channel: int, size: int, dest: int, index: int, count: int) -> int:
    return (channel * size + dest) * count + index


def reduce_max(mesh: RowMesh, value: int) -> int:
    """The largest of every rank's ``value`` (the value itself in one process)."""
    if mesh.group is None:
        return int(value)
    dev = mesh.slots[mesh.local_slots()[0]][0]
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())
