"""Transport between the processes of a distributed run.

``init_lib(distributed=True)`` brings up ``torch.distributed`` (``start``);
from then on a ``ProcessGrid`` (``grid.py``) deals its ranks over the
processes, and each process holds the pieces of its own ranks only. This
module moves pieces between processes: it is the port's counterpart of
what the JAX package gets from ``shard_map``'s ``ppermute`` /
``all_gather`` / ``psum`` and from ``multihost_utils``.

Every transfer is a list of messages that each process builds alike from
the plans (plans are deterministic, so every piece's shape is known on
every process). A process posts its sends and receives of the list in list
order, all in ONE ``batch_isend_irecv``: no order of posting can deadlock,
and two processes match their messages in one order (a message's tag is
its place in the list). A process with no message in a list posts nothing.
No sub-group is ever created: every message is point-to-point on the world
group, so there is no group whose creation order could differ between
processes. A transfer moves bytes and never adds: a sum gathers its
partials to where it is wanted and adds them in rank or layer order, as one
process does (``ordered_sum``); ``all_reduce`` is never used, its order of
addition is the library's.

Under ``gloo`` a CUDA piece is staged through pinned host memory (gloo's
point-to-point takes host memory); under ``nccl`` device tensors go
directly. A complex piece travels as ``torch.view_as_real`` of its
physically conjugated values. A piece of a rank on this process is handed
over (a peer copy between two devices), never sent. Without a world, or
for a grid whose ranks all sit on this process, nothing here calls
``torch.distributed``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.errors import DbcsrError, dbcsr_assert

__all__ = [
    "TIMEOUT",
    "TransferCounts",
    "start",
    "stop",
    "is_up",
    "rank",
    "world_size",
    "device",
    "init_method",
    "process_device",
    "duplicate_cards",
    "move",
    "exchange",
    "shift",
    "gather_along",
    "ordered_sum",
    "all_gather_panels",
    "gather_scalars",
    "barrier",
    "transfer_counts",
    "reset_transfer_counts",
]

#: how long a process waits for the others (rendezvous, every transfer): a
#: collective posted in another order on two processes fails, never hangs
TIMEOUT = timedelta(seconds=300)

#: a message: (source process, destination process, shape, dtype)
Message = Tuple[int, int, Tuple[int, ...], torch.dtype]


@dataclass
class TransferCounts:
    """What this process moved across process boundaries: messages and
    bytes sent and received, and ``host_s``, the host seconds spent inside
    ``exchange`` (staging, posting, waiting on the host). Under ``gloo``
    the host waits for each transfer, so ``host_s`` holds it whole; under
    ``nccl`` waiting only orders the stream after the transfer, so
    ``host_s`` is the time to post it, and the card moves the bytes
    later. A transfer's device time is the ``cannon/shift`` span's, under
    a profiler (``core/timing.py``)."""

    messages: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    host_s: float = 0.0


@dataclass
class _World:
    backend: str
    device: torch.device
    rank: int
    size: int
    counts: TransferCounts = field(default_factory=TransferCounts)


_WORLD: Optional[_World] = None


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def init_method(address: Optional[str]) -> str:
    """``init_process_group``'s ``init_method`` for ``coordinator_address``:
    ``"host:port"`` → ``tcp://host:port``; a ``tcp://`` or ``file://`` URL as
    it is; None → ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``)."""
    if address is None:
        return "env://"
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    dbcsr_assert("://" not in address,
                 f"coordinator_address {address!r}: give host:port, tcp:// or file://")
    host, sep, port = address.rpartition(":")
    dbcsr_assert(bool(sep and host and port.isdigit()),
                 f"coordinator_address {address!r} is not host:port")
    return f"tcp://{address}"


def process_device(device, process_id: Optional[int]) -> torch.device:
    """This process's device: ``device`` if given, else
    ``cuda:{LOCAL_RANK or process_id} % device_count``. Without CUDA and
    without an explicit ``"cpu"`` it raises, as ``ProcessGrid.make`` does:
    a process never drops to the CPU by itself."""
    d = torch.device(device) if device is not None else None
    if d is not None and d.type != "cuda":
        return d
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise DbcsrError(
            "no CUDA device for this process: pass device='cpu' (with "
            "backend='gloo') to run a distributed process on the CPU"
        )
    if d is not None and d.index is not None:
        return d
    local = os.environ.get("LOCAL_RANK")
    k = int(local) if local is not None else int(
        process_id if process_id is not None else os.environ.get("RANK", 0))
    return torch.device("cuda", k % torch.cuda.device_count())


def _card_id(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{os.uname().nodename}/{dev.index}"


def duplicate_cards(card_ids: Sequence[str]) -> Optional[Tuple[int, int]]:
    """The first two processes (by rank) whose cards are one card, or None."""
    seen: Dict[str, int] = {}
    for r, c in enumerate(card_ids):
        if c in seen:
            return seen[c], r
        seen[c] = r
    return None


def start(*, coordinator_address: Optional[str] = None,
          num_processes: Optional[int] = None, process_id: Optional[int] = None,
          backend: Optional[str] = None, device=None) -> None:
    """Bring up the world (``init_lib(distributed=True)``): the rendezvous
    at ``coordinator_address``, then ``init_process_group`` with a finite
    timeout and one barrier. ``backend`` defaults to ``"nccl"`` for a CUDA
    device and ``"gloo"`` for the CPU; it is never switched by itself:
    ``nccl`` on the CPU, or with two processes on one card (NCCL refuses
    both), raises and names ``backend="gloo"``."""
    global _WORLD
    import torch.distributed as tdist

    dbcsr_assert(_WORLD is None, "the distributed run is already up")
    dbcsr_assert(tdist.is_available(), "this torch build has no torch.distributed")
    dev = process_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dbcsr_assert(backend in ("gloo", "nccl"), f"backend {backend!r}: gloo or nccl")
    if backend == "nccl" and dev.type != "cuda":
        raise DbcsrError(f'backend="nccl" needs a CUDA device (this process: {dev}); '
                         'pass backend="gloo" to run the processes on the CPU')
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store, r, w = next(tdist.rendezvous(
        init_method(coordinator_address),
        rank=-1 if process_id is None else int(process_id),
        world_size=-1 if num_processes is None else int(num_processes),
        timeout=TIMEOUT,
    ))
    store.set_timeout(TIMEOUT)
    if backend == "nccl":
        store.set(f"dbcsr_tpu_torch/card/{r}", _card_id(dev))
        ids = [store.get(f"dbcsr_tpu_torch/card/{q}").decode() for q in range(w)]
        dup = duplicate_cards(ids)
        if dup is not None:
            raise DbcsrError(
                f'backend="nccl" runs one process a card, but processes {dup[0]} and '
                f'{dup[1]} share card {ids[dup[0]]}: pass backend="gloo" to run '
                "several processes on one card"
            )
    tdist.init_process_group(backend, store=store, rank=r, world_size=w, timeout=TIMEOUT)
    _WORLD = _World(backend=backend, device=dev, rank=r, size=w)
    barrier()  # every process is up; NCCL's first collective spans them all


def stop() -> None:
    """Tear the world down (``finalize_lib``): a barrier, then
    ``destroy_process_group``."""
    global _WORLD
    if _WORLD is None:
        return
    import torch.distributed as tdist

    try:
        barrier()
    finally:
        _WORLD = None
        tdist.destroy_process_group()


def is_up() -> bool:
    return _WORLD is not None


def rank() -> int:
    """This process's rank in the world (0 without one)."""
    return _WORLD.rank if _WORLD is not None else 0


def world_size() -> int:
    return _WORLD.size if _WORLD is not None else 1


def device() -> torch.device:
    """The device of this process's ranks."""
    dbcsr_assert(_WORLD is not None, "no distributed run: init_lib(distributed=True)")
    return _WORLD.device


def transfer_counts() -> TransferCounts:
    """A copy of this process's transfer counts (all zero without a world)."""
    return replace(_WORLD.counts) if _WORLD is not None else TransferCounts()


def reset_transfer_counts() -> None:
    if _WORLD is not None:
        _WORLD.counts = TransferCounts()


def barrier() -> None:
    """Every process waits for the others (nothing without a world)."""
    if _WORLD is None:
        return
    import torch.distributed as tdist

    if _WORLD.backend == "nccl":
        tdist.barrier(device_ids=[_WORLD.device.index])
    else:
        tdist.barrier()


# ---------------------------------------------------------------------------
# the transfer
# ---------------------------------------------------------------------------

def move(x: torch.Tensor, dev) -> torch.Tensor:
    """Hand ``x`` to a rank on ``dev``: the tensor itself on the same
    device, a peer copy otherwise."""
    return x if x.device == dev else x.to(dev)


def _wire_shape(shape, dtype: torch.dtype):
    if dtype.is_complex:
        return tuple(shape) + (2,), dtype.to_real()
    return tuple(shape), dtype


def _to_wire(x: torch.Tensor, stage: bool) -> torch.Tensor:
    x = x.resolve_conj()
    if x.is_complex():
        x = torch.view_as_real(x)
    x = x.contiguous()
    if stage and x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        return host
    return x


def exchange(messages: Sequence[Message], payload: Callable[[int], torch.Tensor]
             ) -> Dict[int, torch.Tensor]:
    """Post a list of messages: this process sends ``payload(i)`` for each
    message ``i`` it is the source of and receives each message it is the
    destination of, all in one ``batch_isend_irecv``. ``messages`` must be
    the same list, in the same order, on every process. Returns ``{i:
    piece}`` for the messages received, on this process's device, each a
    fresh contiguous tensor (a store's 16-byte alignment holds)."""
    w = _WORLD
    me = rank()
    mine = [i for i, (s, d, _, _) in enumerate(messages) if (s == me) != (d == me)]
    if not mine:
        return {}
    dbcsr_assert(w is not None, "a transfer between processes needs "
                                "init_lib(distributed=True)")
    import torch.distributed as tdist

    t0 = time.perf_counter()
    stage = w.backend == "gloo" and w.device.type == "cuda"
    ops, recvs, nsent, nrecv = [], [], 0, 0
    for i in mine:
        src, dst, shape, dtype = messages[i]
        if src == me:
            x = _to_wire(payload(i), stage)
            nsent += x.numel() * x.element_size()
            ops.append((tdist.isend, x, dst, i))
        else:
            wshape, wdt = _wire_shape(shape, dtype)
            buf = (torch.empty(wshape, dtype=wdt, pin_memory=True) if stage
                   else torch.empty(wshape, dtype=wdt, device=w.device))
            nrecv += buf.numel() * buf.element_size()
            ops.append((tdist.irecv, buf, src, i))
            recvs.append((i, buf, dtype))
    if stage:  # the staging copies are on the current stream
        torch.cuda.current_stream(w.device).synchronize()
    works = tdist.batch_isend_irecv(
        [tdist.P2POp(op, x, peer, tag=tag) for op, x, peer, tag in ops])
    for work in works:
        work.wait()
    out = {}
    for i, buf, dtype in recvs:
        x = torch.view_as_complex(buf) if dtype.is_complex else buf
        out[i] = x.to(w.device, non_blocking=True) if stage else x
    c = w.counts
    c.messages += len(ops)
    c.bytes_sent += nsent
    c.bytes_received += nrecv
    c.host_s += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the grid's transfers
# ---------------------------------------------------------------------------

def _rank_devices(grid) -> List[torch.device]:
    return [grid.device(*rk) for rk in grid.ranks()]


def shift(grid, moves: Sequence[Tuple[list, Sequence[int], tuple, torch.dtype]]
          ) -> List[list]:
    """One ring step of several piece lists at once (Cannon's A and B).
    Each move is ``(pieces, src_of, shape, dtype)``: ``pieces`` a list over
    ``grid.ranks()`` (None off this process) and ``src_of[r]`` the rank
    whose piece rank ``r`` takes next. A piece stays on its process when
    both ranks do (handed over or peer-copied), else it is one message;
    every message of every move goes in one batch. Returns the new lists."""
    own = grid.owner_list()
    devs = _rank_devices(grid)
    me = rank()
    msgs, keys = [], []
    for m, (_, src_of, shape, dtype) in enumerate(moves):
        for r, s in enumerate(src_of):
            if own[r] != own[s]:
                msgs.append((own[s], own[r], shape, dtype))
                keys.append((m, r))
    got = exchange(msgs, lambda i: moves[keys[i][0]][0][moves[keys[i][0]][1][keys[i][1]]])
    by_key = {keys[i]: x for i, x in got.items()}
    out = []
    for m, (pieces, src_of, _, _) in enumerate(moves):
        new: list = [None] * len(src_of)
        for r, s in enumerate(src_of):
            if own[r] == me:
                new[r] = move(pieces[s] if own[s] == me else by_key[(m, r)], devs[r])
        out.append(new)
    return out


def gather_along(grid, pieces: list, lines: Sequence[Sequence[int]], shape: tuple,
                 dtype: torch.dtype) -> list:
    """SUMMA's panel gather: rank ``r`` concatenates the pieces of the ranks
    ``lines[r]`` in order (A's row along 'pc', B's column along 'pr'). A
    piece from another process is sent once to each process that needs it;
    ranks of this process on one device share one panel. Returns a list
    over ranks (None off this process)."""
    own = grid.owner_list()
    devs = _rank_devices(grid)
    me = rank()
    msgs, keys, seen = [], [], set()
    for r, line in enumerate(lines):
        for k in line:
            if own[k] != own[r] and (k, own[r]) not in seen:
                seen.add((k, own[r]))
                msgs.append((own[k], own[r], shape, dtype))
                keys.append(k)
    got = exchange(msgs, lambda i: pieces[keys[i]])
    remote = {keys[i]: x for i, x in got.items()}
    panels: Dict[tuple, torch.Tensor] = {}
    out: list = [None] * len(lines)
    for r, line in enumerate(lines):
        if own[r] != me:
            continue
        key = (tuple(line), devs[r])
        if key not in panels:
            panels[key] = torch.cat([move(pieces[k] if own[k] == me else remote[k], devs[r])
                                     for k in line])
        out[r] = panels[key]
    return out


def ordered_sum(grid, parts: list, present: Sequence[bool],
                sums: Sequence[Tuple[int, Sequence[int]]], shape: tuple,
                dtype: torch.dtype) -> list:
    """Sums of rank partials in a fixed order (the 2.5D layer sum): each
    ``(target, terms)`` of ``sums`` adds the partials of ``terms`` in order
    on the target rank's device, in place into the first, skipping the
    ranks that have none (``present`` False, known from the plan on every
    process); a sum of none is a zero panel. A remote partial is gathered
    to the target's process first. Returns a list over ``sums`` (None
    where the target is off this process)."""
    own = grid.owner_list()
    devs = _rank_devices(grid)
    me = rank()
    msgs, keys = [], []
    for tgt, terms in sums:
        for r in terms:
            if present[r] and own[r] != own[tgt]:
                msgs.append((own[r], own[tgt], shape, dtype))
                keys.append(r)
    got = exchange(msgs, lambda i: parts[keys[i]])
    remote = {keys[i]: x for i, x in got.items()}
    out: list = []
    for tgt, terms in sums:
        if own[tgt] != me:
            out.append(None)
            continue
        acc = None
        for r in terms:
            if present[r]:
                x = move(parts[r] if own[r] == me else remote[r], devs[tgt])
                acc = x if acc is None else acc.add_(x)
        out.append(acc if acc is not None else
                   torch.zeros(shape, dtype=dtype, device=devs[tgt]))
    return out


def all_gather_panels(owners: Sequence[int], pieces: list, shapes: Sequence[tuple],
                      dtype: torch.dtype) -> list:
    """Every piece on every process (C's unpack, ``ShardedMatrix.to_local``,
    the TAS merge): piece ``k`` of process ``owners[k]`` (None elsewhere),
    of shape ``shapes[k]``, sent to each other process. Returns the full
    list; a received piece lies on this process's device."""
    msgs, keys = [], []
    for k, o in enumerate(owners):
        for q in range(world_size()):
            if q != o:
                msgs.append((o, q, tuple(shapes[k]), dtype))
                keys.append(k)
    got = exchange(msgs, lambda i: pieces[keys[i]])
    out = list(pieces)
    for i, x in got.items():
        out[keys[i]] = x
    return out


def gather_scalars(values: list, owners: Sequence[int], is_complex: bool) -> list:
    """Per-rank scalar partials (Python numbers of the ranks of this
    process, None elsewhere) on every process, in rank order, exactly:
    they travel as float64 / complex128, which holds a float32 or float64
    partial without rounding."""
    if all(o == rank() for o in owners) or _WORLD is None:
        return list(values)
    dtype = torch.complex128 if is_complex else torch.float64
    pieces = [None if v is None else torch.tensor(v, dtype=dtype, device=_WORLD.device)
              for v in values]
    full = all_gather_panels(owners, pieces, [()] * len(owners), dtype)
    return [v if v is not None else (complex(x) if is_complex else float(x))
            for v, x in zip(values, full)]
