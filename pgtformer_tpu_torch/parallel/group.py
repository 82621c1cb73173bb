"""One process per device over ``torch.distributed`` (the port's counterpart
of the JAX package's ``parallel/mesh.py``).

The JAX package runs one controller over a device mesh: ``shard_map`` with
``ppermute`` / ``psum`` / ``pmean`` over a ``data`` axis.  The port runs one
process per device, PyTorch's own idiom for data parallelism:

* :func:`init_group` / :func:`destroy_group`: the process group of a rank
  (its rank, the world size, the device it binds), formed through a file
  store (no TCP port to pick, so runs side by side never collide), every
  wait bounded by the group's timeout;
* :func:`shard_rows`: a rank's rows of a global batch (``shard_batch``);
* :func:`broadcast_`, :func:`broadcast_tensors_`: rank 0's values on every
  rank (``replicate``);
* :func:`ring_shift`: the ring shift by d (``ppermute`` with
  ``j -> (j + d) % n``); :func:`masked_sum`: the sum of what the ranks that
  own a value hold, the others contributing zeros (``psum`` of a masked
  value); :func:`all_reduce_`, :func:`mean_tensors_`, :func:`sync_sum` (the
  sum with a gradient, for synced batch statistics);
* :func:`scatter_rows`, :func:`gather_rows`: rank 0's frames out to the
  ranks and their results back (the file I/O of the serving path runs on
  rank 0);
* :func:`spawn`: run a function on N ranks, one process each, and collect
  what each returns.

The backend is NCCL on CUDA devices and gloo on the CPU.  Gloo on CUDA
tensors (several ranks on one card, where NCCL refuses to place two ranks
on one device) is used only when the caller names it.  Gloo moves host
memory: its point-to-point sends take a CUDA tensor's device pointer for a
host address (on torch 2.11 they fail with "writev: Bad address"), so under
gloo every collective here copies a CUDA tensor to host memory, runs on the
host copy, and copies the result back.  That staging is the transport of
this backend, spelled out in :meth:`Group.comm_device`; nothing falls back
from one backend to another.  A group that does not form, or a device that
two ranks share without ``share_device``, raises.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Group:
    """What a rank knows of the default process group: its rank, the world
    size, the device it computes on and the backend."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's buffers live: the host under gloo (a CUDA
        tensor is staged through host memory), the rank's device under
        NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.device


def init_group(rank: int, world: int, store_path: str, device=None,
               backend: Optional[str] = None, share_device: bool = False,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the process group of `world` ranks as `rank`, rendezvousing
    through the file store at `store_path` (every rank names the same path).

    `device`: the rank's device; by default ``cuda:<rank>`` (raises without
    a card, as every entry point of the port does).  `backend`: by default
    NCCL on a CUDA device and gloo on the CPU; gloo with a CUDA device only
    when named.  `share_device`: allow several ranks on one CUDA device
    (under gloo; NCCL refuses it).  Each rank writes its device to the store
    and reads the others', so ranks that share a device without
    `share_device` raise before any collective runs.  `timeout_s` bounds
    every wait of the group."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        device = f"cuda:{rank}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (choices: nccl, gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.FileStore(store_path, world)
    store.set_timeout(timeout)
    store.set(f"device/{rank}", str(device))
    devices = [store.get(f"device/{r}").decode() for r in range(world)]
    shared = {d for d in devices if d.startswith("cuda") and devices.count(d) > 1}
    if shared and not share_device:
        raise RuntimeError(f"ranks share {sorted(shared)} ({devices}): pass share_device=True "
                           "(and the gloo backend) to place several ranks on one card")
    if shared and backend == "nccl":
        raise RuntimeError(f"NCCL cannot place several ranks on one device ({devices})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    return Group(rank=rank, world=world, device=device, backend=backend)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(group: Group) -> None:
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


# -- rows of a global batch ------------------------------------------------------

def shard_rows(x, group: Group):
    """Rank k's rows ``[k * n / world, (k + 1) * n / world)`` of a global
    batch (an array, a tensor, or a dict of them); the batch must divide."""
    if isinstance(x, dict):
        return {k: shard_rows(v, group) for k, v in x.items()}
    n = x.shape[0]
    if n % group.world:
        raise ValueError(f"a batch of {n} does not divide over {group.world} ranks")
    per = n // group.world
    return x[group.rank * per:(group.rank + 1) * per]


# -- collectives -------------------------------------------------------------------

def _on_comm(t: torch.Tensor, group: Group) -> torch.Tensor:
    """`t` on the collective's device: itself, or a contiguous host copy."""
    return t.to(group.comm_device).contiguous()


def _write_back(t: torch.Tensor, moved: torch.Tensor) -> torch.Tensor:
    if moved.data_ptr() != t.data_ptr():
        t.copy_(moved)
    return t


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the ranks, in place (``psum``)."""
    c = _on_comm(t, group)
    dist.all_reduce(c)
    return _write_back(t, c)


def broadcast_(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Rank `src`'s value on every rank, in place."""
    c = _on_comm(t, group)
    dist.broadcast(c, src)
    return _write_back(t, c)


def broadcast_tensors_(tensors: Sequence[torch.Tensor], group: Group, src: int = 0) -> None:
    """Rank `src`'s values of every tensor on every rank, in place, one
    broadcast per dtype (``replicate``)."""
    _flat_collective(tensors, group, lambda c: dist.broadcast(c, src))


def mean_tensors_(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Each tensor replaced by its mean over the ranks (``pmean``), one
    all-reduce per dtype; every rank ends with the same bits."""
    _flat_collective(tensors, group, dist.all_reduce, divide=group.world)


def _flat_collective(tensors, group, op, divide: int = 1):
    """`op` on one flat buffer per dtype of `tensors`, divided by `divide`,
    copied back in place."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    with torch.no_grad():
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            c = _on_comm(flat, group)
            op(c)
            if divide != 1:
                c.div_(divide)
            flat = c.to(flat.device)
            off = 0
            for i in idx:
                t = tensors[i]
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        # the sum of every rank's loss depends on each rank's input through
        # the summed value: its gradient is the sum of the ranks' gradients
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def sync_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over the ranks with a gradient: the backward all-reduces the
    incoming gradient (synced batch statistics; flax's BatchNorm with an
    ``axis_name``)."""
    return _SyncSum.apply(t, group)


def ring_shift(t: torch.Tensor, d: int, group: Group) -> torch.Tensor:
    """Rank j sends `t` to rank (j + d) % world and returns what rank
    (j - d) % world sent (``ppermute`` by d).  Every rank's `t` has one
    shape and dtype."""
    n, k = group.world, group.rank
    if d % n == 0:
        return t.clone()
    send = _on_comm(t, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (k + d) % n), dist.P2POp(dist.irecv, recv, (k - d) % n)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv.to(t.device)


def masked_sum(t: torch.Tensor, mine, group: Group) -> torch.Tensor:
    """The sum over the ranks of `t` where `mine` holds and of zeros where it
    does not (``psum`` of a masked value): with one owner per row, the
    owner's rows on every rank.  `mine`: a bool, or a bool tensor [rows]
    for the rows of `t`.  A uint8 tensor sums bytewise, so the bytes of any
    dtype pass through unchanged (a float sum would turn -0.0 into +0.0)."""
    mine = torch.as_tensor(mine, device=t.device).reshape(-1, *([1] * (t.dim() - 1)))
    return all_reduce_(torch.where(mine, t, torch.zeros((), dtype=t.dtype, device=t.device)),
                       group)


def scatter_rows(x: Optional[torch.Tensor], shape, dtype: torch.dtype, group: Group,
                 src: int = 0) -> torch.Tensor:
    """Rank `src` holds `x` [world * rows, ...] (any device; None elsewhere);
    every rank returns its rows, of `shape`, on its device."""
    recv = torch.empty(shape, dtype=dtype, device=group.comm_device)
    parts = None
    if group.rank == src:
        parts = list(x.to(group.comm_device).contiguous().chunk(group.world))
    dist.scatter(recv, parts, src=src)
    return recv.to(group.device)


def gather_rows(t: torch.Tensor, group: Group, dst: int = 0) -> Optional[torch.Tensor]:
    """Every rank's `t` concatenated in rank order on rank `dst` (on the
    collective's device: the host under gloo); None on the other ranks."""
    c = _on_comm(t, group)
    parts = [torch.empty_like(c) for _ in range(group.world)] if group.rank == dst else None
    dist.gather(c, parts, dst=dst)
    return torch.cat(parts) if parts is not None else None


# -- spawn ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, store_path, args, results):
    try:
        out = fn(rank, world, store_path, *args)
        results.put((rank, True, out))
    except BaseException:
        # the parent reports this rank's traceback and stops the others
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          timeout_s: Optional[float] = None, store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, store_path, *args)`` in `world` new processes
    (spawned: each imports `fn`'s module afresh, so `fn` is a module-level
    function and `args` pickle) and return what each rank returned, by rank.

    `store_path` is a file in `store_dir` (default: a temporary directory
    removed afterwards) for :func:`init_group`.  A rank that raises, or
    exits without a result, fails the run: the others are terminated and
    this raises a RuntimeError with that rank's traceback.  `timeout_s`
    bounds the whole run (None: no bound but each collective's own)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="pgt_store_") if own_dir else store_dir
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store_path, tuple(args), results),
                         name=f"rank{r}") for r in range(world)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a result may still be in flight from a rank that exited cleanly
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"ranks {sorted(set(range(world)) - set(out))} still running after {timeout_s} s"
                    break
                else:
                    continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
