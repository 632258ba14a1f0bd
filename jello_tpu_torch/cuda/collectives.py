"""Collectives over a `torch.distributed` process group, and the ranks
that run them.

Counterpart of the `jax.lax` collectives that `jello_tpu/tpu/sharded.py`
and `sharded2.py` call inside `shard_map`: `all_gather`, `psum`, `pmax`
and the fixed-capacity `all_to_all`. A rank is a process with one
`Group`; `run_ranks` starts them.

The caller picks the transport, and nothing falls back. "nccl" runs the
collectives on the device tensors and needs a card per rank (NCCL
refuses two ranks on one card); each collective's output has a shape its
operand alone fixes, so a CUDA graph can hold them (`cuda/program.py`),
once the communicator exists (`init_group` makes it). "gloo" copies each
operand to the host, runs the collective there and copies the result
back: the CPU tests and several ranks on one card take it, and no graph
can hold it.

Every wait is bounded. `init_group`'s `timeout` bounds the rendezvous
and each collective of the group (a collective whose peer is gone
raises instead of waiting out the backend's default, 30 minutes under
gloo), and `run_ranks`' `timeout` the whole run: a rank still running a
little before it prints its Python stacks to stderr, and the call then
stops every rank and raises `TimeoutError` naming the ranks it stopped.
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing
import multiprocessing.connection
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass
class Group:
    """This process's rank in the default process group, its device and
    the transport. Closing it destroys the group."""

    rank: int
    world: int
    backend: str
    device: torch.device

    def close(self):
        dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def init_group(rank, world, backend, init_file, device, timeout=None) -> Group:
    """Join the `world`-rank group as `rank` through a FileStore at
    `init_file` (a path no earlier group used), on `device`. Under NCCL the
    communicator is made here (`device_id`), not at the first collective,
    which may be inside a capture. `timeout` (a `datetime.timedelta`; None
    keeps torch's default) bounds the rendezvous and every collective of
    the group."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' runs on CUDA tensors, not on {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=Path(init_file).absolute().as_uri(),
                            rank=rank, world_size=world, timeout=timeout,
                            device_id=device if backend == "nccl" else None)
    return Group(rank, world, backend, device)


def _operand(g, t):
    """t as the transport takes it: a contiguous copy, on the host under gloo."""
    return t.cpu() if g.backend == "gloo" and t.is_cuda else t.contiguous().clone()


def all_gather(g, t):
    """[world, *t.shape]: every rank's t, in rank order (one
    `all_gather_into_tensor` into a tensor of the ranks' operands end to
    end)."""
    x = _operand(g, t).reshape((-1,) + tuple(t.shape[1:]) if t.dim() else (1,))
    out = x.new_empty((g.world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    return out.view((g.world,) + tuple(t.shape)).to(t.device)


def _all_reduce(g, t, op):
    x = _operand(g, t)
    dist.all_reduce(x, op=op)
    return x.to(t.device)


def psum(g, t):
    """The elementwise sum of every rank's t."""
    return _all_reduce(g, t, dist.ReduceOp.SUM)


def pmax(g, t):
    """The elementwise maximum of every rank's t (flags ride as int32)."""
    return _all_reduce(g, t, dist.ReduceOp.MAX)


def all_to_all(g, send):
    """send [world, PEX, 8]: row block d goes to rank d. Returns recv
    [world, PEX, 8], row block s from rank s (`lax.all_to_all` with
    split_axis = concat_axis = 0)."""
    if send.shape[0] != g.world:
        raise ValueError(f"all_to_all: {send.shape[0]} blocks for {g.world} ranks")
    x = _operand(g, send)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out.to(send.device)


def _rank_device(device, rank, world):
    """Rank r's device: cuda:r when the machine has `world` cards or more,
    else the one card `device` names (or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if torch.cuda.device_count() >= world:
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def _rank_main(fn, rank, world, backend, init_file, device, args, out_path, timeout,
               deadline, threads):
    # Stacks to stderr a little before the caller's deadline (on its
    # time.monotonic(), one clock for every process of the machine),
    # armed before anything can hang.
    faulthandler.dump_traceback_later(
        max(deadline - min(5.0, 0.1 * timeout) - time.monotonic(), 0.01), file=sys.stderr)
    # The ranks share the caller's intra-op threads.
    torch.set_num_threads(max(1, threads // world))
    with init_group(rank, world, backend, init_file, _rank_device(device, rank, world),
                    datetime.timedelta(seconds=timeout)) as g:
        result = fn(g, *args)
    torch.save(result, out_path)
    faulthandler.cancel_dump_traceback_later()


def run_ranks(fn, world, backend, device, args=(), timeout=900.0):
    """Run `fn(group, *args)` in `world` processes (spawned: CUDA cannot
    start in a forked child, and `fn` is imported by its module path) and
    return each rank's result, in rank order (saved with torch.save).

    `backend` "nccl" needs a card per rank and raises otherwise; "gloo"
    runs anywhere. The kernels are built here first, so that the ranks
    never run nvcc together. A rank that fails or outlives `timeout`
    seconds makes the call raise, after every rank has been stopped; each
    rank's group waits at most `timeout` for a peer, and a rank still
    running a little before the deadline prints its Python stacks to
    stderr (pytest shows them in the failing test's report)."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and (device.type != "cuda" or torch.cuda.device_count() < world):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"backend 'nccl' needs a card per rank: {world} ranks, {cards} "
                           f"cards; ask for backend 'gloo' to run several ranks on one card")
    if device.type == "cuda":
        from .build import build

        build()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        outs = [Path(d) / f"rank{r}.pt" for r in range(world)]
        deadline = time.monotonic() + timeout
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, backend, Path(d) / "store", str(device), args, outs[r], timeout,
            deadline, torch.get_num_threads())) for r in range(world)]
        try:
            for p in procs:
                p.start()
            while any(p.exitcode is None for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    alive = [r for r, p in enumerate(procs) if p.exitcode is None]
                    raise TimeoutError(
                        f"run_ranks: ranks {alive} of {world} still running after {timeout} s "
                        f"and stopped (their Python stacks are on stderr)")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None], left)
                failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
                if failed:
                    raise RuntimeError(f"run_ranks: rank {failed[0][0]} exited with code "
                                       f"{failed[0][1]}")
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(o, map_location="cpu", weights_only=False) for o in outs]
