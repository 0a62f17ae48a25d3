"""Start a multi-device render's ranks from one Python process: one process
per rank, each in the default process group, joined with a deadline.

`torchrun --nproc-per-node N` is the launcher for a program that is written
to run as one rank (examples/multichip.py runs under it). `spawn` serves
the callers that start the ranks themselves: examples/multichip.py
--spawn, chip_smoke.py's phase 13 and the tests. Every process group gets
an explicit timeout, and a rank that fails, dies or outlives the deadline
fails the whole run: the survivors are killed, never waited for."""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that is free now (for the group's store)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, backend: str,
              timeout_s: float):
    """Join the default process group as `rank` of `world`, its store on
    localhost:`port`. LOCAL_RANK, RANK and WORLD_SIZE are set as torchrun
    sets them; under NCCL the rank's card (LOCAL_RANK % device_count) is
    made current first. Raises if the group cannot be formed."""
    os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank),
                      WORLD_SIZE=str(world))
    kw = {}
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        **kw)


def _rank_main(fn, rank, world, port, backend, timeout_s, args, results):
    try:
        init_rank(rank, world, port, backend, timeout_s)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), backend: str = "gloo",
          timeout_s: float = 300.0):
    """Run `fn(rank, world, *args)` in `world` new processes, each the rank
    of that number in a fresh default process group over `backend`, and
    return the list of their results, rank by rank. `fn` must be importable
    by name (a module-level function). Raises RuntimeError if a rank
    raises, exits without a result, or is not done `timeout_s` seconds
    after the start (its collectives time out at the same bound)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, port, backend, timeout_s,
                               tuple(args), results))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, errors = {}, {}
    try:
        # Drain the queue before joining: a child blocks on exit until its
        # results have been read.
        while len(got) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    break
                continue
            (got if ok else errors)[rank] = value
            if errors:
                break  # the other ranks may wait on it: kill them
        if len(got) == world:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    missing = [r for r in range(world) if r not in got]
    codes = [p.exitcode for p in procs]
    if missing or any(c != 0 for c in codes):
        raise RuntimeError(f"ranks {missing} of {world} gave no result "
                           f"(exit codes {codes}, deadline {timeout_s} s)")
    return [got[r] for r in range(world)]
