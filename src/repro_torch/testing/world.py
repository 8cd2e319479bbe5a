"""Worlds of processes for the distributed layer's checks: ``run_world``
spawns ``world`` ranks on this host, starts a ``gloo`` world among them
(one intra-op thread each; CPU or CUDA tensors) over a store on
127.0.0.1, runs ``fn(rank, world, *args)`` on each and hands back their
results in rank order.

No rank is left behind: the world has a deadline, a rank that raises
reports its traceback, a rank that dies is seen by its exit code, and on
any failure every rank still running is ended before ``run_world``
raises.  ``fn`` and its results cross processes, so ``fn`` lives at a
module's top level and returns picklable values (numpy arrays, numbers).

Worlds on one host take turns: ``run_world`` holds an exclusive lock on
a file in the temporary directory while its ranks run, so test processes
that start worlds at once (``pytest -n``) queue instead of running four
ranks each on the same cores.  With ``nice`` the ranks also yield the
cores to the host's other work, some of it timing-sensitive.

``one_rank_world`` starts a world of this process alone (over an
in-process store), for a (1, 1) mesh.
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import os
import queue
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


#: The priority offset of the CPU tests' ranks (``nice``): under ``pytest
#: -n`` they take the cores the other test files leave idle.
TEST_NICE = 10


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_world(backend: str = "gloo"):
    """A world of this process alone over an in-process store, for the
    ``with`` block: ``gloo``, or ``nccl`` on the first card."""
    kw = dict(device_id=torch.device("cuda", 0)) if backend == "nccl" \
        else {}
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _turn():
    """This host's worlds one at a time (an exclusive ``flock``)."""
    path = os.path.join(tempfile.gettempdir(), "repro_torch_world.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _rank_main(fn, rank, world, port, nice, timeout, args, out):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    if nice:
        os.nice(nice)
    try:
        wait = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=wait)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world, timeout=wait)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_world(fn, world: int, *args, timeout: float = 300.0,
              nice: int = 0) -> list:
    """``[fn(rank, world, *args) for rank]``, each in its own process of
    one world, once this host's other worlds have ended.  Raises
    ``RuntimeError`` (with the failing rank's traceback) when a rank
    raises or dies, ``TimeoutError`` after ``timeout`` seconds of
    running; in both cases every rank is ended first.  ``nice`` lowers
    the ranks' scheduling priority by that much."""
    with _turn():
        return _run(fn, world, args, timeout, nice)


def _run(fn, world, args, timeout, nice) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # the world's store, served from here on a port the system picks (no
    # window in which another process could take it)
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    port = store.port
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, port, nice, timeout,
                               args, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world} ranks: no result from ranks "
                    f"{sorted(set(range(world)) - set(results))} after "
                    f"{timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results}
                if dead:
                    raise RuntimeError(f"ranks died without a result: "
                                       f"exit codes {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = payload
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        del store
    return [results[r] for r in range(world)]
