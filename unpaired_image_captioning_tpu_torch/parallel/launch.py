"""Start, join and stop the ranks of a `torch.distributed` job.

`run_ranks(fn, n, args)` starts n processes from a `forkserver` context
(never `fork`: a process that has used the card holds a live CUDA context
and the locks of its threads), each joins the group through a `FileStore`
in a fresh temporary directory (no fixed port, so concurrent jobs do not
collide) and calls `fn(rank, n, *args)` in the caller's working
directory. It returns every rank's result in
rank order. A rank that raises fails the job with its traceback, and a
job that outlasts `timeout` seconds is stopped: the other ranks are
terminated, so a collective that hangs fails rather than waits. `fn` must
be importable by name (a module-level function), and a script that calls
`run_ranks` needs a `__main__` guard.

`init_rank` joins one rank (the group's collectives time out after
`timeout` seconds); under `torchrun` (`WORLD_SIZE` set) `init_from_env`
joins the group that is there. `scale_out` is the CLIs' route: it runs a
CLI's rank function on the ranks `--num_devices` asks for (0 = every
visible card), or in the group `torchrun` started. Ranks on the card
use NCCL, one card a rank (`cuda:<local rank>`); CPU ranks, and ranks
that share a card, use gloo. Build the kernels before starting ranks on
the card (`kernels.build.load()`), so that the ranks load the cached
library rather than race to build it.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT = 600.0
# a CLI rank's collectives wait this long: rank 0 alone scores an eval
CLI_COLLECTIVE_TIMEOUT = 1800.0


def init_rank(rank: int, world_size: int, store_path: str, *,
              backend: str = "gloo", timeout: float = DEFAULT_TIMEOUT,
              device: Optional[torch.device] = None) -> None:
    """Join the group of `world_size` ranks through the FileStore at
    `store_path`; on the card, first make `device` the current one."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def init_from_env(*, backend: str, timeout: float = DEFAULT_TIMEOUT) -> int:
    """Join the group `torchrun` describes (env://); returns LOCAL_RANK."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout))
    return local


def _rank_main(fn, rank, world_size, args, store_path, backend, timeout,
               devices, cwd, results):
    try:
        # a forkserver child starts where the server started
        os.chdir(cwd)
        device = devices[rank] if devices else None
        init_rank(rank, world_size, store_path, backend=backend,
                  timeout=timeout, device=device)
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
              backend: str = "gloo",
              timeout: Optional[float] = DEFAULT_TIMEOUT,
              collective_timeout: Optional[float] = None,
              devices: Optional[Sequence] = None) -> List[Any]:
    """Run `fn(rank, world_size, *args)` on `world_size` fresh ranks; return
    their results (picklable; return numpy arrays rather than tensors) in
    rank order. `devices[rank]` (when given) is made the rank's current
    card before it joins. Raises RuntimeError naming the first rank that
    failed, or TimeoutError after `timeout` seconds (None: no limit);
    either way no rank outlives the call. A collective waits at most
    `collective_timeout` seconds (by default `timeout`, or
    DEFAULT_TIMEOUT)."""
    if collective_timeout is None:
        collective_timeout = timeout or DEFAULT_TIMEOUT
    ctx = mp.get_context("forkserver")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    store_path = os.path.join(tmp, "store")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, tuple(args), store_path,
                               backend, collective_timeout, devices,
                               os.getcwd(), results),
                         daemon=True)
             for r in range(world_size)]
    outs: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = (time.monotonic() + timeout if timeout is not None
                    else float("inf"))
        while len(outs) < world_size and failure is None:
            if not results.empty():
                rank, ok, value = results.get()
                if ok:
                    outs[rank] = value
                else:
                    failure = RuntimeError(f"rank {rank} of {world_size} "
                                           f"failed:\n{value}")
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in outs]
            if dead and results.empty():
                failure = RuntimeError(
                    f"rank {dead[0]} of {world_size} exited with code "
                    f"{procs[dead[0]].exitcode} and no result")
            elif time.monotonic() > deadline:
                failure = TimeoutError(
                    f"{world_size} ranks did not finish within {timeout} s "
                    f"(ranks {sorted(outs)} did)")
            else:
                time.sleep(0.02)
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise failure
    return [outs[r] for r in range(world_size)]


def num_ranks(num_devices: int, device) -> int:
    """The ranks a CLI runs on: `num_devices`, where 0 is every visible
    card (JAX's "all visible devices"), or one CPU rank. Raises, as
    `resolve_device` does, when the card is asked for and there is none,
    and when more cards are asked for than are visible."""
    from ..models.base import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return num_devices or 1
    visible = torch.cuda.device_count()
    n = num_devices or visible
    if n > visible:
        raise ValueError(f"--num_devices {n}: {visible} cards are visible")
    return n


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: `cuda:<local rank>` on the card, else `device`."""
    dev = torch.device(device)
    return torch.device("cuda", local_rank) if dev.type == "cuda" else dev


def _quiet_rank(local_rank, world_size, rank_main, argv):
    """A CLI rank: only global rank 0 prints."""
    import contextlib
    import io

    if dist.get_rank() == 0:
        return rank_main(local_rank, world_size, argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return rank_main(local_rank, world_size, argv)


NO_SCALE_OUT = object()


def scale_out(rank_main: Callable, cfg, argv):
    """Run a CLI's `rank_main(local_rank, world_size, argv)` on every rank
    (it builds its own config from `argv`, its device with `rank_device`
    and its mesh with `mesh.make_mesh`) and return rank 0's result:

    - under `torchrun` (`WORLD_SIZE` set), in this process, a rank of the
      group that is there (NCCL on the card, gloo on the CPU);
    - when `cfg.num_devices` resolves to n > 1 ranks (`num_ranks`), on n
      ranks started here, one card each, with no time limit on the job;
    - otherwise it returns NO_SCALE_OUT and the caller runs on one device.
    """
    on_card = torch.device(cfg.device).type == "cuda"
    backend = "nccl" if on_card else "gloo"
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        local = init_from_env(backend=backend, timeout=CLI_COLLECTIVE_TIMEOUT)
        try:
            out = _quiet_rank(local, dist.get_world_size(), rank_main, argv)
            return out if dist.get_rank() == 0 else None
        finally:
            dist.destroy_process_group()
    n = num_ranks(cfg.num_devices, cfg.device)
    if n <= 1:
        return NO_SCALE_OUT
    if on_card:
        from ..kernels import build

        build.load()     # the ranks load the built library, not race for it
    devices = ([f"cuda:{r}" for r in range(n)] if on_card else None)
    return run_ranks(_quiet_rank, n, (rank_main, argv), backend=backend,
                     timeout=None, collective_timeout=CLI_COLLECTIVE_TIMEOUT,
                     devices=devices)[0]
