"""Start a world of processes, one a rank, and collect what each returns.

``spawn_world(fn, n, args)`` starts ``n`` processes (``spawn``), joins them
into a ``torch.distributed`` world through a ``file://`` rendezvous under
``workdir`` (so that worlds started side by side never share a port),
calls ``fn(rank, world_size, *args)`` in each and returns the ranks'
results in rank order. ``fn`` must be importable (a module-level function
of the package); its result is saved with ``torch.save``. A rank that
raises fails the call with the rank's traceback.

``device="cuda"`` puts every rank on the card(s) (``initialize_distributed``
picks NCCL when each rank has a card of its own, gloo when they share one),
``"cpu"`` on the CPU over gloo with one thread a rank. ``start_world`` runs
``spawn_world`` in a thread and returns a Future, so that the caller works
while the world runs. ``lock=`` names a
file whose exclusive lock the world holds from its start to its end, so
that the worlds of several processes that name the same file (test
workers side by side) take turns, ``LOCK_SLOTS`` of them at once (each
slot a lock file of its own: ``lock``, ``lock.1``): a test worker whose
world waits for a slot idles, while one world of 4 single-threaded ranks
leaves cores of the host free.
"""

from __future__ import annotations

import concurrent.futures
import os
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


def _entry(rank: int, fn: Callable, world_size: int, init_file: str, out_dir: str,
           args: Sequence[Any], device: str) -> None:
    import torch.distributed as dist

    from rlinf_tpu_torch.parallel.distributed import initialize_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        initialize_distributed(f"file://{init_file}", world_size, rank, device=device,
                               verbose=rank == 0)
        result = fn(rank, world_size, *args)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


#: the worlds that name one lock and may run at once
LOCK_SLOTS = 2


def _take_slot(lock: str):
    """An open file of the first free slot of ``lock`` (an exclusive flock
    held on it), waiting until one is free."""
    import fcntl
    import time

    paths = [lock] + [f"{lock}.{i}" for i in range(1, LOCK_SLOTS)]
    while True:
        for path in paths:
            f = open(path, "a")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return f
            except BlockingIOError:
                f.close()
        time.sleep(0.2)


def spawn_world(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
                workdir: Optional[str] = None, device: str = "cuda",
                lock: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on every rank of a new world and
    return the results in rank order."""
    if lock is not None:
        import fcntl

        f = _take_slot(lock)
        try:
            return spawn_world(fn, world_size, args, workdir=workdir, device=device)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()
    import torch.multiprocessing as mp

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="rlinf_world_")
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    try:
        err = None
        try:
            mp.start_processes(_entry, args=(fn, world_size, init_file, workdir, tuple(args),
                                             device),
                               nprocs=world_size, join=True, start_method="spawn")
        except mp.ProcessRaisedException as e:  # the rank's own traceback is saved
            err = e
        results = []
        for r in range(world_size):
            path = os.path.join(workdir, f"rank{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(path) else None
            if got is None or not got["ok"]:
                raise RuntimeError(f"rank {r} of {world_size} failed:\n"
                                   + (got["error"] if got else str(err)))
            results.append(got["result"])
        return results
    finally:
        if own:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)


def start_world(fn: Callable, world_size: int, args: Sequence[Any] = (),
                **kw) -> concurrent.futures.Future:
    """``spawn_world`` in a thread of this process: a Future of its
    results."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(spawn_world, fn, world_size, args, **kw)
    finally:
        pool.shutdown(wait=False)
