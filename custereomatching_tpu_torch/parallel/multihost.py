"""Process-group initialisation, the global mesh, and CPU ranks in
spawned processes.

The counterpart of ``custereomatching_tpu/parallel/multihost.py``.  Where
JAX wires hosts together with ``jax.distributed.initialize()``, the port
initialises ``torch.distributed``: one process a device, NCCL between
CUDA cards, gloo between CPU ranks when the caller asks for the CPU.

On cards, start one process a card with ``torchrun --nproc-per-node N``
and call :func:`initialize_multihost` once in each before any collective.
On the CPU, :func:`spawn_ranks` runs a function on N gloo ranks in
spawned processes: the counterpart of the JAX package's virtual CPU
devices.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from custereomatching_tpu_torch.config import MeshConfig, entry_device

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> None:
    """Initialise ``torch.distributed`` (idempotent).

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a lone process
    without it gets a world of one, JAX's single-host no-op.  Otherwise
    ``coordinator_address`` (``host:port``, rank 0 listens there),
    ``num_processes`` and ``process_id`` name the world.  Asking for more
    than one process without a coordinator raises ``ValueError``.

    The backend is NCCL for CUDA (the default ``device``; without a card
    it raises ``RuntimeError``) and gloo only for ``device="cpu"``.  A
    CUDA rank takes card ``LOCAL_RANK`` (or its rank modulo the cards).
    """
    if dist.is_initialized():
        return
    device = entry_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    env = all(v in os.environ for v in _TORCHRUN_VARS)
    if coordinator_address is None and not env:
        if num_processes not in (None, 1):
            raise ValueError(
                f"num_processes={num_processes} needs a coordinator_address "
                f"(or torchrun's environment)")
        rank, world, kwargs = 0, 1, {"store": dist.HashStore()}
    elif coordinator_address is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        kwargs = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and "
                             "process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} outside a world of "
                             f"{num_processes}")
        rank, world = int(process_id), int(num_processes)
        kwargs = {"init_method": f"tcp://{coordinator_address}"}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        # No device_id: NCCL then initialises lazily and runs each pair's
        # send and receive on a communicator of its own.  Bound eagerly,
        # unbatched P2P ops share the group's communicator, in series with
        # its collectives, and the stage pipeline hung on four cards.
        torch.cuda.set_device(local)
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)


def world_size() -> int:
    """Ranks in the world; 1 when ``torch.distributed`` is not initialised
    (JAX's ``process_count`` on one host)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank; 0 when ``torch.distributed`` is not
    initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(config: MeshConfig, device_type: str = "cuda"):
    """A ``(data, space)`` mesh over ALL ranks of the world.

    Ranks are laid out row-major, so a ``space`` group is consecutive
    ranks (on one host with ``torchrun``, cards that share NVLink);
    ``data`` spans the rest.
    """
    from custereomatching_tpu_torch.parallel.mesh import make_mesh

    n = world_size()
    if config.num_devices != n:
        raise ValueError(
            f"mesh {config.shape} needs exactly all {n} global devices "
            f"(ranks), got {config.num_devices}")
    return make_mesh(config, device_type)


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a leading batch axis this rank feeds when every rank
    holds ``global_batch // world`` frames."""
    per = global_batch // world_size()
    start = per * world_rank()
    return slice(start, start + per)


# ---------------------------------------------------------------------------
# CPU ranks in spawned processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nprocs: int, address: str, fn: Callable,
               args: Sequence[Any], results) -> None:
    torch.set_num_threads(1)
    try:
        initialize_multihost(address, nprocs, rank, device="cpu")
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
                timeout: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` gloo ranks, one spawned process
    each (one CPU thread each), and return the ranks' results in rank
    order.

    ``fn`` and ``args`` are pickled: ``fn`` must be importable by its
    module path.  A rank that raises, or a run that is not done within
    ``timeout`` seconds (a hung collective), ends every rank and raises
    ``RuntimeError`` with what the ranks reported.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, address, fn, tuple(args), results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got, failures = {}, []
    try:
        while len(got) + len(failures) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                if failures or not any(p.is_alive() for p in procs):
                    break
                continue
            if ok:
                got[rank] = out
            else:
                failures.append(f"rank {rank}:\n{out}")
                # The others may wait on the failed rank forever.
                break
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()) if
                   not failures else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        results.close()
    if failures or len(got) < nprocs:
        missing = sorted(set(range(nprocs)) - set(got))
        raise RuntimeError(
            f"spawn_ranks: {len(got)} of {nprocs} ranks returned within "
            f"{timeout:.0f} s (missing {missing})\n" + "\n".join(failures))
    return [got[r] for r in range(nprocs)]


def launch(fn: Callable, args: Any, ranks: int, device: str) -> Any:
    """An entry point's run: ``fn(args)`` on ``ranks`` spawned gloo ranks,
    returning rank 0's result (``device`` must be ``"cpu"``: on cards the
    ranks are ``torchrun``'s); with ``ranks`` 0, ``fn(args)`` in this
    process, whose process group (if ``fn`` made one) is destroyed
    after."""
    if ranks:
        if device != "cpu":
            raise ValueError("--ranks spawns gloo ranks: it needs --device "
                             "cpu (use torchrun on cards)")
        return spawn_ranks(fn, ranks, (args,), timeout=600.0)[0]
    try:
        return fn(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


__all__ = ["initialize_multihost", "launch", "make_global_mesh",
           "process_local_batch_slice", "spawn_ranks", "world_rank",
           "world_size"]
