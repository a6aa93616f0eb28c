"""Multi-process data parallelism: the process group, the host split of the
data and the global batch (counterpart of lass_tpu/parallel/host.py).

One process per card. ``python -m torch.distributed.run --nproc_per_node N
-m lass_torch.<entry> ...`` sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT; ``initialize_distributed`` reads them (or takes explicit
arguments, as ``initialize_multihost`` does) and joins the default process
group: NCCL for the card, gloo only when the caller asks for the CPU. A
single-process run joins no group, and every helper below is then the
identity.

The global batch is the concatenation of the ranks' rows in rank order
(the layout of lass_tpu's ``put_global_batch``): rank r holds rows
[r * b, (r + 1) * b) of a global batch of world * b rows. What the JAX
step computes on the global array (batch statistics, the mixer's partners
and draws, the contrastive logits, train-mode draws) the port computes on
the global batch too: ``gather_rows`` assembles it on every rank,
``local_rows`` takes this rank's rows back out, ``row_span`` says where
they sit.

``run_local_ranks`` starts W ranks on this host without a launcher, each
in a fresh process (the tests' and the smoke's parity runs).
"""
from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("lass_torch.parallel.host")


def is_distributed() -> bool:
    """True once this process has joined a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: Optional[float] = None,
                           device: str = "cuda") -> torch.device:
    """Join the default process group once per process; returns this rank's
    device (``cuda:LOCAL_RANK``, or the CPU when ``device`` is 'cpu').

    Without arguments the launcher's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) is read; without those either,
    the run is single-process and no group is joined. Explicit arguments:
    ``coordinator_address`` 'host:port' of rank 0, ``num_processes``,
    ``process_id``. ``timeout_s`` bounds the rendezvous and every
    collective (torch's default when None)."""
    launched = "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None \
            and not launched:
        return torch.device(device)
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("a multi-card run needs CUDA; pass "
                               "device='cpu' for a gloo run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", (process_id or 0)
                                   % torch.cuda.device_count()))
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if is_distributed():
        return dev
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kwargs["device_id"] = dev
    if coordinator_address is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs)
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    logger.info("process group: rank %d of %d, %s on %s", dist.get_rank(),
                dist.get_world_size(), backend, dev)
    return dev


def host_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) in a single-process run."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_indices_for_host(indices: np.ndarray, process_index: int,
                           process_count: int) -> np.ndarray:
    """Strided per-host slice of a global epoch permutation. Every host
    sees a disjoint subset; the remainder is dropped so all hosts run the
    same number of steps (the DistributedSampler analog)."""
    if process_count <= 1:
        return indices
    usable = (len(indices) // process_count) * process_count
    return indices[process_index:usable:process_count]


def row_span(rows: int) -> Tuple[int, int]:
    """(global rows, first row of this rank) for a rank holding ``rows``
    rows of the global batch: (rows, 0) in a single-process run."""
    rank, world = host_info()
    return rows * world, rows * rank


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (b, ...) -> the global batch (world * b, ...) in
    rank order, on every rank, outside autograd. Every rank must hold the
    same number of rows."""
    if not is_distributed() or dist.get_world_size() == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch (world * b, ...) -> this rank's rows (b, ...)."""
    rank, world = host_info()
    if world == 1:
        return x
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a copy; ``x`` in a single-process
    run)."""
    if not is_distributed():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()


def sum_over_ranks(x: np.ndarray) -> np.ndarray:
    """The elementwise float64 sum of ``x`` over the ranks, on every rank
    (``x`` in a single-process run)."""
    if not is_distributed():
        return x
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.array(x, np.float64)).to(dev)
    dist.all_reduce(t)
    return t.cpu().numpy()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str,
               args: Sequence[Any], results) -> None:
    try:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            out = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        out = ("error", traceback.format_exc())
    results.put((rank, pickle.dumps(out)))


def run_local_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
                    backend: str = "gloo", timeout_s: float = 120.0
                    ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined in
    one ``backend`` group on this host; returns the results by rank.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable (numpy arrays, numbers). A rank that raises, or a
    group that has not finished after ``timeout_s`` seconds, stops every
    rank and raises here."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    errors: dict = {}
    try:
        while len(out) + len(errors) < world:
            try:
                rank, blob = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                if errors:  # the other ranks' reports are late: stop them
                    break
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} did "
                    f"not finish in {timeout_s} s (done: {sorted(out)})")
            status, value = pickle.loads(blob)
            if status == "error":
                if not errors:  # a failed rank breaks its peers' collectives
                    deadline = min(deadline, time.monotonic() + 10.0)
                errors[rank] = value
            else:
                out[rank] = value
        if errors:
            raise RuntimeError("".join(f"rank {r} failed:\n{e}\n"
                                       for r, e in sorted(errors.items())))
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return [out[r] for r in range(world)]
