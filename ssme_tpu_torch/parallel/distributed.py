"""Joining processes into one program, and a local launcher.

PyTorch counterpart of ``ssme_tpu/parallel/distributed.py``.  The same
recipe runs on every process:

    from ssme_tpu_torch import parallel

    parallel.initialize_distributed()              # env:// under torchrun
    mesh = parallel.make_global_mesh()             # every rank on "chain"
    state = pmmh.init(seed, start, ys, num_chains=C)   # same seed everywhere
    state = parallel.shard_chain_state(state, mesh)    # this rank's chains
    res = parallel.sharded_pmmh(pmmh, mesh, num_iters)(state, ys)
    samples = res.samples                          # (iters, C, d), gathered

CUDA tensors talk over NCCL and CPU tensors over gloo, which runs only
when the caller asks for the CPU: a missing card or NCCL raises and never
falls back.  :func:`spawn_local` starts N fresh processes on one machine
joined through a ``file://`` store, the counterpart of JAX's virtual CPU
devices: the tests and the dryruns run the multi-process path with it.
Every process must run the same program order, the reference's implicit
contract between its threads (``thread_pool.h:189-215``) promoted to
processes.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from ssme_tpu_torch.parallel.mesh import (CHAIN_AXIS, PARTICLE_AXIS,
                                         all_gather_cat, make_mesh)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda",
                           timeout: Optional[float] = None) -> torch.device:
    """Join (or form) the default process group; returns this rank's
    device.

    With no address, the group reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment (``torchrun`` sets
    them).  Otherwise pass ``tcp://host:port`` (or ``host:port``) or a
    ``file://`` path, the process count and this process's rank.  On
    ``device="cuda"`` the group runs NCCL on card ``LOCAL_RANK`` (else
    the rank modulo the card count), selected first; ``device="cpu"``
    runs gloo.  ``timeout``: seconds a collective may wait.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    kwargs = {}
    if coordinator_address is not None:
        if "://" not in coordinator_address:
            coordinator_address = "tcp://" + coordinator_address
        kwargs.update(init_method=coordinator_address,
                      world_size=int(num_processes), rank=int(process_id))
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    if device == "cpu":
        dist.init_process_group("gloo", **kwargs)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: no CUDA device (pass "
                           "device='cpu' to run gloo on the CPU)")
    if not dist.is_nccl_available():
        raise RuntimeError("initialize_distributed: this PyTorch has no NCCL")
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", **kwargs)
    return torch.device("cuda", local)


def make_global_mesh(num_chain_shards: Optional[int] = None,
                     num_particle_shards: int = 1):
    """(chain, particle) mesh over every rank of the default group; by
    default every rank on the chain axis (no collective inside the PMMH
    loop)."""
    return make_mesh(num_chain_shards, num_particle_shards)


def fetch_across_hosts(local: torch.Tensor, dim: int = 0):
    """Every rank's slice of a tensor sharded along ``dim``, gathered on
    every rank in rank order (the multi-host read of the samples); at
    world size 1, or with no group formed, the input itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    return all_gather_cat(local, dim=dim)


def _spawned(fn, rank, world_size, device, init_method, out_dir, args,
             timeout):
    torch.set_num_threads(1)
    try:
        initialize_distributed(init_method, world_size, rank, device,
                               timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_local(fn, world_size: int, device: str, args=(),
                timeout: float = 120.0):
    """Run ``fn(*args)`` in ``world_size`` fresh processes joined into one
    group (gloo on ``"cpu"``, NCCL on ``"cuda"``, one card a rank) through
    a ``file://`` store in a temporary directory; returns each rank's
    result, in rank order.

    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function
    of a module the children import.  Each child runs one torch thread.
    ``timeout`` bounds the collectives and the whole run: a rank still
    alive after it is killed, with every other, and the call raises.
    """
    if device == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"spawn_local: {world_size} ranks on cuda, "
                           f"{torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="ssme_spawn_")
    init = "file://" + os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_spawned, args=(
        fn, r, world_size, device, init, out_dir, tuple(args), timeout))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"spawn_local: ranks {hung} still running "
                               f"after {timeout} s")
        errors = {}
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                path = os.path.join(out_dir, f"{r}.err")
                errors[r] = (open(path).read() if os.path.exists(path)
                             else f"exit code {p.exitcode}")
        if errors:
            first = min(errors)
            raise RuntimeError(f"spawn_local: ranks {sorted(errors)} failed; "
                               f"rank {first}:\n{errors[first]}")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


__all__ = ["initialize_distributed", "make_global_mesh", "fetch_across_hosts",
           "spawn_local", "CHAIN_AXIS", "PARTICLE_AXIS"]
