"""Process wiring: ranks, the device and backend rule, collectives, loading plans.

Port of ``anemoi_tpu.parallel.distributed``.  The JAX package runs one SPMD
program whose mesh spans every process; here every rank is a process of its
own (as in anemoi-core) and ``torch.distributed`` joins them.

Launch contracts read by :func:`maybe_initialize`, the JAX package's first:

  ANEMOI_TPU_COORDINATOR   host:port of rank 0
  ANEMOI_TPU_NUM_PROCESSES world size
  ANEMOI_TPU_PROCESS_ID    this process's rank
  LOCAL_RANK               the rank on this host (default: the process id)

and torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  :func:`spawn` starts local ranks itself (the tests,
``chip_smoke.py`` and ``cli train`` with ``hardware.num_devices``).

The device and backend rule (:func:`device_and_backend`), decided before
``init_process_group``, logged with the world size and never changed after a
failure: on the CPU, gloo; with one card per local rank, rank ``r`` on
``cuda:LOCAL_RANK`` with NCCL; with more local ranks than cards, the ranks
share the cards round-robin with gloo (NCCL refuses two ranks on one
device), whose collectives take the CUDA tensors themselves.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import socket
import sys
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LOGGER = logging.getLogger(__name__)

ENV_COORDINATOR = "ANEMOI_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "ANEMOI_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "ANEMOI_TPU_PROCESS_ID"
ENV_INIT_TIMEOUT = "ANEMOI_TPU_INIT_TIMEOUT_S"  # seconds init_process_group waits for peers


@dataclass(frozen=True)
class Launch:
    """This process's place in the world and what it runs on."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: str


_LAUNCH: Optional[Launch] = None


def _env_contract() -> Optional[Tuple[str, int, int, int]]:
    """``(init_method, world, rank, local_rank)`` from the environment, or
    None when no launcher set one."""
    env = os.environ
    if env.get(ENV_COORDINATOR):
        rank = int(env[ENV_PROCESS_ID])
        return (f"tcp://{env[ENV_COORDINATOR]}", int(env[ENV_NUM_PROCESSES]), rank,
                int(env.get("LOCAL_RANK", rank)))
    if env.get("WORLD_SIZE") and env.get("RANK") is not None and env.get("MASTER_ADDR"):
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                int(env["RANK"]), int(env.get("LOCAL_RANK", 0)))
    return None


def device_and_backend(platform: Optional[str], local_rank: int,
                       local_world: int) -> Tuple[torch.device, str]:
    """The rule: ``cpu`` -> (cpu, gloo); otherwise the CUDA cards, which must
    be visible: one card per local rank -> (``cuda:local_rank``, nccl), more
    local ranks than cards -> (``cuda:local_rank % cards``, gloo)."""
    if platform is not None and str(platform).lower() == "cpu":
        return torch.device("cpu"), "gloo"
    if platform is not None and str(platform).lower() not in ("gpu", "cuda"):
        raise ValueError(f"platform '{platform}': anemoi_tpu_torch runs on cpu or gpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("anemoi_tpu_torch runs on a CUDA card by default and none is "
                           "visible; pass platform cpu to run the ranks on the CPU")
    if local_world <= cards:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % cards), "gloo"


def maybe_initialize(platform: Optional[str] = None) -> Optional[Launch]:
    """Join the world a launcher described in the environment (idempotent).

    Returns the :class:`Launch`, or None when no launcher set the
    environment (one process).  A world that cannot start raises: nothing
    falls back to a single process."""
    global _LAUNCH
    if _LAUNCH is not None:
        return _LAUNCH
    contract = _env_contract()
    if contract is None:
        return None
    init_method, world, rank, local_rank = contract
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device, backend = device_and_backend(platform, local_rank, local_world)
    LOGGER.info("rank %d of %d (local %d of %d): %s with %s", rank, world, local_rank,
                local_world, device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=float(os.environ.get(ENV_INIT_TIMEOUT, 600)))
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=timeout)
    except Exception as err:
        raise RuntimeError(f"rank {rank}: the world of {world} ranks did not start at "
                           f"{init_method} ({backend}): {err}") from err
    _LAUNCH = Launch(rank, world, local_rank, local_world, device, backend)
    return _LAUNCH


def launch() -> Optional[Launch]:
    """The :class:`Launch` of :func:`maybe_initialize`, or None."""
    return _LAUNCH


def shutdown() -> None:
    """Leave the world (each rank, at its end)."""
    global _LAUNCH
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAUNCH = None


# --- collectives ------------------------------------------------------------
# Under gloo (ranks that share a card) the collectives take CUDA tensors
# themselves: this torch build's gloo accepts them for all_reduce, all_gather
# and all_to_all_single (chip_smoke.py phase 31 runs all three on CUDA
# tensors), so none is staged here.
def all_reduce(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``group`` (a no-op without one)."""
    if group is not None:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (equal shapes) in group-rank order."""
    if group is None:
        return [tensor]
    tensor = tensor.contiguous()
    out = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, tensor, group=group)
    return out


class Pending:
    """An all-to-all in flight: :meth:`wait` returns its result, ``out``."""

    def __init__(self, work, out: torch.Tensor, inp: torch.Tensor):
        self.work, self.out = work, out
        self.inp = inp  # alive until the collective is done

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = self.inp = None
        return self.out


def all_to_all(inp: torch.Tensor, group, async_op: bool = False) -> Pending:
    """``all_to_all_single`` of ``inp`` (dim 0 split in group-size equal
    blocks, block j to rank j of the group); returns a :class:`Pending`."""
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    work = dist.all_to_all_single(out, inp, group=group, async_op=async_op)
    return Pending(work if async_op else None, out, inp)


# --- loading plans ----------------------------------------------------------
def host_local_slices(sharding, global_shape: Sequence[int]) -> Tuple[slice, ...]:
    """Per-dimension slices of a ``[B, T, E, G, V]`` global batch this rank
    reads under ``sharding`` (:func:`~anemoi_tpu_torch.parallel.mesh.batch_sharding`):
    its data group's batch rows and, with grid sharding, its model block of
    the grid."""
    return sharding.slices(global_shape)


def local_batch_plan(sharding, global_shapes: Dict[str, Tuple[int, ...]]
                     ) -> Dict[str, Tuple[slice, ...]]:
    """Which ``(batch, time, ens, grid, var)`` block of each dataset this
    rank reads."""
    return {name: host_local_slices(sharding, shape) for name, shape in global_shapes.items()}


class RowShard(NamedTuple):
    """This rank's rows ``[lo, hi)`` of a tensor whose rows are split in
    equal blocks over ``group`` (ZeRO's optimizer state)."""

    tensor: torch.Tensor
    group: Any


def fetch_replicated(tree):
    """A host copy of ``tree`` with every :class:`RowShard` gathered whole.
    Collective: every rank of each shard's group takes part, and every rank
    (rank 0 among them) ends with the whole tree."""
    if isinstance(tree, RowShard):
        return torch.cat(all_gather(tree.tensor.detach(), tree.group), 0).cpu()
    if isinstance(tree, dict):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_replicated(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


# --- local ranks ------------------------------------------------------------
def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _child(rank: int, world: int, port: int, work, platform: Optional[str],
           threads: Optional[int], results, env: Dict[str, str]) -> None:
    os.environ.update(env)
    os.environ.update({ENV_COORDINATOR: f"127.0.0.1:{port}", ENV_NUM_PROCESSES: str(world),
                       ENV_PROCESS_ID: str(rank), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    if threads:
        torch.set_num_threads(threads)
    try:
        fn, args = work.get()
        maybe_initialize(platform)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: tuple = (), platform: Optional[str] = None,
          threads: Optional[int] = None, timeout_s: float = 3600.0,
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` local ranks started with the ``spawn``
    method, each joined to the world by :func:`maybe_initialize` (device and
    backend by the rule) before ``fn`` runs; returns each rank's result in
    rank order.  ``fn`` and ``args`` must pickle (a module-level function).
    If a rank fails or exits, every rank is stopped and this raises with its
    traceback: no rank carries on alone.  ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results, work = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=False,
                         args=(r, world, port, work, platform, threads, results,
                               dict(env or {})))
             for r in range(world)]
    for p in procs:
        p.start()
    # ``fn`` and ``args`` go through a queue, not the start call: a start
    # whose arguments overflow the pipe waits until that child has booted,
    # which would start the ranks one after another
    work.cancel_join_thread()
    for _ in procs:
        work.put((fn, args))
    out: Dict[int, Any] = {}
    failure = None
    import time

    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks did not finish within {timeout_s} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn of {world} ranks: {failure}")
    return [out[r] for r in range(world)]
