"""Sharded production paths over ``torch.distributed``: evaluation and
training on a scenario mesh of ranks.

Port of ``rl_mpc_lanemerging_tpu/parallel/sharded.py``.  The JAX package
runs one program over a device mesh (``shard_map``, ``pmean`` over ICI);
here each rank is a process of its own, launched by ``torchrun`` (or by
:func:`spawn` on one host), and the ranks meet only in explicit
collectives.  The reference has no distributed execution at all (SURVEY
§2.3).

* :func:`maybe_initialize_distributed` reads torchrun's variables and joins
  the process group (JAX: ``jax.distributed.initialize`` from
  ``JAX_COORDINATOR``).
* :func:`sharded_episode_runner`: each rank runs ``run_episode_batch`` on
  its own shard to the end, with no collective inside the loop, so the
  ranks' tick counts diverge freely, as the devices' while-loop trip counts
  do under ``shard_map``; a one-rank run uses the same runner on the whole
  batch.  :func:`gather_objects` then brings every rank's
  per-episode stats to rank 0 (JAX: the global array ``shard_map``
  returns).
* The train state.  JAX stacks n local train states into one global state
  with a leading device axis (``stack_states``, ``unstack_states``,
  ``shard_train_state``).  Here each rank already holds its own local state
  (its envs, replay, draws and parameter copy) in its own process, so
  nothing is stacked or placed: ``make_sharded_train`` in ``agents/ddpg.py``
  and ``agents/dqn.py`` builds it on each rank with
  :func:`data_parallel_state`.  What is left of the helpers is
  :func:`broadcast_modules` (rank 0's initial parameters to every rank)
  and :func:`gather_state_dicts` (every rank's parameters on rank 0, for a
  check).
* :func:`sharded_train_round` runs a train round with the gradient
  averaging on: its updates average their gradients over the ranks
  (:func:`average_gradients`, JAX's ``pmean``), which keeps the parameter
  copies identical, and decide to learn together (:func:`agree_min`).
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import socket
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map, tree_map_only

from .._device import const
from .mesh import SCENARIO_AXIS, make_mesh

__all__ = ["maybe_initialize_distributed", "auto_mesh", "axis_group",
           "sharded_episode_runner", "gather_objects", "cat_batches",
           "broadcast_modules", "gather_state_dicts", "average_gradients",
           "agree_min", "rank_seed", "data_parallel_state",
           "sharded_train_round",
           "free_port", "spawn"]

logger = logging.getLogger(__name__)


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun's variables describe (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return whether the run has more than one rank.  Without ``RANK`` and
    ``WORLD_SIZE`` it does nothing; calling it again does nothing.

    The backend is ``nccl`` when a card is present and ``gloo`` otherwise,
    unless the caller names one: ranks that share one card name ``gloo``
    (NCCL refuses two ranks on one GPU).  On a host with cards, local rank
    r works on card ``r % device_count``.  A one-rank launch joins a
    one-rank group too, and one ``all_reduce`` proves the backend is up."""
    if not dist.is_initialized() and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        cuda = torch.cuda.is_available()
        backend = backend or ("nccl" if cuda else "gloo")
        if cuda:
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, rank=rank, world_size=world)
        probe = torch.ones(1, device="cuda" if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            raise RuntimeError(f"{backend} all_reduce over {world} ranks "
                               f"gave {probe.item()}")
        logger.info("process group up: backend %s, rank %d of %d", backend,
                    rank, world)
    return dist.is_initialized() and dist.get_world_size() > 1


def auto_mesh(device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A scenario mesh over every rank, or None in a one-rank run."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return make_mesh(device_type)


def axis_group(mesh: DeviceMesh, axis: str = SCENARIO_AXIS):
    """(process group, this rank's index on ``axis``, ranks on ``axis``)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


def sharded_episode_runner(cfg, controller, max_episode_length: float,
                           wait_before_start: float,
                           record_history: bool = False) -> Callable:
    """``run(worlds, rng, controller_carry=None)`` -> ``run_episode_batch``'s
    outputs for the batch this rank holds: its worlds, its stats, [its
    history], [its carry].  On a mesh the batch is the rank's shard, and
    ``rng`` must key its draws by the shard's global scenario indices
    (``CounterRandom(seed, offset=rank * b)``), so that each scenario
    replays what it draws in a one-process run."""
    from ..sim.episode import run_episode_batch

    def run(worlds, rng, controller_carry=None):
        return run_episode_batch(
            worlds, cfg, controller, rng,
            max_episode_length=max_episode_length,
            wait_before_start=wait_before_start,
            record_history=record_history, controller_carry=controller_carry)

    return run


def gather_objects(obj, mesh: DeviceMesh, axis: str = SCENARIO_AXIS
                   ) -> Optional[list]:
    """Every rank's ``obj`` on the axis's first rank, in rank order, with
    its tensors moved to the CPU first; None on the other ranks.  It goes
    through ``gather_object``: ``gloo`` has no gather of CUDA tensors."""
    group, rank, n = axis_group(mesh, axis)
    out = [None] * n if rank == 0 else None
    dist.gather_object(tree_map_only(torch.Tensor,
                                     lambda t: t.detach().cpu(), obj),
                       out, dst=dist.get_global_rank(group, 0), group=group)
    return out


def cat_batches(trees: Sequence):
    """One tree from per-rank trees: every leaf concatenated on its leading
    axis, in the order given (global scenario order for rank order)."""
    return tree_map(lambda *leaves: torch.cat(leaves), *trees)


def broadcast_modules(modules, mesh: DeviceMesh,
                      axis: str = SCENARIO_AXIS) -> None:
    """Overwrite every parameter and buffer of ``modules`` with the axis's
    first rank's, in place (data parallelism needs every copy to start
    equal)."""
    group, _, _ = axis_group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for module in modules:
            for t in module.state_dict().values():
                dist.broadcast(t, src=src, group=group)


def gather_state_dicts(module: torch.nn.Module, mesh: DeviceMesh,
                       axis: str = SCENARIO_AXIS) -> Optional[list]:
    """Every rank's ``state_dict`` of ``module`` on the CPU, on the axis's
    first rank; None elsewhere."""
    return gather_objects(module.state_dict(), mesh, axis)


def average_gradients(grads: Sequence[torch.Tensor], group
                      ) -> List[torch.Tensor]:
    """The mean of each gradient over the group's ranks (JAX ``pmean``):
    one ``all_reduce(SUM)`` of all of them flattened into one buffer, then
    a division by a tensor holding the rank count.  ``ReduceOp.AVG`` does
    not exist on ``gloo``, and a tensor divisor keeps IEEE division
    (``_device.const``)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / const(float(dist.get_world_size(group)), flat)
    return [part.view_as(g) for part, g in
            zip(torch.split(flat, [g.numel() for g in grads]), grads)]


def agree_min(value: torch.Tensor, group) -> int:
    """The smallest of the ranks' ``value`` (a 0-dim integer tensor on the
    rank's device), known to every rank: how the ranks of a data-parallel
    trainer decide together whether to learn, since one rank that stepped
    into the gradient ``all_reduce`` alone would wait forever."""
    t = value.detach().reshape(1).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


def rank_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s seed of a data-parallel run started from ``seed``
    (JAX splits one key per device)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def data_parallel_state(make_train_state: Callable, cfg, mesh: DeviceMesh,
                        seed: int, nets: Sequence[str], **kw):
    """This rank's train state of a data-parallel trainer (JAX
    ``make_sharded_train``), on the mesh's device (the current card, or the
    CPU): ``make_train_state(cfg, worlds, world_rng, rank_seed(seed, i),
    **kw)`` with rank i's worlds drawn from SEED + i; then rank 0's
    networks ``state.<net>`` for each name in ``nets`` overwrite every
    rank's, and each ``state.target_<net>`` is set to its network."""
    from .. import tasks
    _, rank, _ = axis_group(mesh)
    dev = torch.device("cpu") if mesh.device_type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    if cfg.SEED != "Random":
        cfg = cfg.replace(SEED=int(cfg.SEED) + rank)
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = make_train_state(cfg, worlds, world_rng, rank_seed(seed, rank),
                             **kw)
    broadcast_modules([getattr(state, net) for net in nets], mesh)
    for net in nets:
        getattr(state, "target_" + net).load_state_dict(
            getattr(state, net).state_dict())
    return state


def sharded_train_round(body: Callable, mesh: DeviceMesh) -> Callable:
    """``body(state, ..., group=...)`` with the mesh's scenario group bound:
    every gradient step of the round averages its gradients over the ranks
    (JAX: the round under ``shard_map`` with ``axis_name`` bound)."""
    group, _, _ = axis_group(mesh)
    return functools.partial(body, group=group)


# ---------------------------------------------------------------------------
# n ranks on one host
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on ``localhost`` that is free now (for ``MASTER_PORT``)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, port, backend, out_dir, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    maybe_initialize_distributed(backend)
    try:
        result = tree_map_only(torch.Tensor,
                               lambda t: t.detach().cpu().numpy(), fn(*args))
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` fresh processes joined into one
    process group over ``localhost`` (what ``torchrun --nproc_per_node``
    does), and return each rank's result in rank order, every tensor in it
    as a numpy array.  ``fn`` must be importable by name (a module-level
    function).  A rank that raises makes this raise, after the others are
    stopped; so does a run longer than ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        procs = mp.start_processes(
            _rank_main, args=(fn, nprocs, free_port(), backend, out_dir,
                              args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not procs.join(timeout=1.0):   # raises if a rank failed
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"ran past {timeout} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        results = []
        for r in range(nprocs):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results
