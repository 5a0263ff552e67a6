"""Device-resident replay buffer with prioritized experience replay.

Port of ``rl_mpc_lanemerging_tpu/rl/replay.py`` (reference dqn.py:727-794
and dqn.py:267-270).  Priorities live in a flat tensor on the device and
proportional sampling is a cumulative sum + ``searchsorted`` per draw: each
item is drawn with probability weight/total, independently and with
replacement, like the reference's sum-tree walk.

Capacity rounds up to a power of two like the reference tree
(dqn.py:730-733).  Priorities follow dqn.py:302-304 (insert at
PER_MAX_PRIORITY ** PER_ALPHA) and dqn.py:344-349 (update to
min(|td| + PER_MIN_PRIORITY, PER_MAX_PRIORITY) ** PER_ALPHA).  Uniform
replay is the same buffer with constant priorities.

Two differences from the JAX package, both forced by PyTorch:

* Every buffer has one scratch row at index ``cap``.  ``add_batch`` sends
  invalid rows there, as JAX sends them out of bounds (where its scatter
  drops them; a torch index out of bounds raises), and then clears it.
  Sampling and the priority sums read ``[:cap]`` only, so the scratch row
  is never drawn.
* The writes are in place: ``add_batch`` and ``update_priorities`` write
  into the buffers they were given and return the replay with its cursor
  moved.  The JAX trainers donate the old buffer to the same effect.

Each draw is split from its use: ``sample`` takes its uniforms, or a
``torch.Generator`` that makes them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Settings

__all__ = ["Replay", "init_replay", "add_batch", "sample",
           "sample_with_weights", "update_priorities", "round_up_pow2"]


def round_up_pow2(n: int) -> int:
    cap = 1
    while cap < n:
        cap *= 2
    return cap


class Replay(NamedTuple):
    """Row ``cap`` of every buffer is scratch: written, never read."""

    obs: torch.Tensor        # (cap + 1, D)
    next_obs: torch.Tensor   # (cap + 1, D)
    action: torch.Tensor     # (cap + 1,) int64 discrete / float continuous
    reward: torch.Tensor     # (cap + 1,) (n-step aggregated for n-step)
    terminal: torch.Tensor   # (cap + 1,) bool: transition ended the episode
    discount: torch.Tensor   # (cap + 1,) bootstrap discount (gamma^K)
    priority: torch.Tensor   # (cap + 1,) 0 => slot empty
    pos: torch.Tensor        # () int64 ring cursor
    size: torch.Tensor       # () int64

    @property
    def capacity(self) -> int:
        return self.priority.shape[0] - 1


def init_replay(capacity: int, obs_dim: int, discrete: bool,
                dtype=torch.float32, device="cpu") -> Replay:
    rows = round_up_pow2(capacity) + 1
    act_dtype = torch.int64 if discrete else dtype

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Replay(
        obs=zeros(rows, obs_dim), next_obs=zeros(rows, obs_dim),
        action=zeros(rows, dt=act_dtype), reward=zeros(rows),
        terminal=zeros(rows, dt=torch.bool),
        discount=torch.ones((rows,), dtype=dtype, device=device),
        priority=zeros(rows),
        pos=zeros(dt=torch.int64), size=zeros(dt=torch.int64))


def add_batch(replay: Replay, obs, next_obs, action, reward, terminal,
              valid, init_priority, discount=None) -> Replay:
    """Ring-insert a batch of transitions; ``valid`` masks padded rows.

    Valid rows take consecutive ring slots from the cursor (their rank among
    the valid rows); invalid rows all go to the scratch row, which is then
    cleared: on a card, which of them lands there last is unspecified, and
    the cleared row keeps every buffer a function of the valid rows alone.
    No host synchronisation: no boolean indexing."""
    cap = replay.capacity
    valid = valid.to(torch.int64)
    offsets = torch.cumsum(valid, 0) - valid          # rank among valid rows
    n_valid = valid.sum()
    slots = torch.where(valid == 1, (replay.pos + offsets) % cap, cap)
    if discount is None:
        discount = torch.ones_like(reward)

    def write(dest, src):
        dest.index_copy_(0, slots, src.to(dest.dtype))
        dest[cap] = 0

    write(replay.obs, obs)
    write(replay.next_obs, next_obs)
    write(replay.action, action)
    write(replay.reward, reward)
    write(replay.terminal, terminal)
    write(replay.discount, discount)
    write(replay.priority, torch.full_like(reward, init_priority))
    return replay._replace(pos=(replay.pos + n_valid) % cap,
                           size=torch.clamp_max(replay.size + n_valid, cap))


def sample(replay: Replay, batch: int, u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
    """Proportional sampling with replacement; returns (indices, batch
    dict).  ``u`` (batch,) are U[0, 1) draws; without them they come from
    ``generator``.  Matches the reference's per-item tree sampling
    (dqn.py:778-794)."""
    cap = replay.capacity
    p = replay.priority[:cap]
    # On a card the scan adds in an order that can change from call to
    # call.  In float64 the partial sums of a float32 ring are exact (its
    # priorities, PER_MIN_PRIORITY ** PER_ALPHA to PER_MAX_PRIORITY **
    # PER_ALPHA over at most 65,536 rows, need at most 50 bits), so the
    # draw does not depend on that order.  The CPU's scan is sequential,
    # as JAX's.
    c = torch.cumsum(p, 0, dtype=torch.float64 if p.is_cuda else p.dtype)
    if u is None:
        u = torch.rand((batch,), generator=generator, dtype=p.dtype,
                       device=p.device)
    idx = torch.searchsorted(c, u * c[-1], right=True).clamp_(0, cap - 1)
    batch_data = dict(
        obs=replay.obs[idx], next_obs=replay.next_obs[idx],
        action=replay.action[idx], reward=replay.reward[idx],
        terminal=replay.terminal[idx], discount=replay.discount[idx])
    return idx, batch_data


def sample_with_weights(replay: Replay, batch: int, beta,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Proportional sampling plus importance-sampling correction weights
    w_i = (N * P(i))^-beta / max_j w_j (Schaul et al. 2016).  ``beta`` may
    be a 0-dim tensor, so that the annealing schedule needs no host
    read."""
    idx, batch_data = sample(replay, batch, u, generator)
    p = replay.priority[:replay.capacity]
    total = p.sum()
    n = torch.clamp_min(replay.size.to(p.dtype), 1.0)
    probs = torch.clamp_min(p[idx] / torch.clamp_min(total, 1e-12), 1e-12)
    w = (n * probs) ** (-beta)
    w = w / torch.clamp_min(w.max(), 1e-12)
    return idx, batch_data, w


def update_priorities(replay: Replay, idx, td_error, cfg: Settings
                      ) -> Replay:
    """dqn.py:344-349 semantics.  With a repeated index the value written
    last is unspecified, as in XLA's scatter."""
    pri = torch.clamp_max(torch.abs(td_error) + cfg.PER_MIN_PRIORITY,
                          cfg.PER_MAX_PRIORITY) ** cfg.PER_ALPHA
    replay.priority.index_copy_(0, idx, pri.to(replay.priority.dtype))
    return replay
