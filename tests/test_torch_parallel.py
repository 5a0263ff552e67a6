"""The port's scenario mesh (``parallel/``) against one process and against
the JAX package, with 2 ``gloo`` ranks on the CPU: sharded evaluation equals
a one-process run episode for episode (``tests/test_sharded.py``'s case, a
crashing controller with the history on, and the MPC controller); the
data-parallel DDPG update and DQN grad step equal JAX's ``pmean``'d ones
under ``shard_map`` over 2 of the 8 virtual CPU devices (1e-9 in float64);
both trainers' ``make_sharded_train`` keep the parameter copies identical
while the envs differ, also when the ranks' replays cross the learning
threshold on different ticks; the tensor-parallel rules place what JAX's
place (dims transposed) and the split critic equals the whole one.  The
ranks run ``tests/_torch_ranks.py`` in one spawn; the draws' scenario
offset is checked here in the pytest process."""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import _torch_ranks as ranks
from test_torch_dqn import CFG as DQN_CFG
from test_torch_dqn import SMALL as DQN_SMALL
from test_torch_dqn import _batch as _dqn_batch
from test_torch_dqn import _params as _dqn_params
from test_torch_train import _ddpg_batch, _ddpg_params
from rl_mpc_lanemerging_torch.parallel import sharded, tp
from rl_mpc_lanemerging_torch.models.ddpg import DDPGCritic
from rl_mpc_lanemerging_torch.sim.rng import CounterRandom, _mix32
from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
from rl_mpc_lanemerging_tpu.agents import dqn as jdqn
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.models.ddpg import DDPGCritic as JCritic
from rl_mpc_lanemerging_tpu.parallel import tp as jtp
from rl_mpc_lanemerging_tpu.parallel.sharded import shard_map

JCFG = Settings()
LR = 1e-3
UPDATES = 3
AXIS = "scenario"


def _pmean_steps(body, state, batches):
    """``body(*state, local batch)`` under ``shard_map`` over 2 devices,
    once per entry of ``batches`` (each a pair of per-rank numpy batches);
    returns every output with its leading axis = the shard."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), (AXIS,))

    def local(*args):
        out = body(*args[:-1], jax.tree.map(lambda x: x[0], args[-1]))
        return jax.tree.map(lambda x: x[None], out)

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P(),) * len(state) + (P(AXIS),),
                           out_specs=P(AXIS)))
    outs = []
    for pair in batches:
        stacked = {k: jnp.asarray(np.stack([b[k] for b in pair]))
                   for k in pair[0]}
        out = fn(*state, stacked)
        outs.append(out)
        state = jax.tree.map(lambda x: x[0], out)[:len(state)]
    return outs


def _jax_dp(rng):
    """The JAX side of the data-parallel parity: inputs for the ranks and
    JAX's outputs."""
    ap, cp = _ddpg_params(0)
    ta, tc = _ddpg_params(1)
    ddpg_batches = [[_ddpg_batch(rng), _ddpg_batch(rng)]
                    for _ in range(UPDATES)]
    ddpg_out = _pmean_steps(
        lambda *a: jddpg._update(JCFG, LR, *a, axis_name=AXIS),
        (ap, cp, ta, tc, optax.adam(LR).init(ap), optax.adam(LR).init(cp)),
        ddpg_batches)[-1]

    q, q_target = _dqn_params(0), _dqn_params(1)
    dqn_batches = [[_dqn_batch(rng), _dqn_batch(rng)] for _ in range(UPDATES)]
    dqn_out = _pmean_steps(
        lambda p, o, b: jdqn._grad_step(p, o, b, q_target, DQN_CFG,
                                        axis_name=AXIS),
        (q, optax.adam(DQN_CFG.LEARNING_RATE).init(q)), dqn_batches)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    inputs = dict(ap=np_tree(ap), cp=np_tree(cp), ta=np_tree(ta),
                  tc=np_tree(tc), lr=LR, ddpg_batches=ddpg_batches,
                  q=np_tree(q), q_target=np_tree(q_target),
                  dqn_config="configs/train_default_1.json",
                  dqn_small=DQN_SMALL, dqn_batches=dqn_batches)
    want = {"ddpg": np_tree(ddpg_out[:4]),
            "dqn_q": np_tree(dqn_out[-1][0]),
            "dqn_loss": [np.asarray(o[2]) for o in dqn_out],
            "dqn_td": [np.asarray(o[3]) for o in dqn_out]}
    return inputs, want


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(6)
    dp_inputs, want = _jax_dp(rng)
    with open(tmp / "dp.pkl", "wb") as fh:
        pickle.dump(dp_inputs, fh)
    tp_obs = rng.normal(size=(128, 20)).astype(np.float32)
    tp_action = rng.uniform(-5, 5, (128, 1)).astype(np.float32)
    with open(tmp / "suite.pkl", "wb") as fh:
        pickle.dump(dict(tmp=str(tmp), dp=str(tmp / "dp.pkl"),
                         tp_obs=tp_obs, tp_action=tp_action), fh)
    results = sharded.spawn(ranks.parallel_suite, 2,
                            args=(str(tmp / "suite.pkl"),), timeout=400)
    return dict(ranks=results, want=want)


def test_shard_batch_gives_each_rank_its_rows(suite):
    for r, out in enumerate(suite["ranks"]):
        s = out["shard"]
        np.testing.assert_array_equal(
            s["slice"]["x"], np.arange(24).reshape(8, 3)[4 * r:4 * r + 4])
        assert int(s["slice"]["s"]) == 5 and s["padded"] == 8
        assert s["placements"] == ["S(0)"]


@pytest.mark.parametrize("kind", ["eval", "eval_crash", "eval_mpc"])
def test_sharded_eval_matches_one_process(suite, kind, tmp_path):
    """Every per-episode column identical to one process's run of the same
    16 scenarios (the constant controller of tests/test_sharded.py, a
    slow one that crashes with the history on, and the MPC)."""
    controller = {"eval": ranks.constant_controller(8.0),
                  "eval_crash": ranks.constant_controller(ranks.CRASH_SPEED),
                  "eval_mpc": ranks.mpc.make_batched_controller(ranks.TINY)
                  }[kind]
    kw = dict(save_state_on_crash=True, run_dir=str(tmp_path)) \
        if kind == "eval_crash" else {}
    one = ranks.evaluate(controller, mesh=None, **kw)
    sharded_cols = suite["ranks"][0][kind]
    assert suite["ranks"][1][kind] is None
    assert len(sharded_cols["crashed"]) == 16
    assert sorted(sharded_cols) == sorted(one)
    for col, values in one.items():
        if col.startswith("clock_time"):        # wall time, not a stat
            continue
        np.testing.assert_array_equal(np.asarray(sharded_cols[col]),
                                      np.asarray(values), err_msg=col)
    if kind == "eval_crash":
        crashed = np.asarray(one["crashed"], bool)
        assert 0 < crashed.sum() < 16
        assert len(os.listdir(tmp_path)) == crashed.sum()


def test_each_rank_dumps_its_own_crashes(suite):
    crashed = np.asarray(suite["ranks"][0]["eval_crash"]["crashed"], bool)
    dumps = suite["ranks"][0]["dumps"]
    want = [f"crashed_state_history_r0_rank{r}_{i}.pkl"
            for r in range(2) for i in range(int(crashed[8 * r:8 * r + 8]
                                                 .sum()))]
    assert dumps == sorted(want)


def _assert_tree(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(want[layer][leaf]),
                                       atol=atol, rtol=0,
                                       err_msg=f"{what}/{layer}/{leaf}")


def test_dp_ddpg_update_matches_jax_pmean(suite):
    """3 updates on 2 ranks' batches, gradients averaged: actor, critic and
    both targets of each rank within 1e-9 of JAX's shard."""
    names = ("actor", "critic", "target_actor", "target_critic")
    for r, out in enumerate(suite["ranks"]):
        for name, tree in zip(names, suite["want"]["ddpg"]):
            shard = jax.tree.map(lambda x: x[r], tree)["params"]
            _assert_tree(out["dp"]["ddpg"][name], shard, 1e-9,
                         f"rank {r} {name}")


def test_dp_dqn_grad_step_matches_jax_pmean(suite):
    """3 grad steps: the network within 1e-9 of JAX's, and each rank's own
    loss and td errors within 1e-9 of its shard's."""
    for r, out in enumerate(suite["ranks"]):
        shard = jax.tree.map(lambda x: x[r], suite["want"]["dqn_q"])
        _assert_tree(out["dp"]["dqn"]["q"], shard["params"], 1e-9,
                     f"rank {r} q")
        np.testing.assert_allclose(
            out["dp"]["dqn"]["loss"],
            [float(loss[r]) for loss in suite["want"]["dqn_loss"]],
            atol=1e-9, rtol=0)
        for got, want in zip(out["dp"]["dqn"]["td"],
                             suite["want"]["dqn_td"]):
            np.testing.assert_allclose(got, want[r], atol=1e-9, rtol=0)


def _identical(state_dicts):
    first = state_dicts[0]
    for other in state_dicts[1:]:
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(np.asarray(other[k]),
                                          np.asarray(first[k]), err_msg=k)


@pytest.mark.parametrize("trainer", ["ddpg", "dqn"])
def test_sharded_training_keeps_params_in_sync(suite, trainer):
    """After make_sharded_train rounds: the ranks' parameters bit-identical,
    their envs different, and both made the same (non-zero) updates."""
    outs = [r["train"][trainer] for r in suite["ranks"]]
    counter = "updates" if trainer == "ddpg" else "grad_steps"
    assert outs[0][counter] == outs[1][counter] > 0
    for key in (("actors", "critics") if trainer == "ddpg" else ("nets",)):
        _identical(outs[0][key])
        assert outs[1][key] is None
    assert not np.allclose(outs[0]["obs"], outs[1]["obs"])
    if trainer == "ddpg":
        assert outs[0]["frames"] > 0 and outs[1]["frames"] > 0


@pytest.mark.parametrize("trainer,threshold,counter", [
    ("ddpg_uneven", ranks.DP_REPLAY_START, "updates"),
    ("dqn_uneven", 16, "grad_steps")])
def test_uneven_ranks_start_learning_together(suite, trainer, threshold,
                                              counter):
    """Ranks of 4 and 2 scenarios: their replays cross the threshold on
    different ticks, yet both start learning on the later one and make the
    same updates, and their parameters stay identical."""
    outs = [r["train"][trainer] for r in suite["ranks"]]
    own = [int(np.argmax(np.asarray(o["sizes"]) >= threshold)) for o in outs]
    assert all(np.asarray(o["sizes"]).max() >= threshold for o in outs)
    assert own[0] < own[1]
    assert outs[0][counter] == outs[1][counter]
    steps = np.asarray(outs[0][counter])
    assert steps[own[1]] > 0 and steps[own[1] - 1] == 0
    key = "actors" if trainer == "ddpg_uneven" else "nets"
    _identical(outs[0][key])


def test_tp_rules_place_what_jax_places(suite):
    """JAX's test_tp_sharding_rules_apply, transposed: Dense_0 split on its
    outputs (torch Shard(0)), Dense_1 on its inputs (Shard(1)), the rest
    replicated; the placements the rules predict are those the parameters
    got."""
    params = JCritic(hidden=256).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 20)), jnp.zeros((1, 1)))
    jspecs = dict(zip(
        ["/".join(str(getattr(k, "key", k)) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]],
        jtp.param_path_specs(params, jtp.mlp_tp_rules("model"))))
    specs = tp.param_path_specs(DDPGCritic(), tp.mlp_tp_rules())
    transposed = {P(None, "model"): "S(0)", P("model"): "S(0)",
                  P("model", None): "S(1)", P(): "R"}
    for name, placement in specs.items():
        _, layer, leaf = name.split(".")
        jleaf = "kernel" if leaf == "weight" else leaf
        assert str(placement) == transposed[jspecs[f"params/{layer}/{jleaf}"]]
    for out in suite["ranks"]:
        assert out["tp"]["want"] == {k: str(v) for k, v in specs.items()}
        for name, got in out["tp"]["got"].items():
            want = specs[name]
            if str(want) == "R" and not got:       # a plain tensor
                continue
            assert got == [str(want)], (name, got)


def test_tp_critic_equals_the_whole_critic(suite):
    for out in suite["ranks"]:
        assert out["tp"]["gap"] <= 1e-6


def _old_bits(seed, steps, stream):
    """CounterRandom._bits before it took an offset."""
    scen = torch.arange(steps.shape[0], dtype=torch.int64)
    h = _mix32(torch.full_like(steps, seed) ^ stream)
    h = _mix32(h ^ (scen & 0xFFFFFFFF))
    h = _mix32(h ^ (steps & 0xFFFFFFFF))
    return _mix32(h ^ (steps >> 32))


def test_offset_zero_keeps_the_draws():
    steps = torch.tensor([0, 3, 7, 2 ** 33 + 5, 11], dtype=torch.int64)
    for stream in range(7):
        np.testing.assert_array_equal(
            CounterRandom(42, 0)._bits(steps, stream).numpy(),
            _old_bits(42, steps, stream).numpy())
        np.testing.assert_array_equal(
            CounterRandom(42)._bits(steps, stream).numpy(),
            _old_bits(42, steps, stream).numpy())


@pytest.mark.parametrize("k", [1, 5])
def test_offset_slice_equals_the_rows_of_the_whole_batch(k):
    steps = torch.arange(8, dtype=torch.int64) * 3 + 1
    whole, part = CounterRandom(9), CounterRandom(9, offset=k)
    for a, b in zip(whole.step_draws(steps, torch.float32),
                    part.step_draws(steps[k:], torch.float32)):
        np.testing.assert_array_equal(a[k:].numpy(), b.numpy())
    np.testing.assert_array_equal(
        whole.start_normal(steps, torch.float64)[k:].numpy(),
        part.start_normal(steps[k:], torch.float64).numpy())
    assert not torch.equal(part.start_normal(steps[k:], torch.float64),
                           whole.start_normal(steps[:-k], torch.float64))


def test_without_launcher_variables_nothing_is_initialised(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert sharded.maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    assert sharded.auto_mesh("cpu") is None
