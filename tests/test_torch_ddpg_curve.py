"""TRAIN_DDPG's two stages at the reference's budget, carried across runs
by handoffs (``scripts/train_curve_torch.py --trainer ddpg --stage 1|2``),
on the CPU.

A stage cut after an evaluation block, saved, loaded into a freshly built
state and resumed equals the same stage run straight, bit for bit: every
tensor of the train state, the selection, the log and evaluation points
and the record less its timings (real rounds at B=4 with 16 cars, short
rounds, a small ring that wraps, ``REPLAY_START`` lowered).  The handoff's
packed ring unpacks to the ring; a load refuses a file written for another
config or seed.  The card script's stage 2 equals ``ddpg.train``'s stage 2.
``_train_frames`` of both packages, driven by the same scripted rounds and
evaluations, give the same log points, evaluation points and selection
across both stages, and so do the port's cut into segments.  The JAX
script's two stages, the records, and ``--compare --trainer ddpg --stage
both`` on synthetic records; the sections of the earlier curves stay as
they are."""

import functools
import importlib.util
import json
import os
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.agents import ddpg as pdd
from rl_mpc_lanemerging_torch.config import Settings as PortSettings
from rl_mpc_lanemerging_tpu.agents import ddpg as jdd
from rl_mpc_lanemerging_tpu.config import Settings as JaxSettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tc = _load("train_curve_torch")
jc = _load("jax_train_curve")
pt = _load("paper_table_torch")

OVERRIDES = dict(MAX_CARS=16, MAX_SENSED_CARS=8, EVALUATION_EPISODE_LENGTH=6.0)
SIZES = dict(batch=4, eval_every=5, eval_episodes=4, final_episodes=4,
             overrides=OVERRIDES)
# 12-13 rounds of 20 ticks at B=4 (the first five warm up): cuts after
# the first and second blocks of 5 rounds, the second with learning under
# way
FRAMES = 320


def _short_evaluations(monkeypatch, tasks):
    """Evaluation rounds of 2 s of warmup and 4 s episodes."""
    real = tasks.evaluate_controller
    monkeypatch.setattr(tasks, "evaluate_controller", lambda *a, **kw: real(
        *a, **{**kw, "max_episode_length": 4.0, "wait_before_start": 2.0}))


@pytest.fixture
def small_trainer(monkeypatch):
    """Rounds of 20 ticks and an update a tick, learning from 20 rows, a
    ring of 256 rows, which wraps within the stage."""
    from rl_mpc_lanemerging_torch import tasks
    _short_evaluations(monkeypatch, tasks)
    monkeypatch.setattr(pdd, "TICKS_PER_ROUND", 20)
    monkeypatch.setattr(pdd, "REPLAY_START", 20)
    monkeypatch.setattr(pdd, "DDPG_REPLAY_CAPACITY", 256)
    monkeypatch.setattr(pdd, "_train_frames", functools.partial(
        pdd._train_frames, updates_per_tick=1))
    finals = []
    real = pdd._train_frames

    def recorded(*a, **kw):
        state = real(*a, **kw)
        finals.append(tc.train_state_tree(state))
        return state
    monkeypatch.setattr(pdd, "_train_frames", recorded)
    return finals


def _equal(a, b, path="") -> None:
    """Nested trees of tensors and numbers, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape, path
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bool else b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


TIMINGS = ("s_per_round", "s_per_round_median", "s_per_eval", "segments",
           "train_s", "wall_s", "final_s")


def _untimed(record):
    return {k: v for k, v in record.items() if k not in TIMINGS}


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_a_stage_cut_after_a_block_resumes_bit_for_bit(small_trainer,
                                                       tmp_path):
    """Stage 1 straight, and in three segments as over three runs: the
    first ends in a whole handoff, the second resumes from it in another
    folder and ends in a delta against it, the third resumes from both
    and ends the stage (stage 2's cut:
    ``test_the_card_scripts_stage2_is_trains_stage2``)."""
    straight, first, second, last = (str(tmp_path / name) for name in (
        "straight", "first", "second", "last"))
    ref = tc.run_ddpg_stage(0, FRAMES, 1, handoffs=straight, device="cpu",
                            **SIZES)
    assert tc.run_ddpg_stage(0, FRAMES, 1, handoffs=first, device="cpu",
                             blocks=1, **SIZES) is None
    assert tc.run_ddpg_stage(0, FRAMES, 1, handoffs=second, device="cpu",
                             blocks=1, resume_from=first, **SIZES) is None
    whole, delta = (tc.handoff_path(d, 0, 1, n) for d, n in ((first, 1),
                                                           (second, 2)))
    assert tc.handoff_files(first, 0, 1) == [whole]
    assert tc.handoff_files(second, 0, 1) == [delta]
    for name in (delta, delta + ".json"):
        os.replace(name, os.path.join(first, os.path.basename(name)))
    ring = torch.load(os.path.join(first, os.path.basename(delta)),
                      weights_only=True)["state"]["replay"]
    assert ring["base"] == os.path.basename(whole) and ring["rows"] < 257
    got = tc.run_ddpg_stage(0, FRAMES, 1, handoffs=last, device="cpu",
                            resume_from=first, **SIZES)
    assert tc.handoff_files(first, 0, 1) == []
    # the cuts fell after blocks that evaluated; the resumed stage ran on
    # past them, and its ring wrapped
    segs = got["segments"]
    assert [s["rounds_to"] for s in segs] == [5, 10, ref["rounds"]]
    assert ref["rounds"] > 10 and segs[0]["ended"] == "1 blocks run"
    assert segs[1]["handoff_bytes"] > 0 and segs[2]["load_s"] > 0
    assert len(got["evals"]) == ref["rounds"] // 5 + (ref["rounds"] % 5 > 0)
    straight_state, resumed_state = small_trainer[0], small_trainer[-1]
    assert resumed_state["learning"] and resumed_state["updates"] > 0
    assert int(resumed_state["replay"]["size"]) == 256
    _equal(straight_state, resumed_state)
    assert _untimed(got) == _untimed(ref)
    assert got["selected"]["frames"] in [e["frames"] for e in got["evals"]]
    a, b = _npz(tc.snapshot_path(straight, 0)), _npz(
        tc.snapshot_path(last, 0))
    _equal({k: torch.from_numpy(v) for k, v in a.items()},
           {k: torch.from_numpy(v) for k, v in b.items()})
    assert "final" not in got and got["k1_launches"] == 0


def test_the_handoff_carries_every_field_and_refuses_another_key(
        small_trainer, tmp_path):
    """A state mid-stage (ring wrapped, learning, scratch row written)
    crosses the file into a fresh state exactly; another seed, stage,
    budget or config is refused."""
    from rl_mpc_lanemerging_torch import tasks
    cfg = tc.seed_config(1, 4, OVERRIDES)
    worlds, rng = tasks.make_worlds(cfg, device="cpu")
    state = pdd.make_train_state(cfg, worlds, rng, 1)
    for _ in range(10):
        state = pdd.train_round(state, cfg, env_ticks=20, updates_per_tick=1)
    assert state.learning and int(state.replay.size) == 256
    key = tc.handoff_key(1, 1, 4, 1e6, 5, 2048, OVERRIDES)
    path = str(tmp_path / "h.pt")
    seconds, size = tc.save_handoff(path, state, key, {"rounds": [1, 2]})
    assert seconds > 0 and size == os.path.getsize(path)
    before = tc.train_state_tree(state)
    fresh = pdd.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                 1)
    assert tc.load_handoff(path, fresh, key)["rounds"] == [1, 2]
    _equal(before, tc.train_state_tree(fresh))
    assert fresh.world_rng.seed == state.world_rng.seed
    # the packed ring is a small part of the raw one, and unpacks to it
    packed = tc.pack_replay(state.replay)
    raw = sum(t.numel() * t.element_size() for t in state.replay[:7])
    blobs = sum(v.numel() for v in packed.values()
                if isinstance(v, torch.Tensor))
    assert blobs < raw / 4
    _equal({k: torch.from_numpy(v) for k, v in
            tc.unpack_arrays(packed).items()},
           {k: getattr(state.replay, k) for k in tc.RING})
    # two rounds on, a delta against the loaded ring: only the rows that
    # changed, loaded beside the whole handoff it names
    base = tc.load_handoff(path, fresh, key)["ring"]
    for _ in range(2):
        fresh = pdd.train_round(fresh, cfg, env_ticks=20, updates_per_tick=1)
    later = str(tmp_path / "h2.pt")
    tc.save_handoff(later, fresh, key, {}, base)
    delta = torch.load(later, weights_only=True)["state"]["replay"]
    assert delta["base"] == "h.pt" and 0 < delta["rows"] < 257
    again = pdd.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                 1)
    assert tc.load_handoff(later, again, key)["ring"] is None
    _equal(tc.train_state_tree(fresh), tc.train_state_tree(again))
    # a delta refuses a whole handoff with another ring
    tc.save_handoff(path, state.__class__(**{**state.__dict__,
                                             "replay": fresh.replay}),
                    key, {"rounds": [1, 2]})
    with pytest.raises(ValueError, match="not the one"):
        tc.load_handoff(later, again, key)
    for other in (tc.handoff_key(2, 1, 4, 1e6, 5, 2048, OVERRIDES),
                  tc.handoff_key(1, 2, 4, 1e6, 5, 2048, OVERRIDES),
                  tc.handoff_key(1, 1, 4, 4e5, 5, 2048, OVERRIDES),
                  tc.handoff_key(1, 1, 4, 1e6, 5, 2048, {})):
        with pytest.raises(ValueError, match="was written for"):
            tc.load_handoff(path, fresh, other)


def test_the_card_scripts_stage2_is_trains_stage2(small_trainer, tmp_path,
                                                  monkeypatch):
    """``ddpg.train`` (stage 1, then stage 2 from its selection) against
    ``run_ddpg_stage`` 1, then 2 through the selection file and a
    handoff: the same stage-2 state, selection and log points, and the
    final evaluation of the same actor."""
    from rl_mpc_lanemerging_torch import rundir
    runs, finals = [], []

    def setup_run_dir(cfg, **kw):
        runs.append(tc.Recorder())
        return SimpleNamespace(path=str(tmp_path / cfg.LOG_DIR),
                               log_scalars=runs[-1].log_scalars)
    real_actor_from = pdd._actor_from

    def actor_from(cfg, actor_state, device):
        finals.append({k: v.clone() for k, v in actor_state.items()})
        return real_actor_from(cfg, actor_state, device)
    monkeypatch.setattr(rundir, "setup_run_dir", setup_run_dir)
    monkeypatch.setattr(pdd, "_save", lambda path, params: None)
    monkeypatch.setattr(pdd, "evaluate", lambda *a, **kw: None)
    monkeypatch.setattr(pdd, "_actor_from", actor_from)
    cfg = tc.seed_config(0, 4, OVERRIDES)
    pdd.train(cfg, num_frames=FRAMES, verbose=False, eval_episodes=4,
              device="cpu")
    trained = small_trainer[:]
    small_trainer.clear()
    handoffs = str(tmp_path / "handoffs")
    r1 = tc.run_ddpg_stage(0, FRAMES, 1, handoffs=handoffs, device="cpu",
                           **SIZES)
    assert tc.run_ddpg_stage(0, FRAMES, 2, handoffs=handoffs, device="cpu",
                             blocks=1, **SIZES) is None
    r2 = tc.run_ddpg_stage(0, FRAMES, 2, handoffs=handoffs, device="cpu",
                           **SIZES)
    _equal(trained[0], small_trainer[0])            # stage 1
    _equal(trained[1], small_trainer[-1])           # stage 2, resumed
    assert r2["segments"][0]["rounds_to"] == 5 and r2["lr"] == pytest.approx(
        r1["lr"] / 10, rel=1e-15)
    assert [r.evals() for r in runs] == [r1["evals"], r2["evals"]]
    assert [r.progress() for r in runs] == [r1["progress"], r2["progress"]]
    assert len(finals) == 2
    _equal(finals[0], finals[1])
    assert r2["final"]["episodes"] == 4 and r2["selected"]["stage"] in (1, 2)
    # stage 2's end writes its selection: the actor it evaluated, and the
    # selection's score and frames
    (actor, critic), best = tc._ddpg_selection(
        tc.snapshot_path(handoffs, 0, check=True, stage=2))
    _equal(actor, finals[1])
    assert set(critic) == set(pdd.DDPGCritic(20).state_dict())
    assert best["frames"] == r2["selected"]["frames"]
    assert list(best["score"]) == r2["selected"]["score"]


def test_an_exported_selection_loads_as_the_selected_actor(tmp_path,
                                                           monkeypatch):
    """``--export``: a stage-2 selection file (with its ``best/`` keys)
    becomes ``runs_torch/curve_ddpg_seed<k>_extended/params.npz``, which
    ``MODEL_NAME`` ``runs/curve_ddpg_seed<k>_extended`` resolves to;
    ``checkpoint.load_actor`` gives an actor whose outputs equal the
    selected actor's, and the critic is kept."""
    from rl_mpc_lanemerging_torch import checkpoint
    monkeypatch.chdir(tmp_path)
    gen = torch.Generator().manual_seed(3)
    actor = pdd.DDPGActor(20, -3.0, 2.0, generator=gen)
    critic = pdd.DDPGCritic(20, generator=gen)
    selections = str(tmp_path / "selections")
    tc.save_selection(tc.snapshot_path(selections, 1, stage=2),
                      {"actor": actor.state_dict(),
                       "critic": critic.state_dict()},
                      {"score": (0.06, 0.0, 0.4), "frames": 123456})
    monkeypatch.setattr(tc, "SELECTIONS", selections)
    tc.main(["--export", "--seeds", "1"])
    model = pt.CURVE_MODEL.format(1)
    assert model == "runs/curve_ddpg_seed1_extended"
    path = checkpoint.params_path(model)
    assert path == os.path.join("runs_torch", "curve_ddpg_seed1_extended",
                                "params.npz")
    assert set(checkpoint.load_params(model)) == {"actor", "critic"}
    loaded = checkpoint.load_actor(model, "cpu", -3.0, 2.0)
    obs = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 20)),
                          dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(loaded(obs), actor(obs))
    _equal(tc._ddpg_selection(path)[0][1], critic.state_dict())
    with pytest.raises(FileNotFoundError):
        tc.main(["--export", "--seeds", "2"])


# --- both packages' _train_frames, scripted ---------------------------------

BATCH = 128
CONFIG = os.path.join(REPO, tc.CONFIG)
# (valid frames, episodes ended, return of the ended episodes) of each round
ROUNDS = [(9_919, 88, -40.0), (15_346, 417, -12.0), (20_203, 290, -9.5),
          (18_000, 330, 2.0), (20_977, 370, 3.0), (19_800, 470, 1.5),
          (21_500, 333, 4.0), (22_800, 410, 5.0), (23_100, 250, 4.5),
          (24_000, 388, 6.0), (24_400, 405, 6.5), (23_650, 301, 5.5),
          (24_950, 340, 7.0), (25_300, 260, 7.5), (24_700, 290, 7.0),
          (25_020, 322, 8.0), (24_900, 290, 7.0), (25_001, 271, 7.5),
          (25_111, 305, 8.0), (24_432, 288, 8.5), (25_088, 299, 8.0),
          (25_200, 267, 8.5), (25_300, 300, 8.0), (25_300, 280, 9.0)]
# (crash, merge, |jerk|, time to merge): no merge (a NaN time), a better
# one, its tie (which must not displace it), a worse one, the best
EVALS = [(0.0, 0.0, 0.58, float("nan")), (0.2256, 0.748, 0.473, 29.26),
         (0.2256, 0.748, 0.473, 29.26), (0.4, 0.6, 0.3, 30.0),
         (0.01, 0.99, 0.2, 27.0)]


class JaxState(NamedTuple):
    env: object
    actor_params: object
    critic_params: object
    frames: int
    episodes: int
    ep_ret_sum: float
    ep_ret_n: float


class Net:
    """A stand-in for a port module: its ``state_dict`` is its tag, the
    round after which it was last updated (-1 at the start)."""

    def __init__(self, tag=-1):
        self.tag = tag

    def state_dict(self):
        return {"tag": torch.tensor(self.tag)}


class Script:
    """The scripted rounds and evaluations of one side (``offset``: the
    rounds an earlier stage ran), and what the trainer handed them."""

    def __init__(self, port: bool, offset: int = 0):
        self.port, self.offset = port, offset
        self.rounds, self.evals = [], []

    def train_round(self, state, cfg, *a, env_ticks, updates_per_tick,
                    **kw):
        r = self.offset + len(self.rounds)
        self.rounds.append((env_ticks, updates_per_tick))
        df, de, ret = ROUNDS[r]
        if self.port:
            state.actor.tag = state.critic.tag = r
            state.frames = state.frames + df
            state.episodes = state.episodes + de
            state.ep_ret_sum = state.ep_ret_sum + ret * de
            state.ep_ret_n = state.ep_ret_n + de
            return state
        return state._replace(actor_params=r, critic_params=r,
                              frames=state.frames + df,
                              episodes=state.episodes + de,
                              ep_ret_sum=state.ep_ret_sum + ret * de,
                              ep_ret_n=state.ep_ret_n + de)

    def eval_actor(self, cfg, actor, num_episodes=2048):
        tag = actor.tag if self.port else actor
        self.evals.append((tag, num_episodes))
        return EVALS[(self.offset // 5 + len(self.evals) - 1) % len(EVALS)]


class Run:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, values):
        self.rows.append((int(step), {k: float(v) for k, v in
                                      values.items()}))


def _state(port: bool):
    if port:
        return SimpleNamespace(env=SimpleNamespace(obs=torch.zeros(BATCH, 1)),
                               actor=Net(), critic=Net(),
                               frames=torch.tensor(0),
                               episodes=torch.tensor(0),
                               ep_ret_sum=torch.tensor(0.0),
                               ep_ret_n=torch.tensor(0.0))
    return JaxState(env=SimpleNamespace(obs=np.zeros((BATCH, 1))),
                    actor_params=-1, critic_params=-1, frames=0, episodes=0,
                    ep_ret_sum=0.0, ep_ret_n=0.0)


def _tag(params, port):
    return int(params[0]["tag"]) if port else params[0]


def _drive(monkeypatch, port, num_frames, best, offset=0, run=None,
           segments=None):
    """One stage of ``_train_frames`` on scripted rounds; with
    ``segments`` (the port), cut after that many blocks and resumed, as
    the card script does.  Returns (script, run, state)."""
    module = pdd if port else jdd
    script = Script(port, offset)
    monkeypatch.setattr(module, "train_round", script.train_round)
    monkeypatch.setattr(module, "_eval_actor", script.eval_actor)
    cfg = (PortSettings if port else JaxSettings).load_from_file(
        CONFIG).replace(BATCH_SCENARIOS=BATCH)
    run = run or Run()
    state = _state(port)
    kw = dict(verbose=False, run=run, eval_every_rounds=5, best=best)
    if segments is None:
        state = module._train_frames(cfg, state, num_frames,
                                     cfg.LEARNING_RATE, **kw)
        return script, run, state
    seconds = []
    while True:
        restore = tc.segment_guard(module, seconds, [], 5, None, segments)
        real = module.train_round

        def counted(*a, _real=real, **k):
            out = _real(*a, **k)
            seconds.append(1.0)
            return out
        module.train_round = counted
        try:
            left = num_frames - int(state.frames)
            state = module._train_frames(cfg, state, left,
                                         cfg.LEARNING_RATE, **kw)
            return script, run, state
        except tc.SegmentEnd:
            pass
        finally:
            module.train_round = real
            restore()


@pytest.mark.parametrize("budgets", [(1.0e5, 2.0e5), (2.0e5, 1.05e5),
                                     (3.05e5, 1.0e5)])
def test_train_frames_of_both_packages_match_across_both_stages(
        monkeypatch, budgets):
    """Stage 1, then stage 2 with the selection carried: the rounds run,
    the log points, the evaluation points (each block's, and the final
    one where the last round did not evaluate) and the selection; and the
    port's stages cut after every block and resumed give the same."""
    sides = {}
    for name, port, segments in (("jax", False, None), ("port", True, None),
                                 ("cut", True, 1)):
        best, run, out = {}, Run(), []
        offset = 0
        for frames in budgets:
            script, run, state = _drive(monkeypatch, port, frames, best,
                                        offset, run, segments)
            out.append((len(script.rounds), script.evals, int(state.frames)))
            offset += len(script.rounds)
        sides[name] = dict(stages=out, rows=run.rows, best=(
            best["frames"], tuple(best["score"]), _tag(best["params"], port)))
    assert sides["port"] == sides["jax"] == sides["cut"]
    (n1, evals1, frames1), (n2, evals2, _) = sides["jax"]["stages"]
    assert n1 >= 5 and n2 >= 4 and frames1 >= budgets[0]
    assert [e[1] for e in evals1 + evals2] == [2048] * (len(evals1)
                                                       + len(evals2))
    logged = [step for step, values in sides["jax"]["rows"]
              if "avg_return" in values]
    assert len(logged) >= 2


# --- the scripts' records and the comparison --------------------------------

def test_records_keep_apart_and_resume(tmp_path):
    """The 4e5-frame stage-1 records, the Rainbow stages, the DDPG stages
    and the reference's evaluation in one file: each reader takes its
    own."""
    out = str(tmp_path / "curve.jsonl")
    pr9 = {"seed": 1, "frames_budget": 4e5}
    recs = [pr9, {"trainer": "rainbow", "stage": 1, "seed": 2,
                  "frames_budget": 1e6},
            {"trainer": "ddpg", "stage": 1, "seed": 1, "frames_budget": 1e6},
            {"trainer": "ddpg", "stage": 2, "seed": 1, "frames_budget": 1e6},
            {"trainer": "ddpg", "stage": 1, "seed": 3, "frames_budget": 3e4},
            {"trainer": "reference", "network": tc.DDPG_REFERENCE,
             "final": {"crash": 0.0}}]
    for rec in recs:
        tc.append_record(out, rec)
    assert tc.read_records(out) == {1: pr9}
    assert tc.pending([0, 1], out, 4e5) == [0]
    assert sorted(tc.read_stages(tc._lines(out), "ddpg")) == [(1, 1), (1, 2),
                                                              (3, 1)]
    assert sorted(tc.read_stages(tc._lines(out))) == [(2, 1)]
    assert tc.pending_stage([0, 1, 2, 3], out, 1e6, 1, "ddpg") == [0, 2, 3]
    assert tc.pending_stage([0, 1, 2, 3], out, 1e6, 2, "ddpg") == [0, 2, 3]
    assert tc.pending_stage([3], out, 3e4, 1, "ddpg") == []
    assert tc.reference_record(out)["final"] == {"crash": 0.0}
    with pytest.raises(FileNotFoundError, match="--stage 1 first"):
        tc.snapshot_path(str(tmp_path), 0, check=True)
    with pytest.raises(RuntimeError, match="card"):
        tc.main(["--run", "--trainer", "ddpg", "--stage", "2",
                 "--handoffs", str(tmp_path), "--out", out])


def test_the_reference_network_is_evaluated_once_beside_the_seeds(
        tmp_path, monkeypatch):
    """``ddpg_default1_extended`` (the committed weights) over the final
    evaluation's episodes at the config's own seed, one record."""
    from rl_mpc_lanemerging_torch import tasks
    _short_evaluations(monkeypatch, tasks)
    out = str(tmp_path / "curve.jsonl")
    assert tc.reference_record(out) is None
    rec = tc.evaluate_reference(out, episodes=4, batch=4, device="cpu",
                                overrides=OVERRIDES)
    assert rec["trainer"] == "reference" and rec["seed"] == 0
    assert rec["final"]["episodes"] == 4 and "card" not in rec
    assert tc.reference_record(out) == json.loads(json.dumps(rec))
    assert tc.read_records(out) == {} and tc.read_stages(
        tc._lines(out), "ddpg") == {}


def test_stage2_runs_evaluate_the_reference_in_the_spawning_run_alone(
        tmp_path, monkeypatch):
    """``--run --trainer ddpg --stage 2`` evaluates the reference once: in
    the run that spawns the seeds, or runs the one seed left, and never in
    a spawned seed (``--concurrent`` > 1), which starts before the record
    is written."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tc, "card_line", lambda: "GPU, 700.00 W")
    monkeypatch.setattr(tc, "evaluate_reference",
                        lambda out: calls.append("reference"))
    monkeypatch.setattr(tc, "run_one", lambda seed, *a, **kw:
                        calls.append(f"seed {seed}"))

    def spawn(seeds, frames, out, extra, log, meanwhile):
        meanwhile()
        calls.append(f"spawned {seeds}")
    monkeypatch.setattr(tc, "spawn", spawn)
    handoffs = str(tmp_path / "handoffs")
    for seed in range(4):
        tc.save_selection(tc.snapshot_path(handoffs, seed), {}, {})
    out = str(tmp_path / "curve.jsonl")
    args = dict(stage=2, eval_episodes=8, handoffs=handoffs, deadline=None,
                blocks=None, resume_from=None)
    tc.run([0, 1, 2, 3], 1e6, out, 1, ddpg_args=args)
    assert calls == ["reference", "spawned [0, 1, 2, 3]"]
    calls.clear()
    tc.run([2], 1e6, out, 4, ddpg_args=args)           # a spawned seed
    assert calls == ["seed 2"]
    calls.clear()
    tc.run([3], 1e6, out, 1, ddpg_args=args)           # the one seed left
    assert calls == ["reference", "seed 3"]


def test_jax_script_records_both_stages_once(tmp_path, monkeypatch):
    from rl_mpc_lanemerging_tpu import tasks
    _short_evaluations(monkeypatch, tasks)
    out = str(tmp_path / "ddpg.json")
    argv = ["--trainer", "ddpg", "--stage", "both", "--seeds", "0",
            "--frames", "1", "--out", out]
    sizes = dict(SIZES, eval_every=1)
    data = jc.main(argv, **sizes)
    assert [(r["seed"], r["stage"]) for r in data["records"]] == [(0, 1),
                                                                  (0, 2)]
    r1, r2 = data["records"]
    assert r1["trainer"] == r2["trainer"] == "ddpg"
    assert r1["platform"] == "cpu" and r1["config"] == tc.CONFIG
    assert r2["lr"] == pytest.approx(r1["lr"] / 10.0, rel=1e-15)
    assert r2["final"]["episodes"] == 4 and "final" not in r1
    assert r2["selected"]["score"] <= r1["selected"]["score"]
    assert len(r1["evals"]) == r1["rounds"] == len(r1["s_per_eval"])
    json.dumps(data, allow_nan=False)
    monkeypatch.setattr(jc, "run_ddpg", lambda *a, **kw: pytest.fail(
        "a recorded seed ran again"))
    assert jc.main(argv, **sizes) == json.loads(open(out).read())


def _stage(seed, stage, score, final=None, **extra):
    evals = [(102_071, 1.0, 0.0), (960_793, 0.0, 1.0)] if stage == 1 \
        else [(192_525, 0.0, 1.0), (600_560, 0.001, 0.999)]
    rec = {"trainer": "ddpg", "stage": stage, "seed": seed,
           "config": tc.CONFIG, "batch": 128, "frames_budget": 1e6,
           "frames": 1_004_403, "episodes": 9000,
           "lr": 2e-4 if stage == 1 else 2e-5, "rounds": 55,
           "s_per_round": [48.0] * 55, "s_per_round_median": 48.0,
           "frames_per_round": [18262] * 55, "eval_every_rounds": 5,
           "eval_episodes": 2048, "s_per_eval": [80.0] * 11,
           "evals": [{"frames": f, "crash": c, "merge": m, "jerk": 0.3,
                      "t_merge": 28.0} for f, c, m in evals],
           "progress": [],
           "selected": {"stage": stage, "frames": evals[-1][0],
                        "score": [score, 0.0, 0.3]}, **extra}
    if final is not None:
        crash, merge = final
        rec["final"] = {"episodes": 1024, "crash": crash, "crash_sem": 0.001,
                        "merge": merge, "merge_sem": 0.001, "jerk": 0.3,
                        "jerk_sem": 0.002, "t_merge": 28.0,
                        "t_merge_sem": 0.1}
    return rec


def _side(finals, scores, **extra):
    return [r for seed, ((c, m), s) in enumerate(zip(finals, scores))
            for r in (_stage(seed, 1, s + 0.01, **extra),
                      _stage(seed, 2, s, (c, m), **extra))]


def test_compare_ddpg_decides_and_writes_its_section_alone(tmp_path):
    """Four seeds a side: a port that learns as JAX agrees; one that never
    merges differs.  The earlier sections stay as they were."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "concurrent_seeds": 4,
            "k1_launches": 0, "segments": [
                {"rounds_to": 45, "frames": 801_000},
                {"rounds_to": 55, "frames": 1_004_403}]}
    jax = _side([(0.0, 1.0), (0.002, 0.998), (0.0, 1.0), (0.001, 0.999)],
                [0.062, 0.066, 0.061, 0.064], cpu_count=2)
    port = _side([(0.001, 0.999), (0.0, 1.0), (0.0, 1.0), (0.003, 0.997)],
                 [0.063, 0.061, 0.065, 0.066], **card)
    reference = {"trainer": "reference", "network": tc.DDPG_REFERENCE,
                 "seed": 0, "final": {
                     "episodes": 1024, "crash": 0.0, "crash_sem": 0.0,
                     "merge": 1.0, "merge_sem": 0.0, "jerk": 0.3,
                     "jerk_sem": 0.001, "t_merge": 30.0,
                     "t_merge_sem": 0.1}, "card": card["card"]}
    out = tmp_path / "curve.jsonl"
    pr9 = json.dumps({"seed": 0, "frames_budget": 4e5}) + "\n"
    out.write_text(pr9 + "".join(json.dumps(r) + "\n"
                                 for r in port + [reference]))
    yard = tmp_path / "ddpg.json"
    yard.write_text(json.dumps({"records": jax}))
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    head = ("# Acceptance\n\nthe table\n\n## DDPG learning curve\n\nthe DDPG "
            "section\n\n## Rainbow learning curve\n\nthe Rainbow section\n")
    acc.write_text(head)
    assert tc.main(["--compare", "--trainer", "ddpg", "--stage", "both",
                    "--out", str(out), "--yardsticks", str(yard),
                    "--acceptance", str(acc)]) is None
    text = acc.read_text()
    assert text.startswith(head + "\n" + pt.DDPG_SECTION + "\n")
    assert "**Verdict: the port's two-stage DDPG curve agrees with the " \
           "JAX package's.**" in text
    ref = 0.01 * 0.3 + 0.002 * 30.0
    assert f"scores {ref:.4f} over 1024 episodes" in text
    assert "| seeds no worse than ddpg_default1_extended | 4 of 4 | 4 of 4 " \
           "| 0 | at most 1 | yes |" in text
    assert "| 45 rounds, 801,000 frames; 55 rounds, 1,004,403 frames" in text
    assert "| NVIDIA H100 80GB HBM3, 700.00 W, 4 seeds at once |" in text
    # the JAX package's rows of this network and its TPU logs, for context
    for line in (28, 140, 227):
        assert f"\n| {line} | 4000 | " in text
    assert "| 2, C | " in text and "| 1, A | " in text
    never = _side([(0.0, 0.0)] * 4, [0.2] * 4, **card)
    out.write_text(pr9 + "".join(json.dumps(r) + "\n"
                                 for r in never + [reference]))
    assert tc.compare_ddpg(str(out), str(yard), str(acc)) == "differs"
    new = acc.read_text()
    assert new.startswith(head) and new.count(pt.DDPG_SECTION) == 1
    assert pt._kept_sections(str(acc)) == new[new.index("## DDPG"):]
    # the older sections are rewritten in place, this one kept
    pt.put_section(str(acc), pt.CURVE_SECTION,
                   pt.CURVE_SECTION + "\n\nnew DDPG section\n")
    again = acc.read_text()
    assert "the DDPG section" not in again
    assert again.endswith(new[new.index(pt.DDPG_SECTION):])


def test_compare_ddpg_holds_stage1_alone_until_stage2_runs(tmp_path):
    """With stage 1 alone on the port's side the section holds stage 1's
    selection and first reach to the JAX seeds' stage 1; a port whose
    stage 1 never learns differs."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "concurrent_seeds": 4,
            "segments": [{"rounds_to": 25, "frames": 401_000},
                         {"rounds_to": 55, "frames": 1_004_403}]}
    jax = _side([(0.0, 1.0)] * 4, [0.062, 0.066, 0.061, 0.064], cpu_count=2)
    port = [r for r in _side([(0.0, 1.0)] * 4, [0.063, 0.061, 0.065, 0.066],
                             **card) if r["stage"] == 1]
    out, yard = tmp_path / "curve.jsonl", tmp_path / "ddpg.json"
    out.write_text("".join(json.dumps(r) + "\n" for r in port))
    yard.write_text(json.dumps({"records": jax}))
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    assert tc.compare_ddpg(str(out), str(yard), str(acc)) == "agrees"
    text = acc.read_text()
    assert text.startswith(pt.DDPG_SECTION + "\n") and "**Stage 1 only**" \
        in text
    assert "| seeds that reach crash <= 0.005, merge >= 0.995 | 4 of 4 | " \
           "4 of 4 | 0 | at most 1 | yes |" in text
    assert "| 25 rounds, 401,000 frames; 55 rounds, 1,004,403 frames |" \
        in text
    never = [dict(r, evals=[dict(e, crash=1.0, merge=0.0)
                            for e in r["evals"]],
                  selected=dict(r["selected"], score=[1.0, 1.0, 0.6]))
             for r in port]
    out.write_text("".join(json.dumps(r) + "\n" for r in never))
    assert tc.compare_ddpg(str(out), str(yard), str(acc)) == "differs"
    assert acc.read_text().count(pt.DDPG_SECTION) == 1


def test_the_earlier_curve_sections_are_regenerated_byte_for_byte(tmp_path):
    """The "DDPG learning curve" (stage 1 to 4e5 frames) and "Rainbow
    learning curve" sections, from the records beside the two-stage DDPG
    ones, equal the committed sections."""
    committed = open(os.path.join(REPO, "ACCEPTANCE_TORCH.md")).read()
    for heading, compare, yardsticks in (
            (pt.CURVE_SECTION, tc.compare, tc.YARDSTICKS),
            (pt.RAINBOW_SECTION, tc.compare_rainbow, tc.RAINBOW_YARDSTICKS)):
        acc = str(tmp_path / f"{compare.__name__}.md")
        compare(tc.OUT, yardsticks, acc)
        start = committed.index(heading + "\n")
        end = committed.find("\n## ", start + len(heading))
        want = committed[start:] if end < 0 else committed[start:end]
        assert open(acc).read() == want


# SHA-256 of the section "DDPG learning curve, 1e6 + 1e6 frames" as the
# stage-1 records alone write it (its text before stage 2 ran on the card)
STAGE1_SECTION_SHA256 = \
    "504ff51083c3003561aa882cb6a8f7c131f4f926a878f4e4a17e7288f406cfcc"


def test_the_stage1_section_is_regenerated_byte_for_byte(tmp_path):
    """The stage-1 records alone (the stage-2 and reference records left
    out) write the stage-1 section as it stood before stage 2 ran."""
    import hashlib
    stage1 = str(tmp_path / "stage1.jsonl")
    with open(stage1, "w") as fh:
        for line in open(tc.OUT):
            r = json.loads(line)
            if r.get("stage") != 2 and r.get("trainer") != "reference":
                fh.write(line)
    acc = str(tmp_path / "acceptance.md")
    assert tc.compare_ddpg(stage1, tc.DDPG_YARDSTICKS, acc) == "agrees"
    text = open(acc).read()
    assert text.startswith(pt.DDPG_SECTION + "\n")
    assert hashlib.sha256(text.encode()).hexdigest() == STAGE1_SECTION_SHA256
