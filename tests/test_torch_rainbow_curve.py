"""Rainbow's stage schedule and its learning-curve scripts on the CPU.

``rainbow._train_frames`` of the port and of the JAX package, each driven
with ``train_round`` and ``_eval_greedy`` replaced by the same scripted
stubs: the epsilon of each round, the target-network refreshes, the
evaluations, the logged rows and the selected snapshot must be equal.
Then both ``rainbow.train`` with ``_train_frames`` recorded (the two
stages' frames, lr, epsilon, evaluation cadence, the selection carried
into stage 2 and stage 2's start), and the card script's two stages
(``scripts/train_curve_torch.py --trainer rainbow``) against the port's
``train``.  Then the scripts at a tiny size: the (seed, stage) records
and resuming past them, stage 2 refusing without its snapshot, the
snapshot's round trip, ``--compare --trainer rainbow`` (four seeds a
side, and eight with the port's selections under JAX's evaluator), the
JAX package's logged runs, and a port selection in the JAX network."""

import importlib.util
import inspect
import json
import math
import os
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.agents import rainbow as prb
from rl_mpc_lanemerging_torch.agents.ddpg import derive_seed
from rl_mpc_lanemerging_torch.config import Settings as PortSettings
from rl_mpc_lanemerging_tpu.agents import rainbow as jrb
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

CONFIG = os.path.join(REPO, "configs", "train_dqn_default_1.json")
BATCH = 128
# (valid frames, episodes ended) of each scripted round: 500-episode
# target buckets are crossed after some rounds and not others
ROUNDS = [(9919, 88), (11346, 1417), (10203, 1290), (4000, 30),
          (10977, 1370), (9800, 470), (10500, 1333), (10800, 1010),
          (10100, 1250), (11000, 1388), (10400, 5), (10650, 1301),
          (9950, 1240), (10300, 1260), (10700, 1290), (10020, 1322),
          (10900, 1290), (10001, 1271), (11111, 1305), (10432, 1288),
          (10888, 1299), (10200, 1267), (10600, 1300), (10300, 1280)]
# (crash, merge, |jerk|, time to merge) of each scripted evaluation: no
# merge (a NaN time to merge), an improvement, then a tie with it, which
# must not displace it
EVALS = [(1.0, 0.0, 0.58, math.nan), (0.2256, 0.748, 0.473, 29.26),
         (0.2256, 0.748, 0.473, 29.26)]


def _settings(kind):
    return kind.load_from_file(CONFIG).replace(BATCH_SCENARIOS=BATCH)


class JaxState(NamedTuple):
    env: object
    params: object
    target_params: object
    frames: int
    episodes: int


class Net:
    """A stand-in for the port's net: its ``state_dict`` is its tag, the
    round after which it was last updated (-1 at the start)."""

    def __init__(self, tag=-1):
        self.tag = tag

    def state_dict(self):
        return {"tag": torch.tensor(self.tag)}

    def load_state_dict(self, d):
        self.tag = int(d["tag"])


class Script:
    """The scripted rounds and evaluations of one side, and what the
    trainer handed them."""

    def __init__(self, port: bool):
        self.port, self.rounds, self.evals = port, [], []

    def tag(self, params):
        """The tag of a JAX parameter token, a port net or its snapshot."""
        if not self.port:
            return params
        return int(params["tag"]) if isinstance(params, dict) \
            else params.tag

    def train_round(self, state, cfg, *a, env_ticks, grad_steps, epsilon,
                    **kw):
        r = len(self.rounds)
        target = state.target_net.tag if self.port else state.target_params
        self.rounds.append((epsilon, env_ticks, grad_steps, target))
        df, de = ROUNDS[r]
        if self.port:
            state.net.tag = r
            state.frames, state.episodes = state.frames + df, \
                state.episodes + de
            return state
        return state._replace(params=r, frames=state.frames + df,
                              episodes=state.episodes + de)

    def eval_greedy(self, cfg, params, num_episodes=512):
        self.evals.append((self.tag(params), num_episodes,
                           cfg.TICK_LENGTH))
        return EVALS[(len(self.evals) - 1) % len(EVALS)]


class Run:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, values):
        self.rows.append((step, dict(values)))


def _port_state():
    obs = torch.zeros(BATCH, 1)
    return SimpleNamespace(env=SimpleNamespace(obs=obs), net=Net(),
                           target_net=Net(), frames=0, episodes=0)


def _jax_state():
    return JaxState(env=SimpleNamespace(obs=np.zeros((BATCH, 1))), params=-1,
                    target_params=-1, frames=0, episodes=0)


def _drive(module, port, monkeypatch, capsys, num_frames, **kw):
    script = Script(port)
    monkeypatch.setattr(module, "train_round", script.train_round)
    monkeypatch.setattr(module, "_eval_greedy", script.eval_greedy)
    cfg = _settings(PortSettings if port else JaxSettings)
    run, best = Run(), {}
    state = module._train_frames(cfg, _port_state() if port else
                                 _jax_state(), num_frames,
                                 cfg.LEARNING_RATE, verbose=True, run=run,
                                 best=best, **kw)
    target = state.target_net.tag if port else state.target_params
    return dict(script=script, rows=run.rows, out=capsys.readouterr().out,
                final_target=target, frames=int(state.frames),
                best=(best.get("frames"), best.get("score"),
                      script.tag(best["params"]) if best else None))


# 1e5 frames: the 10th round evaluates, the last (11th) does not; 2e5:
# the 20th round is the last and evaluates; 2.1e5: the 10th and 20th
# evaluate, and the last (21st) does not
@pytest.mark.parametrize("num_frames", [1e5, 2e5, 2.1e5])
@pytest.mark.parametrize("eval_every_rounds", [10, 0])
@pytest.mark.parametrize("eps_start", [1.0, jrb.EPS_END])
def test_train_frames_schedule_matches_jax(monkeypatch, capsys, eps_start,
                                           eval_every_rounds, num_frames):
    kw = dict(eps_start=eps_start, eval_every_rounds=eval_every_rounds)
    jax = _drive(jrb, False, monkeypatch, capsys, num_frames, **kw)
    port = _drive(prb, True, monkeypatch, capsys, num_frames, **kw)
    jr, pr = jax["script"].rounds, port["script"].rounds
    assert len(pr) == len(jr) and len(jr) in (11, 20, 21)
    # the epsilon handed to each round
    np.testing.assert_allclose([r[0] for r in pr], [r[0] for r in jr],
                               rtol=0, atol=1e-12)
    assert [r[0] for r in jr][0] == eps_start
    assert [r[1:3] for r in pr] == [r[1:3] for r in jr]
    # the target net each round starts from: the rounds after which it was
    # refreshed (every 500 episodes)
    assert [r[3] for r in pr] == [r[3] for r in jr]
    assert port["final_target"] == jax["final_target"]
    refreshed = sorted({r[3] for r in jr} - {-1})
    assert 3 <= len(refreshed) < len(jr) - 1
    # the rounds that evaluate, with the final evaluation when the last
    # round did not
    assert port["script"].evals == [
        (tag, 1024, tick) for tag, _, tick in jax["script"].evals]
    evaluated = [e[0] for e in jax["script"].evals]
    if eval_every_rounds == 0:
        assert evaluated == []
    else:
        assert evaluated == {11: [9, 10], 20: [9, 19],
                             21: [9, 19, 20]}[len(jr)]
    # the progress and evaluation rows, the lines printed, the selection
    assert port["rows"] == jax["rows"] and len(jax["rows"]) >= 2
    assert port["out"] == jax["out"]
    assert port["best"] == jax["best"] and port["frames"] == jax["frames"]
    if eval_every_rounds:      # the second evaluation's, not its tie
        assert jax["best"][2] == evaluated[1]


# --- the two stages of ``train`` --------------------------------------------

TRAIN_FRAMES = {prb: prb._train_frames, jrb: jrb._train_frames}


def _selection(stage2_improves):
    """The (score, frames) that each stage's recorded ``_train_frames``
    offers the selection."""
    return {1: ((0.3, 0.1, 0.2), 96_000),
            2: ((0.2, 0.05, 0.1) if stage2_improves else (0.4, 0.2, 0.3),
                51_000)}


def _real_params(seed):
    return {k: v.clone() for k, v in prb._net(
        _settings(PortSettings), torch.Generator().manual_seed(seed)
    ).state_dict().items()}


class Stages:
    """Records ``make_train_state`` and ``_train_frames`` of one side."""

    def __init__(self, module, port, stage2_improves):
        self.module, self.port = module, port
        self.selection = _selection(stage2_improves)
        self.made, self.trained = [], []
        self.call_round = False

    def make_train_state(self, cfg, worlds, rng, *a, lr=None,
                         init_params=None, **kw):
        stage = len(self.made) + 1
        self.made.append(dict(log_dir=cfg.LOG_DIR, lr=lr, init=init_params,
                              seed=a[0] if self.port else None))
        params = _real_params(stage) if self.port else f"stage{stage}"
        if self.port:
            net = prb._net(cfg)
            net.load_state_dict(params)
            return SimpleNamespace(net=net, frames=torch.tensor(0),
                                   episodes=torch.tensor(0))
        return SimpleNamespace(params=params)

    def train_frames(self, *a, **kw):
        bound = inspect.signature(self.real).bind(*a, **kw)
        bound.apply_defaults()
        args = dict(bound.arguments)
        stage = len(self.trained) + 1
        state, best = args["state"], args["best"]
        self.trained.append(dict(
            log_dir=args["cfg"].LOG_DIR, num_frames=args["num_frames"],
            lr=args["lr"], eps_start=args["eps_start"],
            eval_every_rounds=args["eval_every_rounds"],
            eval_episodes=args.get("eval_episodes", 1024), best=best,
            carried=dict(best)))
        score, frames = self.selection[stage]
        if best.get("score") is None or score < best["score"]:
            params = prb._snapshot(state.net) if self.port else state.params
            best.update(score=score, frames=frames, params=params)
        if self.call_round:         # the card script times its rounds
            self.module.train_round(state, args["cfg"])
        return state

    def install(self, monkeypatch):
        self.real = TRAIN_FRAMES[self.module]
        monkeypatch.setattr(self.module, "make_train_state",
                            self.make_train_state)
        monkeypatch.setattr(self.module, "_train_frames", self.train_frames)


def _train_jax(monkeypatch, tmp_path, stage2_improves):
    from rl_mpc_lanemerging_tpu import checkpoint, rundir, tasks
    rec = Stages(jrb, False, stage2_improves)
    rec.install(monkeypatch)
    saved, evaluated = [], []
    monkeypatch.setattr(rundir, "setup_run_dir", lambda cfg, **kw:
                        SimpleNamespace(path=str(tmp_path / cfg.LOG_DIR)))
    monkeypatch.setattr(tasks, "make_worlds", lambda cfg: "worlds")
    monkeypatch.setattr(checkpoint, "save_params", lambda path, tree:
                        saved.append((os.path.basename(path),
                                      tree["q_dist"])))
    monkeypatch.setattr(jrb, "evaluate", lambda cfg, params=None, **kw:
                        evaluated.append(params))
    jrb.train(_settings(JaxSettings), num_frames=1e6, verbose=False)
    return rec, saved, evaluated


def _train_port(monkeypatch, tmp_path, stage2_improves):
    from rl_mpc_lanemerging_torch import rundir, tasks
    rec = Stages(prb, True, stage2_improves)
    rec.install(monkeypatch)
    saved, evaluated = [], []
    monkeypatch.setattr(rundir, "setup_run_dir", lambda cfg, **kw:
                        SimpleNamespace(path=str(tmp_path / cfg.LOG_DIR)))
    monkeypatch.setattr(tasks, "make_worlds", lambda cfg, device: (
        "worlds", "rng"))
    monkeypatch.setattr(prb, "save_params", lambda path, tree: saved.append(
        (os.path.basename(path), tree["q_dist"])))
    monkeypatch.setattr(prb, "evaluate", lambda cfg, net=None, **kw:
                        evaluated.append(net.state_dict()))
    prb.train(_settings(PortSettings), num_frames=1e6, verbose=False,
              device="cpu")
    return rec, saved, evaluated


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _stage_calls(rec):
    return [{k: v for k, v in t.items() if k not in ("best", "carried")}
            for t in rec.trained]


@pytest.mark.parametrize("stage2_improves", [True, False])
def test_train_runs_the_stages_as_jax(monkeypatch, tmp_path,
                                      stage2_improves):
    jax, jsaved, jeval = _train_jax(monkeypatch, tmp_path, stage2_improves)
    port, psaved, peval = _train_port(monkeypatch, tmp_path,
                                      stage2_improves)
    # frames, lr, epsilon and evaluation cadence of each stage
    assert _stage_calls(port) == _stage_calls(jax)
    cfg = _settings(PortSettings)
    assert [t["lr"] for t in port.trained] == [cfg.LEARNING_RATE,
                                               cfg.LEARNING_RATE / 10.0]
    assert [t["eps_start"] for t in port.trained] == [1.0, prb.EPS_END]
    assert [t["log_dir"] for t in port.trained] == [
        "rainbow_default1", "rainbow_default1_extended"]
    # the selection carries from stage 1 into stage 2
    for rec in (jax, port):
        assert rec.trained[0]["best"] is rec.trained[1]["best"]
        assert rec.trained[0]["carried"] == {}
        assert rec.trained[1]["carried"]["score"] == (0.3, 0.1, 0.2)
        assert rec.trained[1]["carried"]["frames"] == 96_000
    # stage 2 starts from stage 1's selected snapshot, at the derived seed
    assert [m["lr"] for m in port.made] == [m["lr"] for m in jax.made]
    assert jax.made[0]["init"] is None and port.made[0]["init"] is None
    assert jax.made[1]["init"] == "stage1"
    assert _same(port.made[1]["init"], _real_params(1))
    assert [m["seed"] for m in port.made] == [0, derive_seed(0)]
    # each stage saves its selection; the evaluation takes the final one
    final = 2 if stage2_improves else 1
    assert [(d, p) for d, p in jsaved] == [("rainbow_default1", "stage1"),
                                          ("rainbow_default1_extended",
                                           f"stage{final}")]
    assert [d for d, _ in psaved] == [d for d, _ in jsaved]
    assert jeval == [f"stage{final}"]
    assert _same(peval[0], _real_params(final))


@pytest.mark.parametrize("stage2_improves", [True, False])
def test_the_card_script_runs_the_stages_as_train(monkeypatch, tmp_path,
                                                  stage2_improves):
    """``run_rainbow_stage`` 1 then 2 (through the snapshot file) makes the
    calls that the port's ``train`` makes."""
    from rl_mpc_lanemerging_torch import tasks
    train, _, tevaluated = _train_port(monkeypatch, tmp_path,
                                       stage2_improves)
    script = Stages(prb, True, stage2_improves)
    script.install(monkeypatch)
    script.call_round = True
    rounds = []
    monkeypatch.setattr(prb, "train_round", lambda state, cfg: rounds.append(
        cfg.LOG_DIR) or state)
    evaluated = []

    class Agg:
        def get_stat_averages(self, report_stds=False):
            avg = {"crashed": 0.01, "merged": 0.98, "mean_abs_jerk": 0.12,
                   "time_to_merge": 33.0}
            return avg, {k: 0.001 for k in avg}

    monkeypatch.setattr(prb, "greedy_controller", lambda net, cfg: net)
    monkeypatch.setattr(tasks, "evaluate_controller", lambda cfg, net, **kw:
                        evaluated.append((net.state_dict(), kw,
                                          cfg.TICK_LENGTH)) or Agg())
    snaps = str(tmp_path / "snapshots")
    recs = [tc.run_rainbow_stage(0, 1e6, stage, snapshots=snaps,
                                 device="cpu") for stage in (1, 2)]
    assert _stage_calls(script) == _stage_calls(train)
    assert [m["lr"] for m in script.made] == [m["lr"] for m in train.made]
    assert [m["seed"] for m in script.made] == [m["seed"]
                                                for m in train.made]
    assert script.made[0]["init"] is None
    assert _same(script.made[1]["init"], train.made[1]["init"])
    assert script.trained[1]["carried"]["score"] == \
        train.trained[1]["carried"]["score"]
    assert script.trained[1]["carried"]["frames"] == \
        train.trained[1]["carried"]["frames"]
    assert _same(evaluated[0][0], tevaluated[0])
    cfg = _settings(PortSettings)
    assert evaluated[0][1]["num_episodes"] == 1024
    assert evaluated[0][2] == cfg.TICK_LENGTH
    assert rounds == ["rainbow_default1", "rainbow_default1_extended"]
    assert [r["stage"] for r in recs] == [1, 2]
    assert [r["lr"] for r in recs] == [cfg.LEARNING_RATE,
                                       cfg.LEARNING_RATE / 10.0]
    assert recs[1]["selected"]["stage"] == (2 if stage2_improves else 1)
    assert recs[0]["k1_launches"] == 0 and "final" not in recs[0]
    assert recs[1]["final"]["merge"] == 0.98


# --- the scripts at a tiny size ---------------------------------------------

SIZES = dict(batch=4, eval_every=1,
             overrides=dict(MAX_CARS=16, MAX_SENSED_CARS=8,
                            EVALUATION_EPISODE_LENGTH=6.0))
FRAMES = 1                   # one round a stage
RECORD_KEYS = {"trainer", "stage", "seed", "config", "batch",
               "frames_budget", "frames", "episodes", "lr", "eps_start",
               "rounds", "s_per_round", "s_per_round_median",
               "frames_per_round", "eval_every_rounds", "eval_episodes",
               "s_per_eval", "evals", "progress", "selected", "train_s",
               "wall_s"}


def _short_evaluations(monkeypatch, tasks):
    """Evaluations of at most 8 episodes, 10 s of warmup, 6 s episodes."""
    real = tasks.evaluate_controller

    def evaluate(*a, **kw):
        kw["num_episodes"] = min(kw.get("num_episodes") or 8, 8)
        return real(*a, **{**kw, "max_episode_length": 6.0,
                           "wait_before_start": 10.0})
    monkeypatch.setattr(tasks, "evaluate_controller", evaluate)


def _check(rec, stage):
    assert RECORD_KEYS <= set(rec)
    assert rec["trainer"] == "rainbow" and rec["stage"] == stage
    assert rec["frames"] >= FRAMES and rec["batch"] == 4
    assert len(rec["s_per_round"]) == len(rec["frames_per_round"]) \
        == rec["rounds"] == len(rec["evals"]) == len(rec["s_per_eval"])
    assert sum(rec["frames_per_round"]) == rec["frames"]
    assert rec["selected"]["frames"] is not None
    json.dumps(rec, allow_nan=False)


def test_port_script_records_each_stage_and_resumes(monkeypatch, tmp_path):
    from rl_mpc_lanemerging_torch import tasks
    _short_evaluations(monkeypatch, tasks)
    snaps = str(tmp_path / "snapshots")
    with pytest.raises(FileNotFoundError, match="stage 1's selected"):
        tc.run_rainbow_stage(1, FRAMES, 2, episodes=8, snapshots=snaps,
                             device="cpu", **SIZES)
    r1 = tc.run_rainbow_stage(1, FRAMES, 1, episodes=8, snapshots=snaps,
                              device="cpu", **SIZES)
    _check(r1, 1)
    assert r1["eps_start"] == 1.0 and "final" not in r1
    assert r1["k1_launches"] == 0
    assert os.path.exists(tc.snapshot_path(snaps, 1))
    r2 = tc.run_rainbow_stage(1, FRAMES, 2, episodes=8, snapshots=snaps,
                              device="cpu", **SIZES)
    _check(r2, 2)
    assert r2["eps_start"] == prb.EPS_END
    assert r2["lr"] == pytest.approx(r1["lr"] / 10.0, rel=1e-15)
    assert r2["final"]["episodes"] == 8
    # stage 2 selects no worse than stage 1's carried selection
    assert r2["selected"]["score"] <= r1["selected"]["score"]
    out = str(tmp_path / "curve.jsonl")
    ddpg = {"seed": 1, "frames_budget": 4e5}
    for rec in (ddpg, r1, r2, {**r1, "seed": 3, "frames_budget": 0.5}):
        tc.append_record(out, rec)
    # the DDPG records and the Rainbow records keep apart
    assert tc.read_records(out) == {1: ddpg}
    assert sorted(tc.read_stages(tc._lines(out))) == [(1, 1), (1, 2), (3, 1)]
    assert tc.pending_stage([0, 1, 2, 3], out, FRAMES, 1) == [0, 2, 3]
    assert tc.pending_stage([0, 1, 2, 3], out, FRAMES, 2) == [0, 2, 3]
    assert tc.pending_stage([3], out, 0.5, 1) == []
    assert tc.pending([0, 1], out, 4e5) == [0]


def test_stage1_snapshot_round_trip(tmp_path):
    """The snapshot crosses the file exactly, read back through
    ``convert.rainbow_from_numpy``, with its selection."""
    params = _real_params(5)
    path = tc.snapshot_path(str(tmp_path), 2)
    best = {"score": (0.1354, 0.0576, 0.1235), "frames": 960_793,
            "params": params}
    tc.save_stage1(path, params, best)
    init, carried = tc.load_stage1(path)
    assert _same(init, params)
    assert carried["score"] == best["score"]
    assert carried["frames"] == best["frames"]
    assert carried["params"] is init
    tc.save_stage1(path, params, {})
    assert tc.load_stage1(path)[1] == {}


def test_stage2_refuses_without_its_snapshot(tmp_path):
    with pytest.raises(FileNotFoundError, match="--stage 1 first"):
        tc.snapshot_path(str(tmp_path), 0, check=True)
    with pytest.raises(RuntimeError, match="card"):
        tc.main(["--run", "--trainer", "rainbow", "--stage", "2",
                 "--snapshots", str(tmp_path),
                 "--out", str(tmp_path / "curve.jsonl")])


def test_jax_script_records_both_stages_once(tmp_path, monkeypatch):
    from rl_mpc_lanemerging_tpu import tasks
    _short_evaluations(monkeypatch, tasks)
    out = str(tmp_path / "rainbow.json")
    argv = ["--trainer", "rainbow", "--seeds", "0", "--frames", "1",
            "--out", out]
    sizes = dict(SIZES, episodes=8)
    data = jc.main(argv, **sizes)
    assert [(r["seed"], r["stage"]) for r in data["records"]] == [(0, 1),
                                                                  (0, 2)]
    r1, r2 = data["records"]
    assert r1["platform"] == "cpu" and r1["config"] == tc.RAINBOW_CONFIG
    assert r1["eval_episodes"] == 1024 and r2["final"]["episodes"] == 8
    assert (r1["eps_start"], r2["eps_start"]) == (1.0, jrb.EPS_END)
    assert r2["selected"]["score"] <= r1["selected"]["score"]
    assert len(r1["evals"]) == r1["rounds"]
    json.dumps(data, allow_nan=False)
    monkeypatch.setattr(jc, "run_rainbow", lambda *a, **kw: pytest.fail(
        "a recorded seed ran again"))
    assert jc.main(argv, **sizes) == json.loads(open(out).read())


# --- the comparison ---------------------------------------------------------

def _stage(seed, stage, score, evals, final=None, **extra):
    rec = {"trainer": "rainbow", "stage": stage, "seed": seed,
           "config": tc.RAINBOW_CONFIG, "batch": 128,
           "frames_budget": 1e6, "frames": 1_004_403, "episodes": 9000,
           "lr": 2e-4 if stage == 1 else 2e-5,
           "eps_start": 1.0 if stage == 1 else 0.1, "rounds": 95,
           "s_per_round": [15.0] * 95, "s_per_round_median": 15.0,
           "frames_per_round": [10573] * 95, "eval_every_rounds": 10,
           "eval_episodes": 1024, "s_per_eval": [70.0] * 10,
           "evals": [{"frames": f, "crash": c, "merge": m, "jerk": 0.1,
                      "t_merge": 33.0} for f, c, m in evals],
           "progress": [],
           "selected": {"stage": stage, "frames": evals[-1][0],
                        "score": [score, 0.0, 0.1]}, **extra}
    if final is not None:
        crash, merge = final
        rec["final"] = {"episodes": 1024, "crash": crash, "crash_sem": 0.007,
                        "merge": merge, "merge_sem": 0.009, "jerk": 0.12,
                        "jerk_sem": 0.002, "t_merge": 34.0,
                        "t_merge_sem": 0.15}
    return rec


EVALS1 = [(112_071, 1.0, 0.0), (960_793, 0.2256, 0.748)]
EVALS2 = [(192_525, 0.0, 0.1396), (600_560, 0.0723, 0.876)]


def _side(finals, scores, **extra):
    return [r for seed, ((c, m), s) in enumerate(zip(finals, scores))
            for r in (_stage(seed, 1, s + 0.1, EVALS1, **extra),
                      _stage(seed, 2, s, EVALS2, (c, m), **extra))]


def test_compare_rainbow_writes_its_section_alone(tmp_path):
    """Four seeds a side: a port that learns as JAX agrees; one that never
    merges differs.  The table and the DDPG section stay as they were."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "concurrent_seeds": 4,
            "k1_launches": 0}
    jax = _side([(0.05, 0.90), (0.08, 0.88), (0.02, 0.60), (0.06, 0.91)],
                [0.13, 0.15, 0.16, 0.12], cpu_count=8)
    port = _side([(0.06, 0.89), (0.04, 0.92), (0.07, 0.85), (0.03, 0.70)],
                 [0.14, 0.12, 0.15, 0.17], **card)
    out = tmp_path / "curve.jsonl"
    ddpg_line = json.dumps({"seed": 0, "frames_budget": 4e5}) + "\n"
    out.write_text(ddpg_line + "".join(json.dumps(r) + "\n" for r in port))
    yard = tmp_path / "rainbow.json"
    yard.write_text(json.dumps({"records": jax}))
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    head = ("# Acceptance\n\nthe table\n\n## DDPG learning curve\n\nthe DDPG "
            "section\n")
    acc.write_text(head)
    assert tc.compare_rainbow(str(out), str(yard), str(acc)) == "agrees"
    text = acc.read_text()
    assert text.startswith(head + "\n## Rainbow learning curve\n")
    assert "**Verdict: the port's Rainbow curve agrees with the JAX " \
           "package's.**" in text
    ref = tc.reference_score()
    assert ref == pytest.approx(0.0576 + 0.2 * (1 - 0.9014 - 0.0576)
                                + 0.01 * 0.1235 + 0.002 * 34.1805, abs=2e-4)
    ps = tc.summarize_rainbow(tc.seeds_of(tc.read_stages(port)), ref)
    assert ps["n"] == 4 and ps["stage1_score"][0] == pytest.approx(0.245)
    assert "| NVIDIA H100 80GB HBM3, 700.00 W, 4 seeds at once |" in text
    assert "| port | 1 | 960793, 0.2200 | 2, 600560, 0.1200 |" in text
    assert "| stage 1 | 1.000 / 0.000 @ 112,071;" in text
    # the DQN row's network scores 0.1355; its final evaluation counts
    assert f"| seeds no worse than rainbow_default1_extended | " \
           f"{ps['no_worse']} of 4 |" in text
    # a rewrite replaces the section, and the table keeps both sections
    never = _side([(0.0, 0.0)] * 4, [0.2] * 4, **card)
    out.write_text(ddpg_line + "".join(json.dumps(r) + "\n" for r in never))
    assert tc.compare_rainbow(str(out), str(yard), str(acc)) == "differs"
    text = acc.read_text()
    assert text.startswith(head) and text.count("## Rainbow") == 1
    assert pt._kept_sections(str(acc)) == text[text.index("## DDPG"):]
    pt.put_section(str(acc), pt.CURVE_SECTION,
                   pt.CURVE_SECTION + "\n\nnew DDPG section\n")
    new = acc.read_text()
    assert "the DDPG section" not in new and new.endswith(
        text[text.index("## Rainbow"):])


def test_logged_rainbow_runs_are_read_from_the_jax_packages_scalars():
    """runs/rainbow_default1{,_extended}/scalars.csv: evaluation rows
    (step, crash, |jerk|, merge, time to merge)."""
    runs = tc.logged_rainbow()
    assert sorted(runs) == ["stage 1", "stage 2"]
    one, two = runs["stage 1"], runs["stage 2"]
    assert [e["frames"] for e in one][0] == 112_071 and len(one) == 8
    assert (one[0]["crash"], one[0]["merge"], one[0]["t_merge"]) == (
        1.0, 0.0, None)
    sel = {e["frames"]: e for e in one}[960_793]
    assert (sel["crash"], sel["merge"]) == (0.2255859375, 0.748046875)
    assert len(two) == 5 and two[2]["frames"] == 600_560
    assert two[2]["merge"] == 0.8759765625


# --- eight seeds a side, and the port's selections under JAX's evaluator ---

JAX8 = [(0.01, 0.97), (0.0, 0.99), (0.02, 0.95), (0.0, 1.0), (0.03, 0.94),
        (0.01, 0.96), (0.0, 0.98), (0.02, 0.93)]
# seed 2 merges 0.48 and seed 4 0.85: two weak seeds against none
PORT8 = [(0.0, 0.96), (0.04, 0.93), (0.0068, 0.48), (0.0, 1.0),
         (0.01, 0.85), (0.0, 0.97), (0.02, 0.95), (0.0, 0.99)]
SCORES8 = [0.09, 0.1, 0.08, 0.11, 0.09, 0.1, 0.12, 0.08]


def _selection_eval(crash, merge, jerk=0.1, t_merge=33.0, n=1024):
    e = {"episodes": n, "crash": crash, "crash_sem": 0.004, "merge": merge,
         "merge_sem": 0.01, "jerk": jerk, "jerk_sem": 0.002,
         "t_merge": t_merge, "t_merge_sem": 0.15}
    from rl_mpc_lanemerging_torch.agents.budget import snapshot_score
    e["score"] = list(snapshot_score(crash, merge, jerk, t_merge))
    return e


def test_the_eight_seed_rule_allows_two_of_eight_in_each_count():
    """Rules (b) and (c) at eight seeds a side: the counts of seeds no
    worse than the reference and of weak seeds may each differ by two;
    at four seeds, by one, as before."""
    side = {"crash": (0.01, 0.005), "merge": (0.9, 0.05),
            "jerk": (0.2, 0.02), "t_merge": (33.0, 1.0),
            "score": (0.1, 0.01), "stage1_score": (0.12, 0.01),
            "no_worse": 8, "weak": 0, "n": 8}
    for name, port_count, jax_count, hold in (
            ("no_worse", 6, 8, True), ("no_worse", 5, 8, False),
            ("weak", 2, 0, True), ("weak", 3, 0, False),
            ("weak", 0, 2, True)):
        rows, counts, allow, verdict = tc.decide_rainbow_seeds(
            {**side, name: port_count}, {**side, name: jax_count})
        assert allow == 2 and all(r[-1] for r in rows)
        assert counts[name] is hold
        assert verdict == ("agrees" if hold else "differs")
    four = {**side, "n": 4, "no_worse": 4}
    _, counts, allow, verdict = tc.decide_rainbow_seeds(
        {**four, "weak": 2}, {**four, "weak": 0})
    assert allow == 1 and not counts["weak"] and verdict == "differs"
    _, counts, _, verdict = tc.decide_rainbow_seeds(
        {**side, "merge": (0.5, 0.01)}, side)
    assert all(counts.values()) and verdict == "differs"


def test_compare_rainbow_decides_eight_seeds_and_the_port_selections(
        tmp_path):
    """``--compare --trainer rainbow`` over the seeds both sides have (a
    port seed with stage 1 alone left out): eight a side with two weak port
    seeds agree; a third weak seed differs by rule (c).  The JAX
    evaluations of the port's selections sit in the section, 7 of 8
    holding being enough."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "concurrent_seeds": 4,
            "k1_launches": 0}
    jax = _side(JAX8, SCORES8, cpu_count=2)
    port = _side(PORT8, SCORES8, **card) + [
        _stage(8, 1, 0.2, EVALS1, **card)]
    out = tmp_path / "curve.jsonl"
    out.write_text("".join(json.dumps(r) + "\n" for r in port))
    yard = tmp_path / "rainbow.json"
    yard.write_text(json.dumps({"records": jax}))
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    acc.write_text("# Acceptance\n")
    # the JAX evaluator's records of seeds 4-7: each as the port's own
    # evaluation of the same network, seed 5's stage-2 one far off
    sel = []
    for seed in (4, 5, 6, 7):
        for stage, (frames, crash, merge) in ((1, EVALS1[-1]),
                                              (2, EVALS2[-1])):
            off = 0.2 if (seed, stage) == (5, 2) else 0.0
            sel.append({"trainer": "rainbow", "seed": seed, "stage": stage,
                        "eval": _selection_eval(crash + off, merge - off)})
    selections = tmp_path / "jax_eval_port_rainbow.json"
    selections.write_text(json.dumps({"records": sel}))
    assert tc.compare_rainbow(str(out), str(yard), str(acc),
                              str(selections)) == "agrees"
    text = acc.read_text()
    assert "Seeds: port [0, 1, 2, 3, 4, 5, 6, 7], JAX [0, 1, 2, 3, 4, 5, 6, " \
        "7]." in text
    assert "| seeds whose final snapshot merges below 0.9 | 2 of 8 | 0 of 8 " \
        "| 2 | at most 2 | yes |" in text
    assert "| seeds no worse than rainbow_default1_extended | 7 of 8 | 8 of " \
        "8 | 1 | at most 2 | yes |" in text
    assert "### The port's selections under JAX's evaluator" in text
    assert "| 5 | 2 | 2, 600,560 | 0.0723 / 0.2723 (flagged) |" in text
    assert "**7 of 8 networks hold: JAX's evaluator scores the port's " \
        "networks as the port's does.**" in text
    weak3 = list(PORT8)
    weak3[5] = (0.0, 0.88)
    out.write_text("".join(json.dumps(r) + "\n"
                           for r in _side(weak3, SCORES8, **card)))
    assert tc.compare_rainbow(str(out), str(yard), str(acc),
                              str(tmp_path / "none.json")) == "differs"
    text = acc.read_text()
    assert "| seeds whose final snapshot merges below 0.9 | 3 of 8 | 0 of 8 " \
        "| 3 | at most 2 | no |" in text
    assert "under JAX's evaluator" not in text


def test_a_port_rainbow_selection_acts_in_the_jax_network(tmp_path):
    """A stage-2 selection file written by the card script, loaded by
    ``jax_eval_port_selections.rainbow_params`` into the JAX Rainbow
    network: on the same observations its distributions equal the port's,
    with no noise (the greedy evaluation's, same actions) and with the
    same NoisyNet noise."""
    import jax
    from _torch_parity import _noise_of
    je = _load("jax_eval_port_selections")
    cfg = _settings(PortSettings)
    net = prb._net(cfg, torch.Generator().manual_seed(11))
    with torch.no_grad():          # a trained net's spread, not the init's
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    path = tc.snapshot_path(str(tmp_path), 4, stage=2)
    tc.save_stage1(path, net.state_dict(), {"score": (0.09, 0.0, 0.1),
                                            "frames": 988_334})
    params = je.rainbow_params(path)
    jnet = jrb._net(_settings(JaxSettings))
    obs = np.random.default_rng(5).normal(size=(256, cfg.obs_dim)).astype(
        np.float32)
    z = np.linspace(jrb.V_MIN, jrb.V_MAX, jrb.NUM_ATOMS)

    def actions(logits):
        p = np.exp(logits - logits.max(-1, keepdims=True))
        return np.argmax((p / p.sum(-1, keepdims=True) * z).sum(-1), -1)

    key = jax.random.PRNGKey(7)
    for rng, noise in ((None, None), (key, _noise_of(key, net))):
        want = np.asarray(jnet.apply(params, obs, rng=rng))
        with torch.no_grad():
            got = net(torch.from_numpy(obs), noise).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (actions(got) == actions(want)).all()
    assert len(set(actions(want))) > 1
