"""The custom Double-DQN's stage at the reference's 150,000 episodes,
carried across runs by handoffs (``scripts/train_curve_torch.py --trainer
dqn``), on the CPU; the port's DDPG selections under JAX's evaluator; the
``custom_dqn`` row of the paper's table.

The stage's schedule (rounds, target refreshes, evaluation points, epsilon
and grad steps a round, the selection) equals the JAX ``dqn.train``'s over
a scripted episode-count sequence, uncut and cut into segments.  With real
rounds (B=4, 16 cars, short rounds, a ring that wraps) the script's loop
equals ``dqn.train`` in every tensor, and a stage cut after an evaluation,
handed off and resumed equals it run straight, bit for bit.  A handoff
refuses another seed, config or budget.  A handoff of the float32 PER
scan loads under today's key and its stage's records keep each segment's
scan.  The decision rule, on hand-made records.  A port selection loaded
into the JAX actor acts as the port's actor.  The guard of
``scripts/beside_torch.py``."""

import csv
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.agents import ddpg as pdd
from rl_mpc_lanemerging_torch.agents import dqn as pdqn
from rl_mpc_lanemerging_torch.config import Settings as PortSettings
from rl_mpc_lanemerging_tpu.agents import ddpg as jdd
from rl_mpc_lanemerging_tpu.agents import dqn as jdqn
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
pt = _load("paper_table_torch")
je = _load("jax_eval_port_selections")

# 16 cars, 10 s training episodes, a target refresh every 2 episodes, an
# evaluation every 4 and a ring of 256 rows, which wraps within the stage
OVERRIDES = dict(MAX_CARS=16, MAX_SENSED_CARS=8, EVALUATION_EPISODE_LENGTH=6.0,
                 TRAINING_EPISODE_LENGTH=10.0, TARGET_NET_FREEZE_PERIOD=2,
                 EVALUATION_PERIOD=4, REPLAY_BUFFER_SIZE=200)
SIZES = dict(batch=4, eval_episodes=4, final_episodes=4, final_batch=4,
             env_ticks=40, device="cpu", overrides=OVERRIDES)
EPISODES = 14                 # 15 rounds of 40 ticks at B=4, 4 evaluations
TIMINGS = ("s_per_round", "s_per_round_median", "s_per_eval", "segments",
           "train_s", "wall_s", "final_s")


def _untimed(record):
    return {k: v for k, v in record.items() if k not in TIMINGS}


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


@pytest.fixture
def short_evaluations(monkeypatch):
    """Evaluation rounds of 2 s of warmup and 4 s episodes; the state at
    the end of each ``dqn.train_episodes`` kept (before ``train`` loads
    its selection into the network)."""
    from rl_mpc_lanemerging_torch import tasks
    real = tasks.evaluate_controller
    monkeypatch.setattr(tasks, "evaluate_controller", lambda *a, **kw: real(
        *a, **{**kw, "max_episode_length": 4.0, "wait_before_start": 2.0}))
    finals = []
    loop = pdqn.train_episodes

    def recorded(*a, **kw):
        state = loop(*a, **kw)
        finals.append(tc.train_state_tree(state, tc.DQN_FIELDS))
        return state
    monkeypatch.setattr(pdqn, "train_episodes", recorded)
    return finals


# --- the schedule, against the JAX trainer ---------------------------------

# episodes a scripted round completes: JAX's log reads ~100-145 a round at
# B=128 early on
STEPS = [100, 129, 132, 144, 118, 97, 151, 123, 109, 138, 126, 117, 131,
         104, 142, 120, 99, 136, 128, 111]
SCHEDULE_EPISODES = 9000
# the scripted evaluations' (crash, merge, |jerk|, time to merge), in order
EVALS = [(0.9, 0.0, 0.01, float("nan")), (0.01, 0.98, 0.5, 28.0),
         (0.0, 1.0, 0.4, 27.0), (0.004, 0.996, 0.3, 26.0)]


def _schedule_cfg(cls):
    return cls.load_from_file(os.path.join(REPO, tc.CONFIG)).replace(
        **tc.DQN_OVERRIDES, MAX_CARS=16, MAX_SENSED_CARS=8, BATCH_SCENARIOS=4,
        EPS_DECAY_RATE=1000)


class _Agg:
    def __init__(self, values):
        self.values = values

    def get_stat_averages(self, report_stds=False):
        crash, merge, jerk, t = self.values
        avg = {"crashed": crash, "merged": merge, "mean_abs_jerk": jerk,
               "time_to_merge": t}
        if report_stds:
            return avg, {k: 0.0 for k in avg}
        return avg


# the trainers' own target refresh, before any test stands in for it
REFRESH = {jdqn: jdqn.refresh_target, pdqn: pdqn.refresh_target}


def _scripted(module, tasks_module, epsilon, replace, calls):
    """``module.train_round`` completing ``STEPS`` episodes a round in
    turn, and ``tasks_module.evaluate_controller`` returning ``EVALS`` in
    turn; ``calls`` gets each round's (episodes at its start, epsilon,
    grad steps) and each evaluation's and refresh's episodes."""
    def train_round(state, cfg, env_ticks, grad_steps, **kw):
        done = int(state.episodes)
        calls["rounds"].append((done, grad_steps))
        calls["epsilon"].append(float(epsilon(state.episodes, cfg)))
        return replace(state, done + STEPS[len(calls["rounds"]) % len(
            STEPS)])

    def evaluate_controller(cfg, controller, *a, **kw):
        calls["evals"].append(len(calls["rounds"]))
        return _Agg(EVALS[(len(calls["evals"]) - 1) % len(EVALS)])

    real = REFRESH[module]

    def refresh_target(state):
        calls["refreshes"].append(int(state.episodes))
        return real(state)
    return {"train_round": train_round, "refresh_target": refresh_target,
            "evaluate_controller": evaluate_controller}


def _patch(monkeypatch, module, tasks_module, fakes):
    for name in ("train_round", "refresh_target"):
        monkeypatch.setattr(module, name, fakes[name])
    monkeypatch.setattr(tasks_module, "evaluate_controller",
                        fakes["evaluate_controller"])


def test_the_stage_schedule_equals_jax_dqn_train(tmp_path, monkeypatch):
    """``dqn.train`` of both packages and the card script, uncut and cut
    after each evaluation, driven by the same scripted rounds and
    evaluations: the same rounds (episodes at each start, epsilon, grad
    steps), target refreshes, evaluation points and selection."""
    from rl_mpc_lanemerging_torch import tasks as ptasks
    from rl_mpc_lanemerging_tpu import tasks as jtasks
    monkeypatch.chdir(tmp_path)
    runs = {}

    jcalls = {"rounds": [], "epsilon": [], "evals": [], "refreshes": []}
    _patch(monkeypatch, jdqn, jtasks, _scripted(
        jdqn, jtasks, jdqn.epsilon_by_episode,
        lambda s, n: s._replace(episodes=jnp.asarray(n, jnp.int32)), jcalls))
    jstate = jdqn.train(_schedule_cfg(JaxSettings), SCHEDULE_EPISODES,
                        verbose=False)
    runs["jax"] = jcalls

    def port_replace(state, n):
        state.episodes = torch.tensor(n)
        return state

    pcalls = {"rounds": [], "epsilon": [], "evals": [], "refreshes": []}
    _patch(monkeypatch, pdqn, ptasks, _scripted(
        pdqn, ptasks, pdqn.epsilon_by_episode, port_replace, pcalls))
    pcfg = _schedule_cfg(PortSettings)
    pstate = pdqn.train(pcfg, SCHEDULE_EPISODES, verbose=False,
                        device="cpu")
    runs["port"] = pcalls

    for name, evals in (("script", None), ("script, cut", 1)):
        calls = {"rounds": [], "epsilon": [], "evals": [], "refreshes": []}
        _patch(monkeypatch, pdqn, ptasks, _scripted(
            pdqn, ptasks, pdqn.epsilon_by_episode, port_replace, calls))
        folder = str(tmp_path / name.replace(", ", "_"))
        kw = dict(batch=4, final_episodes=4, final_batch=4, device="cpu",
                  handoffs=folder, overrides=dict(
                      MAX_CARS=16, MAX_SENSED_CARS=8, EPS_DECAY_RATE=1000))
        record = None
        while record is None:
            n = len(calls["evals"])
            record = tc.run_dqn_stage(0, SCHEDULE_EPISODES, evals=evals,
                                      **kw)
            assert record is not None or len(calls["evals"]) == n + 1
        runs[name] = calls
        if evals:
            assert [s.get("ended") for s in record["segments"]] == \
                ["1 evaluations run"] * len(EVALS) + [None]
        runs[name + " selected"] = record["selected"]["episodes"]
    jax_run = runs["jax"]
    assert len(jax_run["evals"]) == len(EVALS)
    assert len(jax_run["refreshes"]) >= SCHEDULE_EPISODES // 650
    assert len(set(jax_run["epsilon"])) > 3
    assert {g for _, g in jax_run["rounds"]} == {64}
    for name in ("port", "script", "script, cut"):
        run = runs[name]
        assert run["rounds"] == jax_run["rounds"], name
        assert run["refreshes"] == jax_run["refreshes"], name
        assert run["epsilon"] == pytest.approx(jax_run["epsilon"],
                                               rel=1e-6), name
        # a script run evaluates its selection once more at the end
        assert run["evals"][:len(EVALS)] == jax_run["evals"], name
        assert len(run["evals"]) == len(EVALS) + (name != "port")
    assert int(pstate.episodes) == int(jstate.episodes)
    selected = [r for r, e in zip(runs["jax"]["evals"], EVALS)
                if e == EVALS[2]][0]
    assert runs["script selected"] == runs["script, cut selected"] == sum(
        STEPS[(i + 1) % len(STEPS)] for i in range(selected))


# --- real rounds ------------------------------------------------------------

def test_the_scripts_loop_uncut_equals_dqn_train(short_evaluations,
                                                 tmp_path, monkeypatch):
    """The card script's stage, uncut, and ``dqn.train`` on the same
    config and budget end in the same state (network, target, Adam,
    ring with priorities, env, draws, counters), log the same evaluations
    and select the same network."""
    monkeypatch.chdir(tmp_path)
    record = tc.run_dqn_stage(0, EPISODES, handoffs=str(tmp_path / "s"),
                              **SIZES)
    cfg = tc.dqn_config(0, 4, OVERRIDES)
    state = pdqn.train(cfg, EPISODES, verbose=False, env_ticks=40,
                       device="cpu", eval_episodes=4)
    script_end, train_end = short_evaluations
    _equal(script_end, train_end)
    assert record["episodes"] == int(state.episodes) >= EPISODES
    assert record["grad_steps"] == state.grad_steps > 0
    assert int(state.replay.size) == 256
    with open(os.path.join("runs_torch", cfg.LOG_DIR,
                           "scalars_eval_crash.csv")) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()[1:]]
    assert [int(r[0]) for r in rows] == [e["episodes"]
                                         for e in record["evals"]]
    assert [float(r[1]) for r in rows] == pytest.approx(
        [e["crash"] for e in record["evals"]])
    trees, best = tc.load_selection(tc.dqn_selection_path(
        str(tmp_path / "s"), 0))
    assert best["episodes"] == record["selected"]["episodes"]
    _equal(pdqn.convert.dqn_from_numpy(trees["q"]), {
        k: v for k, v in state.net.state_dict().items()})
    assert record["k1_launches"] == 0 and record["final"]["batch"] == 4
    assert len(record["episodes_per_round"]) == record["rounds"]


def test_a_dqn_stage_cut_and_resumed_equals_straight(short_evaluations,
                                                     tmp_path):
    """The stage straight, and in three segments as over three runs, each
    ending after one evaluation with a handoff that the next resumes from
    another folder: every tensor and counter at the end, the selection and
    the record less its timings are the same."""
    straight, first, second, last = (str(tmp_path / n) for n in (
        "straight", "first", "second", "last"))
    ref = tc.run_dqn_stage(0, EPISODES, handoffs=straight, **SIZES)
    assert tc.run_dqn_stage(0, EPISODES, handoffs=first, evals=1,
                            **SIZES) is None
    assert tc.run_dqn_stage(0, EPISODES, handoffs=second, evals=1,
                            resume_from=first, **SIZES) is None
    assert [os.path.basename(p) for p in tc.handoff_files(second, 0, "dqn")
            ] == ["seed0_dqn_handoff2.pt"]
    # the record of a segment's progress, from its handoff
    progress = tc.dqn_progress(second, [0])[0]
    assert progress["partial"] and progress["handoff"] == \
        "seed0_dqn_handoff2.pt" and progress["k1_launches"] == 0
    got = tc.run_dqn_stage(0, EPISODES, handoffs=last, resume_from=second,
                           **SIZES)
    assert progress["evals"] == got["evals"][:2]
    assert progress["episodes"] == got["segments"][1]["episodes"]
    assert progress["s_per_round"] == got["s_per_round"][:progress["rounds"]]
    assert 0 < progress["grad_steps"] < got["grad_steps"]
    assert tc.handoff_files(last, 0, "dqn") == []
    segs = got["segments"]
    assert [s["ended"] for s in segs[:2]] == ["1 evaluations run"] * 2
    assert segs[1]["handoff_bytes"] > 0 and segs[2]["load_s"] > 0
    assert segs[0]["rounds_to"] < segs[1]["rounds_to"] < ref["rounds"]
    _equal(short_evaluations[0], short_evaluations[-1])
    assert _untimed(got) == _untimed(ref)
    _equal({k: torch.from_numpy(v) for k, v in np.load(
        tc.dqn_selection_path(straight, 0)).items()},
        {k: torch.from_numpy(v) for k, v in np.load(
            tc.dqn_selection_path(last, 0)).items()})


def test_the_dqn_handoff_carries_every_field_and_refuses_another_key(
        tmp_path):
    """A trainer mid-stage (ring wrapped, priorities updated, int64
    actions) crosses the file into a fresh trainer exactly; another seed,
    config or budget is refused."""
    from rl_mpc_lanemerging_torch import tasks
    cfg = tc.dqn_config(1, 4, OVERRIDES)
    state = pdqn.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                  1)
    for _ in range(8):
        state = pdqn.train_round(state, cfg, env_ticks=40, grad_steps=8)
    assert int(state.replay.size) == 256 and state.grad_steps > 0
    assert state.replay.action.dtype == torch.int64
    key = tc.dqn_handoff_key(1, 4, 150_000, 512, 40, OVERRIDES)
    path = tc.handoff_path(str(tmp_path), 1, tc.DQN_STAGE, 1)
    assert os.path.basename(path) == "seed1_dqn_handoff1.pt"
    tc.save_handoff(path, state, key, {"loop": {"rounds": 8}},
                    fields=tc.DQN_FIELDS)
    before = tc.train_state_tree(state, tc.DQN_FIELDS)
    fresh = pdqn.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                  1)
    assert tc.load_handoff(path, fresh, key, tc.DQN_FIELDS)["loop"] == \
        {"rounds": 8}
    _equal(before, tc.train_state_tree(fresh, tc.DQN_FIELDS))
    assert tc.peek_handoff(path)["key"] == key
    for other in (tc.dqn_handoff_key(2, 4, 150_000, 512, 40, OVERRIDES),
                  tc.dqn_handoff_key(1, 4, 20_000, 512, 40, OVERRIDES),
                  tc.dqn_handoff_key(1, 4, 150_000, 512, 40, {}),
                  tc.handoff_key(1, 1, 4, 1e6, 5, 2048, OVERRIDES)):
        with pytest.raises(ValueError, match="was written for"):
            tc.load_handoff(path, fresh, other, tc.DQN_FIELDS)


@pytest.mark.parametrize("wide", [False, True], ids=["float32", "float64"])
def test_a_ring_of_any_width_unpacks_to_itself(wide):
    """The ring's packing takes 8-byte columns (the custom DQN's int64
    actions, a float64 ring) as it takes DDPG's float32 ring: unpacked, it
    is the ring bit for bit."""
    gen = torch.Generator().manual_seed(5)
    n, dim = 64, 20
    dtype = torch.float64 if wide else torch.float32
    obs = torch.randn(n + 1, dim, generator=gen, dtype=dtype)
    ring = SimpleNamespace(
        obs=obs, next_obs=torch.roll(obs, -1, 0),
        action=torch.randint(0, 5, (n + 1,), generator=gen) if wide
        else torch.randn(n + 1, generator=gen),
        reward=torch.randn(n + 1, generator=gen, dtype=dtype),
        terminal=torch.rand(n + 1, generator=gen) < 0.1,
        discount=torch.ones(n + 1, dtype=dtype),
        priority=torch.rand(n + 1, generator=gen, dtype=dtype),
        pos=torch.tensor(3), size=torch.tensor(n))
    got = tc.unpack_arrays(tc.pack_replay(ring))
    for name in tc.RING:
        np.testing.assert_array_equal(got[name], getattr(ring, name).numpy())


# evaluations after these rounds: periods of 3, 4 and 5 rounds
EVAL_ROUNDS = [3, 7, 12]


def _boundaries(kind, seconds, eval_rounds):
    if kind == "blocks of 5":
        return lambda: 5 if len(seconds) % 5 == 0 else 0
    return lambda: (eval_rounds[-1] - (eval_rounds[-2] if len(eval_rounds)
                                       > 1 else 0))\
        if eval_rounds and eval_rounds[-1] == len(seconds) else 0


@pytest.mark.parametrize("kind", ["blocks of 5", "evaluations"])
def test_a_segment_ends_at_a_boundary_after_its_periods_or_its_time(kind):
    """``segment_end`` serves both trainers' boundaries: no end before a
    boundary of this segment; a count of periods ends it at the boundary
    that completes them; a deadline ends it at the first boundary whose
    next period (its rounds at the slowest of the last period's), two
    evaluations and the save would pass it."""
    def drive(start, periods, deadline, slow_round=None):
        seconds = [1.0] * start
        evals = [r for r in EVAL_ROUNDS if r <= start]
        eval_seconds = [2.0] * len(evals)
        check = tc.segment_end(
            seconds, eval_seconds, _boundaries(kind, seconds, evals),
            deadline, periods, "periods", "period",
            clock=lambda: float(sum(seconds)))
        while len(seconds) < 15:
            why = check()
            if why is not None:
                return len(seconds), why
            seconds.append(10.0 if len(seconds) == slow_round else 1.0)
            if len(seconds) in EVAL_ROUNDS:
                evals.append(len(seconds))
                eval_seconds.append(2.0)
        return len(seconds), None

    late = "the next period would pass the run's time limit"
    first, second = (5, 10) if kind == "blocks of 5" else (3, 7)
    assert drive(0, 1, None) == (first, "1 periods run")
    assert drive(0, 2, None) == (second, "2 periods run")
    # a segment resumed at a boundary does not end there
    assert drive(first, 1, None) == (second, "1 periods run")
    assert drive(0, None, None) == (15, None)
    # at the first boundary the clock reads `first`; the next period (as
    # long as the last), two evaluations of 2 s and the reserve must fit
    need = first + 4 + tc.HANDOFF_RESERVE_S
    assert drive(0, None, first + need)[0] > first
    assert drive(0, None, first + need - 0.5) == (first, late)
    # one slow round in the last period counts for every round of the next
    reserve = tc.HANDOFF_RESERVE_S
    assert drive(0, None, reserve + 30) == (15, None)
    assert drive(0, None, reserve + 30, slow_round=first + 1) == (
        second, late)


def test_the_custom_dqn_records_are_read_as_a_stage_and_keep_their_scan(
        tmp_path):
    """The custom DQN's records are read and made pending by the stage
    helpers the other trainers use (its one stage is stage 1, its budget
    in episodes); each seed keeps one record, its newest, whose segments
    made before the card's PER scan was float64 are marked so, and the
    section names the stitch (or, for records of the float32 scan alone,
    says that they cannot be rerun)."""
    records = tc._lines(tc.OUT)
    partial = tc.read_stages(records, "dqn", partial=True)
    assert sorted(partial) == [(s, 1) for s in tc.SEEDS]
    dqn = [r for r in records if r.get("trainer") == "dqn"]
    assert len(dqn) == len(tc.SEEDS) and all("per_scan" not in r for r in dqn)
    assert {tuple(tc.segment_scans(r)) for r in dqn} == {
        ("float32", "float32", "float64")}
    assert tc.read_stages(records, "dqn") == {}
    assert tc.pending_stage([0, 1, 2, 3], tc.OUT, 150_000, 1, "dqn") == \
        [0, 1, 2, 3]
    out = tmp_path / "curve.jsonl"
    out.write_text(json.dumps({"trainer": "dqn", "seed": 1,
                               "episodes_budget": 150_000}) + "\n")
    assert tc.pending_stage([0, 1], str(out), 150_000, 1, "dqn") == [0]
    assert tc.pending_stage([0, 1], str(out), 200_000, 1, "dqn") == [0, 1]
    acc = tmp_path / "acc.md"
    assert tc.compare_dqn(tc.OUT, str(acc)) == "is not decided yet"
    assert "(each segment's `\"per_scan\"`): seeds 0, 1, 2, 3, segments 1-2 " \
        "float32 and segment 3 float64." in acc.read_text()

    def section(scan, old=None):
        return tc.section_dqn({}, {s: dict(r, segments=[
            {**{k: v for k, v in g.items() if k != "per_scan"},
             **({"per_scan": scan} if scan else {})}
            for g in r["segments"]], **({"per_scan": old} if old else {}))
            for (s, _), r in partial.items()}, tc.logged_dqn(),
            tc.jax_dqn_row())[0]
    assert "float32" not in section(tc.DQN_PER_SCAN)
    old = section(None, "float32")
    assert "Seeds 0, 1, 2, 3: records made while `rl/replay.py::sample` " \
        "scanned the PER priorities in float32" in old
    assert "stitches" not in old


# --- the rule ----------------------------------------------------------------

def _final(crash, merge, jerk, t):
    return {"episodes": 4000, "crash": crash, "crash_sem": 0.0,
            "merge": merge, "merge_sem": 0.0, "jerk": jerk,
            "jerk_sem": 0.001, "t_merge": t, "t_merge_sem": 0.03,
            "batch": 512}


LINE = {"crashed": "0.0", "merged": "1.0", "mean_abs_jerk": "0.3602",
        "mean_abs_jerk_std": "0.0012", "time_to_merge": "26.354",
        "time_to_merge_std": "0.030"}


def test_the_dqn_rule_on_hand_made_records():
    """The prediction interval's arithmetic; a port that learns as JAX
    agrees; one whose |jerk| sits apart, or that learns in 2 seeds of 4,
    differs; with fewer than 2 seeds reaching crash 0 and merge 1 the
    third part is reported, not decided."""
    lo, hi = tc.prediction_interval([1.0, 2.0, 3.0, 4.0])
    sd = np.std([1.0, 2.0, 3.0, 4.0], ddof=1)
    assert (lo, hi) == pytest.approx((2.5 - 3 * sd * np.sqrt(1.25),
                                      2.5 + 3 * sd * np.sqrt(1.25)))
    finals = [_final(0.0, 1.0, j, t) for j, t in
              ((0.34, 26.1), (0.38, 26.6), (0.36, 26.3), (0.37, 26.5))]
    reach = [80_000, 95_000, 70_000, 101_000]
    d = tc.decide_dqn(finals, reach, LINE, 88_497)
    assert d["verdict"] == "agrees" and d["learned"]["count"] == 4
    assert d["reach"]["holds"] and d["reach"]["reached"] == 4
    apart = [dict(f, jerk=f["jerk"] + 0.3) for f in finals]
    d = tc.decide_dqn(apart, reach, LINE, 88_497)
    assert d["verdict"] == "differs" and not d["jerk"]["holds"]
    two = finals[:2] + [_final(0.02, 0.9, 0.36, 26.3)] * 2
    assert tc.decide_dqn(two, reach, LINE, 88_497)["learned"]["holds"] \
        is False
    three = finals[:3] + [_final(0.02, 0.9, 0.36, 26.3)]
    d = tc.decide_dqn(three, [None, None, 90_000, None], LINE, 88_497)
    assert d["learned"]["holds"] and d["reach"]["holds"] is None
    assert d["reach"]["interval"] is None and d["verdict"] == "agrees"
    assert tc.first_clean([{"episodes": 10, "crash": 0.001, "merge": 0.999},
                           {"episodes": 20, "crash": 0.0, "merge": 1.0}]) \
        == 20


def test_compare_dqn_writes_its_section_from_records_or_handoffs(
        tmp_path, monkeypatch):
    """``--compare --trainer dqn``: while a seed's stage runs, the section
    shows its last segment's record and decides nothing; once four seeds'
    stages have records, it decides.  The 73 JAX evaluations are beside the
    port's, and the sections before it stay as they were."""
    jax = tc.logged_dqn()
    assert len(jax) == 73 and tc.first_clean(jax) == 88_497
    assert jax[-1] == {"episodes": 149_915, "crash": 0.0,
                       "jerk": pytest.approx(0.2719295934305122),
                       "merge": 1.0}
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    acc.write_text("# Acceptance\n\n## DDPG learning curve\n\nkept\n")
    out = tmp_path / "curve.jsonl"

    def record(seed, jerk):
        # the first evaluation of crash 0 and merge 1: 80,000-98,000
        evals = [{"episodes": 2000 * (i + 1),
                  "crash": 0.0 if i > 38 + 3 * seed else 0.5,
                  "merge": 1.0 if i > 38 + 3 * seed else 0.4, "jerk": 0.4,
                  "t_merge": 27.0} for i in range(75)]
        return {"trainer": "dqn", "seed": seed, "episodes": 150_100,
                "rounds": 1270, "segments": [
                    {"rounds_to": 600, "episodes": 70_000},
                    {"rounds_to": 1270, "episodes": 150_100}],
                "s_per_round_median": 6.1, "s_per_eval": [20.0],
                "evals": evals, "selected": {"episodes": 8000},
                "final": _final(0.0, 1.0, jerk, 26.0 + 20 * (jerk - 0.35)),
                "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    out.write_text("".join(json.dumps(record(s, 0.35 + 0.01 * s)) + "\n"
                           for s in range(3)))
    with pytest.raises(SystemExit):
        tc.compare_dqn(str(tmp_path / "x.jsonl"), str(acc))
    # seed 3's stage runs: its last segment's record stands in
    partial = dict(record(3, 0.37), partial=True, episodes=60_000,
                   segments=[{"rounds_to": 500, "episodes": 60_000}])
    partial.pop("final")
    out.write_text(out.read_text() + json.dumps(partial) + "\n")
    assert tc.compare_dqn(str(out), str(acc)) == "is not decided yet"
    text = acc.read_text()
    assert text.startswith("# Acceptance\n\n## DDPG learning curve\n\nkept\n")
    assert "**Not decided" in text and "| 73 | 149,915: 0.0000 / 1.0000 / " \
        "0.272 | 146,000: 0.0000 / 1.0000 / 0.400 | " in text
    assert "| 75 | - | 150,000: 0.0000 / 1.0000 / 0.400 | " in text
    assert "| 3 | 60,000 | 1270 | 500, 60,000 | " in text
    out.write_text(out.read_text() + json.dumps(record(3, 0.37)) + "\n")
    assert tc.compare_dqn(str(out), str(acc)) == "agrees"
    text = acc.read_text()
    assert text.count(tc.DQN_SECTION) == 1 and "**Verdict: the port's " \
        "custom DQN agrees with the JAX package's.**" in text
    assert "| 3 | 150,100 | 1270 | 600, 70,000; 1270, 150,100 | 6.10 | " \
        "20.00 | 98000 | 8000 |" in text


# --- the port's DDPG selections under JAX's evaluator -----------------------

def test_a_port_selection_loads_into_the_jax_actor():
    """``jax_eval_port_selections.actor_params`` puts a committed selection
    into the JAX actor, which then acts as the port's actor of the same file
    on the same observations."""
    path = je.selection_path(0, 2)
    params = je.actor_params(path)
    assert sorted(params["params"]) == ["Dense_0", "Dense_1", "Dense_2"]
    jcfg = JaxSettings.load_from_file(os.path.join(REPO, tc.CONFIG))
    obs = np.random.default_rng(0).normal(size=(64, jcfg.obs_dim)).astype(
        np.float32)
    want = np.asarray(jdd._nets(jcfg)[0].apply(params, jnp.asarray(obs)))
    trees, _ = tc.load_selection(path)
    pcfg = tc.seed_config(0, 128)
    actor = pdd._actor_from(pcfg, pdd.convert.ddpg_actor_from_numpy(
        trees["actor"]), "cpu")
    with torch.no_grad():
        got = actor(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_the_selections_section_holds_the_eight_networks(tmp_path):
    """The committed JAX evaluations beside the port's records: every
    selection has its port evaluation, and the section counts how many
    hold; a network whose JAX |jerk| sits 10 SEM away is flagged."""
    stages = tc.read_stages(tc._lines(tc.OUT), "ddpg")
    with open(tc.JAX_SELECTIONS) as fh:
        jax = json.load(fh)["records"]
    assert len(jax) == 8 and all(r["eval"]["episodes"] == 2048 for r in jax)
    text, held = tc.section_selections(stages, jax)
    assert text.startswith(tc.SELECTIONS_SECTION + "\n")
    assert f"**{held} of 8 networks hold" in text
    moved = [dict(r, eval=dict(r["eval"], jerk=r["eval"]["jerk"]
                               + 10 * r["eval"]["jerk_sem"] * 1.5))
             if (r["seed"], r["stage"]) == (1, 1) else r for r in jax]
    text2, held2 = tc.section_selections(stages, moved)
    assert held2 == held - 1 and "(flagged)" in text2


def test_the_ddpg_two_stage_section_is_regenerated_byte_for_byte(tmp_path):
    """``--compare --trainer ddpg --stage both`` on the committed records
    writes the two-stage section as committed, and after it the section
    of the selections under JAX's evaluator."""
    committed = open(os.path.join(REPO, "ACCEPTANCE_TORCH.md")).read()
    start = committed.index(pt.DDPG_SECTION + "\n")
    end = committed.find("\n## ", start + len(pt.DDPG_SECTION))
    want = committed[start:] if end < 0 else committed[start:end + 1]
    acc = tmp_path / "acc.md"
    tc.compare_ddpg(tc.OUT, tc.DDPG_YARDSTICKS, str(acc))
    text = acc.read_text()
    assert text.startswith(want.rstrip("\n") + "\n")
    assert tc.SELECTIONS_SECTION in text[len(want.rstrip("\n")):]


# --- the custom_dqn row of the table ----------------------------------------

def test_the_custom_dqn_family_row_is_line_218(tmp_path):
    """``--family custom_dqn``: ``dqn_custom_default1`` is
    configs/train_default_1.json as TRAIN_DQN with the committed network
    at line 218's B=512, and ``--compare`` holds its row to line 218."""
    assert pt.ALL_FAMILIES["custom_dqn"] == ["dqn_custom_default1"]
    assert "dqn_custom_default1" not in [n for f in pt.FAMILIES.values()
                                         for n in f]
    jax_rows = pt.newest_rows(pt.read_rows(pt.JAX_CSV), pt.MIN_JAX_EPISODES)
    assert jax_rows["dqn_custom_default1"]["_line"] == 218
    cfg = pt.table_config("dqn_custom_default1", 4000, jax_rows)
    assert (cfg.TASK, cfg.LOG_DIR, cfg.MODEL_NAME, cfg.BATCH_SCENARIOS,
            cfg.NUM_EPISODES, cfg.SEED) == (
        "TRAIN_DQN", "dqn_custom_default1", "runs/dqn_custom_default1",
        512, 4000, 0)
    assert pt.expected_k1_per_tick(cfg) == 0
    # --run --family custom_dqn reaches the card's check (no config file
    # of its own is asked for)
    with pytest.raises(RuntimeError, match="evaluates on the card"):
        pt.main(["--run", "--family", "custom_dqn", "--episodes", "4000"])
    line = {k: v for k, v in jax_rows["dqn_custom_default1"].items()
            if k != "_line"}
    port = tmp_path / "port.csv"
    with open(port, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(line))
        writer.writeheader()
        writer.writerow(dict(line, mean_abs_jerk="0.39"))
    acc = tmp_path / "acc.md"
    pt.compare(str(port), str(acc))
    text = acc.read_text()
    row = [r for r in text.splitlines()
           if r.startswith("| dqn_custom_default1 | line 218 |")]
    assert len(row) == 1 and "mean abs jerk" in row[0]


def test_a_timing_taken_on_a_shared_card_says_so(tmp_path):
    """The table's timing row names what shared the card where the record
    says so: the committed ``dqn_custom_default1`` row ran beside four
    training processes."""
    acc = tmp_path / "acc.md"
    pt.compare(pt.PORT_CSV, str(acc))
    rows = [r for r in acc.read_text().splitlines()
            if r.startswith("| dqn_custom_default1 | NVIDIA H100")]
    assert len(rows) == 1 and "; the card shared with four custom-DQN " \
        "training processes" in rows[0]
    shared = [r for r in acc.read_text().splitlines()
              if "the card shared with" in r]
    assert shared == rows


def test_the_dqn_run_spawns_the_seeds_with_their_segment_arguments(
        tmp_path, monkeypatch):
    """``--run --trainer dqn``: the seeds without a record are spawned at
    once with the stage's budget, evaluation episodes, handoff folders and
    the run's deadline; a spawned seed runs its own segment."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tc, "card_line", lambda: "GPU, 700.00 W")
    monkeypatch.setattr(tc, "spawn", lambda *a: calls.append(a))
    monkeypatch.setattr(tc, "run_one", lambda *a, **kw: calls.append(
        (a, kw)))
    out = tmp_path / "curve.jsonl"
    out.write_text(json.dumps({"trainer": "dqn", "seed": 1,
                               "episodes_budget": 150_000}) + "\n")
    tc.main(["--run", "--trainer", "dqn", "--time-limit", "3300",
             "--handoffs", str(tmp_path / "h"), "--resume-from",
             str(tmp_path / "r"), "--out", str(out)])
    (seeds, budget, _, extra, log, meanwhile, flag), = calls
    assert seeds == [0, 2, 3] and budget == 150_000 and log == \
        "train_curve_dqn" and meanwhile is None and flag == "--train-episodes"
    deadline = float(extra[extra.index("--deadline") + 1])
    assert extra[:6] == ["--trainer", "dqn", "--episodes", "512",
                         "--handoffs", str(tmp_path / "h")]
    assert extra[extra.index("--resume-from") + 1] == str(tmp_path / "r")
    calls.clear()
    tc.main(["--run", "--trainer", "dqn", "--seeds", "2", "--concurrent",
             "3", "--train-episodes", "150000", "--deadline", str(deadline),
             "--handoff-after-evals", "2", "--out", str(out)])
    (args, kw), = calls
    assert args[:4] == (2, 150_000, str(out), 3)
    assert args[-1] == dict(eval_episodes=512, handoffs=tc.DQN_HANDOFFS,
                            deadline=deadline, evals=2, resume_from=None)


def test_a_float32_rings_float64_scan_is_exact():
    """The card's PER draw scans a float32 ring in float64 because its
    partial sums are then exact: any order of additions gives the same
    bits (here sequential, blocked and reversed), so the draw does not
    depend on the card's scan order; the CPU's draw is the float32 scan's,
    as JAX's."""
    from rl_mpc_lanemerging_torch.config import Settings as S
    from rl_mpc_lanemerging_torch.rl import replay as rb
    cfg = S()
    g = torch.Generator().manual_seed(3)
    cap = rb.round_up_pow2(cfg.REPLAY_BUFFER_SIZE)
    td = torch.rand(cap, generator=g) * 2 * cfg.PER_MAX_PRIORITY
    pri = (torch.clamp(td + cfg.PER_MIN_PRIORITY, max=cfg.PER_MAX_PRIORITY)
           ** cfg.PER_ALPHA).float()
    pri[::7] = cfg.PER_MIN_PRIORITY ** cfg.PER_ALPHA
    seq = torch.cumsum(pri, 0, dtype=torch.float64)
    blocks = torch.cumsum(pri.double().view(256, -1), 1)
    starts = torch.cat([torch.zeros(1, dtype=torch.float64),
                        torch.cumsum(blocks[:, -1], 0)[:-1]])
    assert torch.equal((blocks + starts[:, None]).reshape(-1), seq)
    assert torch.equal(pri.double().flip(0).sum().reshape(1), seq[-1:])
    ring = rb.init_replay(cfg.REPLAY_BUFFER_SIZE, 4, discrete=True)
    ring.priority[:cap] = pri
    u = torch.rand(512, generator=g)
    c = torch.cumsum(pri, 0)
    assert torch.equal(rb.sample(ring, 512, u=u)[0], torch.searchsorted(
        c, u * c[-1], right=True).clamp_(0, cap - 1))


# --- a stage stitched from two PER scans ------------------------------------

# the key of a custom-DQN handoff written under the float32 PER scan (seed 0
# of the stage at 150,000 episodes), as such a file holds it
FLOAT32_ERA_KEY = {"trainer": "dqn", "config": "configs/train_default_1.json",
                   "TASK": "TRAIN_DQN", "LOG_DIR": "dqn_custom_default1",
                   "seed": 0, "batch": 128, "episodes_budget": 150000,
                   "eval_episodes": 512, "env_ticks": 200, "overrides": "{}"}


def _as_float32_era(path):
    """Rewrite a handoff as one saved before segments kept their scan."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    for g in data["segments"]:
        g.pop("per_scan")
    torch.save(data, path)


def test_a_stage_stitched_from_two_scans_is_recorded_and_compared(
        short_evaluations, tmp_path):
    """A segment resumed from a handoff of the float32 scan: its progress
    record keeps each segment's scan, replaces the seed's older partial
    records and is read back; the stage's final record keeps every
    segment's scan and claims none for the whole; ``--compare`` names the
    stitch."""
    first, second, last = (str(tmp_path / n) for n in ("a", "b", "c"))
    assert tc.run_dqn_stage(0, EPISODES, handoffs=first, evals=1,
                            **SIZES) is None
    _as_float32_era(tc.handoff_files(first, 0, "dqn")[-1])
    assert tc.run_dqn_stage(0, EPISODES, handoffs=second, evals=1,
                            resume_from=first, **SIZES) is None
    progress = tc.dqn_progress(second, [0])[0]
    assert tc.segment_scans(progress) == ["float32", "float64"]
    out = tmp_path / "curve.jsonl"
    older = {"trainer": "dqn", "partial": True, "seed": 0,
             "per_scan": "float32", "segments": [{}]}
    # another seed's record of the float32 scan, one field for every segment
    other = dict(progress, seed=1, per_scan="float32", segments=[
        {k: v for k, v in g.items() if k != "per_scan"}
        for g in progress["segments"]])
    out.write_text("".join(json.dumps(r) + "\n" for r in (older, other)))
    tc.put_record(str(out), progress, tc.dqn_partials_of(0))
    back = tc.read_stages(tc._lines(str(out)), "dqn", partial=True)
    assert [r["seed"] for r in tc._lines(str(out))] == [1, 0]
    assert tc.segment_scans(back[(0, 1)]) == ["float32", "float64"]
    assert tc.segment_scans(back[(1, 1)]) == ["float32", "float32"]
    assert all(round(s, 2) == s for s in back[(0, 1)]["s_per_round"])
    text, _ = tc.section_dqn({}, {0: back[(0, 1)], 1: back[(1, 1)]},
                             tc.logged_dqn(), tc.jax_dqn_row())
    assert "Seeds 1: records made while `rl/replay.py::sample` scanned" \
        in text
    assert "The stage stitches two scans of the PER priorities on the card " \
        "(each segment's `\"per_scan\"`): seed 0, segment 1 float32 and " \
        "segment 2 float64." in text
    got = tc.run_dqn_stage(0, EPISODES, handoffs=last, resume_from=second,
                           **SIZES)
    assert "per_scan" not in got
    assert tc.segment_scans(got) == ["float32", "float64", "float64"]
    tc.put_record(str(out), got, tc.dqn_partials_of(0))
    assert tc.read_stages(tc._lines(str(out)), "dqn", partial=True).keys() \
        == {(1, 1)}
    assert tc.segment_scans(tc.read_stages(tc._lines(str(out)), "dqn")[
        (0, 1)]) == ["float32", "float64", "float64"]


def test_a_float32_era_handoff_key_loads_and_another_is_refused(tmp_path):
    """Today's key of seed 0's stage is the key the float32-era files
    hold: such a file (its segments without a scan, its draws a card
    generator's 16 bytes) loads into a CPU train state through
    ``--peek``'s check, which reports where the stage stands; another
    seed, config or budget is still refused."""
    from rl_mpc_lanemerging_torch import tasks
    assert tc.dqn_handoff_key(0, 128, 150_000, 512, 200) == FLOAT32_ERA_KEY
    cfg = tc.dqn_config(0, 128)
    state = pdqn.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                  0)
    state.episodes = state.episodes + 59_596
    path = tc.handoff_path(str(tmp_path), 0, tc.DQN_STAGE, 2)
    segments = [{"rounds_to": 274, "episodes": 37_099},
                {"rounds_to": 473, "episodes": 59_596}]
    tc.save_handoff(path, state, FLOAT32_ERA_KEY, {
        "loop": {"rounds": 473, "last_target": 59_482, "last_eval": 59_596},
        "seconds": [9.3] * 473, "best": {"score": [0.0833, 0.0, 0.32],
                                          "episodes": 22_648},
        "segments": segments}, fields=tc.DQN_FIELDS)
    data = torch.load(path, map_location="cpu", weights_only=True)
    data["state"]["draws"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(data, path)
    seen = tc.check_handoffs(str(tmp_path), [0])[0]
    assert (seen["episodes"], seen["rounds"], seen["last_target"],
            seen["last_eval"], seen["draws_bytes"]) == (
        59_596, 473, 59_482, 59_596, 16)
    assert seen["segments"] == [(274, 37_099), (473, 59_596)]
    assert seen["best_episodes"] == 22_648 and seen["ring_fill"] == 0
    fresh = pdqn.make_train_state(cfg, *tasks.make_worlds(cfg, device="cpu"),
                                  0)
    fresh.draws.generator = tc._HeldGeneratorState()
    for other in (tc.dqn_handoff_key(1, 128, 150_000, 512, 200),
                  tc.dqn_handoff_key(0, 128, 150_000, 512, 200,
                                     {"MAX_CARS": 16}),
                  tc.dqn_handoff_key(0, 128, 100_000, 512, 200)):
        with pytest.raises(ValueError, match="was written for"):
            tc.load_handoff(path, fresh, other, tc.DQN_FIELDS)
    with pytest.raises(FileNotFoundError, match="no handoff"):
        tc.check_handoffs(str(tmp_path), [1])


def test_the_beside_guard_reads_each_seeds_first_rounds(tmp_path):
    """``scripts/beside_torch.py``'s guard: the median of the first N
    rounds of every DQN seed's log together, None until each has N; the
    lines are those ``run_dqn_stage`` prints before each round."""
    bt = _load("beside_torch")
    logs = []
    for seed, base in ((0, 9.0), (1, 11.0)):
        log = tmp_path / f"train_curve_dqn_seed{seed}.log"
        log.write_text("seed line\n" + "".join(
            f"  round {474 + i}: {base + i / 100:.3f} s\n"
            "  round 10 episodes=1 eps=0.1 loss=0.1\n" for i in range(25)))
        logs.append(str(log))
    assert bt.round_seconds(logs[0])[:2] == [9.0, 9.01]
    assert bt.guard_median(logs, 20) == pytest.approx(10.095)
    assert bt.guard_median(logs, 26) is None
    assert bt.guard_median(logs[:1], 20) == pytest.approx(9.095)
    with pytest.raises(RuntimeError, match="card"):
        bt.main(["--dir", str(tmp_path / "x")])
