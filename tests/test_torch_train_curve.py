"""The DDPG learning-curve scripts at a tiny size on the CPU:
``scripts/jax_train_curve.py`` (the JAX package's yardstick) and
``scripts/train_curve_torch.py`` (the port on the card).  Two or three
rounds of a seed at B=4 with 16 cars and 8-episode evaluations on each
side: the recorder's rows, the JSON and JSONL records, resuming past a
recorded seed; ``--compare`` on fabricated records (the decision rule, its
verdict, the section it writes); the JAX package's logged runs; and that
``--run`` needs the card."""

import importlib.util
import json
import os
import sys

import pytest
import torch

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

SIZES = dict(batch=4, eval_every=1, eval_episodes=8, final_episodes=8,
             overrides=dict(MAX_CARS=16, MAX_SENSED_CARS=8,
                            EVALUATION_EPISODE_LENGTH=6.0))
# two or three rounds at B=4: the first round's warmup leaves fewer valid
# frames
FRAMES = 500
RECORD_KEYS = {"seed", "config", "batch", "frames_budget", "frames",
               "episodes", "rounds", "s_per_round", "s_per_round_median",
               "eval_every_rounds", "eval_episodes", "evals", "progress",
               "selected", "final", "train_s", "wall_s"}
FINAL_KEYS = {"episodes", "crash", "crash_sem", "merge", "merge_sem",
              "jerk", "jerk_sem", "t_merge", "t_merge_sem"}


def _short_evaluations(monkeypatch, tasks):
    """Evaluation rounds of 10 s of warmup and 6 s episodes."""
    real = tasks.evaluate_controller
    monkeypatch.setattr(tasks, "evaluate_controller", lambda *a, **kw: real(
        *a, **{**kw, "max_episode_length": 6.0, "wait_before_start": 10.0}))


def _check_record(rec, seed):
    assert RECORD_KEYS <= set(rec)
    assert rec["seed"] == seed and rec["batch"] == 4
    assert rec["frames"] >= FRAMES and 2 <= rec["rounds"] <= 3
    assert len(rec["s_per_round"]) == rec["rounds"]
    assert rec["s_per_round_median"] > 0
    assert [e["frames"] for e in rec["evals"]] == sorted(
        e["frames"] for e in rec["evals"])
    assert len(rec["evals"]) == rec["rounds"]   # every round, eval_every 1
    for e in rec["evals"]:
        assert set(e) == {"frames", "crash", "merge", "jerk", "t_merge"}
        assert 0.0 <= e["crash"] <= 1.0 and 0.0 <= e["merge"] <= 1.0
    assert rec["selected"]["frames"] in [e["frames"] for e in rec["evals"]]
    assert set(rec["final"]) == FINAL_KEYS
    assert rec["final"]["episodes"] == 8
    assert [p["frames"] for p in rec["progress"]] == [rec["frames"]]
    json.dumps(rec, allow_nan=False)          # standard JSON: no NaN


def test_jax_script_records_each_seed_once(tmp_path, monkeypatch):
    from rl_mpc_lanemerging_tpu import tasks
    _short_evaluations(monkeypatch, tasks)
    out = str(tmp_path / "yardsticks.json")
    argv = ["--seeds", "0", "--frames", str(FRAMES), "--out", out]
    jc.main(argv, **SIZES)
    with open(out) as fh:
        data = json.load(fh)
    rec = data["seeds"]["0"]
    _check_record(rec, 0)
    assert rec["platform"] == "cpu" and rec["config"] == tc.CONFIG
    monkeypatch.setattr(jc, "run_seed", lambda *a, **kw: pytest.fail(
        "a recorded seed ran again"))
    assert jc.main(argv, **SIZES)["seeds"]["0"] == rec


def test_port_script_records_a_seed_and_resumes(tmp_path, monkeypatch):
    from rl_mpc_lanemerging_torch import tasks
    _short_evaluations(monkeypatch, tasks)
    rec = tc.run_seed(1, FRAMES, device="cpu", **SIZES)
    _check_record(rec, 1)
    assert rec["k1_launches"] == 0
    out = str(tmp_path / "curve.jsonl")
    tc.append_record(out, rec)
    tc.append_record(out, {**rec, "seed": 3, "frames_budget": 10.0})
    with open(out) as fh:
        lines = [json.loads(line) for line in fh]
    assert [r["seed"] for r in lines] == [1, 3]
    assert lines[0] == json.loads(json.dumps(rec))
    # seed 1 is done at this budget; seed 3 only at a smaller one
    assert tc.pending([0, 1, 2, 3], out, FRAMES) == [0, 2, 3]
    assert tc.pending([1], out, 10.0) == []


def test_card_script_refuses_to_run_without_cuda(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="card"):
        tc.main(["--run", "--out", str(tmp_path / "curve.jsonl")])


def _fabricated(seed, final_crash, final_merge, jerk, evals, budget=4e5,
                **extra):
    return {"seed": seed, "config": tc.CONFIG, "batch": 128,
            "frames_budget": budget, "frames": int(budget) + 1000,
            "episodes": 2000, "rounds": 25, "s_per_round": [60.0] * 25,
            "s_per_round_median": 60.0, "eval_every_rounds": 5,
            "eval_episodes": 2048,
            "evals": [{"frames": f, "crash": c, "merge": m, "jerk": 0.4,
                       "t_merge": 28.0} for f, c, m in evals],
            "progress": [], "selected": {"frames": evals[-1][0],
                                         "score": [0.004, 0.0, 0.4]},
            "final": {"episodes": 1024, "crash": final_crash,
                      "crash_sem": 0.001, "merge": final_merge,
                      "merge_sem": 0.001, "jerk": jerk, "jerk_sem": 0.005,
                      "t_merge": 28.0, "t_merge_sem": 0.1}, **extra}


LEARNS = [(80_000, 0.4, 0.6), (160_000, 0.0, 1.0), (400_500, 0.0, 1.0)]
LATE = [(80_000, 0.4, 0.6), (160_000, 0.2, 0.8), (400_500, 0.0, 1.0)]
NEVER = [(80_000, 0.0, 0.0), (160_000, 0.0, 0.0), (400_500, 0.0, 0.0)]


def _write(tmp_path, port, jax):
    out = tmp_path / "curve.jsonl"
    out.write_text("".join(json.dumps(r) + "\n" for r in port))
    yard = tmp_path / "yardsticks.json"
    yard.write_text(json.dumps({"seeds": {str(r["seed"]): r for r in jax}}))
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    acc.write_text("# Acceptance\n\nthe table\n\n## DDPG learning curve\n\n"
                   "an older section\n")
    return str(out), str(yard), str(acc)


def test_compare_applies_the_rule_and_writes_its_section(tmp_path):
    """Four seeds a side.  The JAX seeds: three reach the point (at 160k
    and 400.5k frames), one never.  A port whose seeds learn alike agrees;
    one that never merges differs on merge and on the count of seeds."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "concurrent_seeds": 4,
            "k1_launches": 0}
    jax = [_fabricated(0, 0.0, 1.0, 0.40, LEARNS, cpu_count=8),
           _fabricated(1, 0.001, 0.999, 0.42, LATE, cpu_count=8),
           _fabricated(2, 0.0, 1.0, 0.38, LEARNS, cpu_count=8),
           _fabricated(3, 0.0, 0.5, 0.30, NEVER, cpu_count=8)]
    port = [_fabricated(0, 0.0, 1.0, 0.41, LATE, **card),
            _fabricated(1, 0.0, 1.0, 0.39, LEARNS, **card),
            _fabricated(2, 0.002, 0.998, 0.43, LEARNS, **card),
            _fabricated(3, 0.0, 0.0, 0.31, NEVER, **card)]
    out, yard, acc = _write(tmp_path, port, jax)
    assert tc.compare(out, yard, acc) == "agrees"
    text = open(acc).read()
    assert text.startswith("# Acceptance\n\nthe table\n\n## DDPG learning")
    assert "an older section" not in text and text.count("## DDPG") == 1
    assert "**Verdict: the port's curve agrees with the JAX package's.**" \
        in text
    assert "| seeds that reach crash <= 0.005, merge >= 0.995 | 3 of 4 | " \
           "3 of 4 | 0 | at most 1 | yes |" in text
    assert "NVIDIA H100 80GB HBM3, 700.00 W, 4 seeds at once" in text
    assert "| JAX | 3 | 400500 |" in text and "| never |" in text
    # the frames to the point: JAX 160k, 400.5k, 160k, and the budget
    js = tc.summarize({r["seed"]: r for r in jax})
    assert js["reach_frames"][0] == pytest.approx(
        (160_000 + 400_500 + 160_000 + 400_000) / 4)
    assert js["reached"] == 3 and js["n"] == 4

    never = [_fabricated(s, 0.0, 0.0, 0.3, NEVER, **card) for s in range(4)]
    out, yard, acc = _write(tmp_path, never, jax)
    assert tc.compare(out, yard, acc) == "differs"
    text = open(acc).read()
    rule = {line.split(" | ")[0]: line for line in text.splitlines()
            if line.endswith((" | yes |", " | no |"))}
    assert rule["| merge"].startswith(
        "| merge | 0.0000 ± 0.0000 | 0.8748 ± ")
    assert rule["| merge"].endswith(" | no |")
    assert rule["| mean abs jerk"].endswith(" | yes |")
    assert "| 0 of 4 | 3 of 4 | 3 | at most 1 | no |" in text


@pytest.mark.parametrize("port, jax, holds", [
    ((0.5, 0.1), (0.5, 0.1), True),
    ((0.0, 0.0), (0.0, 0.0), True),          # equal, no spread
    ((0.1, 0.0), (0.0, 0.0), False),         # no spread at all: any gap
    ((0.0, 0.1), (0.3, 0.0), True),          # exactly 3 SEM: not beyond
    ((0.0, 0.1), (0.31, 0.0), False),
    ((0.12, 0.03), (0.0, 0.03), True),       # both spread: 3 sqrt(2) SEM
    ((0.13, 0.03), (0.0, 0.03), False),
])
def test_each_quantity_is_held_to_three_sems(port, jax, holds):
    """Each rule, DDPG's and Rainbow's, holds |jerk| (and each of its other
    quantities) to 3 SEM of the difference, and its count of seeds to one."""
    side = {"crash": (0.0, 0.0), "merge": (1.0, 0.0), "jerk": (0.4, 0.0),
            "reach_frames": (0.0, 0.0), "reached": 4, "n": 4}
    rows, counts_hold, verdict = tc.decide({**side, "jerk": port},
                                           {**side, "jerk": jax})
    assert [r[0] for r in rows][2] == "mean abs jerk"
    assert rows[2][-1] is holds and counts_hold
    assert verdict == ("agrees" if holds else "differs")
    _, counts_hold, verdict = tc.decide({**side, "reached": 2}, side)
    assert not counts_hold and verdict == "differs"
    side = {"crash": (0.06, 0.01), "merge": (0.9, 0.01), "jerk": (0.12, 0.0),
            "t_merge": (34.2, 0.2), "score": (0.13, 0.01),
            "stage1_score": (0.25, 0.05), "no_worse": 2, "n": 4}
    for i, name in enumerate(("crash", "merge", "jerk", "t_merge", "score",
                              "stage1_score")):
        rows, counts_hold, verdict = tc.decide_rainbow(
            {**side, name: port}, {**side, name: jax})
        assert rows[i][-1] is holds and counts_hold
        assert all(r[-1] for j, r in enumerate(rows) if j != i)
        assert verdict == ("agrees" if holds else "differs")
    for port_count, hold in ((2, True), (3, False), (0, True)):
        _, counts_hold, verdict = tc.decide_rainbow(
            {**side, "no_worse": port_count}, {**side, "no_worse": 1})
        assert counts_hold is hold
        assert verdict == ("agrees" if hold else "differs")


def test_logged_runs_are_read_from_the_jax_packages_scalars():
    """runs/ddpg_default1: runs A and B in scalars.1.csv, C in scalars.csv,
    each evaluation row (step, crash, |jerk|, merge[, t_merge])."""
    runs = tc.logged_runs()
    assert sorted(runs) == ["A", "B", "C"]
    first = {name: (e[0]["frames"], e[0]["crash"], e[0]["merge"])
             for name, e in runs.items()}
    assert first == {"A": (144900, 0.0, 0.0), "B": (137545, 0.0, 1.0),
                     "C": (87411, 0.412109375, 0.587890625)}
    c = {e["frames"]: (e["crash"], e["merge"]) for e in runs["C"]}
    assert c[403268] == (0.0, 1.0)
    assert len(runs["C"]) == 14 and len(runs["A"]) == 5


def test_the_table_keeps_the_curve_section(tmp_path):
    """``paper_table_torch.py --compare`` rewrites the table and keeps the
    section the curve script put at the end; ``put_section`` replaces it."""
    path = str(tmp_path / "ACCEPTANCE_TORCH.md")
    pt.put_section(path, pt.CURVE_SECTION, pt.CURVE_SECTION + "\n\nfirst\n")
    assert open(path).read() == "## DDPG learning curve\n\nfirst\n"
    with open(path, "w") as fh:
        fh.write("# old table\n\n" + pt.CURVE_SECTION + "\n\nkept\n")
    assert pt._kept_sections(path) == pt.CURVE_SECTION + "\n\nkept\n"
    pt.put_section(path, pt.CURVE_SECTION, pt.CURVE_SECTION + "\n\nnew\n")
    assert open(path).read() == "# old table\n\n## DDPG learning curve\n\n" \
        "new\n"
