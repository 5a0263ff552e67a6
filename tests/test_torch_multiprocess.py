"""The port run as separate processes that torchrun's variables join
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), 2 ``gloo``
ranks on the CPU: the counterpart of ``tests/test_multihost.py`` through
``scripts/multihost_worker_torch.py`` (rank 0's per-episode columns equal
one process's run of the same 8 seeded scenarios), and the CLI
(``python -m rl_mpc_lanemerging_torch.main``) on 2 ranks, where rank 0
alone appends the ``--csv`` row, which equals a one-process run's."""

import csv
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from rl_mpc_lanemerging_torch import main as tmain
from rl_mpc_lanemerging_torch.config import Settings
from rl_mpc_lanemerging_torch.parallel.sharded import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker_torch.py")
ST_SETTINGS = dict(FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=8, MAX_SENSED_CARS=8,
                   QP_ITERATIONS=5, BATCH_SCENARIOS=8, NUM_EPISODES=8,
                   SEED=7, TASK="ST", LOG_DIR="mp_st")

# several test workers run at once: one intra-op thread each, in the ranks
# too, keeps the small CPU work from oversubscribing the cores
torch.set_num_threads(1)


def _two_ranks(cmd, cwd):
    """Run ``cmd`` as ranks 0 and 1 of one group; both must exit 0."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(cmd, env=env, cwd=cwd,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, f"rank failed:\n{text[-3000:]}"
    return outputs


def _worker_module():
    spec = importlib.util.spec_from_file_location("multihost_worker_torch",
                                                  WORKER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_two_process_worker_matches_one_process(tmp_path):
    out = tmp_path / "metrics.json"
    _two_ranks([sys.executable, WORKER, "--device", "cpu", "--out",
                str(out)], REPO)
    got = json.loads(out.read_text())
    assert got["world_size"] == 2
    worker = _worker_module()
    one = worker.evaluate(8, "cpu", mesh=None)
    for col in worker.COLUMNS:
        np.testing.assert_array_equal(np.asarray(got["columns"][col]),
                                      np.asarray(one.columns[col]),
                                      err_msg=col)
        assert got["means"][col] == float(np.mean(one.columns[col]))


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_cli_on_two_ranks_writes_rank_zero_row(tmp_path, monkeypatch):
    cfg = Settings().replace(**ST_SETTINGS)
    config = tmp_path / "st.json"
    config.write_text(json.dumps(dataclasses.asdict(cfg)))
    (tmp_path / "two").mkdir()
    (tmp_path / "one").mkdir()
    _two_ranks([sys.executable, "-m", "rl_mpc_lanemerging_torch.main",
                str(config), "--device", "cpu", "--csv", "rows.csv"],
               str(tmp_path / "two"))
    monkeypatch.chdir(tmp_path / "one")
    tmain.main([str(config), "--device", "cpu", "--csv", "rows.csv"])
    two, one = (_rows(tmp_path / d / "rows.csv") for d in ("two", "one"))
    assert len(two) == len(one) == 1
    assert sorted(two[0]) == sorted(one[0])
    for key, value in one[0].items():
        if "clock_time" not in key and key != "TIME":   # wall clock
            assert two[0][key] == value, key
    assert (tmp_path / "two" / "runs_torch" / "mp_st").is_dir()
