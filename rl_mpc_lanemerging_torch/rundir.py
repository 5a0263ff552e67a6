"""Per-run directory: resolved settings, logs, source snapshot, scalars.

Re-design of the reference's run-dir observability (reference:
config.py:172-193 ``setup_logging``/``dump_src``): every task gets a
directory under ``runs_torch/<LOG_DIR>`` holding

* ``settings.json`` — the fully-resolved configuration (config.py:190-192),
* ``out.log``       — the Python logging stream (config.py:189-191),
* ``src/``          — a snapshot of the framework sources (config.py:172-177),
* ``scalars.csv``   — append-only training/eval scalars, the TensorBoard
  equivalent of the reference's ``SummaryWriter`` calls (dqn.py:259,
  308-309, 353-354).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Mapping, Optional

from .config import Settings

__all__ = ["RunDir", "setup_run_dir", "RUNS_ROOT"]

# The port's run directories live apart from the JAX package's tracked
# ``runs/`` tree (gitignored).
RUNS_ROOT = "runs_torch"

logger = logging.getLogger(__name__)


class RunDir:
    """Handle to one run directory with scalar logging."""

    def __init__(self, path: str):
        self.path = path
        self._scalars_path = os.path.join(path, "scalars.csv")
        self._scalar_keys: Optional[list] = None
        self._rotated = False

    def log_scalars(self, step: int, values: Mapping[str, float]) -> None:
        """Append one scalar row (TensorBoard-equivalent; reference
        dqn.py:308-309 logs loss/epsilon, dqn.py:721-722 eval metrics).

        A pre-existing ``scalars.csv`` from an earlier run is rotated to
        ``scalars.<n>.csv`` on this RunDir's *first* write — lazily, so a
        re-run that never logs scalars (EVALUATE_* into a training
        LOG_DIR) leaves the training history untouched (ADVICE r4)."""
        if not self._rotated:
            self._rotated = True
            if os.path.exists(self._scalars_path):
                n = 1
                while os.path.exists(os.path.join(self.path,
                                                  f"scalars.{n}.csv")):
                    n += 1
                os.rename(self._scalars_path,
                          os.path.join(self.path, f"scalars.{n}.csv"))
        keys = sorted(values)
        header_needed = not os.path.exists(self._scalars_path)
        if self._scalar_keys is None:
            self._scalar_keys = keys
        with open(self._scalars_path, "a") as fh:
            if header_needed:
                fh.write(",".join(["step"] + keys) + "\n")
            fh.write(",".join([str(step)] + [repr(float(values[k]))
                                             for k in keys]) + "\n")

    def save_json(self, name: str, payload) -> None:
        with open(os.path.join(self.path, name), "w") as fh:
            json.dump(payload, fh, indent=1, default=str)


def _dump_src(run_path: str) -> None:
    """Snapshot the framework sources into the run dir (reference
    config.py:172-177 copies every ``*.py`` beside the entry point)."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(run_path, "src")
    os.makedirs(dst, exist_ok=True)
    for root, dirs, files in os.walk(pkg_dir):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        rel = os.path.relpath(root, pkg_dir)
        for fname in files:
            if fname.endswith(".py"):
                out_dir = os.path.join(dst, rel) if rel != "." else dst
                os.makedirs(out_dir, exist_ok=True)
                shutil.copy2(os.path.join(root, fname),
                             os.path.join(out_dir, fname))


def setup_run_dir(cfg: Settings, snapshot_src: bool = True) -> RunDir:
    """Create ``runs_torch/<LOG_DIR>``, dump resolved settings + sources, and
    attach a file handler for ``out.log`` (reference config.py:179-193).

    Scalar-file rotation (so a rerun never appends mixed-schema rows
    under an old header, ADVICE r3) happens lazily inside
    ``RunDir.log_scalars`` — only when this run actually writes scalars
    (ADVICE r4: eager rotation here shuffled training history whenever
    an EVALUATE_* task reused a training LOG_DIR)."""
    path = os.path.join(RUNS_ROOT, cfg.LOG_DIR)
    os.makedirs(path, exist_ok=True)
    run = RunDir(path)

    settings = {k: v for k, v in dataclasses.asdict(cfg).items()}
    run.save_json("settings.json", settings)
    if snapshot_src:
        _dump_src(path)

    root = logging.getLogger()
    log_file = os.path.abspath(os.path.join(path, cfg.LOG_FILE))
    if not any(isinstance(h, logging.FileHandler)
               and getattr(h, "baseFilename", None) == log_file
               for h in root.handlers):
        handler = logging.FileHandler(log_file)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
    logger.info("Run directory ready: %s", path)
    return run
