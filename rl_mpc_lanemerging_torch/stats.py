"""Host-side statistics aggregation and CSV reporting.

Port of ``rl_mpc_lanemerging_tpu/stats.py`` (reference stats.py:12-199):
the device produces an ``EpisodeStats`` of tensors per batch (already-reduced
per-episode scalars), and this module
turns batches of those into the same per-run report the reference prints —
mean +- standard error per metric (stats.py:115-143) — and appends the same
``run_data.csv`` row schema (metric columns + ``_std`` columns + scalar
settings + ST/traffic signatures, stats.py:160-199).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from .config import Settings
from .sim.episode import BIN_EDGES, EpisodeStats

__all__ = ["StatsAggregator"]

logger = logging.getLogger(__name__)


def _sem(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    if x.size < 2:
        return float("nan")
    return float(np.std(x, ddof=1) / np.sqrt(x.size))


class StatsAggregator:
    """Accumulates per-episode metrics across device batches."""

    def __init__(self, cfg: Settings):
        self.cfg = cfg
        self.columns: Dict[str, List[float]] = {
            "crashed": [], "merged": [], "mean_speed": [], "max_speed": [],
            "mean_abs_jerk": [], "closest_distance": [],
            "mean_closest_distance": [], "mean_abs_jerk_merged": [],
            "closest_distance_merged": [], "mean_closest_distance_merged": [],
            "mean_disruption": [], "max_disruption": [],
            "total_disruption": [], "disruption_time": [],
            "time_taken": [], "time_to_merge": [],
            "clock_time_per_episode": [], "clock_time_per_step": [],
        }
        self.custom: Dict[str, List[float]] = {}
        self.bin_counts = np.zeros(len(BIN_EDGES) - 1)
        self.bin_jerk = np.zeros(len(BIN_EDGES) - 1)
        self.bin_speed = np.zeros(len(BIN_EDGES) - 1)
        self.bin_aux = np.zeros(len(BIN_EDGES) - 1)
        self.episodes = 0

    def add_batch(self, stats: EpisodeStats,
                  wall_clock_seconds: Optional[float] = None,
                  custom: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Ingest one device batch (mirrors per-episode ingestion at
        stats.py:43-85, vectorized).  ``wall_clock_seconds`` is the host
        time for the whole batch; per-episode clock time is amortized."""
        s = {k: v.detach().cpu().numpy() for k, v in stats._asdict().items()}
        b = s["crashed"].shape[0]
        tick = self.cfg.TICK_LENGTH
        ticks = np.maximum(s["ticks"], 1)

        crashed = s["crashed"].astype(bool)
        merged = s["merged"].astype(bool)
        mean_speed = s["sum_speed"] / ticks
        mean_jerk = s["sum_abs_jerk"] / ticks
        time_taken = s["ticks"] * tick
        has_closest = s["n_closest"] > 0
        mean_closest = np.where(has_closest,
                                s["sum_closest"] / np.maximum(s["n_closest"],
                                                              1), np.nan)
        min_closest = np.where(has_closest, s["min_closest"], np.nan)
        has_disr = s["n_disruption"] > 0
        mean_disr = np.where(has_disr, s["sum_disruption"]
                             / np.maximum(s["n_disruption"], 1), np.nan)

        c = self.columns
        c["crashed"].extend(crashed.astype(float))
        c["merged"].extend(merged.astype(float))
        c["mean_speed"].extend(mean_speed)
        c["max_speed"].extend(s["max_speed"])
        c["mean_abs_jerk"].extend(mean_jerk)
        c["time_taken"].extend(time_taken)
        c["closest_distance"].extend(min_closest[has_closest])
        c["mean_closest_distance"].extend(mean_closest[has_closest])
        c["mean_disruption"].extend(mean_disr[has_disr])
        c["max_disruption"].extend(s["max_disruption"][has_disr])
        c["total_disruption"].extend(
            (s["sum_disruption"] * tick)[has_disr])
        c["disruption_time"].extend(
            (s["n_disruption_nonzero"] * tick)[has_disr])
        c["time_to_merge"].extend(time_taken[merged])
        c["mean_abs_jerk_merged"].extend(mean_jerk[merged])
        c["closest_distance_merged"].extend(
            min_closest[merged & has_closest])
        c["mean_closest_distance_merged"].extend(
            mean_closest[merged & has_closest])
        if wall_clock_seconds is not None:
            per_ep = wall_clock_seconds / b
            c["clock_time_per_episode"].extend([per_ep] * b)
            c["clock_time_per_step"].extend(
                wall_clock_seconds / max(int(np.sum(s["ticks"])), 1)
                * np.ones(b))

        self.bin_counts += s["bin_counts"].sum(axis=0)
        self.bin_jerk += s["bin_jerk"].sum(axis=0)
        self.bin_speed += s["bin_speed"].sum(axis=0)
        self.bin_aux += s["bin_aux"].sum(axis=0)
        self.episodes += b

        if custom:
            for k, v in custom.items():
                self.custom.setdefault(k, []).extend(np.asarray(v).ravel())

    # ------------------------------------------------------------------
    def get_stat_averages(self, report_stds: bool = False):
        averages, stds = {}, {}
        data = dict(self.columns)
        data.update(self.custom)
        for name, vals in data.items():
            arr = np.asarray(vals, np.float64)
            averages[name] = float(np.mean(arr)) if arr.size else float("nan")
            stds[name] = _sem(arr)
        if report_stds:
            return averages, stds
        return averages

    def print_stats(self) -> None:
        """Mean +- SEM console/log report (stats.py:115-143) plus the
        x-binned jerk profile."""
        avg_jerks = self.bin_jerk / np.maximum(self.bin_counts, 1)
        print("Average jerks per segment:")
        for i in range(len(self.bin_counts)):
            print("{} to {}: {}".format(BIN_EDGES[i], BIN_EDGES[i + 1],
                                        avg_jerks[i]))
        averages, stds = self.get_stat_averages(report_stds=True)
        for name in averages:
            message = "{}: {} ± {}".format(name, averages[name],
                                                stds[name])
            logger.info(message)
            print(message)

    def save_plots(self, run_dir: str) -> list:
        """Matplotlib artifacts: x-binned mean |jerk| and speed bars
        (reference stats.py:124-133) and, when a combined controller ran,
        the ST-takeover proportion vs x (reference dqn.py:215-226
        ``plot_st_proportion``)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:                       # pragma: no cover
            logger.warning("matplotlib unavailable; skipping stat plots")
            return []
        os.makedirs(run_dir, exist_ok=True)
        centers = (BIN_EDGES[:-1] + BIN_EDGES[1:]) / 2.0
        counts = np.maximum(self.bin_counts, 1)
        written = []

        def bar(values, title, fname):
            fig, ax = plt.subplots(figsize=(7, 4))
            ax.bar(centers, values, width=18.0)
            ax.set_xlabel("x position (m)")
            ax.set_title(title)
            path = os.path.join(run_dir, fname)
            fig.savefig(path, dpi=100)
            plt.close(fig)
            written.append(path)

        bar(self.bin_jerk / counts, "Mean |jerk| per x segment",
            "jerk_by_x.png")
        bar(self.bin_speed / counts, "Mean speed per x segment",
            "speed_by_x.png")
        if self.bin_aux.sum() > 0:
            bar(self.bin_aux / counts, "ST-takeover proportion per x",
                "st_proportion_by_x.png")
        return written

    # ------------------------------------------------------------------
    def get_stat_report_row_dict(self) -> dict:
        """CSV row: metrics + _std columns + scalar settings + signatures
        (reference stats.py:160-190)."""
        averages, stds = self.get_stat_averages(report_stds=True)
        columns: dict = {}
        for name in averages:
            columns[name] = averages[name]
            columns[name + "_std"] = stds[name]
        for key, value in self.cfg.export_settings().items():
            if isinstance(value, (str, int, float, bool)):
                columns[key] = value
        cfg = self.cfg
        if cfg.USE_ALTERNATE_TRAFFIC_DISTRIBUTION:
            traffic = "joseph_{}".format(cfg.TRAFFIC_DENSITY)
        elif cfg.USE_SIMPLE_TRAFFIC_DISTRIBUTION:
            static = "varying" if cfg.VARY_TRAFFIC_START_TIMES else "constant"
            traffic = "uniform-{}-{}-{}".format(
                cfg.OTHER_CAR_SPEED, cfg.BASE_TRAFFIC_INTERVAL, static)
        else:
            traffic = "harsh"
        columns["ST_DESCRIPTION"] = "st-{}-{}-{}-{}-{}-{}-{}-{}".format(
            cfg.V_WEIGHT, cfg.A_WEIGHT, cfg.J_WEIGHT, cfg.A_WEIGHT,
            cfg.MIN_ALLOWED_DISTANCE, cfg.CRASH_MIN_S,
            cfg.START_UNCERTAINTY, cfg.UNCERTAINTY_PER_SECOND)
        columns["TRAFFIC_DESCRIPTION"] = traffic
        import datetime
        columns["TIME"] = datetime.datetime.now().isoformat()
        return columns

    def add_csv_data(self, path: str) -> None:
        """Append one row to the CSV at ``path`` (stats.py:192-199).

        Strictly append-only: existing rows are never re-parsed or
        re-formatted (the old pandas read/concat/rewrite churned float
        formatting of prior results on every append).  New metric columns
        extend the header and pad existing lines with empty trailing
        fields, byte-identical otherwise; floats are written with repr()
        (shortest round-trip form) for a stable format.
        """
        import csv
        import io

        row = self.get_stat_report_row_dict()

        def fmt(v):
            if v is None:
                return ""
            if isinstance(v, float):
                return repr(v)
            if isinstance(v, (np.floating,)):
                return repr(float(v))
            return str(v)

        if not os.path.exists(path):
            header = list(row)
            with open(path, "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(header)
                w.writerow([fmt(row.get(k)) for k in header])
            return

        with open(path, "r", newline="") as fh:
            lines = fh.read().splitlines()
        header = next(csv.reader(io.StringIO(lines[0])))
        new_cols = [k for k in row if k not in header]
        if new_cols:
            header = header + new_cols
            buf = io.StringIO()
            csv.writer(buf).writerow(new_cols)
            lines[0] = lines[0] + "," + buf.getvalue().rstrip("\r\n")
            pad = "," * len(new_cols)
            lines[1:] = [ln + pad for ln in lines[1:]]
        buf = io.StringIO()
        csv.writer(buf).writerow([fmt(row.get(k)) for k in header])
        lines.append(buf.getvalue().rstrip("\r\n"))
        with open(path, "w", newline="") as fh:
            fh.write("\n".join(lines) + "\n")
