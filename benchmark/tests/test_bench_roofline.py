"""K1's bytes and operations, counted as the repository's chip_smoke.py
counts them."""

import types

import pytest
import torch

from harness import roofline
from reference.settings import params


def test_bytes_at_chip_smokes_snapshot():
    """chip_smoke's 128 realistic st_default grids: 661,612 window cells
    make its 3,327,516 bytes (PERF.md's K1 bound, 0.000993 ms)."""
    assert roofline.k1_bytes(661_612, 128, 18) == 3_327_516
    assert roofline.k1_bytes(661_612, 128, 18) / roofline.HBM_BYTES_PER_S \
        == pytest.approx(0.000993e-3, rel=1e-3)


def test_least_time_is_the_larger_bound():
    by_bytes = roofline.k1_least_s(661_612, 0, 0, 128, 18)
    assert by_bytes == pytest.approx(3_327_516 / 3.35e12)
    by_ops = roofline.k1_least_s(0, 10 ** 9, 0, 1, 18)
    assert by_ops == pytest.approx(4e9 / 67e12)


def _grids(batch, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    obstacles = torch.rand((batch, p.num_t, p.num_s), generator=g) > 0.97
    distances = torch.rand((batch, p.num_t, p.num_s), generator=g) * 40.0
    distances = torch.where(obstacles, 0.0, distances)
    v0 = 5.0 + 20.0 * torch.rand((batch,), generator=g)
    a0 = -2.0 + 4.0 * torch.rand((batch,), generator=g)
    return obstacles, distances, v0, a0


def test_work_equals_the_programs_banded_count():
    """The counter is the port's own banded algorithm's ``work`` record
    (ops/st_kernel.py), summed; a short horizon keeps it quick."""
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import st_kernel
    from rl_mpc_lanemerging_torch.planner import mpc
    settings = {"FUTURE_T": 1.5, "FUTURE_S": 60.0}
    p = params(settings)
    cfg = Settings().replace(**settings)
    obstacles, distances, v0, a0 = _grids(3, p)
    w = mpc.weights_from_settings(cfg)
    s_pad, d_pad = st_kernel.kernel_shapes(p.num_s, mpc._max_offset(cfg))
    pen = st_kernel.fold_penalty(obstacles, distances, w, s_pad)
    consts = st_kernel._kernel_constants(cfg.T_DISCRETIZATION,
                                         cfg.S_DISCRETIZATION, w)
    work = []
    st_kernel._wavefront_tables_banded(pen, v0, a0, consts, p.num_s, d_pad,
                                       work=work)
    want = tuple(sum(x[i] for x in work) for i in range(3))
    assert roofline.k1_work(obstacles, distances, v0, a0, p, block=2) == want
    assert want[0] > 0 and want[2] > 0


def test_settings_namespace_derives_grid_sizes():
    p = params({})
    assert (p.num_t, p.num_s, p.fine_horizon) == (18, 3001, 26)
    assert isinstance(p, types.SimpleNamespace)
