"""The CUDA kernel of the port against its plain version, on the card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Without a card its ``cuda`` tests skip.
"""

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.config import Settings
from rl_mpc_lanemerging_torch.ops import st_dp, st_kernel
from rl_mpc_lanemerging_torch.planner.mpc import weights_from_settings

CFG = Settings()
W = weights_from_settings(CFG)
KW = dict(delta_t=0.3, delta_s=0.05, w=W,
          max_offset=st_dp.default_max_offset(CFG.MAX_SPEED, 0.3, 0.05))


def random_grids(seed, batch=128, num_t=8, num_s=301):
    """Moving obstacle bands (as tests/test_pallas.py:random_batch)."""
    rng = np.random.default_rng(seed)
    obst = np.zeros((batch, num_t, num_s), bool)
    dist = np.full((batch, num_t, num_s), 1e10, np.float32)
    cells = np.arange(num_s)
    for b in range(batch):
        for _ in range(rng.integers(0, 3)):
            pos, vel = rng.uniform(0, num_s), rng.uniform(-30, 30)
            half = int(rng.integers(20, 60))
            for t in range(num_t):
                c = int(pos + vel * t)
                lo, hi = max(c - half, 0), max(min(c + half, num_s), 0)
                obst[b, t, lo:hi] = True
                gap = np.minimum(np.abs(cells - (c - half)),
                                 np.abs(cells - (c + half))) * 0.05
                dist[b, t] = np.minimum(dist[b, t], gap)
        dist[b][obst[b]] = 0
    obst[:, :, 0] = False
    s_values = (rng.uniform(-150, 0, (batch, 1))
                + cells[None, :] * 0.05).astype(np.float32)
    v0 = rng.uniform(0, 25, batch).astype(np.float32)
    a0 = rng.uniform(-5, 4, batch).astype(np.float32)
    return obst, s_values, v0, a0, dist


def _tensors(seed, device, batch=128):
    return [torch.as_tensor(x, device=device)
            for x in random_grids(seed, batch)]


def blocked_layer_grids(seed, layer=4, batch=16):
    """Random grids whose even scenarios have every cell of one layer
    blocked: their paths end at the layer before it."""
    obst, s_values, v0, a0, dist = random_grids(seed, batch)
    obst[::2, layer, :] = True
    dist[::2, layer, :] = 0
    return obst, s_values, v0, a0, dist


def test_plain_version_is_per_scenario():
    """One block per scenario on the card: a scenario's path must not depend
    on the rest of the batch."""
    args = _tensors(3, "cpu")
    whole = st_kernel.st_wavefront_reference(*args, **KW)
    part = st_kernel.st_wavefront_reference(*(x[40:47] for x in args), **KW)
    torch.testing.assert_close(part, whole[40:47], rtol=0, atol=0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_kernel_matches_plain_version_on_card(seed):
    _need_card()
    args = _tensors(seed, "cuda")
    before = st_kernel.launches
    got = st_kernel.st_wavefront(*args, **KW)
    torch.cuda.synchronize()
    assert st_kernel.launches == before + 1
    ref = st_kernel.st_wavefront_reference(*args, **KW)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7])
def test_kernel_matches_plain_version_on_card_small_batch(batch):
    _need_card()
    args = _tensors(5, "cuda", batch)
    got = st_kernel.st_wavefront(*args, **KW)
    ref = st_kernel.st_wavefront_reference(*args, **KW)
    assert got.shape == (batch, 8)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card_blocked_layer():
    _need_card()
    args = [torch.as_tensor(x, device="cuda") for x in blocked_layer_grids(6)]
    got = st_kernel.st_wavefront(*args, **KW).cpu().numpy()
    ref = st_kernel.st_wavefront_reference(*args, **KW).cpu().numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[::2, 4:] == 0.0)


@pytest.mark.cuda
def test_kernel_on_unaligned_views_and_counts_its_pairs_on_card():
    """Slices of a larger batch start at addresses that are not multiples
    of 4 bytes (rows of 301 obstacle bytes); the counter receives the pairs
    the plain banded version counts."""
    _need_card()
    args = _tensors(2, "cuda")
    part = [x[3:10] for x in args]
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = st_kernel.st_wavefront(*part, **KW, visited=visited)
    ref = st_kernel.st_wavefront_reference(*args, **KW)[3:10]
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    v0, a0, s_pad, d_pad = st_kernel._shapes_and_start(
        part[0], part[2], part[3], KW["max_offset"])
    work = []
    st_kernel._wavefront_tables_banded(
        st_kernel.fold_penalty(part[0], part[4], W, s_pad), v0, a0,
        st_kernel._kernel_constants(0.3, 0.05, W), part[0].shape[2], d_pad,
        work=work)
    assert int(visited.item()) == sum(p for p, _, _ in work) > 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    obst, sv, v0, a0, dist = _tensors(0, "cuda")
    with pytest.raises(ValueError, match="bool"):
        st_kernel.st_wavefront(obst.float(), sv, v0, a0, dist, **KW)
    with pytest.raises(ValueError, match="shape"):
        st_kernel.st_wavefront(obst, sv[:, :-1], v0, a0, dist, **KW)
    with pytest.raises(ValueError, match="on cpu"):
        st_kernel.st_wavefront(obst, sv, v0.cpu(), a0, dist, **KW)
