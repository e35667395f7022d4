"""Tiled Voigt cross-section gates (f32 line-bucketed tiles).

1. Real-arithmetic Faddeeva == the complex CEF implementation.
2. Tiled sweep == dense wofz reference at f32 tolerance.
3. VoigtPlan == one-shot wrapper; engine='tiled' == engine='dense'
   through the spectroscopy API on the CO2 parser fixture.
4. Grids ending mid-tile.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from vsmartmom.spectroscopy.voigt import (VoigtPlan, rew_hw32sd,
                                          voigt_xsec_tiled)

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_rew_matches_complex_cef():
    from vsmartmom.spectroscopy.cef import w_humlicek_weideman32_sd
    rng = np.random.default_rng(0)
    x = rng.uniform(-30, 30, 1000)
    y = 10 ** rng.uniform(-4, 1.2, 1000)
    mine = np.asarray(rew_hw32sd(jnp.asarray(x), jnp.asarray(y)))
    ref = np.real(np.asarray(w_humlicek_weideman32_sd(
        jnp.asarray(x + 1j * y))))
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-12)


def _rand_problem(n_l=400, n_g=2100, seed=3):
    rng = np.random.default_rng(seed)
    grid = np.linspace(13000.0, 13080.0, n_g)
    nu = rng.uniform(12995.0, 13085.0, n_l)
    S = 10 ** rng.uniform(-3, 0, n_l)
    gd = rng.uniform(0.01, 0.03, n_l)
    yv = rng.uniform(0.05, 4.0, n_l)
    return grid, nu, S, gd, yv


def _dense_truth(grid, nu, S, gd, yv, cut):
    from scipy.special import wofz
    SQRT_LN2, C = 0.8325546111576977, 0.46971863934982566
    dx = grid[None, :] - nu[:, None]
    prof = (C / gd[:, None]
            * wofz(SQRT_LN2 / gd[:, None] * dx + 1j * yv[:, None]).real)
    return np.where(np.abs(dx) <= cut, S[:, None] * prof, 0).sum(0)


def test_kernel_vs_dense():
    grid, nu, S, gd, yv = _rand_problem()
    cut = 10.0
    sig = voigt_xsec_tiled(grid, nu, S, gd, yv, cut)
    dense = _dense_truth(grid, nu, S, gd, yv, cut)
    assert np.abs(sig - dense).max() / dense.max() < 5e-4


def test_plan_matches_oneshot():
    grid, nu, S, gd, yv = _rand_problem(seed=5)
    cut = 8.0
    plan = VoigtPlan(grid, nu, cut)
    sig_plan = np.asarray(plan.run(nu, S, gd, yv))
    sig_once = voigt_xsec_tiled(grid, nu, S, gd, yv, cut)
    np.testing.assert_allclose(sig_plan, sig_once, rtol=2e-5,
                               atol=1e-6 * sig_once.max())


def test_engine_pallas_matches_dense_api():
    """engine='tiled' (the GPU's absorption engine) == engine='dense'."""
    from vsmartmom.spectroscopy.hitran import read_hitran
    from vsmartmom.spectroscopy.voigt import (
        compute_absorption_cross_section, make_hitran_model)
    ht = read_hitran(os.path.join(DATA, "testCO2.par"))
    model = make_hitran_model(ht, wing_cutoff=40.0)
    grid = np.arange(6214.0, 6214.8, 0.002)
    ref = np.asarray(compute_absorption_cross_section(
        model, grid, 1000.0, 296.0))
    got = np.asarray(compute_absorption_cross_section(
        model, grid, 1000.0, 296.0, engine="tiled"))
    assert np.abs(got - ref).max() < 1e-3 * ref.max() + 1e-30


@pytest.mark.parametrize("n_g", [700, 2100])
def test_tiles_with_partial_last_tile_match_dense(n_g):
    """Grids that end mid-tile: the padded points never see a line and
    the real points of the last tile keep f32 accuracy."""
    grid, nu, S, gd, yv = _rand_problem(n_l=150, n_g=n_g, seed=7)
    assert n_g % 256
    got = np.asarray(VoigtPlan(grid, nu, 6.0).run(nu, S, gd, yv))
    dense = _dense_truth(grid, nu, S, gd, yv, 6.0)
    assert got.shape == (n_g,)
    assert np.abs(got - dense).max() / dense.max() < 5e-4
