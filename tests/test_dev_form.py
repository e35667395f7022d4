"""Direct/diffuse split ("deviation form") engine gates.

The dev-form engine (core.rt.{doubling_dev, interaction_dev}; driver
engine "xla_dev") carries every transmission operator as diag(g) + E so no
matmul operand contains the ~1.0 direct-beam diagonal. This is what keeps
reduced-precision products (a 3-pass bf16 split, "bf16x3") accurate and
lowers the plain f32 floor of the doubling recursion. These gates pin:
  1. exact algebraic equivalence to the plain path (f64, LU),
  2. engine equivalence through rt_run_band (dev == plain bucketed schulz),
  3. the bf16x3 cliff-kill: deviation-form bf16x3 stays at the f32 floor
     on a grazing-mu doubling stack where plain bf16x3 collapses.
No reference counterpart (the reference runs f64 CUBLAS throughout).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vsmartmom.core.rt import (LayerRT, dev_to_full, interaction,
                               interaction_dev, make_added_layer,
                               make_added_layer_dev, make_rsolve, rsolve_lu)
from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom.util.quadrature import rt_set_streams


def _layer_args(S=8, n=12, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    qp = np.sort(rng.uniform(0.05, 1.0, n))
    qp[-1] = 0.5
    i_mu0 = n - 1
    wct2 = rng.uniform(0.01, 0.2, n)
    wct2[2] = 0.0                              # a zero-weight camera column
    d_vec = np.ones(n)
    d_vec[5] = -1.0                            # exercise the D-flip signs
    i0_vec = np.zeros(n)
    i0_vec[i_mu0] = 1.0
    f = lambda x: jnp.asarray(x, dtype)
    return dict(
        tau=f(rng.uniform(0.05, 0.4, S)), omega=f(rng.uniform(0.3, 0.99, S)),
        z_pp=f(rng.uniform(0.1, 1.0, (1, n, n))),
        z_mp=f(rng.uniform(0.1, 1.0, (1, n, n))),
        tau_sum=f(rng.uniform(0, 0.5, S)), qp=f(qp), wct2=f(wct2), wct02=0.5,
        i0_vec=f(i0_vec), i_mu0_n=i_mu0, n_stokes=1,
        mu0_node=float(qp[i_mu0]), mu0=float(qp[i_mu0]), d_vec=f(d_vec),
        min_qp_mu=float(qp.min()))


def test_dev_added_and_interaction_match_plain_f64():
    """Split-form doubling + adding == plain path, exactly (f64, LU)."""
    a = _layer_args()
    S, n = a["tau"].shape[0], a["qp"].shape[0]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float64), (S, n, n))
    common = (a["tau"], a["omega"], a["z_pp"], a["z_mp"], a["tau_sum"],
              a["qp"], a["wct2"], a["wct02"], a["i0_vec"], a["i_mu0_n"],
              a["n_stokes"], a["mu0_node"], a["mu0"], a["d_vec"],
              a["min_qp_mu"])
    plain = make_added_layer(*common, eye, rsolve=rsolve_lu, ndoubl_static=9)
    dev = make_added_layer_dev(*common, ndoubl_static=9, exact_eye=eye)
    for fld in LayerRT._fields:
        p, d = getattr(plain, fld), getattr(dev_to_full(dev), fld)
        assert float(jnp.abs(p - d).max()) < 1e-12 * float(
            jnp.abs(p).max()) + 1e-300, fld
    c_plain = interaction(plain, plain, eye, rsolve=rsolve_lu)
    c_dev = interaction_dev(dev, dev, exact_eye=eye)
    for fld in LayerRT._fields:
        p, d = getattr(c_plain, fld), getattr(dev_to_full(c_dev), fld)
        assert float(jnp.abs(p - d).max()) < 1e-12 * float(
            jnp.abs(p).max()) + 1e-300, fld
    # schulz twins agree too (same iteration counts -> same residual)
    sched = (2, 3, 3, 4, 4, 4, 4, 4, 4)
    plain_s = make_added_layer(*common, eye,
                               rsolve=make_rsolve("schulz", 4),
                               ndoubl_static=9, ns_schedule=sched)
    dev_s = make_added_layer_dev(*common, ndoubl_static=9, ns_schedule=sched)
    for fld in LayerRT._fields:
        p, d = getattr(plain_s, fld), getattr(dev_to_full(dev_s), fld)
        assert float(jnp.abs(p - d).max()) < 1e-11 * (
            float(jnp.abs(p).max()) + 1e-300), fld


def _band_fixture(n_z=12, n_spec=24, seed=3):
    """Heterogeneous profile: thin stratosphere above thick scatterers
    (wide doubling-count spread — the flagship schedule-builder path)."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [10.0, 40.0],
                          pol.n)
    rng = np.random.default_rng(seed)
    tau = np.concatenate([np.full((n_z // 2, n_spec), 0.002),
                          rng.uniform(0.05, 0.3, (n_z - n_z // 2, n_spec))])
    om = rng.uniform(0.4, 0.999, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=om, zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    return pol, quad, band, surf


def test_rt_run_band_xla_dev_matches_plain_schulz():
    pol, quad, band, surf = _band_fixture()
    kw = dict(dtype=jnp.float64, max_m=3, solver="schulz", surface=surf)
    R0, _ = rt_run_band(pol, quad, band, [30.], [0.],
                        doubling_engine="xla", **kw)
    R1, _ = rt_run_band(pol, quad, band, [30.], [0.],
                        doubling_engine="xla_dev", **kw)
    assert np.abs(R1 - R0).max() < 1e-11 * np.abs(R0).max()


def test_rt_run_band_xla_dev_matches_plain_lu_f64():
    """Exact-LU f64 twin: with both engines solving exactly (no Newton-
    Schulz truncation in the comparison), the split-form algebra must
    reproduce the plain engine to f64 roundoff — the 'identical algebra'
    claim pinned at full precision rather than via f32 gate runs.
    Uniform profile: both engines then run the same static ndoubl (a
    spread profile puts plain-LU on the traced unquantized path while the
    dev engine uses quantized buckets — a discretization, not algebra,
    difference)."""
    pol, quad, band, surf = _band_fixture()
    tau_scat = np.full_like(np.asarray(band.tau), 0.3)
    tau = tau_scat + 0.1
    band = type(band)(tau=tau, omega=tau_scat / tau, zw=band.zw,
                      greeks=band.greeks)
    kw = dict(dtype=jnp.float64, max_m=3, solver="lu", surface=surf)
    R0, T0 = rt_run_band(pol, quad, band, [30.], [0.],
                         doubling_engine="xla", **kw)
    R1, T1 = rt_run_band(pol, quad, band, [30.], [0.],
                         doubling_engine="xla_dev", **kw)
    # f64 roundoff under different association order (~1e-13 rel observed)
    assert np.abs(R1 - R0).max() < 1e-11 * np.abs(R0).max()
    assert np.abs(T1 - T0).max() < 1e-11 * np.abs(T0).max()


def test_dev_bf16x3_kills_the_precision_cliff():
    """The round-3 excluded lever, reclaimed: on a grazing-mu 13-doubling
    stack plain bf16x3 collapses (>0.1 rel) while deviation-form bf16x3
    stays at/below the plain-f32 floor."""
    from vsmartmom.core.rt import doubling, doubling_dev
    rng = np.random.default_rng(1)
    S, n, nd = 16, 16, 13
    mu = np.linspace(0.02, 1.0, n)
    dtau = 1e-6
    z = 0.5 + 0.5 * rng.random((S, n, n))
    w = np.full(n, 2.0 / n)
    r0 = 0.9999 * z * (w[None, :] * dtau
                       / (mu[:, None] + mu[None, :]))[None]
    g0 = np.tile(np.exp(-dtau / mu)[None], (S, 1))
    e0 = 0.3 * 0.9999 * z * (w[None, :] * dtau
                             / np.abs(mu[:, None] - mu[None, :]
                                      + 1e-1))[None]
    t0 = e0 + g0[:, :, None] * np.eye(n)[None]
    jp0 = rng.uniform(0, dtau, (S, n))
    jm0 = rng.uniform(0, dtau, (S, n))
    ek0 = np.full(S, np.exp(-dtau / 0.5))
    eye64 = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float64), (S, n, n))
    sched = (4,) * nd

    # f64 truth (plain path)
    r64, t64, _, _ = doubling(
        jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(jp0),
        jnp.asarray(jm0), jnp.asarray(ek0), nd, eye64,
        rsolve=make_rsolve("schulz", 4), ns_schedule=sched)

    def rel(a, b):
        return float(jnp.abs(a - b).max() / jnp.abs(b).max())

    # plain f32
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    eye32 = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (S, n, n))
    r_f32, t_f32, _, _ = doubling(
        f32(r0), f32(t0), f32(jp0), f32(jm0), f32(ek0), nd, eye32,
        rsolve=make_rsolve("schulz", 4), ns_schedule=sched)
    plain_f32_err = max(rel(r_f32, r64), rel(t_f32, t64))

    # bf16x3-emulating matmul: a_hi b_lo + a_lo b_hi + a_hi b_hi
    def mm_b3(a, b):
        ah = a.astype(jnp.bfloat16).astype(jnp.float32)
        al = (a - ah).astype(jnp.bfloat16).astype(jnp.float32)
        bh = b.astype(jnp.bfloat16).astype(jnp.float32)
        bl = (b - bh).astype(jnp.bfloat16).astype(jnp.float32)
        mm = lambda x, y: jnp.einsum("nij,njk->nik", x, y)
        return mm(ah, bl) + mm(al, bh) + mm(ah, bh)

    # plain algebra at bf16x3: the cliff
    class _RS:
        @staticmethod
        def apply(left, a, x):
            n_ = a.shape[-1]
            eye2 = 2.0 * jnp.eye(n_, dtype=a.dtype)[None]
            m = eye2 - a
            for _ in range(4):
                m = mm_b3(m, eye2 - mm_b3(a, m))
            return mm_b3(left, mm_b3(m, x))
    import vsmartmom.core.rt as rtmod
    orig = rtmod.bmm
    rtmod.bmm = mm_b3
    try:
        r_b3, t_b3, _, _ = doubling(
            f32(r0), f32(t0), f32(jp0), f32(jm0), f32(ek0), nd, eye32,
            rsolve=_RS, ns_schedule=sched)
    finally:
        rtmod.bmm = orig
    plain_b3_err = max(rel(r_b3, r64), rel(t_b3, t64))

    # deviation form at bf16x3
    rd, gd, ed, _, _ = doubling_dev(
        f32(r0), f32(g0), f32(e0), f32(jp0), f32(jm0), f32(ek0),
        ns_schedule=sched, mm=mm_b3)
    td = ed + gd[:, :, None] * jnp.eye(n, dtype=jnp.float32)[None]
    dev_b3_err = max(rel(rd, r64), rel(td, t64))

    # The emulation only carries the dropped-a_lo*b_lo error (~2^-18 per
    # term). Assert the ORDERING the design claims: plain bf16x3 is well
    # above the f32 floor, dev-form bf16x3 is at/below it.
    assert plain_b3_err > 4.0 * plain_f32_err, (plain_b3_err, plain_f32_err)
    assert dev_b3_err < 1.5 * plain_f32_err, (dev_b3_err, plain_f32_err)
    assert dev_b3_err < 1e-3, dev_b3_err


def test_rt_run_band_dev_heterogeneous_34_layers():
    """Flagship decision path: 34-layer wide-spread profile, schulz,
    through rt_run_band's own schedule builder, dev engine."""
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 60.0, [30.0], pol.n)
    n_z, n_spec = 34, 16
    rng = np.random.default_rng(7)
    tau = np.concatenate([
        np.full((20, n_spec), 0.0005),
        rng.uniform(0.02, 0.25, (14, n_spec))])
    om = rng.uniform(0.3, 0.99, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=om, zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.0)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    kw = dict(dtype=jnp.float64, max_m=2, solver="schulz", surface=surf)
    R0, _ = rt_run_band(pol, quad, band, [30.], [0.],
                        doubling_engine="xla", **kw)
    R1, _ = rt_run_band(pol, quad, band, [30.], [0.],
                        doubling_engine="xla_dev", **kw)
    assert np.isfinite(R1).all()
    assert np.abs(R1 - R0).max() < 1e-10 * np.abs(R0).max()
