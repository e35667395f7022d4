"""Raman / Cabannes scattering cross-section coefficients.

Effective polarizability, rotational-Raman (J -> J +/- 2) line strengths
with Placzek-Teller factors and Boltzmann populations, Cabannes-line
coefficient, and depolarization ratios.

ref: src/Inelastic/src/inelastic_cross_section.jl (compute_effective_
coefficents!:1-24, compute_sigma_Rayl_coeff!:27-32,
compute_sigma_RoVibRaman_coeff!:146-293).
Cross-section coefficients are in cm^2 per (nu/cm^-1)^4 — multiply by nu^4.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from vsmartmom.inelastic.constants import (HC_BY_K, MolecularConstants,
                                           energy_levels, g_nuclear)

C_LIGHT_SI = 2.99792458e8


@dataclasses.dataclass
class RamanLines:
    """Rotational Raman line set of one molecule at temperature T.

    shifts: scattered-light wavenumber shifts [cm^-1] (Stokes < 0)
    coeffs: cross-section coefficients [cm^2 / (cm^-1)^4]
    """
    shifts: np.ndarray
    coeffs: np.ndarray
    sigma_rayl_coeff: float     # total (Cabannes incl. wings) Rayleigh coeff
    rho_depol_rayl: float
    rho_depol_rot_raman: float


def effective_polarizability(mol: MolecularConstants, nu_eff: float,
                             T: float):
    """alpha-bar(nu, T), gamma-bar and the King/depol factors.

    ref: inelastic_cross_section.jl:1-24."""
    p = mol.pol
    # nu_eff in cm^-1 -> angular frequency ratio (omega_0 in 1/s, c in cm/s)
    c_cgs = 2.99792458e10
    alpha = (p.alpha_00 * (1.0 + p.alpha_b * T + p.alpha_c * T**2)
             / (1.0 - (2.0 * np.pi * c_cgs * nu_eff / p.omega_0) ** 2))
    gamma = p.gamma_00
    eps = alpha / gamma
    gamma_c_rayl = 3.0 / (45.0 * eps**2 + 4.0)
    gamma_c_rot = 3.0 / 4.0
    rho_rayl = 2.0 * gamma_c_rayl / (1.0 + gamma_c_rayl)
    rho_rot = 2.0 * gamma_c_rot / (1.0 + gamma_c_rot)
    return alpha, gamma, gamma_c_rayl, rho_rayl, rho_rot


def rotational_raman_lines(mol: MolecularConstants, nu_eff: float, T: float,
                           j_max: int = 30) -> RamanLines:
    """J -> J+/-2 rotational Raman lines (v = 0), Boltzmann-weighted.

    sigma_coeff(J -> J') = (256/27) pi^5 g_N (2J+1) b_JJ' (N_J/N) gamma^2,
    with partition sum over v = {0, 1}; Placzek-Teller coefficients
    b_JJ-2 = 3J(J-1)/(2(2J+1)(2J-1)), b_JJ+2 = 3(J+1)(J+2)/(2(2J+1)(2J+3)).
    ref: inelastic_cross_section.jl:146-293."""
    alpha, gamma, gamma_c_rayl, rho_rayl, rho_rot = \
        effective_polarizability(mol, nu_eff, T)
    E = energy_levels(mol, v_max=1, j_max=j_max)
    j = np.arange(j_max + 1)
    g_n = g_nuclear(mol, j)
    boltz0 = np.exp(-HC_BY_K * E[0] / T)
    z_pf = np.sum(g_n * (2 * j + 1)
                  * (np.exp(-HC_BY_K * E[0] / T)
                     + np.exp(-HC_BY_K * E[1] / T)))

    k_v = (256.0 / 27.0) * np.pi**5
    with np.errstate(divide="ignore", invalid="ignore"):
        b_m2 = 3.0 * j * (j - 1.0) / (2.0 * (2 * j + 1.0) * (2 * j - 1.0))
        b_p2 = (3.0 * (j + 1.0) * (j + 2.0)
                / (2.0 * (2 * j + 1.0) * (2 * j + 3.0)))
    b_m2 = np.where(j >= 2, b_m2, 0.0)

    shifts, coeffs = [], []
    # anti-Stokes (J -> J-2): scattered shift = -(E[0,J-2] - E[0,J]) > 0
    ok = j >= 2
    shifts.append(-(E[0, j[ok] - 2] - E[0, j[ok]]))
    coeffs.append(k_v * g_n[ok] * (2 * j[ok] + 1) * b_m2[ok]
                  * boltz0[ok] * gamma**2 / z_pf)
    # Stokes (J -> J+2): shift = -(E[0,J+2] - E[0,J]) < 0
    ok = j + 2 <= j_max
    shifts.append(-(E[0, j[ok] + 2] - E[0, j[ok]]))
    coeffs.append(k_v * g_n[ok] * (2 * j[ok] + 1) * b_p2[ok]
                  * boltz0[ok] * gamma**2 / z_pf)

    sigma_rayl = (128.0 * np.pi**5 * alpha**2
                  * (1.0 + 2.0 * gamma_c_rayl) / (3.0 - 4.0 * gamma_c_rayl))
    return RamanLines(shifts=np.concatenate(shifts),
                      coeffs=np.concatenate(coeffs),
                      sigma_rayl_coeff=sigma_rayl,
                      rho_depol_rayl=rho_rayl,
                      rho_depol_rot_raman=rho_rot)


def cabannes_fraction(lines_list, vmrs, nu0: float) -> float:
    """Elastic (Cabannes) fraction of the total Rayleigh cross-section:
    sigma_Cab / (sigma_Cab + sigma_RRS) at wavenumber nu0.
    ref: inelastic_helper.jl compute_ϖ_Cabannes (:74-130, RRS terms)."""
    sig_el = sum(v * ln.sigma_rayl_coeff for ln, v in zip(lines_list, vmrs))
    sig_el *= nu0**4
    sig_rrs = sum(v * np.sum((nu0 + ln.shifts) ** 4 * ln.coeffs)
                  for ln, v in zip(lines_list, vmrs))
    return float(sig_el / (sig_el + sig_rrs))


def rayleigh_depol(lines_list, vmrs) -> float:
    """VMR-weighted Rayleigh depolarization
    (ref: inelastic_helper.jl:451-454)."""
    num = sum(v * ln.rho_depol_rayl for ln, v in zip(lines_list, vmrs))
    den = sum(vmrs)
    return float(num / den)


def vibrational_raman_lines(mol: MolecularConstants, nu_eff: float, T: float,
                            direction: str = "0to1",
                            j_max: int = 30):
    """Vibrational (Q-branch, dJ = 0) + rovibrational (dJ = +/-2) Raman
    lines for v 0->1 (Stokes, 'scattered' redward) or 1->0 (anti-Stokes).

    Uses the derivative polarizabilities alpha' = alpha00' sqrt(Be/we),
    gamma' = gamma00' sqrt(Be/we) (Buldakov et al. 1996).
    ref: inelastic_cross_section.jl compute_sigma_Rayl_VibRaman_coeff_
    hires! (:34-104) and compute_sigma_RoVibRaman_coeff! (:146-293).
    Returns (shifts, coeffs, rho_depol_vib).
    """
    assert direction in ("0to1", "1to0")
    p = mol.pol
    alpha_p = p.alpha_00_prime * np.sqrt(mol.Y[0, 1] / mol.Y[1, 0])
    gamma_p = p.gamma_00_prime * np.sqrt(mol.Y[0, 1] / mol.Y[1, 0])
    eps_p = alpha_p / gamma_p
    gamma_c_vib = 3.0 / (45.0 * eps_p**2 + 4.0)
    rho_vib = 2.0 * gamma_c_vib / (1.0 + gamma_c_vib)

    E = energy_levels(mol, v_max=1, j_max=j_max)
    j = np.arange(j_max + 1)
    g_n = g_nuclear(mol, j)
    z_pf = np.sum(g_n * (2 * j + 1)
                  * (np.exp(-HC_BY_K * E[0] / T)
                     + np.exp(-HC_BY_K * E[1] / T)))
    vi, vf = (0, 1) if direction == "0to1" else (1, 0)
    boltz = np.exp(-HC_BY_K * E[vi] / T)

    with np.errstate(divide="ignore", invalid="ignore"):
        b_jj = j * (j + 1.0) / ((2 * j - 1.0) * (2 * j + 3.0))
        b_m2 = 3.0 * j * (j - 1.0) / (2.0 * (2 * j + 1.0) * (2 * j - 1.0))
        b_p2 = (3.0 * (j + 1.0) * (j + 2.0)
                / (2.0 * (2 * j + 1.0) * (2 * j + 3.0)))
    b_m2 = np.where(j >= 2, b_m2, 0.0)

    shifts, coeffs = [], []
    # Q branch (dJ = 0): per-J gamma_C with the b_JJ anisotropy mixing;
    # b_JJ -> 0 (J = 0) is the isotropic limit: gamma_C -> 0.
    with np.errstate(divide="ignore"):
        ratio2 = (alpha_p / (np.where(b_jj == 0, 1.0, b_jj) * gamma_p)) ** 2
    gc_q = np.where(b_jj == 0, 0.0, 3.0 / (4.0 + 45.0 * ratio2))
    shifts.append(-(E[vf, j] - E[vi, j]))
    coeffs.append(128.0 * np.pi**5 * g_n * (2 * j + 1) * boltz * alpha_p**2
                  * (1.0 + 2.0 * gc_q) / (3.0 - 4.0 * gc_q) / z_pf)
    # O branch (J -> J-2)
    k_v = (256.0 / 27.0) * np.pi**5
    ok = j >= 2
    shifts.append(-(E[vf, j[ok] - 2] - E[vi, j[ok]]))
    coeffs.append(k_v * g_n[ok] * (2 * j[ok] + 1) * b_m2[ok] * boltz[ok]
                  * gamma_p**2 / z_pf)
    # S branch (J -> J+2)
    ok = j + 2 <= j_max
    shifts.append(-(E[vf, j[ok] + 2] - E[vi, j[ok]]))
    coeffs.append(k_v * g_n[ok] * (2 * j[ok] + 1) * b_p2[ok] * boltz[ok]
                  * gamma_p**2 / z_pf)
    return (np.concatenate(shifts), np.concatenate(coeffs), float(rho_vib))


def apply_lineshape(shifts, coeffs, nu0: float, grid_out,
                    temperature: float, mol_mass: float,
                    wing_cutoff_hwhm: float = 4.0):
    """Deposit discrete Raman transitions onto a hires shift grid with a
    Doppler (Gaussian) lineshape, conserving each line's integral.

    shifts/coeffs: line positions [cm^-1, relative to nu0] and strengths
    [cm^2 / (cm^-1)^4]; nu0: incident wavenumber [cm^-1]; grid_out:
    equidistant output *shift* grid [cm^-1]; mol_mass in amu. Returns
    sigma_out [cm^2 per cm^-1] on grid_out.

    ref: src/Inelastic/src/apply_lineshape.jl apply_lineshape_! — the
    reference loops transitions and mutates a view per line; here one
    (nLines, nGrid) masked broadcast does all lines at once (vmap
    friendly, and what XLA fuses into a single kernel).
    """
    shifts = np.asarray(shifts, np.float64)
    coeffs = np.asarray(coeffs, np.float64)
    grid_out = np.asarray(grid_out, np.float64)
    k_boltz, m_amu = 1.380649e-23, 1.66053906892e-27
    sqrt2ln2 = np.sqrt(2.0 * np.log(2.0))

    nu = nu0 + shifts                                  # absolute [cm^-1]
    gamma_d = (sqrt2ln2 / C_LIGHT_SI) * np.sqrt(
        k_boltz * temperature / (m_amu * mol_mass)) * nu    # HWHM [cm^-1]
    strength = coeffs * nu**4                          # [cm^2]

    in_grid = (shifts > grid_out.min()) & (shifts < grid_out.max())
    d = grid_out[None, :] - shifts[:, None]            # (nL, nG)
    mask = (np.abs(d) <= wing_cutoff_hwhm * gamma_d[:, None]) \
        & in_grid[:, None]
    ln2 = np.log(2.0)
    prof = np.sqrt(ln2 / np.pi) / gamma_d[:, None] * np.exp(
        -ln2 * (d / gamma_d[:, None]) ** 2)
    return np.sum(np.where(mask, strength[:, None] * prof, 0.0), axis=0)
