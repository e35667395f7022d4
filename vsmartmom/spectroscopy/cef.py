"""Complex error (Faddeeva) functions w(z) for Voigt lineshapes — jnp,
branchless (select-both-sides), so XLA fuses them.

ref: src/Absorption/complex_error_functions.jl (Humlicek 1982 regions,
Humlicek 1979 CPF12, Weideman 1994 32-term rational approximation).

All functions take z = x + i*y with y > 0 and return complex w(z).
Region dispatch is done with jnp.where so both (cheap, polynomial) branches
vectorize on the VPU.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_ISQRTPI = 1.0 / np.sqrt(np.pi)

# Weideman (1994) eq. 38.I, N=32 coefficients (Table I)
_W32 = np.array([
    2.5722534081245696e+00, 2.2635372999002676e+00, 1.8256696296324824e+00,
    1.3455441692345453e+00, 9.0192548936480144e-01, 5.4601397206393498e-01,
    2.9544451071508926e-01, 1.4060716226893769e-01, 5.7304403529837900e-02,
    1.9006155784845689e-02, 4.5195411053501429e-03, 3.9259136070122748e-04,
    -2.4532980269928922e-04, -1.3075449254548613e-04, -2.1409619200870880e-05,
    6.8210319440412389e-06, 4.4015317319048931e-06, 4.2558331390536872e-07,
    -4.1840763666294341e-07, -1.4813078891201116e-07, 2.2930439569075392e-08,
    2.3797557105844622e-08, 8.1248960947953431e-10, -3.2080150458594088e-09,
    -5.2310170266050247e-10, 4.1537465934749353e-10, 1.1658312885903929e-10,
    -5.5441820344468828e-11, -2.1542618451370239e-11, 8.0314997274316680e-12,
    3.7424975634801558e-12, -1.3031797863050087e-12])

# CPF12 (Humlicek 1979) constants
_CT = np.array([0.3142403762544, 0.9477883912402, 1.5976826351526,
                2.2795070805011, 3.0206370251209, 3.88972489786978])
_CA = np.array([-1.393236997981977, -0.2311524061886763, 0.1553514656420944,
                -0.006218366236965554, 9.190829861057117e-5, 6.275259577e-7])
_CB = np.array([1.011728045548831, -0.7519714696746353, 0.01255772699323164,
                0.01002200814515897, -2.420681348155727e-4,
                5.008480613664576e-7])


def humlicek1(z):
    """Humlicek (1982) region I (|x|+y > 15)."""
    return 1j * _ISQRTPI * z / (z * z - 0.5)


def humlicek2(z):
    """Humlicek (1982) region II (fortran-code variant)."""
    t = z.imag - 1j * z.real
    u = t * t
    return (t * (1.410474 + u * _ISQRTPI)) / (0.75 + u * (3.0 + u))


def humlicek3(z):
    t = z.imag - 1j * z.real
    num = (16.4955 + t * (20.20933 + t * (11.96482
           + t * (3.778987 + 0.5642236 * t))))
    den = (16.4955 + t * (38.82363 + t * (39.27121
           + t * (21.69274 + t * (6.699398 + t)))))
    return num / den


def humlicek4(z):
    t = z.imag - 1j * z.real
    u = t * t
    nom = t * (36183.31 - u * (3321.99 - u * (1540.787 - u * (219.031
          - u * (35.7668 - u * (1.320522 - u * 0.56419))))))
    den = 32066.6 - u * (24322.8 - u * (9022.23 - u * (2186.18
          - u * (364.219 - u * (61.5704 - u * (1.84144 - u))))))
    return jnp.exp(u) - nom / den


def weideman32(z):
    """Weideman (1994) 32-term rational approximation (accurate for
    moderate |z|)."""
    L = np.sqrt(32.0 / np.sqrt(2.0))
    iz = 1j * z.real - z.imag
    lmiz = L - iz
    rec = 1.0 / lmiz
    Z = (L + iz) * rec
    poly = jnp.zeros_like(z) + _W32[-1]
    for c in _W32[-2::-1]:
        poly = poly * Z + c
    return (_ISQRTPI + 2.0 * poly * rec) * rec


def _cpf12a(z):
    x, y = z.real, z.imag
    ry = 1.5 + y
    ryy = ry * ry
    wk = jnp.zeros_like(x)
    wl = jnp.zeros_like(x)
    for ct, ca, cb in zip(_CT, _CA, _CB):
        dm, dp = x - ct, x + ct
        wk = wk + ((ca * dm + cb * ry) / (dm * dm + ryy)
                   - (ca * dp - cb * ry) / (dp * dp + ryy))
        wl = wl + ((cb * dm - ca * ry) / (dm * dm + ryy)
                   + (cb * dp + ca * ry) / (dp * dp + ryy))
    return wk + 1j * wl


def _cpf12b(z):
    x, y = z.real, z.imag
    ry = 1.5 + y
    y2r = y + 3.0
    rry = 1.5 * ry
    ryry = ry * ry
    wk = jnp.zeros_like(x)
    wl = jnp.zeros_like(x)
    for ct, ca, cb in zip(_CT, _CA, _CB):
        dm, dp = x - ct, x + ct
        dm2, dp2 = dm * dm, dp * dp
        wk = wk + ((cb * (dm2 - rry) - ca * dm * y2r)
                   / ((dm2 + 2.25) * (dm2 + ryry))
                   + (cb * (dp2 - rry) + ca * dp * y2r)
                   / ((dp2 + 2.25) * (dp2 + ryry)))
        wl = wl + ((cb * dm - ca * ry) / (dm2 + ryry)
                   + (cb * dp + ca * ry) / (dp2 + ryry))
    return jnp.exp(-x * x) + y * wk + 1j * wl


def w_humlicek(z):
    """Full 4-region Humlicek (1982) w4 (ref: humlicek(z))."""
    s = jnp.abs(z.real) + z.imag
    inner = jnp.where(z.imag >= 0.195 * jnp.abs(z.real) - 0.176,
                      humlicek3(z), humlicek4(z))
    return jnp.where(s > 15.0, humlicek1(z),
                     jnp.where(s > 5.5, humlicek2(z), inner))


def w_cpf12(z):
    cond = (jnp.abs(z.real) < 18.1 * z.imag + 1.65) | (z.imag > 0.85)
    return jnp.where(cond, _cpf12a(z), _cpf12b(z))


def w_humlicek_weideman32_voigt(z):
    """|x|+y > 15: Humlicek region I; else Weideman-32."""
    s = jnp.abs(z.real) + z.imag
    return jnp.where(s > 15.0, humlicek1(z), weideman32(z))


def w_humlicek_weideman32_sd(z):
    """|x|+y >= 8: Humlicek region II; else Weideman-32 (reference default)."""
    s = jnp.abs(z.real) + z.imag
    return jnp.where(s >= 8.0, humlicek2(z), weideman32(z))


def w_weideman_n(z, n=64):
    """High-order Weideman rational approximation (near-exact; used as the
    framework's 'erfcx-class' high-accuracy CEF). Coefficients computed once
    per n via the FFT construction in Weideman (1994)."""
    coefs, L = _weideman_coefs(n)
    iz = 1j * z.real - z.imag
    lmiz = L - iz
    rec = 1.0 / lmiz
    Z = (L + iz) * rec
    poly = jnp.zeros_like(z) + coefs[-1]
    for c in coefs[-2::-1]:
        poly = poly * Z + c
    return (_ISQRTPI + 2.0 * poly * rec) * rec


_WEIDEMAN_CACHE = {}


def _weideman_coefs(n):
    """Weideman (1994) rational-approximation coefficients c_1..c_n
    (ascending powers of Z), via the FFT construction of weideman.m."""
    if n in _WEIDEMAN_CACHE:
        return _WEIDEMAN_CACHE[n]
    m = 2 * n
    m2 = 2 * m
    L = np.sqrt(n / np.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m2
    t = L * np.tan(theta)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    coefs = a[1:n + 1]          # c_1 (constant) .. c_n (Z^{n-1})
    _WEIDEMAN_CACHE[n] = (coefs, L)
    return _WEIDEMAN_CACHE[n]


CEF_REGISTRY = {
    "HumlicekWeidemann32SDErrorFunction": w_humlicek_weideman32_sd,
    "HumlicekWeidemann32VoigtErrorFunction": w_humlicek_weideman32_voigt,
    "HumlicekErrorFunction": w_humlicek,
    "CPF12ErrorFunction": w_cpf12,
    "ErfcErrorFunction": lambda z: w_weideman_n(z, 64),
    "ErfcHumliErrorFunctionVoigt": lambda z: jnp.where(
        jnp.abs(z.real) + z.imag > 15.0, humlicek1(z), w_weideman_n(z, 64)),
    "ErfcHumliErrorFunctionSD": lambda z: jnp.where(
        jnp.abs(z.real) + z.imag >= 8.0, humlicek2(z), w_weideman_n(z, 64)),
}
