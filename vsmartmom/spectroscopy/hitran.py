"""HITRAN .par fixed-width parser and line table.

ref: src/Absorption/read_hitran.jl:14-68 and Absorption/types.jl:24-63.
The 160-character HITRAN2004+ format: 19 fixed-width fields per line.
Parsed into numpy column arrays (struct-of-arrays) for vectorized line
preparation on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# (name, width, kind): the HITRAN2004 160-char record layout
_FIELDS = [
    ("mol", 2, int), ("iso", 1, int), ("nu", 12, float), ("sw", 10, float),
    ("a", 10, float), ("gamma_air", 5, float), ("gamma_self", 5, float),
    ("elower", 10, float), ("n_air", 4, float), ("delta_air", 8, float),
    ("global_upper_quanta", 15, str), ("global_lower_quanta", 15, str),
    ("local_upper_quanta", 15, str), ("local_lower_quanta", 15, str),
    ("ierr", 6, str), ("iref", 12, str), ("line_mixing_flag", 1, str),
    ("gp", 7, float), ("gpp", 7, float),
]


class HitranEmptyError(Exception):
    """No matching records found in the HITRAN file."""


@dataclasses.dataclass
class HitranTable:
    """Column-major HITRAN line list (ref: Absorption/types.jl:24-63)."""
    mol: np.ndarray
    iso: np.ndarray
    nu: np.ndarray            # transition wavenumber [cm^-1]
    sw: np.ndarray            # line intensity at 296 K
    a: np.ndarray             # Einstein A
    gamma_air: np.ndarray     # air-broadened HWHM
    gamma_self: np.ndarray    # self-broadened HWHM
    elower: np.ndarray        # lower-state energy [cm^-1]
    n_air: np.ndarray         # T-dependence exponent of gamma_air
    delta_air: np.ndarray     # pressure shift
    global_upper_quanta: list
    global_lower_quanta: list
    local_upper_quanta: list
    local_lower_quanta: list
    ierr: list
    iref: list
    line_mixing_flag: list
    gp: np.ndarray            # upper-state statistical weight
    gpp: np.ndarray           # lower-state statistical weight

    def __len__(self):
        return len(self.nu)


def _parse_num(s: str, kind):
    s = s.strip()
    if not s:
        return kind(0)
    try:
        return kind(s)
    except ValueError:
        return kind(0)


def read_hitran(filepath: str, mol: int = -1, iso: int = -1,
                nu_min: float = 0.0, nu_max: float = np.inf,
                min_strength: float = 0.0,
                engine: str = "auto") -> HitranTable:
    """Parse a HITRAN .par file with optional molecule/isotope/range filters.

    engine: 'auto' uses the native C++ scanner (vsmartmom/native) when it
    compiles — ~50x faster on million-line files — and falls back to this
    pure-Python parser; force with 'native' / 'python'.
    ref: src/Absorption/read_hitran.jl:14-68
    """
    if engine in ("auto", "native"):
        try:
            from vsmartmom.spectroscopy.hitran_native import \
                read_hitran_native
            return read_hitran_native(filepath, mol, iso, nu_min, nu_max,
                                      min_strength)
        except HitranEmptyError:
            raise
        except Exception:
            if engine == "native":
                raise
    starts = np.cumsum([0] + [w for _, w, _ in _FIELDS])
    cols = {name: [] for name, _, _ in _FIELDS}

    with open(filepath) as f:
        for ln in f:
            m = _parse_num(ln[starts[0]:starts[1]], int)
            i = _parse_num(ln[starts[1]:starts[2]], int)
            nu = _parse_num(ln[starts[2]:starts[3]], float)
            sw = _parse_num(ln[starts[3]:starts[4]], float)
            if not ((mol in (-1, m)) and (iso in (-1, i))
                    and (nu_min <= nu <= nu_max) and sw >= min_strength):
                continue
            for k, (name, _, kind) in enumerate(_FIELDS):
                raw = ln[starts[k]:starts[k + 1]]
                cols[name].append(raw if kind is str else _parse_num(raw, kind))

    if not cols["nu"]:
        raise HitranEmptyError(
            f"No matching HITRAN records in {filepath} "
            f"(mol={mol}, iso={iso}, nu=[{nu_min}, {nu_max}])")

    arr = {name: (np.asarray(v) if kind is not str else v)
           for (name, _, kind), v in
           ((fld, cols[fld[0]]) for fld in _FIELDS)}
    return HitranTable(
        mol=arr["mol"], iso=arr["iso"], nu=arr["nu"], sw=arr["sw"],
        a=arr["a"], gamma_air=arr["gamma_air"], gamma_self=arr["gamma_self"],
        elower=arr["elower"], n_air=arr["n_air"], delta_air=arr["delta_air"],
        global_upper_quanta=arr["global_upper_quanta"],
        global_lower_quanta=arr["global_lower_quanta"],
        local_upper_quanta=arr["local_upper_quanta"],
        local_lower_quanta=arr["local_lower_quanta"],
        ierr=arr["ierr"], iref=arr["iref"],
        line_mixing_flag=arr["line_mixing_flag"],
        gp=arr["gp"], gpp=arr["gpp"])


def hitran_table_from_arrays(mol: int, iso: int, nu, sw, elower, gamma_air,
                             n_air, delta_air,
                             gamma_self=None) -> "HitranTable":
    """Build a HitranTable from bare line-parameter arrays.

    Used for full-precision binary line lists (npz) — the fixed-width .par
    format quantizes gamma to 4 decimals and S to 4 significant digits,
    which matters when a list is *reconstructed by fitting* rather than
    measured (tools/fit_linelist.py): single-condition fits land between
    the .par lattice points. ref: the reference only reads .par
    (read_hitran.jl); binary tables are this framework's extension.
    """
    n = len(nu)
    z = np.zeros(n)
    blank = [""] * n
    return HitranTable(
        mol=np.full(n, mol, dtype=np.int64),
        iso=np.full(n, iso, dtype=np.int64),
        nu=np.asarray(nu, np.float64), sw=np.asarray(sw, np.float64),
        a=z.copy(),
        gamma_air=np.asarray(gamma_air, np.float64),
        gamma_self=np.asarray(gamma_self if gamma_self is not None
                              else gamma_air, np.float64),
        elower=np.asarray(elower, np.float64),
        n_air=np.asarray(n_air, np.float64),
        delta_air=np.asarray(delta_air, np.float64),
        global_upper_quanta=blank, global_lower_quanta=blank,
        local_upper_quanta=blank, local_lower_quanta=blank,
        ierr=blank, iref=blank, line_mixing_flag=blank,
        gp=z.copy(), gpp=z.copy())


def read_linelist_npz(path: str, mol: int, iso: int = 1) -> "HitranTable":
    """Load a full-precision npz line list (theta = (n, 6) array of
    [nu0, ln S296, E'', ln gamma_air, n_air, delta_air])."""
    th = np.load(path)["theta"]
    th = th[np.argsort(th[:, 0])]
    return hitran_table_from_arrays(
        mol, iso, th[:, 0], np.exp(th[:, 1]), th[:, 2], np.exp(th[:, 3]),
        th[:, 4], th[:, 5])
