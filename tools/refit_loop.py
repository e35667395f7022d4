"""Grind the worst line-list windows with targeted refits.

Repeatedly locates the global-max residual point, runs refit_window on a
window centered there, and moves on. Windows that fail to improve are
blacklisted (+-half) so the loop walks DOWN the worst-point list instead
of hammering one stubborn blend.

Usage: VSM_FIT_DEVICE=1 python tools/refit_loop.py CO2 --hours=3
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from fit_linelist import GRID, LineSet, STATE_DIR, load_conditions, \
    synth_full  # noqa: E402
from refit_window import refit  # noqa: E402


def main(molecule, hours, half=0.6, target=2.4e-27, iters=500):
    t_end = time.time() + hours * 3600.0
    skip = []
    conds, Y = load_conditions(molecule)
    while time.time() < t_end:
        ls = LineSet(molecule)
        ls.load(os.path.join(STATE_DIR, f"{molecule}_fit.npz"))
        M = synth_full(ls, conds)
        gmax = np.abs(Y - M).max(axis=0)
        for s in skip:
            gmax[np.abs(GRID - s) < half] = 0.0
        j = int(np.argmax(gmax))
        if gmax[j] < target:
            print(f"[{molecule}] all non-blacklisted windows under "
                  f"{target:.1e}; done", flush=True)
            break
        nu_c = float(GRID[j])
        before, after = refit(molecule, nu_c, half, target, iters)
        if after >= before:
            skip.append(nu_c)
            print(f"[{molecule}] blacklisted {nu_c:.2f} "
                  f"({len(skip)} skipped)", flush=True)
    # final status refresh for the achieved gate
    if molecule == "CO2":
        import subprocess
        # on the CPU: this process may hold the card
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("VSM_FIT_DEVICE", None)
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(__file__),
                                     "co2_status.py")], env=env,
                       check=False)


if __name__ == "__main__":
    mol = sys.argv[1] if len(sys.argv) > 1 else "CO2"
    hours, half = 3.0, 0.6
    for arg in sys.argv[2:]:
        if arg.startswith("--hours="):
            hours = float(arg.split("=")[1])
        if arg.startswith("--half="):
            half = float(arg.split("=")[1])
    main(mol, hours, half=half)
