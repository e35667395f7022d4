"""vsmartmom: hyperspectral polarized radiative transfer in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of vSmartMOM.jl
(RadiativeTransfer.jl): Matrix Operator Method doubling-adding RT, HITRAN
line-by-line absorption, Mie/aerosol scattering, Rayleigh, BRDF surfaces,
rotational-Raman inelastic scattering, and forward-mode differentiability —
batched over the hyperspectral axis and sharded across device meshes.

Public API (mirrors the reference exports, src/vSmartMOM.jl:49):
  parameters_from_yaml, default_parameters, model_from_parameters, rt_run
"""

from vsmartmom.config.params import default_parameters, parameters_from_yaml
from vsmartmom.core.api import rt_run
from vsmartmom.core.model import model_from_parameters

__version__ = "0.1.0"

__all__ = ["parameters_from_yaml", "default_parameters",
           "model_from_parameters", "rt_run", "__version__"]
