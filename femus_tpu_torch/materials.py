"""Physical materials and nondimensionalization parameters.

Equivalent of the reference layer 01 (src/01_parameters/Parameter.hpp:33-50,
src/01_materials/Material.hpp:34, Fluid.hpp:34, Solid.hpp:35):

- ``Parameter``: reference scales (Lref, Uref, DeltaTref) used to
  nondimensionalize the equations.
- ``Fluid``: Newtonian fluid; Reynolds number Re = rho*Uref*Lref/mu and its
  inverse IRe (Fluid.cpp:64-67) — the coefficient that multiplies the viscous
  term in the nondimensional Navier-Stokes forms.
- ``Solid``: constitutive model selection by name (Solid.cpp:62-95) and Lame
  parameters from (E, nu) (Solid.cpp:110-122); the names/model ids match the
  reference so FSI apps translate directly.

These are plain frozen dataclasses: they are consumed on host at form-build
time (their scalars are closed over by a form or passed as aux scalars);
nothing here touches the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# model-name -> (model id, penalty, mass_penalty), Solid.cpp:62-95
_SOLID_MODELS = {
    "Linear_elastic": (0, False, False),
    "Saint-Venant": (0, False, False),
    "Saint-Venant-Penalty": (0, True, False),
    "Neo-Hookean": (1, False, False),
    "Neo-Hookean-MassPenalty": (1, False, True),
    "Neo-Hookean-BW": (2, False, False),
    "Neo-Hookean-BW-MassPenalty": (2, False, True),
    "Neo-Hookean-BW-Penalty": (3, True, False),
    "Neo-Hookean-AB-Penalty": (4, True, False),
    "Mooney-Rivlin": (5, False, False),
    "Mooney-Rivlin-MassPenalty": (5, False, True),
}


@dataclasses.dataclass(frozen=True)
class Parameter:
    """Reference scales for nondimensionalization (Parameter.hpp:33)."""
    lref: float = 1.0
    uref: float = 1.0
    delta_t_ref: float = 1.0


@dataclasses.dataclass(frozen=True)
class Gravity:
    """Constant body-force vector (Parameter.hpp:59)."""
    g: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Material:
    """Base material (Material.hpp:34): density + thermal properties."""
    parameter: Parameter = Parameter()
    density: float = 1.0
    thermal_conductivity: float = 1.0
    heat_capacity: float = 1.0
    thermal_expansion: float = 1.0


@dataclasses.dataclass(frozen=True)
class Fluid(Material):
    """Newtonian fluid (Fluid.hpp:34). ``ire`` = 1/Re is the nondimensional
    viscosity coefficient used by the NS forms (Fluid.cpp:64-67)."""
    viscosity: float = 1.0

    @property
    def reynolds(self) -> float:
        p = self.parameter
        return self.density * p.uref * p.lref / self.viscosity

    @property
    def ire(self) -> float:
        return 1.0 / self.reynolds

    @property
    def prandtl(self) -> float:
        # mu * cp / k (used by Boussinesq-type coupled problems)
        return self.viscosity * self.heat_capacity / self.thermal_conductivity


@dataclasses.dataclass(frozen=True)
class Solid(Material):
    """Solid with constitutive model by name (Solid.cpp:42-122)."""
    young_module: float = 1.0
    poisson_coeff: float = 0.3
    model: str = "Linear_elastic"

    def __post_init__(self):
        if self.model not in _SOLID_MODELS:
            raise ValueError(f"unknown solid model '{self.model}'; "
                             f"one of {sorted(_SOLID_MODELS)}")
        if not (0.0 <= self.poisson_coeff <= 0.5):
            raise ValueError("Poisson coefficient must be in [0, 0.5]")
        _, penalty, _ = _SOLID_MODELS[self.model]
        if penalty and self.poisson_coeff >= 0.5:
            raise ValueError("penalty models require nu < 0.5")

    @property
    def physical_model(self) -> int:
        return _SOLID_MODELS[self.model][0]

    @property
    def penalty(self) -> bool:
        return _SOLID_MODELS[self.model][1]

    @property
    def mass_penalty(self) -> bool:
        return _SOLID_MODELS[self.model][2]

    @property
    def lame_lambda(self) -> float:
        # Solid.cpp:110-121; nu = 0.5 -> incompressible, lambda -> "infinity"
        nu = self.poisson_coeff
        if nu < 0.5:
            return self.young_module * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return 1.0e100

    @property
    def lame_shear_modulus(self) -> float:
        return self.young_module / (2.0 * (1.0 + self.poisson_coeff))
