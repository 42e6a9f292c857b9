"""Monolithic implicit MPM-FSI on a fixed background mesh.

Reference: ``applications/MPM_FSI`` — the background grid carries the fluid
unknowns (velocity + pressure, incompressible NS); the immersed solid is a
material-point cloud.  Inside the assembly loop the reference adds the solid
particles' inertia and internal stress to the momentum rows of their owner
elements (particle-grid transfer helpers Line.hpp:81-87,
``GetParticlesToGridMaterial``/``UpdateLineMPM``), then solves the coupled
system implicitly and updates the particles from the grid solution.

Fictitious-domain / mixture form:

- background unknowns (vel..., p) are one Assembler with the transient NS
  volume form everywhere (backward Euler, old velocity as aux fields);
- the solid enters through the engine's *particle form*
  (``Assembler.set_particle_form``): for each particle, the grid velocity
  field pushes the deformation gradient forward implicitly
  ``F^{n+1} = (I + dt grad v) F^n``; the residual gains
    inertia   (m_p − ρ_f V_p) (v(x_p) − v_p^n)/dt · φ_i(x_p)
    stress    V_p  σ_s(F^{n+1}) : ∇φ_i(x_p)
    gravity  −(m_p − ρ_f V_p) g · φ_i(x_p)
  (the ρ_f V_p subtraction removes the double-counted fictitious fluid);
- everything is differentiable, so the engine's ``vmap(jacfwd(...))``
  yields the exact monolithic Newton matrix — the adept analogue in the
  reference;
- after Newton converges: G2P — v_p ← FLIP/PIC blend, x_p += dt v(x_p),
  F_p ← (I + dt ∇v) F_p, neighbor-walk relocation (marker machinery).

Assembly, P2G and G2P run on the device; each Newton correction is a
direct sparse solve on the host (scipy ``spsolve``), and ``history`` keeps
the seconds of both apart.  Particle regrouping per step is a host pass
(static (ne, ppe) capacity — the particle_tables contract).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..assembly.bc import generate_bdc
from ..assembly.engine import Assembler, Unknown
from ..assembly.forms import navier_stokes
from ..mesh.mesh import Mesh
from ..particles.mpm import MPMState, ParticleShapes


class MonolithicMPMFSI:
    """Implicit MPM-FSI stepper: background NS + material-point solid."""

    def __init__(self, mesh: Mesh, solid_stress: Callable,
                 rho_s: float, rho_f: float, mu_f: float,
                 bc_fn: Callable, dt: float,
                 vel_family: str = "biquadratic", pres_family: str = "linear",
                 gravity: Tuple[float, ...] = (0.0, -9.81),
                 ppe: int = 16, flip: float = 0.95,
                 newton_iters: int = 8, newton_tol: float = 1e-9,
                 pin_pressure: bool = True, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.mesh = mesh
        self.dim = mesh.dim
        self.dt = dt
        self.flip = flip
        self.ppe = ppe
        self.rho_f = rho_f
        self.newton_iters = newton_iters
        self.newton_tol = newton_tol
        self.stress = solid_stress
        # one entry per step: Newton iterations, residual norms, whether the
        # loop met newton_tol, device assembly and host solve seconds
        self.history = []
        dim = self.dim
        vel_names = ["U", "V", "W"][:dim]
        self.vel_names = vel_names
        unknowns = [Unknown(n, vel_family) for n in vel_names]
        unknowns.append(Unknown("P", pres_family))
        asm = Assembler(mesh, unknowns, quad_order="fifth", dtype=self.dtype,
                        device=self.device)
        self.asm = asm
        grav = tuple(gravity[:dim])

        # fluid everywhere: transient NS, backward Euler
        ns = navier_stokes(vel=tuple(vel_names), pres="P",
                           vel_family=vel_family, pres_family=pres_family,
                           nu=mu_f / rho_f)

        def form(ops, u, aux):
            out = ns(ops, u, aux)
            dtv = aux["dt"]
            for d, vn in enumerate(vel_names):
                vh = ops.value(vel_family, u[vn])
                vo = ops.value(vel_family, aux[vn + "_old"])
                inertia = ops.t(vel_family, (vh - vo) / dtv)
                body = ops.t(vel_family, -torch.full_like(vh, grav[d]))
                out[vn] = out[vn] + inertia + body
            return out

        asm.set_volume_form(form)
        for vn in vel_names:
            asm.add_aux_field(vn + "_old", vel_family)

        eye = torch.eye(dim, dtype=self.dtype, device=self.device)

        def particle_form(u, p, aux):
            """One particle's contribution to its owner element's rows."""
            dtv = aux["dt"]
            phi, gphi = p["phi"], p["gphi"]          # (nd_v,), (nd_v, dim)
            vel = torch.stack([phi @ u[vn] for vn in vel_names])    # (dim,)
            L = torch.stack([gphi.T @ u[vn] for vn in vel_names])   # (dim, dim)
            F_new = (eye + dtv * L) @ p["F"]
            sig = solid_stress(F_new)                # Cauchy (dim, dim)
            vol = p["vol0"] * torch.linalg.det(F_new)
            dm = p["mass"] - rho_f * p["vol0"] * torch.linalg.det(p["F"])
            out = {}
            # the fluid form is kinematic (divided by rho_f), so the
            # particle terms are scaled by 1/rho_f for consistency
            for d, vn in enumerate(vel_names):
                inertia = dm * (vel[d] - p["v_old"][d]) / dtv * phi
                stress_t = vol * (gphi @ sig[d])
                body = -dm * grav[d] * phi
                out[vn] = (inertia + stress_t + body) / rho_f
            return out

        asm.set_particle_form(
            particle_form, ["phi", "gphi", "F", "vol0", "mass", "v_old"])
        generate_bdc(asm, bc_fn)
        if pin_pressure:
            # closed-cavity pressure null space: fix one pressure dof
            # (reference FixSolutionAtOnePoint, MultiLevelSolution.hpp:492)
            m = asm.dirichlet_mask.copy()
            v = asm.dirichlet_values.copy()
            m[asm.offsets["P"]] = True
            v[asm.offsets["P"]] = 0.0
            asm.set_dirichlet(m, v)

        self._assemble = asm.make_assemble_fn(pass_tables=True)
        self._tables = asm.device_tables()
        pat = asm.pattern
        self._rows = np.repeat(np.arange(pat.n_rows), pat.width)
        self._cols = pat.cols.ravel()

        # particle shape evaluation + relocation (marker machinery)
        self._vconn = torch.as_tensor(mesh.dofmap(vel_family).conn,
                                      dtype=torch.int64, device=self.device)
        self._shape_at = ParticleShapes(mesh, vel_family, self.device,
                                        self.dtype)

    def _relocate(self, x, e):
        return self._shape_at.geo.walk(x, e, 4, iters=6, inside_tol=1e-9,
                                       leave=False)

    # ------------------------------------------------------------------
    def newton_solve(self, u0: torch.Tensor, tables: dict,
                     aux_fields: dict, aux_scalars: dict) -> torch.Tensor:
        """Monolithic Newton: assembly on the device, each correction a
        direct sparse solve on the host.  Appends the step's record to
        ``history``."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        pat = self.asm.pattern
        rec = {"newton_its": 0, "res_norms": [], "converged": False,
               "assembly_s": 0.0, "solve_s": 0.0}
        u = u0
        for _ in range(self.newton_iters):
            t0 = time.perf_counter()
            R, data = self._assemble(u, tables, aux_scalars, aux_fields)
            r = R.cpu().numpy()
            rec["assembly_s"] += time.perf_counter() - t0
            rec["res_norms"].append(float(np.linalg.norm(r)))
            if rec["res_norms"][-1] < self.newton_tol:
                rec["converged"] = True
                break
            t0 = time.perf_counter()
            A = sp.csr_matrix(
                (data.cpu().numpy().ravel(), (self._rows, self._cols)),
                shape=(pat.n_rows, pat.n_rows))
            du = spla.spsolve(A.tocsc(), r)
            rec["solve_s"] += time.perf_counter() - t0
            rec["newton_its"] += 1
            u = u - torch.as_tensor(du, dtype=u.dtype, device=u.device)
        self.history.append(rec)
        return u

    # ------------------------------------------------------------------
    def step(self, s: MPMState, u: torch.Tensor
             ) -> Tuple[MPMState, torch.Tensor]:
        """One implicit time step: returns (particles, grid dof vector)."""
        dt = self.dt
        phi, gphi = self._shape_at(s.x, s.elem)
        payload = {"phi": phi, "gphi": gphi, "F": s.F, "vol0": s.vol0,
                   "mass": s.mass, "v_old": s.v}
        tables = dict(self._tables)
        tables["particles"] = self.asm.particle_tables(s.elem, payload,
                                                       self.ppe)
        aux_fields = {}
        for vn in self.vel_names:
            sl = self.asm.offsets[vn]
            nd = self.asm.dofmaps[vn].n_dofs
            aux_fields[vn + "_old"] = u[sl:sl + nd]
        aux_scalars = {"dt": torch.tensor(float(dt), dtype=self.dtype,
                                          device=self.device)}

        # apply Dirichlet values into the iterate, then Newton
        u0 = torch.where(tables["dir_mask"],
                         torch.as_tensor(self.asm.dirichlet_values,
                                         dtype=self.dtype, device=self.device),
                         u)
        u_new = self.newton_solve(u0, tables, aux_fields, aux_scalars)

        # ---- G2P -------------------------------------------------------
        vconn = self._vconn[s.elem]                     # (np_, nd_v)
        vel_new, vel_old, Lp = [], [], []
        for vn in self.vel_names:
            sl = self.asm.offsets[vn]
            nd = self.asm.dofmaps[vn].n_dofs
            un = u_new[sl:sl + nd]
            uo = u[sl:sl + nd]
            vel_new.append(torch.einsum("pn,pn->p", phi, un[vconn]))
            vel_old.append(torch.einsum("pn,pn->p", phi, uo[vconn]))
            Lp.append(torch.einsum("pnd,pn->pd", gphi, un[vconn]))
        v_grid = torch.stack(vel_new, dim=1)             # (np_, dim)
        v_grid_old = torch.stack(vel_old, dim=1)
        L = torch.stack(Lp, dim=1)                       # (np_, dim, dim)
        v_p = (self.flip * (s.v + v_grid - v_grid_old)
               + (1 - self.flip) * v_grid)
        x_p = s.x + dt * v_grid
        I = torch.eye(self.dim, dtype=s.F.dtype, device=self.device)
        F_p = (I[None] + dt * L) @ s.F
        e_p = self._relocate(x_p, s.elem)
        return (MPMState(x=x_p, v=v_p, F=F_p, mass=s.mass, vol0=s.vol0,
                         elem=e_p), u_new)
