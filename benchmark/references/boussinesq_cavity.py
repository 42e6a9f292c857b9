"""Plain reference of the differentially heated square cavity (de Vahl
Davis 1983), in PyTorch, float64, on the CPU.

From the configuration alone it builds the n x n square mesh of the unit
cavity (n = coarse cells x 2^(levels - 1)), the Q2 spaces of u, v and T,
the discontinuous linear pressure (coefficients of 1, xi, eta on each
element, as the element's own reference coordinates), the Dirichlet rows
(no-slip walls; T = +0.5 on x = 0 and -0.5 on x = 1; top and bottom
insulated) and the discrete steady Boussinesq equations in free-fall
scaling

  momentum d:  nu grad(u_d) . grad(phi) + (u . grad u_d) phi
               - p dphi/dx_d - T phi [d = y]
  continuity:  -div(u) psi
  temperature: kappa grad(T) . grad(phi) + (u . grad T) phi

with nu = sqrt(Pr / Ra) and kappa = 1 / sqrt(Ra Pr), integrated with the
Gauss rule of the configuration's quadrature order.  It judges a solution
by four numbers: the norm of its residual over the free rows as a share of
the same at the initial state (rest, the wall temperatures), and its
hot-wall Nusselt number, u_max on x = 1/2 and v_max on y = 1/2 (in units of
kappa / L: free-fall velocities times sqrt(Ra Pr)) against the published
values.  Every product is computed in float64, or, for the control, with
each operand rounded to TF32 and float32 sums.  :meth:`CavityReference.
newton` solves the same equations (a sparse LU a step); it serves the
control and the tests, never the timed runs.

It imports nothing of the program: the program's fields come in as arrays
with the coordinates they sit at, and are only judged here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import splu
from scipy.spatial import cKDTree

from .ns_channel import _REF, _lagrange, tf32
from .ns_channel import _tables as channel_tables

# de Vahl Davis (1983), Table IV: the mean Nusselt number and the largest
# velocities on the mid-lines, in units of kappa / L, at Ra = 1e5 (the
# cell's case) and 1e4 (the case that meshes a CPU test can hold resolve).
# The hot-wall Nusselt number is held against the mean: in the exact
# steady state the heat through every vertical line is the same, so the
# two are one number, and the table's wall values (4.509, 2.238) differ
# from it by that paper's own wall-gradient error
# (the hot-wall values of this discretisation converge to 4.5216 at 1e5)
PUBLISHED = {1e4: {"nu": 2.243, "u_max": 16.178, "v_max": 19.617},
             1e5: {"nu": 4.519, "u_max": 34.73, "v_max": 68.59}}
# Gauss points a direction for the quadrature order the configuration
# names (exact to degree 2 n - 1 = 5, as the program's rule)
ORDERS = {"fifth": 3}

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Arith:
    """The precision of the reference's products: float64, or TF32
    operands with float32 sums (the control)."""

    def __init__(self, control: bool):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def ein(self, spec: str, *ops) -> torch.Tensor:
        if self.control:
            ops = [torch.from_numpy(tf32(torch.as_tensor(o).numpy()))
                   for o in ops]
        else:
            ops = [torch.as_tensor(o, dtype=torch.float64) for o in ops]
        return torch.einsum(spec, *ops)


def _tables(n1d: int):
    """The channel reference's Gauss tables on [-1, 1]^2 (weights, Q2
    values and reference gradients) and the points (nq, 2) themselves."""
    wq, phi, dphi, _, _ = channel_tables(n1d)
    g, _ = np.polynomial.legendre.leggauss(n1d)
    X, Y = np.meshgrid(g, g, indexing="ij")
    return tuple(map(torch.from_numpy, (
        wq, phi, dphi, np.stack([X.ravel(), Y.ravel()], axis=1))))


class CavityReference:
    """The discrete cavity problem on ``n`` x ``n`` squares at Rayleigh
    number ``ra`` and Prandtl number ``pr``.  State: [u, v, T] at the Q2
    nodes, then (E, 3) pressure coefficients of (1, xi, eta)."""

    def __init__(self, n: int, ra: float, pr: float,
                 quadrature: str = "fifth"):
        self.n, self.ra, self.pr = n, ra, pr
        self.nu, self.kappa = math.sqrt(pr / ra), 1.0 / math.sqrt(ra * pr)
        self.h = 1.0 / n
        m = 2 * n + 1                       # Q2 nodes a direction
        gx, gy = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        self.xy = np.stack([gx.ravel(), gy.ravel()], axis=1) * (self.h / 2)
        a, b = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        a, b = a.ravel(), b.ravel()         # element (a, b): x in [a h, ...]
        ix = 2 * a[:, None] + 1 + _REF[None, :, 0]
        iy = 2 * b[:, None] + 1 + _REF[None, :, 1]
        self.conn = torch.from_numpy(ix * m + iy)             # (E, 9)
        self.centre = np.stack([(a + 0.5) * self.h, (b + 0.5) * self.h], 1)
        self.n_nodes, self.n_elems = m * m, n * n
        self.n_dofs = 3 * self.n_nodes + 3 * self.n_elems
        x, y = self.xy[:, 0], self.xy[:, 1]
        tol = 1e-9
        wall = (x < tol) | (x > 1 - tol) | (y < tol) | (y > 1 - tol)
        self.hot, self.cold = x < tol, x > 1 - tol
        self.t_wall = np.where(self.hot, 0.5, np.where(self.cold, -0.5, 0.0))
        N = self.n_nodes
        free = np.ones(self.n_dofs, bool)
        free[:N][wall] = False
        free[N:2 * N][wall] = False
        free[2 * N:3 * N][self.hot | self.cold] = False
        self._free = free
        self.wq, self.phi, self.dphi, self.pts = _tables(ORDERS[quadrature])

    # ---- states ---------------------------------------------------------
    def initial_state(self) -> np.ndarray:
        """Rest, T = 0 inside and the wall temperatures on x = 0, 1."""
        s = np.zeros(self.n_dofs)
        s[2 * self.n_nodes:3 * self.n_nodes] = self.t_wall
        return s

    def free(self, pinned: Optional[int] = None) -> np.ndarray:
        """Mask of the rows that are not Dirichlet rows; ``pinned``: the
        element whose constant pressure coefficient is held too."""
        f = self._free.copy()
        if pinned is not None:
            f[3 * self.n_nodes + 3 * pinned] = False
        return f

    def element_at(self, points: np.ndarray) -> np.ndarray:
        """The reference's element whose centre is each of ``points``."""
        dist, el = cKDTree(self.centre).query(points)
        if dist.max() > 1e-6 * self.h:
            raise ValueError("the program's elements are not the "
                             "reference's")
        return el

    def state_from_program(self, vel_xy, fields: Dict,
                           elem_corners) -> np.ndarray:
        """The state of a program's fields: ``u``, ``v``, ``T`` at the
        points ``vel_xy``, ``p`` as coefficients of (1, xi, eta) on the
        elements with corners ``elem_corners`` (E, 4, 2), counter-clockwise
        from the reference element's (-1, -1)."""
        dist, at = cKDTree(self.xy).query(vel_xy)
        if (dist.max() > 1e-6 * self.h or len(at) != self.n_nodes
                or len(np.unique(at)) != self.n_nodes):
            raise ValueError("the program's Q2 nodes are not the "
                             "reference's")
        N = self.n_nodes
        s = np.zeros(self.n_dofs)
        for k, name in enumerate(("u", "v", "T")):
            s[k * N + at] = fields[name]
        el = self.element_at(elem_corners.mean(axis=1))
        if len(np.unique(el)) != self.n_elems or len(el) != self.n_elems:
            raise ValueError("the program's elements are not the "
                             "reference's")
        c = np.asarray(fields["p"], np.float64).reshape(-1, 3)
        # p = c0 + (c1, c2) . J^-1 (x - centre) on a parallelogram with
        # J = [C1 - C0, C3 - C0] / 2: its gradient is J^-T (c1, c2); on
        # the reference's own squares J = h / 2
        J = np.stack([elem_corners[:, 1] - elem_corners[:, 0],
                      elem_corners[:, 3] - elem_corners[:, 0]], axis=2) / 2
        grad = np.linalg.solve(np.transpose(J, (0, 2, 1)),
                               c[:, 1:, None])[..., 0]
        p = np.zeros((self.n_elems, 3))
        p[el, 0] = c[:, 0]
        p[el, 1:] = grad * (self.h / 2)
        s[3 * N:] = p.ravel()
        return s

    # ---- element quantities ---------------------------------------------
    def _geometry(self, ar: Arith):
        """Physical Q2 gradients (nq, 9, 2), weights x |J| (nq,) and the
        pressure basis (1, xi, eta) at the points (nq, 3): every element is
        the same square."""
        G = self.dphi * (2.0 / self.h)
        wdet = self.wq * (self.h / 2) ** 2
        psi = torch.cat([torch.ones(len(self.pts), 1, dtype=torch.float64),
                         self.pts], dim=1)
        return (G.to(ar.dtype), wdet.to(ar.dtype), psi.to(ar.dtype))

    def _fields(self, s: np.ndarray):
        N = self.n_nodes
        t = torch.as_tensor(s, dtype=torch.float64)
        return (t[:N][self.conn], t[N:2 * N][self.conn],
                t[2 * N:3 * N][self.conn], t[3 * N:].reshape(-1, 3))

    def _at_points(self, s: np.ndarray, ar: Arith):
        G, wdet, psi = self._geometry(ar)
        Ue, Ve, Te, Pe = self._fields(s)
        val = {k: ar.ein("qn,en->eq", self.phi, f)
               for k, f in (("u", Ue), ("v", Ve), ("T", Te))}
        grad = {k: ar.ein("qnd,en->eqd", G, f)
                for k, f in (("u", Ue), ("v", Ve), ("T", Te))}
        val["p"] = ar.ein("qk,ek->eq", psi, Pe)
        return G, wdet, psi, val, grad

    def residual(self, s: np.ndarray, control: bool = False) -> np.ndarray:
        """The residual of the state ``s`` at every dof (Dirichlet rows
        included), as float64."""
        ar = Arith(control)
        G, wdet, psi, val, grad = self._at_points(s, ar)
        u, v = val["u"], val["v"]

        def adv(g):
            return ar.ein("eq,eq->eq", u, g[..., 0]) + ar.ein(
                "eq,eq->eq", v, g[..., 1])

        def diff(c, g):
            return c * ar.ein("qnd,eqd,q->en", G, g, wdet)

        def mass(f):
            return ar.ein("qn,eq,q->en", self.phi, f, wdet)

        p = val["p"]
        ru = (diff(self.nu, grad["u"]) + mass(adv(grad["u"]))
              - ar.ein("qn,eq,q->en", G[..., 0], p, wdet))
        rv = (diff(self.nu, grad["v"]) + mass(adv(grad["v"]))
              - ar.ein("qn,eq,q->en", G[..., 1], p, wdet) - mass(val["T"]))
        rT = diff(self.kappa, grad["T"]) + mass(adv(grad["T"]))
        div = grad["u"][..., 0] + grad["v"][..., 1]
        rp = -ar.ein("qk,eq,q->ek", psi, div, wdet)
        N = self.n_nodes
        out = torch.zeros(self.n_dofs, dtype=torch.float64)
        idx = self.conn.reshape(-1)
        for k, r in enumerate((ru, rv, rT)):
            out[k * N:(k + 1) * N].index_add_(0, idx, r.reshape(-1).double())
        out[3 * N:] = rp.reshape(-1).double()
        return out.numpy()

    def relative_residual(self, s: np.ndarray,
                          pinned: Optional[int] = None) -> float:
        """||R(s)|| over the free rows as a share of ||R(s0)|| at the
        initial state, in float64."""
        f = self.free(pinned)
        r0 = np.linalg.norm(self.residual(self.initial_state())[f])
        return float(np.linalg.norm(self.residual(s)[f]) / r0)

    # ---- observables ----------------------------------------------------
    def observables(self, s: np.ndarray) -> Dict[str, float]:
        """Nu on the hot wall (-int_0^1 dT/dx(0, y) dy from the wall
        elements' Q2 values of T, Gauss-Legendre along the wall), u_max on
        x = 1/2 and v_max on y = 1/2 (nodal maxima) in units of kappa / L."""
        N, n = self.n_nodes, self.n
        T = torch.as_tensor(s[2 * N:3 * N], dtype=torch.float64)
        g, w = np.polynomial.legendre.leggauss(4)
        lx, dx = _lagrange(np.full_like(g, -1.0))
        ly, _ = _lagrange(g)
        ix, iy = _REF[:, 0] + 1, _REF[:, 1] + 1
        dphi_x = torch.from_numpy((dx[ix] * ly[iy]).T) * (2.0 / self.h)
        wall = torch.arange(n)                   # elements (0, b)
        dTdx = torch.einsum("qn,en->eq", dphi_x, T[self.conn[wall]])
        nu = -float((dTdx * torch.from_numpy(w)).sum()) * self.h / 2
        scale = math.sqrt(self.ra * self.pr)
        x, y = self.xy[:, 0], self.xy[:, 1]
        mid_x, mid_y = np.abs(x - 0.5) < 1e-9, np.abs(y - 0.5) < 1e-9
        return {"nu": nu, "u_max": float(s[:N][mid_x].max()) * scale,
                "v_max": float(s[N:2 * N][mid_y].max()) * scale}

    # ---- the solve (control and tests) ----------------------------------
    def jacobian(self, s: np.ndarray, control: bool = False):
        """The Jacobian of :meth:`residual` at ``s``, as CSR."""
        ar = Arith(control)
        G, wdet, psi, val, grad = self._at_points(s, ar)
        phi = self.phi
        u, v = val["u"], val["v"]
        lap = ar.ein("qid,qjd,q->ij", G, G, wdet)
        adv = ar.ein("qi,eq,qj,q->eij", phi, u, G[..., 0], wdet) + ar.ein(
            "qi,eq,qj,q->eij", phi, v, G[..., 1], wdet)

        def mass(c):
            return ar.ein("qi,qj,eq,q->eij", phi, phi, c, wdet)

        E = self.n_elems
        K = torch.zeros(E, 30, 30, dtype=torch.float64)
        U, V, T, P = slice(0, 9), slice(9, 18), slice(18, 27), slice(27, 30)
        K[:, U, U] = self.nu * lap + adv + mass(grad["u"][..., 0])
        K[:, U, V] = mass(grad["u"][..., 1])
        K[:, V, U] = mass(grad["v"][..., 0])
        K[:, V, V] = self.nu * lap + adv + mass(grad["v"][..., 1])
        K[:, V, T] = -ar.ein("qi,qj,q->ij", phi, phi, wdet)
        K[:, T, U] = mass(grad["T"][..., 0])
        K[:, T, V] = mass(grad["T"][..., 1])
        K[:, T, T] = self.kappa * lap + adv
        for d, rows in ((0, U), (1, V)):
            K[:, rows, P] = -ar.ein("qi,qk,q->ik", G[..., d], psi, wdet)
            K[:, P, rows] = -ar.ein("qk,qj,q->kj", psi, G[..., d], wdet)
        K = K.numpy()
        if control:
            K = tf32(K).astype(np.float64)
        N = self.n_nodes
        conn = self.conn.numpy()
        dofs = np.concatenate([conn, N + conn, 2 * N + conn,
                               3 * N + 3 * np.arange(E)[:, None]
                               + np.arange(3)[None]], axis=1)
        rows = np.broadcast_to(dofs[:, :, None], K.shape).ravel()
        cols = np.broadcast_to(dofs[:, None, :], K.shape).ravel()
        return sp.csr_matrix((K.ravel(), (rows, cols)),
                             shape=(self.n_dofs, self.n_dofs))

    def newton(self, steps: int = 12, control: bool = False,
               tol: float = 1e-13) -> np.ndarray:
        """Newton's method from the initial state, each step a sparse LU
        solve with the Dirichlet rows and the pressure of element 0 held:
        the reference's own solution (``control``: residuals and Jacobians
        in TF32)."""
        s = self.initial_state()
        f = self.free(pinned=0)
        fixed = np.nonzero(~f)[0]
        for _ in range(steps):
            r = self.residual(s, control)
            r[fixed] = 0.0
            A = (sp.diags(f.astype(np.float64)) @ self.jacobian(s, control)
                 + sp.diags((~f).astype(np.float64)))
            delta = splu(A.tocsc()).solve(-r)
            s = s + delta
            if np.linalg.norm(delta) <= tol * np.linalg.norm(s):
                break
        return s


def reference_of(cfg) -> CavityReference:
    mesh, phys = cfg["mesh"], cfg["physics"]
    n = mesh["coarse_cells"] * 2 ** (mesh["levels"] - 1)
    return CavityReference(n, phys["ra"], phys["pr"],
                           cfg["solver"]["quadrature"])


def numbers(ref: CavityReference, states, pinned: Optional[int] = None
            ) -> Dict[str, float]:
    """The worst of each judged number over ``states``."""
    pub = PUBLISHED[ref.ra]
    out = {"rel_residual": 0.0, "nu_rel_err": 0.0, "u_max_rel_err": 0.0,
           "v_max_rel_err": 0.0}
    for s in states:
        obs = ref.observables(s)
        read = {"rel_residual": ref.relative_residual(s, pinned),
                **{f"{k}_rel_err": abs(obs[k] - pub[k]) / pub[k]
                   for k in ("nu", "u_max", "v_max")}}
        out = {k: max(out[k], read[k]) for k in out}
    return out


def check(cfg, workdir, layout, samples):
    """The worst of each number among the sampled solves' fields; the
    program's pressure is pinned at its first dof, the constant
    coefficient of its first element."""
    ref = reference_of(cfg)
    pinned = int(ref.element_at(layout["elem_corners"][:1].mean(axis=1))[0])
    states = [ref.state_from_program(layout["vel_xy"], s["fields"],
                                     layout["elem_corners"])
              for s in samples]
    return numbers(ref, states, pinned)
