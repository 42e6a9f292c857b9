"""Plain reference of the steady DFG channel (test case 2D-1, the
square-obstacle variant), in NumPy.

From the mesh file alone it builds the refined mesh, the Q2 velocity and
discontinuous linear pressure spaces, the Dirichlet conditions and the
discrete steady Navier-Stokes equations

  momentum d:  nu grad(u_d) . grad(phi) + (u . grad u_d) phi - p dphi/dx_d
  continuity:  -div(u) psi

(4 x 4 Gauss points on each element, which integrate every term exactly on
these straight-sided quads), and judges a solution by the norm of its
residual over the free rows, as a share of the residual of the initial
guess (the inflow profile everywhere).  Every product is computed in
float64, or, for the control, with each operand rounded to TF32 and
float32 sums.  :func:`newton` solves the same equations (sparse LU each
step); it serves the control, never the timed runs.

It imports nothing of the program: the program's fields come in as arrays
with the coordinates they sit at, and are only judged here.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu
from scipy.spatial import cKDTree

from .channel_mesh import read_neu

NU = 1e-3                     # 1 / Re of the DFG benchmark's test case 2D-1
U_MEAN_FACTOR = 1.5 * 0.2     # U_max = 0.3 (Schaefer and Turek 1996)

# Q2 nodes on [-1, 1]^2: corners counter-clockwise, edge midpoints, centre
_REF = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1], [0, -1], [1, 0],
                 [0, 1], [-1, 0], [0, 0]], np.int64)


def inflow_u(y):
    """The DFG parabolic inflow profile, U_max = 0.3 on a 0.41 channel."""
    return U_MEAN_FACTOR * (4.0 / 0.1681) * y * (0.41 - y)


def tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32 (10 stored mantissa bits, round to nearest
    even), as float32."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    lsb = (b >> 13) & 1
    b = ((b + 0x0FFF + lsb) & np.uint32(0xFFFFE000)).astype(np.uint32)
    return b.view(np.float32)


class Arith:
    """The precision of the reference's products: float64, or TF32 operands
    with float32 sums (the control)."""

    def __init__(self, control: bool):
        self.control = control
        self.dtype = np.float32 if control else np.float64

    def ein(self, spec: str, *ops) -> np.ndarray:
        if self.control:
            return np.einsum(spec, *[tf32(o) for o in ops])
        return np.einsum(spec, *[np.asarray(o, np.float64) for o in ops])


def _lagrange(t):
    """Values and derivatives of the quadratic Lagrange basis on the nodes
    -1, 0, 1 at the points ``t``: (3, n) each."""
    return (np.stack([t * (t - 1) / 2, 1 - t * t, t * (t + 1) / 2]),
            np.stack([t - 0.5, -2 * t, t + 0.5]))


def _tables(n1d: int = 4):
    """Gauss points' weights (nq,), Q2 values (nq, 9), Q2 reference
    gradients (nq, 9, 2), bilinear corner values (nq, 4) and gradients
    (nq, 4, 2)."""
    g, w = np.polynomial.legendre.leggauss(n1d)
    X, Y = np.meshgrid(g, g, indexing="ij")
    x, y = X.ravel(), Y.ravel()
    wq = np.outer(w, w).ravel()
    lx, dx = _lagrange(x)
    ly, dy = _lagrange(y)
    ix, iy = _REF[:, 0] + 1, _REF[:, 1] + 1
    phi = (lx[ix] * ly[iy]).T
    dphi = np.stack([(dx[ix] * ly[iy]).T, (lx[ix] * dy[iy]).T], axis=-1)
    sx, sy = _REF[:4, 0], _REF[:4, 1]
    q1 = ((1 + sx[None] * x[:, None]) * (1 + sy[None] * y[:, None])) / 4
    dq1 = np.stack([(sx[:, None] * (1 + sy[:, None] * y)).T / 4,
                    (sy[:, None] * (1 + sx[:, None] * x)).T / 4], axis=-1)
    return wq, phi, dphi, q1, dq1


def _refine(corners: np.ndarray) -> np.ndarray:
    """Each straight-sided quad (E, 4, 2) into four, corners in the same
    counter-clockwise order."""
    c0, c1, c2, c3 = (corners[:, k] for k in range(4))
    m01, m12, m23, m30 = (c0 + c1) / 2, (c1 + c2) / 2, (c2 + c3) / 2, \
        (c3 + c0) / 2
    mid = (c0 + c1 + c2 + c3) / 4
    kids = [(c0, m01, mid, m30), (m01, c1, m12, mid), (mid, m12, c2, m23),
            (m30, mid, m23, c3)]
    return np.stack([np.stack(k, axis=1) for k in kids], axis=1).reshape(
        -1, 4, 2)


class ChannelReference:
    """The discrete channel problem on the mesh file refined ``refinements``
    times."""

    def __init__(self, mesh_path: str, refinements: int):
        coords, conn, faces = read_neu(mesh_path)
        corners = coords[conn[:, :4]]
        # boundary segments of the coarse mesh, with their groups
        seg_a = coords[conn[faces[:, 0], faces[:, 1]]]
        seg_b = coords[conn[faces[:, 0], (faces[:, 1] + 1) % 4]]
        for _ in range(refinements):
            corners = _refine(corners)
        self.corners = corners
        # the Q2 nodes of every element, shared by position
        q1 = np.stack([(1 - _REF[:, 0]) * (1 - _REF[:, 1]),
                       (1 + _REF[:, 0]) * (1 - _REF[:, 1]),
                       (1 + _REF[:, 0]) * (1 + _REF[:, 1]),
                       (1 - _REF[:, 0]) * (1 + _REF[:, 1])], axis=1) / 4
        pos = np.einsum("bv,evd->ebd", q1, corners)           # (E, 9, 2)
        h = np.abs(corners[:, 1] - corners[:, 0]).max(axis=1).min()
        key = np.rint(pos.reshape(-1, 2) / (h / 8)).astype(np.int64)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        self.conn = inv.reshape(-1, 9)
        self.xy = pos.reshape(-1, 2)[first]
        self.n_nodes = len(self.xy)
        self.n_elems = len(corners)
        self.centre = corners.mean(axis=1)
        # Dirichlet nodes: on a coarse boundary segment of group 1, 3 or 4
        on = np.zeros((self.n_nodes, 5), bool)
        d = seg_b - seg_a
        for lo in range(0, len(seg_a), 64):
            a, dd = seg_a[lo:lo + 64], d[lo:lo + 64]
            rel = self.xy[:, None, :] - a[None]
            t = (rel * dd).sum(-1) / (dd * dd).sum(-1)
            off = np.abs(rel[..., 0] * dd[..., 1] - rel[..., 1] * dd[..., 0])
            hit = (t > -1e-9) & (t < 1 + 1e-9) & (off < 1e-9 * np.sqrt(
                (dd * dd).sum(-1)))
            for j, g in enumerate(faces[lo:lo + 64, 2]):
                on[:, g] |= hit[:, j]
        self.dirichlet = on[:, 1] | on[:, 3] | on[:, 4]
        self.u_bc = np.where(on[:, 1] & ~(on[:, 3] | on[:, 4]),
                             inflow_u(self.xy[:, 1]), 0.0)
        self.wq, self.phi, self.dphi, self.q1, self.dq1 = _tables()
        self.n_dofs = 2 * self.n_nodes + 3 * self.n_elems

    # ---- states ---------------------------------------------------------
    def initial_state(self) -> np.ndarray:
        """U = the inflow profile everywhere, V = P = 0, Dirichlet values
        imposed; the stacked state [U, V, P] (P as (value at the centre,
        d/dx, d/dy) per element)."""
        n = self.n_nodes
        s = np.zeros(self.n_dofs)
        s[:n] = np.where(self.dirichlet, self.u_bc, inflow_u(self.xy[:, 1]))
        return s

    def state_from_program(self, vel_xy, U, V, elem_corners, P) -> np.ndarray:
        """The stacked state of a program's fields: ``U``, ``V`` at the
        points ``vel_xy``, ``P`` as the coefficients of (1, xi, eta) on the
        elements with corners ``elem_corners`` (E, 4, 2), counter-clockwise
        from the reference element's (-1, -1)."""
        h = np.abs(self.corners[:, 1] - self.corners[:, 0]).max(axis=1).min()
        dist, at = cKDTree(self.xy).query(vel_xy)
        if dist.max() > 1e-6 * h or len(np.unique(at)) != self.n_nodes \
                or len(at) != self.n_nodes:
            raise ValueError("the program's velocity nodes are not the "
                             "reference's")
        s = np.zeros(self.n_dofs)
        s[at] = U
        s[self.n_nodes + at] = V
        cen = elem_corners.mean(axis=1)
        dist, el = cKDTree(self.centre).query(cen)
        if dist.max() > 1e-6 * h or len(np.unique(el)) != self.n_elems \
                or len(el) != self.n_elems:
            raise ValueError("the program's elements are not the "
                             "reference's")
        c = np.asarray(P).reshape(-1, 3)
        # p = c0 + c . J^-1 (x - centre) on a parallelogram, J = [(C1 - C0),
        # (C3 - C0)] / 2: the gradient is J^-T (c1, c2)
        J = np.stack([elem_corners[:, 1] - elem_corners[:, 0],
                      elem_corners[:, 3] - elem_corners[:, 0]], axis=2) / 2
        grad = np.linalg.solve(np.transpose(J, (0, 2, 1)), c[:, 1:, None])[
            ..., 0]
        p = np.zeros((self.n_elems, 3))
        p[el, 0] = c[:, 0]
        p[el, 1:] = grad
        s[2 * self.n_nodes:] = p.ravel()
        return s

    # ---- element quantities ---------------------------------------------
    def _geometry(self, ar: Arith):
        """Physical Q2 gradients (E, nq, 9, 2), weights x |J| (E, nq) and
        the pressure basis (1, x - xc, y - yc) at the points (E, nq, 3)."""
        J = ar.ein("qvr,evd->eqdr", self.dq1, self.corners)   # dx_d/dxi_r
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        inv = np.stack([np.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                        np.stack([-J[..., 1, 0], J[..., 0, 0]], -1)],
                       -2) / det[..., None, None]              # dxi_r/dx_d
        G = ar.ein("qnr,eqrd->eqnd", self.dphi, inv)
        wdet = (self.wq[None] * det).astype(ar.dtype)
        xq = ar.ein("qv,evd->eqd", self.q1, self.corners)
        rel = xq - self.centre[:, None, :]
        psi = np.concatenate([np.ones(rel.shape[:2] + (1,), ar.dtype),
                              rel.astype(ar.dtype)], axis=-1)
        return G, wdet, psi

    def _fields(self, s: np.ndarray, ar: Arith):
        n, E = self.n_nodes, self.n_elems
        Ue, Ve = s[:n][self.conn], s[n:2 * n][self.conn]
        Pe = s[2 * n:].reshape(E, 3)
        return Ue, Ve, Pe

    def residual(self, s: np.ndarray, control: bool = False) -> np.ndarray:
        """The residual of the stacked state ``s`` at every dof (Dirichlet
        rows included)."""
        ar = Arith(control)
        G, wdet, psi = self._geometry(ar)
        Ue, Ve, Pe = self._fields(s, ar)
        u = ar.ein("qn,en->eq", self.phi, Ue)
        v = ar.ein("qn,en->eq", self.phi, Ve)
        gu = ar.ein("eqnd,en->eqd", G, Ue)
        gv = ar.ein("eqnd,en->eqd", G, Ve)
        p = ar.ein("eqk,ek->eq", psi, Pe)
        conv_u = ar.ein("eq,eq->eq", u, gu[..., 0]) + ar.ein(
            "eq,eq->eq", v, gu[..., 1])
        conv_v = ar.ein("eq,eq->eq", u, gv[..., 0]) + ar.ein(
            "eq,eq->eq", v, gv[..., 1])
        ru = (NU * ar.ein("eqnd,eqd,eq->en", G, gu, wdet)
              + ar.ein("qn,eq,eq->en", self.phi, conv_u, wdet)
              - ar.ein("eqn,eq,eq->en", G[..., 0], p, wdet))
        rv = (NU * ar.ein("eqnd,eqd,eq->en", G, gv, wdet)
              + ar.ein("qn,eq,eq->en", self.phi, conv_v, wdet)
              - ar.ein("eqn,eq,eq->en", G[..., 1], p, wdet))
        div = gu[..., 0] + gv[..., 1]
        rp = -ar.ein("eqk,eq,eq->ek", psi, div, wdet)
        n = self.n_nodes
        out = np.zeros(self.n_dofs)
        out[:n] = np.bincount(self.conn.ravel(), ru.ravel().astype(
            np.float64), minlength=n)
        out[n:2 * n] = np.bincount(self.conn.ravel(), rv.ravel().astype(
            np.float64), minlength=n)
        out[2 * n:] = rp.ravel()
        return out

    def free(self) -> np.ndarray:
        """Mask of the rows that are not Dirichlet rows."""
        m = np.ones(self.n_dofs, bool)
        m[:self.n_nodes][self.dirichlet] = False
        m[self.n_nodes:2 * self.n_nodes][self.dirichlet] = False
        return m

    def relative_residual(self, s: np.ndarray) -> float:
        """||R(s)|| over the free rows, as a share of ||R(s0)|| at the
        initial guess, in float64."""
        f = self.free()
        if getattr(self, "_r0", None) is None:
            self._r0 = np.linalg.norm(self.residual(self.initial_state())[f])
        return float(np.linalg.norm(self.residual(s)[f]) / self._r0)

    # ---- the solve (control) ----------------------------------------------
    def jacobian(self, s: np.ndarray, control: bool = False):
        """The Jacobian of :meth:`residual` at ``s``, as CSR."""
        ar = Arith(control)
        G, wdet, psi = self._geometry(ar)
        Ue, Ve, Pe = self._fields(s, ar)
        phi = self.phi
        u = ar.ein("qn,en->eq", phi, Ue)
        v = ar.ein("qn,en->eq", phi, Ve)
        gu = ar.ein("eqnd,en->eqd", G, Ue)
        gv = ar.ein("eqnd,en->eqd", G, Ve)
        visc = NU * ar.ein("eqid,eqjd,eq->eij", G, G, wdet)
        adv = ar.ein("qi,eq,eqj,eq->eij", phi, u, G[..., 0], wdet) + ar.ein(
            "qi,eq,eqj,eq->eij", phi, v, G[..., 1], wdet)

        def mass(c):
            return ar.ein("qi,qj,eq,eq->eij", phi, phi, c, wdet)

        E = self.n_elems
        K = np.zeros((E, 21, 21))
        K[:, :9, :9] = visc + adv + mass(gu[..., 0])
        K[:, :9, 9:18] = mass(gu[..., 1])
        K[:, 9:18, :9] = mass(gv[..., 0])
        K[:, 9:18, 9:18] = visc + adv + mass(gv[..., 1])
        K[:, :9, 18:] = -ar.ein("eqi,eqk,eq->eik", G[..., 0], psi, wdet)
        K[:, 9:18, 18:] = -ar.ein("eqi,eqk,eq->eik", G[..., 1], psi, wdet)
        K[:, 18:, :9] = -ar.ein("eqk,eqj,eq->ekj", psi, G[..., 0], wdet)
        K[:, 18:, 9:18] = -ar.ein("eqk,eqj,eq->ekj", psi, G[..., 1], wdet)
        if control:
            K = tf32(K).astype(np.float64)
        n = self.n_nodes
        dofs = np.concatenate([self.conn, n + self.conn,
                               2 * n + 3 * np.arange(E)[:, None]
                               + np.arange(3)[None]], axis=1)
        rows = np.broadcast_to(dofs[:, :, None], K.shape).ravel()
        cols = np.broadcast_to(dofs[:, None, :], K.shape).ravel()
        return sp.csr_matrix((K.ravel(), (rows, cols)),
                             shape=(self.n_dofs, self.n_dofs))

    def newton(self, steps: int = 8, control: bool = False,
               tol: float = 1e-13) -> np.ndarray:
        """Newton's method from the initial guess, each step a sparse LU
        solve with the Dirichlet rows held: the reference's own solution
        (``control``: residuals and Jacobians in TF32)."""
        s = self.initial_state()
        f = self.free()
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


def check(cfg, workdir, layout, samples):
    """The largest relative residual among the sampled solves' fields."""
    import os

    ref = ChannelReference(os.path.join(workdir, "channel.neu"),
                           cfg["mesh"]["levels"] - 1)
    worst = 0.0
    for s in samples:
        f = s["fields"]
        state = ref.state_from_program(layout["vel_xy"], f["U"], f["V"],
                                       layout["elem_corners"], f["P"])
        worst = max(worst, ref.relative_residual(state))
    return {"rel_residual": worst}
