"""Plain reference of Q2 Poisson on the unit square, in NumPy.

-div(grad u) = f on (0, 1)^2, u = 0 on the boundary, on a uniform mesh of
``n`` x ``n`` biquadratic quads, with f a sum of sine modes
sum_m a_m sin(k_m pi x) sin(l_m pi y).  On a tensor mesh the Q2 stiffness
matrix is K1 (x) M1 + M1 (x) K1 and the load of a separable f is a sum of
outer products, with K1, M1 and the 1-D loads integrated by the 3-point
Gauss rule (the program's "fifth" order: exact for K1 and M1).  So the
residual of a nodal field U (a (2n + 1) x (2n + 1) grid) is
K1 U M1 + M1 U K1 - B, worked out here in float64 from the mesh size and
the modes alone.

The sampled solves are judged by two numbers: the largest of their
residuals over the interior rows as a share of the load's norm there, which
a wrong value at a few dofs shows magnified, and the median of their
distances from the discrete solution as a share of that solution's norm,
which a smooth error (a scaled operator, a solve stopped short of its
tolerance) shows as it is.  The median, since the largest distance swings
from seed to seed with the loads' spectra: float32 rounding of a 1M-dof
operator and load moves the lowest modes, while the solution of a mode
(k, l) shrinks as 1 / (k^2 + l^2).  :meth:`solve` (fast
diagonalisation: the generalised eigenvectors of (K1, M1), worked out once)
gives that solution in float64; with ``control`` it is computed in TF32
(K1 and M1 rounded to TF32 and decomposed in float32, every product with
TF32 operands and float32 sums), which serves the control.  Nothing of the
program is imported: its field comes in as an array with the coordinates
it sits at.
"""
from __future__ import annotations

import statistics

import numpy as np
import scipy.linalg
import scipy.sparse as sp

from .ns_channel import tf32


def _lagrange(t):
    return (np.stack([t * (t - 1) / 2, 1 - t * t, t * (t + 1) / 2]),
            np.stack([t - 0.5, -2 * t, t + 0.5]))


class PoissonReference:
    """The discrete problem on ``n`` x ``n`` Q2 elements."""

    def __init__(self, n: int):
        self.n = n
        self.m = 2 * n + 1                     # nodes per side
        g, w = np.polynomial.legendre.leggauss(3)
        phi, dphi = _lagrange(g)               # (3 local, 3 points)
        h = 1.0 / n
        k_loc = (2 / h) * np.einsum("iq,jq,q->ij", dphi, dphi, w)
        m_loc = (h / 2) * np.einsum("iq,jq,q->ij", phi, phi, w)
        dofs = 2 * np.arange(n)[:, None] + np.arange(3)[None]  # (n, 3)
        rows = np.repeat(dofs, 3, axis=1).ravel()
        cols = np.tile(dofs, (1, 3)).ravel()
        self.K1 = sp.csr_matrix((np.tile(k_loc.ravel(), n), (rows, cols)),
                                shape=(self.m, self.m))
        self.M1 = sp.csr_matrix((np.tile(m_loc.ravel(), n), (rows, cols)),
                                shape=(self.m, self.m))
        # 1-D quadrature: points (n, 3), weights x (h / 2), basis values
        self._xq = (dofs[:, :1] + 1 + g[None]) / (2 * n)
        self._wq = w * (h / 2)
        self._phi = phi
        self._dofs = dofs
        self._eig = {}

    def load_1d(self, k: int) -> np.ndarray:
        """int sin(k pi x) phi_i(x) dx for every node i."""
        vals = np.sin(k * np.pi * self._xq) * self._wq[None]     # (n, 3)
        contrib = np.einsum("eq,iq->ei", vals, self._phi)
        return np.bincount(self._dofs.ravel(), contrib.ravel(),
                           minlength=self.m)

    def load(self, modes) -> np.ndarray:
        """The (m, m) load grid of the modes ((k, l, a) rows)."""
        B = np.zeros((self.m, self.m))
        for k, l, a in modes:
            B += a * np.outer(self.load_1d(int(k)), self.load_1d(int(l)))
        return B

    def grid(self, xy: np.ndarray, u: np.ndarray) -> np.ndarray:
        """The (m, m) grid of a field ``u`` given at the points ``xy``."""
        ij = np.rint(np.asarray(xy) * (self.m - 1)).astype(np.int64)
        if (np.abs(ij / (self.m - 1) - xy).max() > 1e-9
                or len(ij) != self.m * self.m):
            raise ValueError("the program's nodes are not the reference's")
        U = np.full((self.m, self.m), np.nan)
        U[ij[:, 0], ij[:, 1]] = u
        if np.isnan(U).any():
            raise ValueError("the program's nodes do not cover the grid")
        return U

    def relative_residual(self, U: np.ndarray, modes) -> float:
        """||K1 U M1 + M1 U K1 - B|| over the interior rows, as a share of
        ||B|| there, in float64; U is taken as it is (its boundary too)."""
        B = self.load(modes)
        R = (self.K1 @ (self.M1 @ U.T).T + self.M1 @ (self.K1 @ U.T).T) - B
        return float(np.linalg.norm(R[1:-1, 1:-1])
                     / np.linalg.norm(B[1:-1, 1:-1]))

    def solve(self, modes, control: bool = False) -> np.ndarray:
        """The solution grid by fast diagonalisation: V^T M1 V = I,
        V^T K1 V = diag(lam), U = V ((V^T B V) / (lam_i + lam_j)) V^T on
        the interior."""
        if control not in self._eig:
            K = self.K1[1:-1, 1:-1].toarray()
            M = self.M1[1:-1, 1:-1].toarray()
            if control:
                K, M = tf32(K), tf32(M)
            self._eig[control] = scipy.linalg.eigh(K, M)
        lam, V = self._eig[control]
        B = self.load(modes)[1:-1, 1:-1]
        if control:
            def mm(a, b):
                return tf32(a) @ tf32(b)
        else:
            def mm(a, b):
                return a @ b
        W = mm(mm(V.T, B), V) / (lam[:, None] + lam[None, :])
        U = np.zeros((self.m, self.m))
        U[1:-1, 1:-1] = mm(mm(V, W), V.T)
        return U

    def relative_error(self, U: np.ndarray, modes) -> float:
        """||U - X|| / ||X|| over the whole grid, X the float64 solution."""
        X = self.solve(modes)
        return float(np.linalg.norm(U - X) / np.linalg.norm(X))


def numbers(ref: PoissonReference, answers) -> dict:
    """The numbers compared over (U, modes) pairs: the largest relative
    residual and the median relative error."""
    return {"rel_residual": max(ref.relative_residual(U, m)
                                for U, m in answers),
            "rel_error": statistics.median(ref.relative_error(U, m)
                                           for U, m in answers)}


def check(cfg, workdir, layout, samples):
    """The numbers compared over the sampled solves' fields."""
    mesh = cfg["mesh"]
    ref = PoissonReference(mesh["coarse_cells"] * 2 ** (mesh["levels"] - 1))
    return numbers(ref, [(ref.grid(layout["xy"], s["fields"]["u"]),
                          s["request"]["modes"]) for s in samples])
