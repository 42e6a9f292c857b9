"""Field-split / Schur block preconditioners over the stacked dof layout.

Reference: ``FieldSplitTree`` (FieldSplitTree.hpp:42-178): recursive
PCFIELDSPLIT with additive/multiplicative/Schur nodes, index sets built from
the KKoffset block layout, Schur factorization and preconditioner type
selectors (:69-70).  Splits are static index arrays into the stacked
vector; combinators return preconditioner closures M(r) -> z usable by the
Krylov solvers, and block sub-solves are Jacobi/CG/Vanka applications of
masked sub-operators: no matrix is re-assembled per split.

``A`` is duck-typed: anything with ``@``, ``diagonal()`` and ``n_rows``
(``SparseOp``, or a ``BellBackedOp`` whose every sub-, coupling and Vanka
matvec then runs through kernel B1).  Split vectors are embedded and
extracted with gathers and out-of-place ``index_copy``/``index_add``, so
no tensor that a Krylov loop still holds is written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .krylov import cg, richardson


@dataclasses.dataclass
class Split:
    name: str
    idx: np.ndarray                 # global dof indices of this split


def splits_from_offsets(assembler, groups: Dict[str, Sequence[str]]
                        ) -> List[Split]:
    """Build splits from unknown names using the assembler's KKoffset
    layout, e.g. {"vel": ["u", "v"], "press": ["p"]}."""
    out = []
    for name, vars_ in groups.items():
        parts = []
        for v in vars_:
            off = assembler.offsets[v]
            nd = assembler.dofmaps[v].n_dofs
            parts.append(np.arange(off, off + nd))
        out.append(Split(name, np.concatenate(parts)))
    return out


def _device(A) -> torch.device:
    return A.diagonal().device


def _index(A, idx) -> torch.Tensor:
    """A split's index array (numpy or tensor) as an int64 tensor on
    ``A``'s device."""
    return torch.as_tensor(idx, dtype=torch.int64, device=_device(A))


def _embed(xs: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The length-``n`` vector that holds ``xs`` at ``idx``, zero elsewhere."""
    return xs.new_zeros(n).index_copy(0, idx, xs)


def sub_operator(A, idx: torch.Tensor, n: int) -> Callable:
    """Masked block operator: x_s -> (A @ E x_s)[idx] (E = embedding)."""

    def op(xs):
        return (A @ _embed(xs, idx, n))[idx]

    return op


def coupling_operator(A, row_idx: torch.Tensor, col_idx: torch.Tensor,
                      n: int) -> Callable:
    def op(xs):
        return (A @ _embed(xs, col_idx, n))[row_idx]

    return op


def _safe_diag(A, idx: torch.Tensor) -> torch.Tensor:
    d = A.diagonal()[idx]
    return torch.where(d.abs() < 1e-30, 1.0, d)


def jacobi_pc(A, idx) -> Callable:
    dsafe = _safe_diag(A, _index(A, idx))
    return lambda r: r / dsafe


def additive_fieldsplit(A, splits: Sequence[Split],
                        sub_pcs: Sequence[Callable]) -> Callable:
    """Block-Jacobi over splits (PC_COMPOSITE_ADDITIVE)."""
    idxs = [_index(A, s.idx) for s in splits]

    def M(r):
        z = torch.zeros_like(r)
        for idx, pc in zip(idxs, sub_pcs):
            z = z.index_copy(0, idx, pc(r[idx]))
        return z

    return M


def multiplicative_fieldsplit(A, splits: Sequence[Split],
                              sub_pcs: Sequence[Callable]) -> Callable:
    """Block Gauss-Seidel over splits (PC_COMPOSITE_MULTIPLICATIVE)."""
    idxs = [_index(A, s.idx) for s in splits]

    def M(r):
        z = torch.zeros_like(r)
        for idx, pc in zip(idxs, sub_pcs):
            rr = (r - A @ z)[idx]
            z = z.index_add(0, idx, pc(rr))
        return z

    return M


# ---------------------------------------------------------------------------
# Recursive FieldSplitTree (reference FieldSplitTree.hpp:42-178): nodes are
# additive / multiplicative / Schur combinations of child splits; leaves own
# their sub-preconditioner ("per-split KSP/PC"), including Vanka-within-split
# (the reference's ASM-within-split, FieldSplitTree.hpp:61).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FieldSplitNode:
    """One node of the recursive split tree.

    Leaf: ``vars`` lists unknown names; ``pc`` picks the sub-preconditioner
    ("jacobi" | "cg" | "vanka"), ``iters`` its sweep/iteration count.
    Inner: ``children`` + ``combine`` in {"additive", "multiplicative",
    "schur"}; a Schur node has exactly two children (field, constraint) with
    ``schur_fact`` in {"diag","lower","upper","full"} and the Schur solve
    approximated by ``schur_iters`` CG iterations on S = C - B diag(F)^-1 B'
    (SetSchurFactorizationType / SetSchurPreType semantics).
    """

    name: str
    vars: Optional[Sequence[str]] = None
    children: Optional[Sequence["FieldSplitNode"]] = None
    combine: str = "additive"
    pc: str = "jacobi"
    iters: int = 4
    schur_fact: str = "full"
    schur_iters: int = 10
    vanka_block_elems: int = 2

    def leaf_vars(self) -> List[str]:
        if self.vars is not None:
            return list(self.vars)
        out: List[str] = []
        for c in self.children:
            out.extend(c.leaf_vars())
        return out


def _node_idx(node: FieldSplitNode, assembler) -> np.ndarray:
    parts = []
    for v in node.leaf_vars():
        off = assembler.offsets[v]
        nd = assembler.dofmaps[v].n_dofs
        parts.append(np.arange(off, off + nd))
    return np.concatenate(parts)


def _schur_parts(A, iu: torch.Tensor, ip: torch.Tensor, n: int):
    """(F, B', B, S_neg) of the 2x2 block split [[F, B'], [B, C]]:
    S_neg = -(C - B diag(F)^-1 B'), positive (semi)definite for saddle
    systems, so CG can solve the Schur system."""
    F = sub_operator(A, iu, n)
    Bt = coupling_operator(A, iu, ip, n)    # u <- p
    B = coupling_operator(A, ip, iu, n)     # p <- u
    C = sub_operator(A, ip, n)
    dFs = _safe_diag(A, iu)

    def S_neg(xp):
        return B(Bt(xp) / dFs) - C(xp)

    return F, Bt, B, S_neg


def _schur_apply(fact: str, ru, rp, solve_F, solve_S, B, Bt):
    """(zu, zp) of one Schur-factorised application: "diag" | "lower" |
    "upper" | "full" (LDU)."""
    if fact == "diag":
        return solve_F(ru), solve_S(rp)
    if fact == "lower":
        zu = solve_F(ru)
        return zu, solve_S(rp - B(zu))
    if fact == "upper":
        zp = solve_S(rp)
        return solve_F(ru - Bt(zp)), zp
    zu0 = solve_F(ru)
    zp = solve_S(rp - B(zu0))
    return zu0 - solve_F(Bt(zp)), zp


def build_fieldsplit_tree(A, assembler, node: FieldSplitNode,
                          dirichlet_mask=None) -> Callable:
    """Recursive preconditioner M(r) -> z over the full stacked vector.

    ``assembler`` supplies the KKoffset layout (offsets/dofmaps); pass the
    fine-level Assembler, or any object with compatible ``offsets`` /
    ``dofmaps`` attributes for PtAP-coarsened levels.  Dirichlet rows are
    identity in A, so sub-solves leave them consistent."""
    n = A.n_rows
    dev = _device(A)

    def make(nd: FieldSplitNode) -> Callable:
        idx_np = _node_idx(nd, assembler)
        idx = _index(A, idx_np)
        if nd.vars is not None:                       # leaf
            if nd.pc == "vanka":
                from .vanka import build_element_blocks, vanka_smoother
                blocks = build_element_blocks(
                    assembler, nd.vanka_block_elems,
                    dof_filter=np.isin(np.arange(assembler.n_dofs), idx_np),
                    device=dev)
                sm = vanka_smoother(A, blocks, omega=1.0, iters=nd.iters)

                def M_vanka(r):
                    return sm(_embed(r, idx, n), r.new_zeros(n))[idx]

                return M_vanka
            Fop = sub_operator(A, idx, n)
            dsafe = _safe_diag(A, idx)
            if nd.pc == "cg":
                def M_cg(r):
                    z, _ = cg(Fop, r, M=lambda rr: rr / dsafe, tol=1e-2,
                              maxiter=nd.iters)
                    return z
                return M_cg

            def M_jac(r):
                return richardson(Fop, r, M=lambda rr: rr / dsafe,
                                  iters=nd.iters)
            return M_jac

        child_Ms = [make(c) for c in nd.children]
        child_idx = [_index(A, _node_idx(c, assembler)) for c in nd.children]

        if nd.combine == "schur":
            assert len(nd.children) == 2, "Schur node needs 2 children"
            iu, ip = child_idx
            Mu, Mp_inner = child_Ms
            _, Bt, B, S_neg = _schur_parts(A, iu, ip, n)

            def solve_S(rp):
                z, _ = cg(S_neg, -rp, M=Mp_inner, tol=1e-2,
                          maxiter=nd.schur_iters)
                return z

            pu, pp = _pos(idx_np, iu), _pos(idx_np, ip)

            def M_schur(r):
                zu, zp = _schur_apply(nd.schur_fact, r[pu], r[pp], Mu,
                                      solve_S, B, Bt)
                return (r.new_zeros(idx.shape[0]).index_copy(0, pu, zu)
                        .index_copy(0, pp, zp))

            return M_schur

        if nd.combine == "multiplicative":
            def M_mult(r):
                zg = r.new_zeros(n)
                rg = _embed(r, idx, n)
                for ci, cm in zip(child_idx, child_Ms):
                    rr = (rg - A @ zg)[ci]
                    zg = zg.index_add(0, ci, cm(rr))
                return zg[idx]
            return M_mult

        def M_add(r):
            rg = _embed(r, idx, n)
            zg = r.new_zeros(n)
            for ci, cm in zip(child_idx, child_Ms):
                zg = zg.index_copy(0, ci, cm(rg[ci]))
            return zg[idx]
        return M_add

    root_idx = _index(A, _node_idx(node, assembler))
    M_root = make(node)

    def M(r):
        return torch.zeros_like(r).index_copy(0, root_idx,
                                              M_root(r[root_idx]))

    return M


def _pos(parent_idx, child_idx) -> torch.Tensor:
    """Static positions of child dofs within the parent's index array (on
    the child index's device)."""
    p = np.asarray(parent_idx)
    c = child_idx.cpu().numpy()
    lut = np.full(int(p.max()) + 1, -1, np.int64)
    lut[p] = np.arange(len(p))
    pos = lut[c]
    assert (pos >= 0).all(), "child split not contained in parent"
    return torch.as_tensor(pos, device=child_idx.device)


def schur_fieldsplit(A, split_u: Split, split_p: Split, pc_u: Callable,
                     fact: str = "full", schur_iters: int = 10,
                     u_iters: int = 4) -> Callable:
    """Schur-complement preconditioner for [[F, B'],[B, C]] saddle systems
    (PCFIELDSPLIT type SCHUR; SetSchurFactorizationType semantics).

    The Schur complement S = C - B diag(F)^{-1} B' is applied matrix-free
    and solved approximately with ``schur_iters`` unpreconditioned CG
    iterations; F-solves use ``u_iters`` Richardson sweeps of pc_u.
    fact: "diag" | "lower" | "upper" | "full" (LDU).
    """
    n = A.n_rows
    iu, ip = _index(A, split_u.idx), _index(A, split_p.idx)
    F, Bt, B, S_neg = _schur_parts(A, iu, ip, n)

    def solve_F(ru):
        return richardson(F, ru, M=pc_u, iters=u_iters)

    def solve_S(rp):
        # S z = rp  <=>  S_neg z = -rp (keeps CG on an SPD operator)
        z, _ = cg(S_neg, -rp, tol=1e-2, maxiter=schur_iters)
        return z

    def M(r):
        zu, zp = _schur_apply(fact, r[iu], r[ip], solve_F, solve_S, B, Bt)
        return torch.zeros_like(r).index_copy(0, iu, zu).index_copy(0, ip,
                                                                   zp)

    return M
