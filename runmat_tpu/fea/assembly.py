"""Finite-element assembly: batched TET4 stiffness/mass for elasticity and
scalar diffusion.

Reference parity: runmat-analysis/fea/src/assembly. Here all element
matrices are produced in one batched einsum over the whole mesh (no Python
per-element loop for the matrix algebra), then scattered into triplets.
"""

from __future__ import annotations

import numpy as np

from ..sparse import SparseMatrix
from .mesh import TetMesh


def _grads_and_vols(mesh: TetMesh):
    """Shape-function gradients (M, 4, 3) and volumes (M,) for all tets."""
    p = mesh.nodes[mesh.tets]          # (M, 4, 3)
    J = p[:, 1:] - p[:, :1]            # (M, 3, 3) edge matrix
    detJ = np.linalg.det(J)
    vol = detJ / 6.0
    Jinv = np.linalg.inv(J)            # (M, 3, 3)
    # x(xi) = p0 + sum_k (p_{k+1}-p0) xi_k, so dx_i/dxi_k = J[k,i] = (J^T)[i,k]
    # and dN/dx = dN/dxi * dxi/dx = g_local @ inv(J^T) = g_local @ (J^-1)^T
    g_local = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    grads = np.einsum("nk,mik->mni", g_local, Jinv)   # (M, 4, 3)
    return grads, np.abs(vol), np.sign(vol)


def elasticity_D(E: float, nu: float) -> np.ndarray:
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[3:, 3:] = np.eye(3) * mu
    return D


def assemble_elasticity(mesh: TetMesh, E: float, nu: float,
                        rho: float = 0.0, escale: np.ndarray = None):
    """Global stiffness K (3N x 3N) and lumped mass M diag (3N,).
    `escale` (M,) optionally scales each element's modulus — the secant-
    stiffness hook used by the nonlinear Newton pipeline."""
    grads, vol, _ = _grads_and_vols(mesh)
    M = mesh.n_tets
    B = np.zeros((M, 6, 12))
    for a in range(4):
        gx, gy, gz = grads[:, a, 0], grads[:, a, 1], grads[:, a, 2]
        c = 3 * a
        B[:, 0, c] = gx
        B[:, 1, c + 1] = gy
        B[:, 2, c + 2] = gz
        B[:, 3, c] = gy
        B[:, 3, c + 1] = gx
        B[:, 4, c + 1] = gz
        B[:, 4, c + 2] = gy
        B[:, 5, c] = gz
        B[:, 5, c + 2] = gx
    D = elasticity_D(E, nu)
    w = vol if escale is None else vol * np.asarray(escale, np.float64)
    Ke = np.einsum("mia,ij,mjb,m->mab", B, D, B, w, optimize=True)
    # scatter
    dofs = (3 * mesh.tets[:, :, None] + np.arange(3)[None, None, :]) \
        .reshape(M, 12)
    ii = np.repeat(dofs, 12, axis=1).reshape(-1)
    jj = np.tile(dofs, (1, 12)).reshape(-1)
    K = SparseMatrix.from_triplets(ii, jj, Ke.reshape(-1),
                                   3 * mesh.n_nodes, 3 * mesh.n_nodes)
    mdiag = None
    if rho > 0:
        mdiag = np.zeros(3 * mesh.n_nodes)
        melem = rho * vol / 4.0
        for a in range(4):
            for c in range(3):
                np.add.at(mdiag, 3 * mesh.tets[:, a] + c, melem)
    return K, mdiag


def assemble_diffusion(mesh: TetMesh, k: float, rho_c: float = 0.0):
    """Scalar Laplacian (conduction k, capacity rho*c lumped)."""
    grads, vol, _ = _grads_and_vols(mesh)
    Ke = k * np.einsum("mai,mbi,m->mab", grads, grads, vol, optimize=True)
    M = mesh.n_tets
    ii = np.repeat(mesh.tets, 4, axis=1).reshape(-1)
    jj = np.tile(mesh.tets, (1, 4)).reshape(-1)
    K = SparseMatrix.from_triplets(ii, jj, Ke.reshape(-1),
                                   mesh.n_nodes, mesh.n_nodes)
    cdiag = None
    if rho_c > 0:
        cdiag = np.zeros(mesh.n_nodes)
        np.add.at(cdiag, mesh.tets.reshape(-1),
                  np.repeat(rho_c * vol / 4.0, 4))
    return K, cdiag


def apply_dirichlet(K: SparseMatrix, f: np.ndarray, fixed: np.ndarray,
                    values=0.0):
    """Reduce the system to free dofs. Returns (K_ff, f_f, free_index)."""
    n = K.n
    fixed = np.asarray(fixed, dtype=np.int64)
    mask = np.ones(n, dtype=bool)
    mask[fixed] = False
    free = np.nonzero(mask)[0]
    remap = -np.ones(n, dtype=np.int64)
    remap[free] = np.arange(free.size)
    ii, jj, vv = K.triplets()
    if np.isscalar(values):
        uvals = np.full(fixed.size, float(values))
    else:
        uvals = np.asarray(values, dtype=np.float64)
    u_fixed = np.zeros(n)
    u_fixed[fixed] = uvals
    # move K_fc * u_c to the rhs
    keep_rows = mask[ii]
    f = f.copy()
    cross = keep_rows & ~mask[jj]
    np.subtract.at(f, ii[cross], vv[cross] * u_fixed[jj[cross]])
    keep = keep_rows & mask[jj]
    Kff = SparseMatrix.from_triplets(remap[ii[keep]], remap[jj[keep]],
                                     vv[keep], free.size, free.size)
    return Kff, f[free], free, u_fixed
