"""The plain eigensolve and adjoint of the reference: SciPy's SuperLU and
ARPACK, nothing of the program.

``lowest_pairs`` finds the eigenpairs of K phi = lam M phi nearest the
shift by ARPACK in shift-invert mode on a SuperLU factor of K - sigma M.
``adjoint_pairs`` turns the seeds (lamb, Phib) of a function of the
eigenpairs into the bilinear forms whose derivative in the design is the
function's total derivative. For each simple mode i, M-normalised:

    dlam_i = phi_i^T (dK - lam_i dM) phi_i
    phi_b^T dphi_i = -psi_i^T (dK - lam_i dM) phi_i
                     - (phi_b . phi_i) / 2 * phi_i^T dM phi_i

where psi_i solves (K - lam_i M) psi_i = g_i, g_i = phi_b - M phi_i
(phi_i . phi_b), with phi_i^T M psi_i = 0. The matrix is singular along
phi_i, so the solve is Nelson's (AIAA J. 14:9, 1976): the row and column
of the entry k where |phi_i| is largest are replaced by the unit ones,
which pins psi_k = 0 and leaves a nonsingular matrix; g_i is orthogonal
to phi_i, so the dropped equation holds; then psi_i loses its phi_i
component. One SuperLU factor a mode, the modes in threads. So the
derivative is
sum_i UK_i^T dK V_i + UM_i^T dM V_i with V_i = phi_i and the UK, UM below.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
from scipy.sparse import linalg as spla


def _lu(A):
    """SuperLU of a structurally symmetric matrix: a minimum-degree order
    of A + A^T kept by taking the pivots from the diagonal (row pivoting
    would undo it; on the shell matrices, whose DOF scales differ by
    1/t^2, it fills the factor tenfold)."""
    return spla.splu(sp.csc_matrix(A), permc_spec="MMD_AT_PLUS_A",
                     diag_pivot_thresh=0.0,
                     options={"SymmetricMode": True})


def _solve(A, lu, b):
    """lu's solve of A x = b with one step of iterative refinement."""
    x = lu.solve(b)
    return x + lu.solve(b - A @ x)


def lowest_pairs(K, M, sigma, k, dtype=np.float64):
    """The k eigenpairs of (K, M) nearest sigma, in ascending order, with
    Phi^T M Phi = I, computed in ``dtype``."""
    K = K.astype(dtype)
    M = M.astype(dtype)
    lu = _lu(K - dtype(sigma) * M)
    n = K.shape[0]
    op = spla.LinearOperator((n, n), matvec=lu.solve, dtype=dtype)
    v0 = np.ones(n, dtype=dtype)
    lam, Phi = spla.eigsh(K, k=k, M=M, sigma=sigma, OPinv=op, v0=v0,
                          which="LM")
    order = np.argsort(lam)
    lam, Phi = lam[order], Phi[:, order]
    # M-normalise again in the working precision
    Phi = Phi / np.sqrt(np.einsum("ij,ij->j", Phi, M @ Phi))[None, :]
    return lam.astype(dtype), Phi.astype(dtype)


def adjoint_pairs(K, M, lam, Phi, lamb, Phib, dtype=np.float64):
    """(UK, UM): the derivative of the seeded function in the design is
    sum_i UK_i^T dK Phi_i + UM_i^T dM Phi_i (see the module's docstring).
    A mode whose vector seed is zero needs no solve."""
    K = K.astype(dtype)
    M = M.astype(dtype)
    n, N = Phi.shape
    UK = np.zeros((n, N), dtype=dtype)
    UM = np.zeros((n, N), dtype=dtype)

    def mode(i):
        phi, l = Phi[:, i], lam[i]
        s = phi @ Phib[:, i]
        UK[:, i] = lamb[i] * phi
        UM[:, i] = (-lamb[i] * l - 0.5 * s) * phi
        if not np.any(Phib[:, i]):
            return
        Mphi = M @ phi
        g = Phib[:, i] - Mphi * s
        k = int(np.argmax(np.abs(phi)))
        keep = np.ones(n, dtype=dtype)
        keep[k] = 0.0
        D = sp.diags(keep)
        A = sp.csc_matrix(D @ (K - dtype(l) * M) @ D + sp.diags(1.0 - keep))
        psi = _solve(A, _lu(A), keep * g)
        psi -= (Mphi @ psi) * phi
        UK[:, i] -= psi
        UM[:, i] += l * psi

    with ThreadPoolExecutor(N) as pool:
        list(pool.map(mode, range(N)))
    return UK, UM
