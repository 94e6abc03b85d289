"""Multidimensional parabolic (quadratic) fits with covariance, for
likelihood-minimum finding (counterpart of chroma_tpu/parabola.py;
reference: chroma/parabola.py, with the chi2 probability from scipy
instead of ROOT)."""
import numpy as np
from scipy import stats


def build_design_matrix(x):
    """Design matrix for y = c + b.x + x^T A x with A symmetric."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    n, d = x.shape
    cols = [np.ones(n)]
    cols.extend(x[:, i] for i in range(d))
    for i in range(d):
        for j in range(i, d):
            scale = 1.0 if i == j else 2.0
            cols.append(scale * x[:, i] * x[:, j])
    return np.column_stack(cols)


def parabola_fit(x, y, yerr=None):
    """Weighted least-squares quadratic fit.

    Returns (c, b, A, covariance, chi2, prob): constant, gradient
    vector, symmetric Hessian-like matrix, parameter covariance, the
    chi^2 of the fit and its probability."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    y = np.asarray(y, dtype=float)
    n, d = x.shape
    if yerr is None:
        yerr = np.ones_like(y)
    yerr = np.asarray(yerr, dtype=float)

    M = build_design_matrix(x)
    W = 1.0 / yerr
    Mw = M * W[:, None]
    yw = y * W

    coef, residuals, rank, sv = np.linalg.lstsq(Mw, yw, rcond=None)
    cov = np.linalg.pinv(Mw.T @ Mw)

    c = coef[0]
    b = coef[1:1 + d]
    A = np.zeros((d, d))
    k = 1 + d
    for i in range(d):
        for j in range(i, d):
            A[i, j] = A[j, i] = coef[k]
            k += 1

    resid = (M @ coef - y) / yerr
    chi2 = float((resid ** 2).sum())
    ndof = max(n - len(coef), 1)
    prob = float(stats.chi2.sf(chi2, ndof))
    return c, b, A, cov, chi2, prob


def parabola_eval(x, c, b, A):
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return c + x @ b + np.einsum('ni,ij,nj->n', x, A, x)


def minimum(c, b, A):
    """Location and value of the quadratic's stationary point."""
    xmin = -0.5 * np.linalg.solve(A, b)
    return xmin, float(c + b @ xmin + xmin @ A @ xmin)
