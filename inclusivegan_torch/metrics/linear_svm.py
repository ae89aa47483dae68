"""A linear SVM on the device, for the ``ls`` metric: the problem that
``sklearn.svm.LinearSVC(C=0.1, dual="auto")`` solves, with a solver of the
port's own, since the card's machine has no scikit-learn.

With more samples than features, ``dual="auto"`` makes liblinear solve the
primal L2-regularized squared-hinge problem, its intercept a feature of
constant 1 (``intercept_scaling=1``) regularized with the weights:

    min_w  0.5 |w|^2 + C sum_i max(0, 1 - s_i w . x_i)^2,  s_i = 2 y_i - 1.

It is strictly convex and piecewise quadratic, so its minimizer is unique,
and Newton's method with the generalized Hessian I + 2C X_A^T X_A over the
active set A (margins below 1) and a backtracking line search reaches it
in a few steps. At d + 1 = 513 the Hessian is formed and solved by
Cholesky directly. The stopping rule is liblinear's, |grad| <= EPS
min(n+, n-) / n |grad(0)|, with EPS = 1e-6, a hundred times tighter than
its tol=1e-4; in float32 the solver also stops when a step lowers the
objective by no more than its rounding.
"""

from typing import Tuple

import torch

C = 0.1
EPS = 1e-6
MAX_ITER = 100


def fit_linear_svc(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x [n, d], y [n] in {0, 1}, on one device, in x's dtype. Returns the
    weights [d + 1] (the intercept last) and the Newton steps taken."""
    n = x.shape[0]
    X = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    s = y.to(x.dtype) * 2 - 1
    w = torch.zeros(X.shape[1], dtype=x.dtype, device=x.device)
    eye = torch.eye(X.shape[1], dtype=x.dtype, device=x.device)
    n_pos = int((y > 0).sum())
    scale = EPS * max(min(n_pos, n - n_pos), 1) / n

    def objective(w):
        m = torch.clamp_min(1 - s * (X @ w), 0)
        return 0.5 * w.dot(w) + C * m.dot(m), m

    f, m = objective(w)
    g0_norm = None
    for it in range(MAX_ITER):
        active = (m > 0).to(x.dtype)
        # d/dw of C (1 - s x.w)^2 on the active set: -2C s m x
        g = w - 2 * C * (X.T @ (s * m))
        g_norm = float(torch.linalg.vector_norm(g))
        if g0_norm is None:
            g0_norm = g_norm
        if g_norm <= scale * g0_norm:
            return w, it
        Xa = X * active[:, None]
        H = eye + 2 * C * (Xa.T @ Xa)
        p = -torch.cholesky_solve(g[:, None], torch.linalg.cholesky(H))[:, 0]
        slope = float(g.dot(p))
        step = 1.0
        while True:
            f_new, m_new = objective(w + step * p)
            if float(f_new) <= float(f) + 1e-4 * step * slope:
                break
            step *= 0.5
            if step < 1e-10:
                return w, it  # no further descent at this precision
        decrease = float(f) - float(f_new)
        w, f, m = w + step * p, f_new, m_new
        if decrease <= 8 * torch.finfo(x.dtype).eps * abs(float(f)):
            return w, it + 1  # the objective moves no more at this precision
    return w, MAX_ITER


def predict(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The class of each row of x [n, d]: 1 where w . (x, 1) > 0, else 0."""
    return (x @ w[:-1] + w[-1] > 0).to(torch.int32)
