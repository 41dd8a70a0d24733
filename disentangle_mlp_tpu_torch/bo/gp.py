"""Gaussian-process regression + Expected Improvement for the β search
(a copy of disentangle_mlp_tpu/bo/gp.py: the port imports nothing of the
JAX package, so it keeps its own; numpy and scipy only).

The reference hand-rolls a GP posterior over β∈[1,150] with an RBF kernel
(ℓ=30, σ_f=50) from five (β, FID) observations and plots mean ± 2σ; the
acquisition/argmax step was done manually (reference:
bayesian_optimization/final_bo.py:24-77). Here the GP is a reusable class
with the same kernel defaults, a Cholesky-based posterior, and an analytic
Expected-Improvement acquisition (minimization form) so the search loop
can run unattended (driver.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def rbf_kernel(x1: np.ndarray, x2: np.ndarray, ell: float = 30.0,
               sigma_f: float = 50.0) -> np.ndarray:
    """k(a,b) = σ_f² exp(−|a−b|² / (2ℓ²)) — the reference's kernel with its
    default hyperparameters (final_bo.py:24-28)."""
    x1 = np.asarray(x1, np.float64).reshape(-1, 1)
    x2 = np.asarray(x2, np.float64).reshape(-1, 1)
    sq = (x1 - x2.T) ** 2
    return sigma_f ** 2 * np.exp(-sq / (2.0 * ell ** 2))


@dataclasses.dataclass
class GaussianProcess:
    ell: float = 30.0
    sigma_f: float = 50.0
    noise_var: float = 0.0
    jitter: float = 1e-9

    x_train: Optional[np.ndarray] = None
    y_train: Optional[np.ndarray] = None
    _chol: Optional[np.ndarray] = None
    _alpha: Optional[np.ndarray] = None
    _y_mean: float = 0.0

    def kernel(self, a, b) -> np.ndarray:
        return rbf_kernel(a, b, self.ell, self.sigma_f)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        self.x_train = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        self._y_mean = float(y.mean())
        self.y_train = y
        k = self.kernel(self.x_train, self.x_train)
        k[np.diag_indices_from(k)] += self.noise_var + self.jitter
        self._chol = np.linalg.cholesky(k)
        resid = y - self._y_mean
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, resid))
        return self

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at query points."""
        assert self._chol is not None, "fit() first"
        x = np.asarray(x, np.float64).ravel()
        k_star = self.kernel(x, self.x_train)
        mean = self._y_mean + k_star @ self._alpha
        v = np.linalg.solve(self._chol, k_star.T)
        var = np.clip(
            np.diag(self.kernel(x, x)) - np.sum(v * v, axis=0), 0.0, None)
        return mean, np.sqrt(var)


def expected_improvement(gp: GaussianProcess, x_grid: np.ndarray,
                         xi: float = 0.01) -> np.ndarray:
    """EI for MINIMIZATION (lower FID is better):
    EI(x) = (f* − μ(x) − ξ)Φ(z) + σ(x)φ(z), z = (f* − μ − ξ)/σ."""
    from scipy.stats import norm

    mean, std = gp.predict(x_grid)
    f_best = float(np.min(gp.y_train))
    imp = f_best - mean - xi
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(std > 0, imp / std, 0.0)
        ei = imp * norm.cdf(z) + std * norm.pdf(z)
    return np.where(std > 0, np.clip(ei, 0.0, None), 0.0)
