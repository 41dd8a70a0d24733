from .gp import GaussianProcess, expected_improvement, rbf_kernel
from .driver import BetaSearch

__all__ = ["GaussianProcess", "expected_improvement", "rbf_kernel",
           "BetaSearch"]
