"""Closed-form convergence-theory quantities (Section VI).

Every constant of Lemmas 1-4 and Theorems 1-2, so that the paper's analytic
figures (Fig. 2: error vs delta; Fig. 3: error vs d) come out exactly and
the tests can hold the round's measured bias and variance against the
bounds. Pure Python: the port's own copy of the reference's module, equal
to it number for number.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "lemma1_deviation",
    "lemma2_variance_bound",
    "kappas",
    "xis",
    "com_lad_error_term",
    "lad_error_term",
    "com_lad_error_order",
    "lad_error_order",
    "baseline_error_order",
    "max_learning_rate",
    "min_d_for_improvement",
    "TheoryParams",
]


@dataclasses.dataclass(frozen=True)
class TheoryParams:
    n: int  # number of devices N
    h: int  # number of honest devices H (> N/2)
    d: int  # computational load (subsets per device)
    kappa: float  # robustness coefficient of the aggregation rule
    beta: float = 1.0  # heterogeneity bound (Assumption 2)
    delta: float = 0.0  # compression constant (Definition 2)
    lipschitz: float = 1.0  # L (Assumption 1)

    def __post_init__(self):
        if not (self.h > self.n / 2):
            raise ValueError(f"need H > N/2, got N={self.n}, H={self.h}")
        if not (1 <= self.d <= self.n):
            raise ValueError(f"need 1 <= d <= N, got d={self.d}")


def lemma1_deviation(n: int, h: int, d: int) -> float:
    """Lemma 1 / eq. (17): (N-H)(N-d) / (d H (N-1) N)."""
    return (n - h) * (n - d) / (d * h * (n - 1) * n)


def lemma2_variance_bound(n: int, d: int, beta: float) -> float:
    """Lemma 2 / eq. (18): (N-d) beta^2 / (d (N-1))."""
    return (n - d) * beta**2 / (d * (n - 1))


def kappas(p: TheoryParams) -> tuple[float, float, float, float]:
    """kappa_1..kappa_4 of eqs. (21)-(25) (Com-LAD constants)."""
    n, h, d, beta, delta = p.n, p.h, p.d, p.beta, p.delta
    lam = lemma1_deviation(n, h, d)  # (N-H)(N-d)/(dH(N-1)N)
    k1 = n * beta**2 * ((1.0 / h + 1.0) * 4.0 * delta / d) + 4.0 * beta**2 * (n - d) * n / (
        d * h * (n - 1)
    )
    k2 = ((1.0 / h + 1.0) * 4.0 * delta / d + 4.0 * lam) / n
    k3 = (4.0 * delta / (h * d) + 4.0 * lam) * n * beta**2
    k4 = 2.0 / n**2 + 4.0 * delta / (h * d * n) + 4.0 * (n - h) * (n - d) / (
        d * h * (n - 1) * n**2
    )
    return k1, k2, k3, k4


def xis(p: TheoryParams) -> tuple[float, float, float, float]:
    """xi_1..xi_4 of eqs. (28)-(31), exactly as printed in the paper.

    NOTE (paper inconsistency): the paper derives Theorem 2 "by substituting
    delta = 0 into Theorem 1", which gives xi_3 = 4*lam*N*beta^2 and a
    matching 4x term in xi_4 — but eqs. (30)-(31) print an 8x coefficient
    (2x the delta=0 limit of eqs. (24)-(25)).  We implement the printed
    constants here and the substitution in ``kappas(delta=0)``; both bound
    the same quantity, the printed xis being looser by <= 2x.
    """
    p0 = dataclasses.replace(p, delta=0.0)
    n, h, d, beta = p0.n, p0.h, p0.d, p0.beta
    x1 = 4.0 * beta**2 * (n - d) * n / (d * h * (n - 1))
    x2 = 4.0 * (n - h) * (n - d) / (d * h * (n - 1) * n) / n
    x3 = 8.0 * (n - h) * (n - d) / (d * h * (n - 1)) * beta**2
    x4 = 2.0 / n**2 + 8.0 * (n - h) * (n - d) / (d * h * (n - 1) * n**2)
    return x1, x2, x3, x4


def max_learning_rate(p: TheoryParams) -> float:
    """Theorem 1 step-size ceiling: (1/N - sqrt(kappa kappa_2)) / (L kappa kappa_2 + L kappa_4)."""
    k1, k2, k3, k4 = kappas(p)
    num = 1.0 / p.n - math.sqrt(p.kappa * k2)
    den = p.lipschitz * (p.kappa * k2 + k4)
    if num <= 0:
        return 0.0  # convergence condition sqrt(kappa kappa_2) < 1/N violated
    return num / den


def com_lad_error_term(p: TheoryParams, gamma0: float) -> float:
    """Exact eq. (32) error floor of Com-LAD for a given step size.

    Degenerate corner: kappa*kappa_2 = 0 (e.g. d = N with delta = 0, or a
    perfect aggregator) makes the Young's-inequality eta = sqrt(kappa k2)
    choice vanish; the first numerator term is then 0 (its k1*sqrt(kappa/k2)/2
    limit, noting k1 ~ k2 -> 0 jointly in d and delta).
    """
    k1, k2, k3, k4 = kappas(p)
    L, kap = p.lipschitz, p.kappa
    lead = 0.0 if kap * k2 == 0.0 else k1 * math.sqrt(kap) / (2.0 * math.sqrt(k2))
    num = lead + gamma0 * (L * kap * k1 + L * k3)
    den = (1.0 / p.n - math.sqrt(kap * k2)) - gamma0 * (L * kap * k2 + L * k4)
    if den <= 0:
        return float("inf")
    return num / den


def lad_error_term(p: TheoryParams, gamma0: float) -> float:
    """Exact eq. (34) error floor of LAD (delta = 0)."""
    return com_lad_error_term(dataclasses.replace(p, delta=0.0), gamma0)


def com_lad_error_order(p: TheoryParams) -> float:
    """eq. (33): the big-O error scaling kappa_1 sqrt(kappa) / sqrt(kappa_2)."""
    k1, k2, _, _ = kappas(p)
    return k1 * math.sqrt(p.kappa) / math.sqrt(k2)


def lad_error_order(p: TheoryParams) -> float:
    """eq. (35): O(beta^2 sqrt(kappa (N-d) N / (d H (N-H))))."""
    n, h, d = p.n, p.h, p.d
    if d == n:
        return 0.0
    return p.beta**2 * math.sqrt(p.kappa * (n - d) * n / (d * h * (n - h)))


def baseline_error_order(p: TheoryParams) -> float:
    """eq. (36): the no-coding robust-aggregation floor O(beta^2 kappa) [23]."""
    return p.beta**2 * p.kappa


def min_d_for_improvement(n: int, h: int, kappa: float) -> int:
    """Section VI: LAD beats the [23] baseline when d >= N^2/(kappa H (N-H) + N)."""
    return math.ceil(n**2 / (kappa * h * (n - h) + n))
