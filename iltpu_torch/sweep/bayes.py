"""Bayesian hyperparameter optimisation for `train_all --sweep`: the port's
own copy of `iltpu/sweep/bayes.py`, with the same seeds and arithmetic, so
that its trials equal iltpu's (numpy and scipy only).

- Sobol quasi-random initialisation (scipy.stats.qmc).
- A Gaussian-process surrogate (Matern-5/2 kernel, fitted noise) with
  expected-improvement acquisition maximised over Sobol candidates.
- Log-scale and choice parameters, and an early stop after a number of
  trials that did not improve on the best.
"""

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.stats import norm, qmc


@dataclass
class Param:
    """One search dimension (mirrors an Ax parameter config entry)."""

    name: str
    type: str  # "range" | "choice" | "fixed"
    bounds: Optional[Tuple[float, float]] = None  # for range
    values: Optional[Sequence] = None  # for choice / fixed
    log_scale: bool = False
    value_type: str = "float"  # "float" | "int" | "bool" | "str"

    def to_unit(self, v) -> float:
        if self.type == "choice":
            return self.values.index(v) / max(len(self.values) - 1, 1)
        lo, hi = self.bounds
        if self.log_scale:
            return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (v - lo) / (hi - lo)

    def from_unit(self, u: float):
        if self.type == "fixed":
            return self.values[0]
        if self.type == "choice":
            idx = min(int(u * len(self.values)), len(self.values) - 1)
            return self.values[idx]
        lo, hi = self.bounds
        if self.log_scale:
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if self.value_type == "int":
            v = int(round(v))
            v = max(min(v, int(hi)), int(lo))
        return v


def _matern52(d2: np.ndarray) -> np.ndarray:
    d = np.sqrt(np.maximum(d2, 0.0))
    s = math.sqrt(5.0) * d
    return (1.0 + s + s * s / 3.0) * np.exp(-s)


class GP:
    """Minimal Matern-5/2 GP with per-dimension shared lengthscale chosen by
    grid-searched marginal likelihood. Enough for <=100-trial sweeps."""

    def __init__(self, x: np.ndarray, y: np.ndarray, noise: float = 1e-4):
        self.x = x
        self.y_mean = float(np.mean(y))
        self.y_std = float(np.std(y)) or 1.0
        self.y = (y - self.y_mean) / self.y_std
        self.noise = noise
        self.ls = self._fit_lengthscale()
        k = self._k(self.x, self.x) + np.eye(len(x)) * self.noise
        self.chol = np.linalg.cholesky(k)
        self.alpha = np.linalg.solve(
            self.chol.T, np.linalg.solve(self.chol, self.y)
        )

    def _k(self, a: np.ndarray, b: np.ndarray, ls: Optional[float] = None):
        ls = self.ls if ls is None else ls
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1) / (ls * ls)
        return _matern52(d2)

    def _fit_lengthscale(self) -> float:
        best_ls, best_ll = 0.5, -np.inf
        n = len(self.x)
        for ls in (0.1, 0.2, 0.3, 0.5, 0.8, 1.2, 2.0):
            k = self._k(self.x, self.x, ls) + np.eye(n) * self.noise
            try:
                chol = np.linalg.cholesky(k)
            except np.linalg.LinAlgError:
                continue
            a = np.linalg.solve(chol.T, np.linalg.solve(chol, self.y))
            ll = -0.5 * self.y @ a - np.log(np.diag(chol)).sum()
            if ll > best_ll:
                best_ls, best_ll = ls, ll
        return best_ls

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = self._k(xq, self.x)
        mu = ks @ self.alpha
        v = np.linalg.solve(self.chol, ks.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-9)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


@dataclass
class Trial:
    index: int
    params: Dict
    value: Optional[float] = None
    method: str = "sobol"  # "sobol" | "gp-ei": which acquisition proposed it


@dataclass
class BayesOpt:
    """Sequential maximiser: ask() -> params, tell(trial, value).

    `minimize=False` maximises (the reference's objective is a score to
    maximise, `train_all.py:28`). `early_stop_epochs` mirrors the reference's
    stop-after-5-non-improving-epochs (`conf/train_all_config.yaml:17-18`).
    """

    space: List[Param]
    total_trials: int = 30
    sobol_trials: int = 8
    minimize: bool = False
    seed: int = 0
    early_stop_epochs: int = 5
    candidates: int = 512
    trials: List[Trial] = field(default_factory=list)

    def __post_init__(self):
        self._active = [p for p in self.space if p.type != "fixed"]
        d = max(len(self._active), 1)
        self._sobol = qmc.Sobol(d, scramble=True, seed=self.seed)
        self._best = -np.inf
        self._epochs_since_improvement = 0

    # ------------------------------------------------------------------ api
    def ask(self) -> Trial:
        i = len(self.trials)
        if i < self.sobol_trials or sum(t.value is not None for t in self.trials) < 3:
            u, method = self._sobol.random(1)[0], "sobol"
        else:
            u, method = self._acquire(), "gp-ei"
        params = self._decode(u)
        trial = Trial(index=i, params=params, method=method)
        self.trials.append(trial)
        return trial

    def tell(self, trial: Trial, value: float):
        trial.value = float(value)
        signed = -value if self.minimize else value
        if signed > self._best:
            self._best = signed
            self._epochs_since_improvement = 0
        else:
            self._epochs_since_improvement += 1

    @property
    def should_stop(self) -> bool:
        done = sum(t.value is not None for t in self.trials)
        return (
            done >= self.total_trials
            or self._epochs_since_improvement >= self.early_stop_epochs
        )

    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.value is not None]
        key = (lambda t: -t.value) if self.minimize else (lambda t: t.value)
        return max(done, key=key)

    # ------------------------------------------------------------ internals
    def _decode(self, u: np.ndarray) -> Dict:
        params = {}
        j = 0
        for p in self.space:
            if p.type == "fixed":
                params[p.name] = p.values[0]
            else:
                params[p.name] = p.from_unit(float(u[j]))
                j += 1
        return params

    def _encode(self, params: Dict) -> np.ndarray:
        return np.array(
            [p.to_unit(params[p.name]) for p in self._active], np.float64
        )

    def _acquire(self) -> np.ndarray:
        done = [t for t in self.trials if t.value is not None]
        x = np.stack([self._encode(t.params) for t in done])
        y = np.array([t.value for t in done], np.float64)
        if self.minimize:
            y = -y
        gp = GP(x, y)
        cand = self._sobol.random(self.candidates)
        mu, sigma = gp.predict(cand)
        best = y.max()
        z = (mu - best) / sigma
        ei = (mu - best) * norm.cdf(z) + sigma * norm.pdf(z)
        return cand[int(np.argmax(ei))]


def space_from_config(entries: Dict) -> List[Param]:
    """Build a search space from a YAML dict shaped like the reference's Ax
    spaces (`conf/hyperparameter_search_space/*.yaml`): each key maps to
    {type: range|choice|fixed, bounds|values, log_scale, value_type}."""
    space = []
    for name, spec in entries.items():
        space.append(
            Param(
                name=name,
                type=spec["type"],
                bounds=tuple(spec["bounds"]) if "bounds" in spec else None,
                values=list(spec["values"])
                if "values" in spec
                else ([spec["value"]] if "value" in spec else None),
                log_scale=bool(spec.get("log_scale", False)),
                value_type=spec.get("value_type", "float"),
            )
        )
    return space
