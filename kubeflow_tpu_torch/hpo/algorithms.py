"""Suggestion algorithms: the Katib algorithm-service zoo, numpy-native.

Capability parity with the reference's suggestion services [upstream:
kubeflow/katib -> pkg/suggestion/v1beta1/{random,grid,hyperopt,skopt,...}]:
``random``, ``grid``, ``tpe`` (tree-structured Parzen estimator, the
hyperopt default), and ``bayesianoptimization`` (GP + expected improvement,
the skopt default named in baseline config 4).  The reference shells out to
hyperopt/optuna/skopt pips; none are installed here, so the estimators are
implemented directly (numpy/scipy) behind the same GetSuggestions contract.

All suggesters are pure: (search space, observation history, count) ->
assignments.  State lives in the Experiment's trial history, so the service
can restart at any time — same property Katib gets by re-sending full
history on every GetSuggestions call.

The port's copy of ``kubeflow_tpu/hpo/algorithms.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import math
import random as pyrandom
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..api.experiment import (
    FeasibleSpace,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
)


@dataclass
class Observation:
    """One completed trial: assignments + objective value."""

    assignments: dict[str, object]
    value: float
    #: trial name (issue-ordered); population-based algorithms use it to
    #: name checkpoint-fork parents
    trial: Optional[str] = None


@dataclass
class SuggestRequest:
    parameters: list[ParameterSpec]
    objective_type: ObjectiveType
    history: list[Observation] = field(default_factory=list)
    count: int = 1
    settings: dict[str, str] = field(default_factory=dict)
    seed: Optional[int] = None
    #: how many assignments have ALREADY been issued for this experiment
    #: (not just completed) — the dedup cursor for enumerative algorithms;
    #: parallel trials mean issued > len(history)
    issued: int = 0


class Suggester:
    name = "base"

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        raise NotImplementedError


# -- parameter-space encoding ------------------------------------------------


def _sample_one(p: ParameterSpec, rng: pyrandom.Random) -> object:
    fs = p.feasible_space
    if p.parameter_type == ParameterType.DOUBLE:
        if fs.log_scale:
            lo, hi = math.log(fs.min), math.log(fs.max)
            return math.exp(rng.uniform(lo, hi))
        return rng.uniform(fs.min, fs.max)
    if p.parameter_type == ParameterType.INT:
        return rng.randint(int(fs.min), int(fs.max))
    return rng.choice(list(fs.list_))


def _to_unit(p: ParameterSpec, v: object) -> float:
    """Map a parameter value into [0,1] for continuous surrogate models."""
    fs = p.feasible_space
    if p.parameter_type == ParameterType.DOUBLE:
        if fs.log_scale:
            return (math.log(float(v)) - math.log(fs.min)) / (
                math.log(fs.max) - math.log(fs.min) or 1.0)
        return (float(v) - fs.min) / ((fs.max - fs.min) or 1.0)
    if p.parameter_type == ParameterType.INT:
        return (float(v) - fs.min) / ((fs.max - fs.min) or 1.0)
    values = list(fs.list_)
    return values.index(v) / max(len(values) - 1, 1)


def _from_unit(p: ParameterSpec, u: float) -> object:
    fs = p.feasible_space
    u = min(max(u, 0.0), 1.0)
    if p.parameter_type == ParameterType.DOUBLE:
        if fs.log_scale:
            return math.exp(
                math.log(fs.min) + u * (math.log(fs.max) - math.log(fs.min)))
        return fs.min + u * (fs.max - fs.min)
    if p.parameter_type == ParameterType.INT:
        return int(round(fs.min + u * (fs.max - fs.min)))
    values = list(fs.list_)
    return values[min(int(u * len(values)), len(values) - 1)]


# -- algorithms ---------------------------------------------------------------


class RandomSearch(Suggester):
    name = "random"

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        # explicit seed -> reproducible; otherwise OS entropy, so repeated
        # calls at the same history length don't replay identical points
        # (e.g. re-suggesting after a failed trial)
        rng = pyrandom.Random(req.seed)
        return [
            {p.name: _sample_one(p, rng) for p in req.parameters}
            for _ in range(req.count)
        ]


class GridSearch(Suggester):
    """Cartesian grid; continuous params discretized by step (or a default
    resolution), same contract as Katib's grid suggester."""

    name = "grid"
    #: points per continuous axis when the spec gives no ``step`` — kept
    #: deliberately coarse because grid cost is resolution^d (Katib's grid
    #: suggester simply REQUIRES step for doubles; defaulting is kinder).
    #: Override per experiment with settings["resolution"].
    DEFAULT_RESOLUTION = 4

    def _axis(self, p: ParameterSpec, resolution: int) -> list[object]:
        fs = p.feasible_space
        if p.parameter_type in (ParameterType.CATEGORICAL, ParameterType.DISCRETE):
            return list(fs.list_)
        if p.parameter_type == ParameterType.INT:
            step = int(fs.step or 1)
            return list(range(int(fs.min), int(fs.max) + 1, step))
        n = int((fs.max - fs.min) / fs.step) + 1 if fs.step else resolution
        return [fs.min + i * (fs.max - fs.min) / max(n - 1, 1) for i in range(n)]

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        resolution = int(req.settings.get(
            "resolution", self.DEFAULT_RESOLUTION))
        axes = [(p.name, self._axis(p, resolution)) for p in req.parameters]
        total = math.prod(len(v) for _, v in axes)
        # cursor = assignments already issued (running trials included), NOT
        # completed history — else parallel trials revisit cells
        start = max(req.issued, len(req.history))
        out = []
        for flat in range(start, min(start + req.count, total)):
            point, rem = {}, flat
            for name, values in axes:
                point[name] = values[rem % len(values)]
                rem //= len(values)
            out.append(point)
        return out


class Tpe(Suggester):
    """Tree-structured Parzen estimator (hyperopt's default algorithm).

    Split history at the gamma-quantile into good/bad sets, model each with
    a Parzen window (per-dimension Gaussian KDE in unit space), and pick the
    candidate maximizing the density ratio l(x)/g(x).
    """

    name = "tpe"
    N_STARTUP = 5
    N_CANDIDATES = 32
    GAMMA = 0.25
    #: Parzen-window bandwidth FLOOR in unit space.  The working bandwidth
    #: is per-dimension Scott's-rule (std(centers_d) * n^(-1/(d+4))),
    #: floored here so early history (few points, zero spread on a dim)
    #: still explores; override with settings["bandwidth"].
    BANDWIDTH = 0.15

    def _bandwidths(self, centers: np.ndarray, floor: float) -> np.ndarray:
        """Scott's-rule per-dimension bandwidths — adapts to history
        spread and dimensionality instead of one magic constant (r2
        advisor: fixed 0.15 degrades past ~4 dims)."""
        n, d = centers.shape
        scott = centers.std(axis=0) * n ** (-1.0 / (d + 4))
        return np.clip(scott, floor, 0.5)

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        if len(req.history) < self.N_STARTUP:
            return RandomSearch().suggest(req)
        rng = pyrandom.Random(req.seed)
        nprng = np.random.default_rng(rng.randrange(2**31))
        sign = -1.0 if req.objective_type == ObjectiveType.MAXIMIZE else 1.0
        pts = np.array(
            [[_to_unit(p, ob.assignments[p.name]) for p in req.parameters]
             for ob in req.history])
        vals = sign * np.array([ob.value for ob in req.history])
        n_good = max(1, int(self.GAMMA * len(vals)))
        order = np.argsort(vals)
        good, bad = pts[order[:n_good]], pts[order[n_good:]]
        floor = float(req.settings.get("bandwidth", self.BANDWIDTH))
        bw_good = self._bandwidths(good, floor)   # [d]
        bw_all = self._bandwidths(pts, floor)

        def density(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
            # product over dims of mean-of-gaussians (Parzen window)
            d2 = (x[:, None, :] - centers[None, :, :]) ** 2
            kern = np.exp(-0.5 * d2 / bw_all**2)
            return np.log(kern.mean(axis=1) + 1e-12).sum(axis=-1)

        out = []
        bad_aug = bad  # grows with each pick so a batch doesn't collapse
        for _ in range(req.count):
            # candidates drawn around the good set
            idx = nprng.integers(0, len(good), self.N_CANDIDATES)
            cand = good[idx] + nprng.normal(
                0, 1.0, (self.N_CANDIDATES, pts.shape[1])) * bw_good
            cand = np.clip(cand, 0.0, 1.0)
            score = density(cand, good) - density(cand, bad_aug)
            best = cand[int(np.argmax(score))]
            # treat the chosen point as "bad" for the rest of the batch:
            # the l/g ratio then penalizes re-picking its neighborhood, so
            # count>1 returns diverse assignments (Katib's TPE batches via
            # hyperopt get this from sequential model updates)
            bad_aug = np.concatenate([bad_aug, best[None, :]], axis=0)
            out.append({
                p.name: _from_unit(p, float(best[i]))
                for i, p in enumerate(req.parameters)
            })
        return out


class BayesianOptimization(Suggester):
    """GP surrogate + expected improvement (the skopt-backed Katib algorithm
    named in baseline config 4), with an RBF kernel in unit space."""

    name = "bayesianoptimization"
    N_STARTUP = 4
    N_CANDIDATES = 256
    #: RBF length-scale FLOOR; the working scale is the median pairwise
    #: distance of the history in unit space (the standard median
    #: heuristic), so it adapts to dimensionality — median distance grows
    #: ~sqrt(d) and a fixed 0.2 would make every point look far in high d.
    #: Override with settings["length_scale"].
    LENGTH_SCALE = 0.2
    NOISE = 1e-6

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        if len(req.history) < self.N_STARTUP:
            return RandomSearch().suggest(req)
        from scipy.stats import norm

        rng = np.random.default_rng(req.seed)
        sign = -1.0 if req.objective_type == ObjectiveType.MAXIMIZE else 1.0
        x = np.array(
            [[_to_unit(p, ob.assignments[p.name]) for p in req.parameters]
             for ob in req.history])
        y = sign * np.array([ob.value for ob in req.history])
        y_mean, y_std = y.mean(), y.std() or 1.0
        yn = (y - y_mean) / y_std

        if "length_scale" in req.settings:
            scale = float(req.settings["length_scale"])
        else:
            diff2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
            pair = np.sqrt(diff2[np.triu_indices(len(x), k=1)])
            med = float(np.median(pair)) if len(pair) else 0.0
            scale = max(med, self.LENGTH_SCALE)

        def kernel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / scale**2)

        k_xx = kernel(x, x) + self.NOISE * np.eye(len(x))
        l_chol = np.linalg.cholesky(k_xx)
        alpha = np.linalg.solve(l_chol.T, np.linalg.solve(l_chol, yn))

        out = []
        for _ in range(req.count):
            cand = rng.uniform(0, 1, (self.N_CANDIDATES, x.shape[1]))
            k_s = kernel(cand, x)
            mu = k_s @ alpha
            v = np.linalg.solve(l_chol, k_s.T)
            var = np.clip(1.0 - (v**2).sum(axis=0), 1e-12, None)
            sd = np.sqrt(var)
            best_y = yn.min()
            # expected improvement (minimization in normalized space)
            z = (best_y - mu) / sd
            ei = (best_y - mu) * norm.cdf(z) + sd * norm.pdf(z)
            best = cand[int(np.argmax(ei))]
            out.append({
                p.name: _from_unit(p, float(best[i]))
                for i, p in enumerate(req.parameters)
            })
            # avoid duplicate suggestions within one batch
            x = np.vstack([x, best[None, :]])
            yn = np.append(yn, mu[int(np.argmax(ei))])
            k_xx = kernel(x, x) + self.NOISE * np.eye(len(x))
            l_chol = np.linalg.cholesky(k_xx)
            alpha = np.linalg.solve(l_chol.T, np.linalg.solve(l_chol, yn))
        return out


class CmaEs(Suggester):
    """(mu/mu_w, lambda)-CMA-ES [Hansen's standard strategy; reference
    analog: Katib's goptuna/cmaes suggestion service].

    Stateless like every suggester here: the evolution state (mean, step
    size, covariance, evolution paths) is reconstructed by replaying the
    observation history in generation-sized chunks, so the gRPC service can
    restart mid-experiment and continue the same trajectory — the property
    Katib gets by re-sending full history per GetSuggestions call.  The
    controller feeds history in issue order including early-stopped trials'
    observations; a trial that fails with NO observation shifts generation
    boundaries, degrading adaptation gracefully (chunks still track the
    recent selection mean) rather than crashing.

    settings: population_size (default 4+floor(3 ln d)), sigma (initial
    step size in unit space, default 0.3).
    """

    name = "cmaes"

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        params = req.parameters
        d = len(params)
        lam = int(req.settings.get(
            "population_size", 4 + int(3 * math.log(max(d, 1) + 1e-12))))
        lam = max(lam, 2)
        sigma0 = float(req.settings.get("sigma", 0.3))
        seed = req.seed if req.seed is not None else 0

        mu = lam // 2
        w = np.log(lam / 2 + 0.5) - np.log(np.arange(1, mu + 1))
        w = w / w.sum()
        mu_eff = 1.0 / float(np.square(w).sum())
        c_sigma = (mu_eff + 2) / (d + mu_eff + 5)
        d_sigma = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (d + 1)) - 1) + c_sigma
        c_c = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
        c_1 = 2 / ((d + 1.3) ** 2 + mu_eff)
        c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
        chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

        mean = np.full(d, 0.5)
        sigma = sigma0
        cov = np.eye(d)
        p_sigma = np.zeros(d)
        p_c = np.zeros(d)

        # internal objective is MINIMIZED
        flip = -1.0 if req.objective_type == ObjectiveType.MAXIMIZE else 1.0
        hist = req.history
        n_gens = len(hist) // lam
        for g in range(n_gens):
            gen = hist[g * lam : (g + 1) * lam]
            xs = np.array([
                [_to_unit(p, o.assignments[p.name]) for p in params]
                for o in gen
            ])
            fs = np.array([flip * o.value for o in gen])
            order = np.argsort(fs)  # best first
            x_sel = xs[order[:mu]]
            old_mean = mean
            mean = w @ x_sel
            # evolution paths in the whitened frame
            c_inv_sqrt = _inv_sqrt(cov)
            y = (mean - old_mean) / max(sigma, 1e-12)
            p_sigma = (1 - c_sigma) * p_sigma + math.sqrt(
                c_sigma * (2 - c_sigma) * mu_eff) * (c_inv_sqrt @ y)
            h_sigma = float(
                np.linalg.norm(p_sigma)
                / math.sqrt(1 - (1 - c_sigma) ** (2 * (g + 1)))
                < (1.4 + 2 / (d + 1)) * chi_n
            )
            p_c = (1 - c_c) * p_c + h_sigma * math.sqrt(
                c_c * (2 - c_c) * mu_eff) * y
            arts = (x_sel - old_mean) / max(sigma, 1e-12)
            rank_mu = (w[:, None] * arts).T @ arts
            cov = (
                (1 - c_1 - c_mu) * cov
                + c_1 * (np.outer(p_c, p_c)
                         + (1 - h_sigma) * c_c * (2 - c_c) * cov)
                + c_mu * rank_mu
            )
            sigma = sigma * math.exp(
                (c_sigma / d_sigma) * (np.linalg.norm(p_sigma) / chi_n - 1))
            sigma = float(min(max(sigma, 1e-8), 1.0))

        # sample the current generation's candidates deterministically;
        # the cursor past complete generations indexes into this stream so
        # parallel suggest() calls hand out distinct members.  Like grid's
        # cursor, it defends with len(history): a driver that never sets
        # `issued` must still advance, not replay one point all generation.
        rng = np.random.default_rng(seed + 7919 * n_gens)
        issued_in_gen = max(max(req.issued, len(hist)) - n_gens * lam, 0)
        n_draw = issued_in_gen + req.count
        try:
            chol = np.linalg.cholesky(
                cov + 1e-12 * np.eye(d))
        except np.linalg.LinAlgError:
            chol = np.eye(d)
        z = rng.standard_normal((n_draw, d))
        points = mean[None, :] + sigma * (z @ chol.T)
        out = []
        for row in points[issued_in_gen:]:
            out.append({
                p.name: _from_unit(p, float(u)) for p, u in zip(params, row)})
        return out


def _inv_sqrt(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.maximum(vals, 1e-12)
    return vecs @ np.diag(vals ** -0.5) @ vecs.T


#: reserved assignment key PBT emits: name of the trial whose checkpoint
#: the new trial forks from ("" = fresh start).  Trial templates map it to
#: the runtime's resume env (e.g. KFT_RESUME_FROM).
PBT_PARENT_KEY = "__parent"


class Pbt(Suggester):
    """Population Based Training [Jade+ 2017; reference analog: Katib's PBT
    suggestion service, pkg/suggestion/v1beta1/pbt].

    Trials form generations of ``population_size``.  Each member of
    generation g+1 continues SOME generation-g member's training from its
    checkpoint: survivors (top 1-truncation by objective) continue
    themselves with unchanged hyperparameters; the bottom ``truncation``
    fraction is replaced by exploit+explore — fork a random top member's
    checkpoint and perturb its hyperparameters (continuous: x1.2 / /1.2;
    categorical: resampled with ``resample_prob``).

    The fork edge travels as the reserved ``__parent`` assignment
    (PBT_PARENT_KEY): the trial template maps it into the trainer's
    resume-from env, and the trainer copies the parent's checkpoint before
    training (train/llm.py KFT_PBT_ROOT contract).  Stateless like every
    suggester: generations are reconstructed from issue-ordered history.

    settings: population_size (default 4), truncation (default 0.25),
    perturb_factor (default 1.2), resample_prob (default 0.25).
    """

    name = "pbt"

    def suggest(self, req: SuggestRequest) -> list[dict[str, object]]:
        pop = max(2, int(req.settings.get("population_size", "4")))
        truncation = float(req.settings.get("truncation", "0.25"))
        factor = float(req.settings.get("perturb_factor", "1.2"))
        resample_prob = float(req.settings.get("resample_prob", "0.25"))
        seed = req.seed if req.seed is not None else 0
        cursor = max(req.issued, len(req.history))

        # slot-index observations by the trial name's issue index, so a
        # Failed trial (absent from history) is just a hole in its
        # generation rather than a permanent misalignment of every chunk
        by_index: dict[int, Observation] = {}
        for pos, ob in enumerate(req.history):
            m = re.search(r"(\d+)$", ob.trial or "")
            by_index[int(m.group(1)) if m else pos] = ob

        out: list[dict[str, object]] = []
        sign = -1.0 if req.objective_type == ObjectiveType.MINIMIZE else 1.0
        for i in range(req.count):
            slot_index = cursor + i
            gen, slot = divmod(slot_index, pop)
            rng = pyrandom.Random(seed * 1_000_003 + slot_index)
            prev = {
                j: by_index.get((gen - 1) * pop + j) for j in range(pop)
            } if gen > 0 else {}
            present = [j for j, ob in prev.items() if ob is not None]
            if gen == 0 or len(present) < 2:
                # first generation, or too few survivors to rank: fresh
                a = {p.name: _sample_one(p, rng) for p in req.parameters}
                a[PBT_PARENT_KEY] = ""
                out.append(a)
                continue
            ranked = sorted(
                present, key=lambda j: sign * prev[j].value, reverse=True)
            n_cut = max(1, int(round(len(present) * truncation)))
            rank_of = {j: r for r, j in enumerate(ranked)}
            member = prev.get(slot)
            if member is None or rank_of[slot] >= len(present) - n_cut:
                # exploit (slot's lineage failed, or ranked in the bottom
                # truncation): fork a random top member + explore
                donor = prev[rng.choice(ranked[:n_cut])]
                a = self._explore(
                    donor.assignments, req.parameters, rng, factor,
                    resample_prob)
                a[PBT_PARENT_KEY] = donor.trial or ""
            else:
                # survivor: continue own lineage unchanged
                a = {
                    p.name: member.assignments[p.name] for p in req.parameters
                }
                a[PBT_PARENT_KEY] = member.trial or ""
            out.append(a)
        return out

    def _explore(
        self,
        assignments: dict[str, object],
        parameters: list[ParameterSpec],
        rng: pyrandom.Random,
        factor: float,
        resample_prob: float,
    ) -> dict[str, object]:
        out: dict[str, object] = {}
        for p in parameters:
            v = assignments[p.name]
            fs = p.feasible_space
            if p.parameter_type == ParameterType.DOUBLE:
                f = factor if rng.random() < 0.5 else 1.0 / factor
                out[p.name] = min(max(float(v) * f, fs.min), fs.max)
            elif p.parameter_type == ParameterType.INT:
                f = factor if rng.random() < 0.5 else 1.0 / factor
                out[p.name] = int(min(max(round(int(v) * f), fs.min), fs.max))
            else:
                out[p.name] = (
                    rng.choice(list(fs.list_))
                    if rng.random() < resample_prob else v
                )
        return out


REGISTRY: dict[str, type] = {
    cls.name: cls
    for cls in (RandomSearch, GridSearch, Tpe, BayesianOptimization, CmaEs, Pbt)
}


def get_suggester(name: str) -> Suggester:
    if name == "darts":  # one-shot NAS lives in nas.py (torch)
        from .nas import OneShotNas

        return OneShotNas()
    try:
        return REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: "
            f"{sorted(REGISTRY) + ['darts']}"
        ) from None
