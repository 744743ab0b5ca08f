"""Disentanglement metrics: DCI, IRS, MCC, and the R^2/linear/permutation scores.

The port's own copy of ``causaldiffae_tpu/evals/metrics.py`` (numpy and
scipy, the same code, so the same arrays give bit-equal scores). They run on
the host over latents encoded on the device. sklearn is imported only inside
``compute_importance_gbt`` (DCI) and ``_corr_disentanglement`` and the two
scores that call it: the rest needs numpy and scipy alone. The reference's
vendored Hungarian solver is ``scipy.optimize.linear_sum_assignment``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.stats
from scipy.optimize import linear_sum_assignment

__all__ = [
    "compute_dci",
    "compute_importance_gbt",
    "disentanglement",
    "completeness",
    "compute_irs",
    "scalable_disentanglement_score",
    "mcc",
]


# --------------------------------------------------------------------- #
# DCI (reference `metrics.py:167-232`)
# --------------------------------------------------------------------- #
def compute_dci(mus_train, ys_train, mus_test, ys_test) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """codes/factors are (num_codes, N) / (num_factors, N) like the reference."""
    scores = {}
    importance_matrix, train_err, test_err = compute_importance_gbt(
        mus_train, ys_train, mus_test, ys_test
    )
    assert importance_matrix.shape[0] == mus_train.shape[0]
    assert importance_matrix.shape[1] == ys_train.shape[0]
    scores["informativeness_train"] = train_err
    scores["informativeness_test"] = test_err
    disent, code_importance = disentanglement(importance_matrix)
    scores["disentanglement"] = disent
    scores["completeness"] = completeness(importance_matrix)
    return scores, importance_matrix, code_importance


def compute_importance_gbt(x_train, y_train, x_test, y_test):
    """Feature importances from per-factor GradientBoostingRegressors
    (reference `metrics.py:182-199`; the ==-accuracy 'informativeness' quirk
    of regressing continuous targets is preserved)."""
    from sklearn import ensemble

    num_factors = y_train.shape[0]
    num_codes = x_train.shape[0]
    importance_matrix = np.zeros([num_codes, num_factors], dtype=np.float64)
    train_loss, test_loss = [], []
    for i in range(num_factors):
        model = ensemble.GradientBoostingRegressor()
        model.fit(x_train.T, y_train[i, :])
        importance_matrix[:, i] = np.abs(model.feature_importances_)
        train_loss.append(np.mean(model.predict(x_train.T) == y_train[i, :]))
        test_loss.append(np.mean(model.predict(x_test.T) == y_test[i, :]))
    return importance_matrix, np.mean(train_loss), np.mean(test_loss)


def disentanglement_per_code(importance_matrix):
    return 1.0 - scipy.stats.entropy(
        importance_matrix.T + 1e-11, base=importance_matrix.shape[1]
    )


def disentanglement(importance_matrix):
    per_code = disentanglement_per_code(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    code_importance = importance_matrix.sum(axis=1) / importance_matrix.sum()
    return np.sum(per_code * code_importance), code_importance


def completeness_per_factor(importance_matrix):
    return 1.0 - scipy.stats.entropy(
        importance_matrix + 1e-11, base=importance_matrix.shape[0]
    )


def completeness(importance_matrix):
    per_factor = completeness_per_factor(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    factor_importance = importance_matrix.sum(axis=0) / importance_matrix.sum()
    return np.sum(per_factor * factor_importance)


# --------------------------------------------------------------------- #
# IRS (reference `metrics.py:61-164`)
# --------------------------------------------------------------------- #
def compute_irs(rep, y, diff_quantile: float = 0.99) -> Dict:
    if not rep.any():
        irs_score = 0.0
    else:
        irs_score = scalable_disentanglement_score(y.T, rep.T, diff_quantile)["avg_score"]
    return {"IRS": irs_score, "num_active_dims": np.sum(rep)}


def scalable_disentanglement_score(gen_factors, latents, diff_quantile=0.99) -> Dict:
    num_gen = gen_factors.shape[1]
    num_lat = latents.shape[1]
    max_deviations = np.max(np.abs(latents - latents.mean(axis=0)), axis=0)
    cum_deviations = np.zeros([num_lat, num_gen])
    for i in range(num_gen):
        unique_factors = np.unique(gen_factors[:, i], axis=0)
        assert unique_factors.ndim == 1
        num_distinct = unique_factors.shape[0]
        for k in range(num_distinct):
            match = gen_factors[:, i] == unique_factors[k]
            e_loc = np.mean(latents[match, :], axis=0)
            diffs = np.abs(latents[match, :] - e_loc)
            max_diffs = np.percentile(diffs, q=diff_quantile * 100, axis=0)
            cum_deviations[:, i] += max_diffs
        cum_deviations[:, i] /= num_distinct
    normalized = cum_deviations / max_deviations[:, np.newaxis]
    irs_matrix = 1.0 - normalized
    disentanglement_scores = irs_matrix.max(axis=1)
    if np.sum(max_deviations) > 0.0:
        avg_score = np.average(disentanglement_scores, weights=max_deviations)
    else:
        avg_score = np.mean(disentanglement_scores)
    return {
        "disentanglement_scores": disentanglement_scores,
        "avg_score": avg_score,
        "parents": irs_matrix.argmax(axis=1),
        "IRS_matrix": irs_matrix,
        "max_deviations": max_deviations,
    }


# --------------------------------------------------------------------- #
# MCC (reference `metrics.py:235-245`)
# --------------------------------------------------------------------- #
def mcc(Z: np.ndarray, Zp: np.ndarray) -> float:
    """Mean correlation coefficient under the optimal latent permutation."""
    n = Z.shape[1]
    rho = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            rho[i, j] = np.abs(np.corrcoef(Z[:, i], Zp[:, j])[0, 1])
    r, c = linear_sum_assignment(-rho)
    return float(np.mean(rho[r, c]))


# --------------------------------------------------------------------- #
# R^2 / linear / permutation disentanglement (reference `metrics.py:248-506`)
# The Munkres reorder uses scipy.optimize.linear_sum_assignment instead of
# the vendored 734-line solver.
# --------------------------------------------------------------------- #
def _corr_disentanglement(z, hz, mode, reorder):
    from sklearn import metrics as skmetrics

    if mode == "r2":
        return skmetrics.r2_score(z, hz), None
    if mode == "adjusted_r2":
        r2 = skmetrics.r2_score(z, hz)
        n, p = z.shape[0], z.shape[1]
        return 1.0 - (1.0 - r2) * (n - 1) / (n - p - 1), None
    assert mode in ("pearson", "spearman")
    dim = z.shape[-1]
    if mode == "spearman":
        raw_corr, _ = scipy.stats.spearmanr(z, hz)
    else:
        raw_corr = np.corrcoef(z.T, hz.T)
    corr = raw_corr[:dim, dim:]
    if reorder:
        _, cols = linear_sum_assignment(-np.abs(corr))
        hz_sort = hz[:, cols]
        if mode == "spearman":
            raw_corr, _ = scipy.stats.spearmanr(z, hz_sort)
        else:
            raw_corr = np.corrcoef(z.T, hz_sort.T)
        corr = raw_corr[:dim, dim:]
    return float(np.diag(np.abs(corr)).mean()), corr


def r2_disentanglement(z, hz, mode: str = "r2", reorder=None):
    """Per-row-mean R^2 (mode='r2') or correlation disentanglement
    (reference `metrics.py:248-300`)."""
    assert mode in ("r2", "adjusted_r2", "pearson", "spearman")
    if mode == "r2":
        from sklearn import metrics as skmetrics

        scores = [skmetrics.r2_score(z[i], hz[i]) for i in range(z.shape[0])]
        return float(np.mean(scores))
    return _corr_disentanglement(z, hz, mode, reorder)


def linear_disentanglement(z, hz, mode: str = "r2", train_test_split: bool = False):
    """Disentanglement up to a linear map (reference `metrics.py:303-341`)."""
    from sklearn import linear_model

    z, hz = np.asarray(z), np.asarray(hz)
    if train_test_split:
        n_train = len(z) // 2
        z1, hz1, z2, hz2 = z[:n_train], hz[:n_train], z[n_train:], hz[n_train:]
    else:
        z1, hz1, z2, hz2 = z, hz, z, hz
    model = linear_model.LinearRegression()
    model.fit(hz1, z1)
    pred = model.predict(hz2)
    return _corr_disentanglement(z2, pred, mode, False), (z2, pred)


def permutation_disentanglement(z, hz, mode: str = "r2", rescaling: bool = True,
                                solver: str = "munkres"):
    """Disentanglement up to permutation (+ optional per-dim rescaling)
    (reference `metrics.py:405-506`; 'naive' enumerates permutations with
    sign flips, 'munkres' uses the assignment-based reorder)."""
    z, hz = np.asarray(z), np.asarray(hz)
    n = z.shape[-1]

    def score(Thz, reorder):
        if rescaling:
            beta = (z * Thz).sum(0) / np.maximum((Thz**2).sum(0), 1e-12)
            Thz = Thz * beta[None, :]
        return _corr_disentanglement(z, Thz, mode, reorder)

    if solver == "munkres":
        assert mode in ("pearson", "spearman"), "munkres solver needs a correlation mode"
        return score(hz, True)
    assert solver == "naive"
    import itertools

    best = (-np.inf, None)
    for perm in itertools.permutations(range(n)):
        for signs in itertools.product([1, -1], repeat=n):
            T = np.zeros((n, n))
            for i, (p, s) in enumerate(zip(perm, signs)):
                T[p, i] = s
            val = score(hz @ T, False)
            v = val[0] if isinstance(val, tuple) else val
            if v > best[0]:
                best = (v, val)
    return best[1]
