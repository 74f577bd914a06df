"""Offline uncertainty analytics (copy of
``aa_rmvsnet_tpu/utils/analysis.py``; scikit-learn, scipy and matplotlib
are imported on use through :func:`.optional.require`).

Capability-parity with the reference's analysis suite (reference:
evidential/statistics.py:21-1566), which consumes training-time tensor
dumps and evaluates how well predicted uncertainty detects depth error:

- ROC / precision-recall of uncertainty as a detector of pixels whose
  depth error exceeds a threshold (reference :636-873, 1179-1267),
- calibration curve (predicted-uncertainty quantiles vs observed error,
  reference :1054-1119),
- sparsification / precision-recall sweeps over uncertainty thresholds
  (reference :1287-1543),
- error/uncertainty summary statistics and correlation fits (:914-1053).

All functions are pure numpy/sklearn over ``(H, W)`` maps (or stacks) and
return plain dicts so they can be logged, tested, or plotted.
``plot_report`` renders the standard figure grid.
"""

from __future__ import annotations

import numpy as np

from .optional import pyplot, require


def _flatten_valid(error, uncertainty, mask):
    m = np.asarray(mask) > 0.5
    return np.asarray(error)[m].ravel(), np.asarray(uncertainty)[m].ravel()


def uncertainty_roc(error, uncertainty, mask, error_threshold: float):
    """ROC of uncertainty as a detector of |error| > threshold.

    Returns dict with ``auc``, ``fpr``, ``tpr`` (reference statistics.py:636-733).
    """
    metrics = require("sklearn.metrics", "the uncertainty ROC")

    err, unc = _flatten_valid(error, uncertainty, mask)
    labels = (np.abs(err) > error_threshold).astype(np.int32)
    if labels.min() == labels.max():
        return {"auc": float("nan"), "fpr": None, "tpr": None}
    fpr, tpr, _ = metrics.roc_curve(labels, unc)
    return {"auc": float(metrics.roc_auc_score(labels, unc)), "fpr": fpr, "tpr": tpr}


def uncertainty_precision_recall(error, uncertainty, mask, error_threshold: float):
    """Average precision + PR curve of uncertainty as an error detector
    (reference statistics.py:1179-1267)."""
    metrics = require("sklearn.metrics", "the uncertainty precision-recall curve")

    err, unc = _flatten_valid(error, uncertainty, mask)
    labels = (np.abs(err) > error_threshold).astype(np.int32)
    if labels.min() == labels.max():
        return {"average_precision": float("nan"), "precision": None, "recall": None}
    precision, recall, _ = metrics.precision_recall_curve(labels, unc)
    return {
        "average_precision": float(metrics.average_precision_score(labels, unc)),
        "precision": precision,
        "recall": recall,
    }


def calibration_curve(error, uncertainty, mask, num_bins: int = 10):
    """Observed |error| quantile per predicted-uncertainty bin
    (reference statistics.py:1054-1119).

    Returns ``{bin_uncertainty, bin_abs_error, counts}`` — a well-calibrated
    predictor has monotonically increasing bin_abs_error.
    """
    err, unc = _flatten_valid(error, uncertainty, mask)
    if err.size == 0:
        return {"bin_uncertainty": [], "bin_abs_error": [], "counts": []}
    edges = np.quantile(unc, np.linspace(0, 1, num_bins + 1))
    edges[-1] += 1e-9
    idx = np.clip(np.searchsorted(edges, unc, side="right") - 1, 0, num_bins - 1)
    bin_u, bin_e, counts = [], [], []
    for b in range(num_bins):
        sel = idx == b
        if not sel.any():
            continue
        bin_u.append(float(unc[sel].mean()))
        bin_e.append(float(np.abs(err[sel]).mean()))
        counts.append(int(sel.sum()))
    return {"bin_uncertainty": bin_u, "bin_abs_error": bin_e, "counts": counts}


def sparsification_curve(error, uncertainty, mask, num_points: int = 20):
    """MAE after removing the q most-uncertain pixels, vs the oracle that
    removes the largest-error pixels.  Returns fractions removed, the
    uncertainty-ordered MAE curve, the oracle curve, and the area between
    them (lower = better uncertainty ranking)."""
    err, unc = _flatten_valid(error, uncertainty, mask)
    abs_err = np.abs(err)
    n = abs_err.size
    if n == 0:
        return {"fractions": [], "curve": [], "oracle": [], "ause": float("nan")}
    order_unc = np.argsort(-unc)
    order_err = np.argsort(-abs_err)
    fractions = np.linspace(0, 0.99, num_points)
    curve, oracle = [], []
    for q in fractions:
        k = int(q * n)
        curve.append(float(abs_err[order_unc[k:]].mean()))
        oracle.append(float(abs_err[order_err[k:]].mean()))
    curve = np.array(curve) / max(curve[0], 1e-12)
    oracle = np.array(oracle) / max(oracle[0], 1e-12)
    return {
        "fractions": fractions,
        "curve": curve,
        "oracle": oracle,
        "ause": float(np.trapezoid(curve - oracle, fractions)),
    }


def precision_recall_vs_threshold(error, uncertainty, mask, error_threshold: float,
                                  num_points: int = 50):
    """Sweep uncertainty thresholds: precision/recall of 'certain' pixels
    being correct (reference statistics.py:1287-1543)."""
    err, unc = _flatten_valid(error, uncertainty, mask)
    correct = np.abs(err) <= error_threshold
    thresholds = np.quantile(unc, np.linspace(0.02, 0.98, num_points))
    precision, recall, kept = [], [], []
    total_correct = max(correct.sum(), 1)
    for t in thresholds:
        sel = unc <= t
        if not sel.any():
            continue
        precision.append(float(correct[sel].mean()))
        recall.append(float(correct[sel].sum() / total_correct))
        kept.append(float(sel.mean()))
    return {"thresholds": thresholds, "precision": precision,
            "recall": recall, "fraction_kept": kept}


def error_uncertainty_density(error, uncertainty, mask, bins: int = 50,
                              clip_quantile: float = 0.995):
    """2D density (heatmap) of |error| vs uncertainty over valid pixels
    (reference statistics.py:395-635 density/heatmap plots).

    Extreme outliers are clipped at the given quantile so the histogram
    resolves the bulk of the distribution.  Returns ``{hist, err_edges,
    unc_edges}`` with ``hist[i, j]`` counting pixels in |error| bin i and
    uncertainty bin j.
    """
    err, unc = _flatten_valid(error, uncertainty, mask)
    abs_err = np.abs(err)
    if abs_err.size == 0:
        return {"hist": np.zeros((bins, bins)), "err_edges": None, "unc_edges": None}
    e_hi = max(float(np.quantile(abs_err, clip_quantile)), 1e-9)
    u_lo, u_hi = float(unc.min()), max(float(np.quantile(unc, clip_quantile)), 1e-9)
    hist, err_edges, unc_edges = np.histogram2d(
        np.minimum(abs_err, e_hi), np.minimum(unc, u_hi),
        bins=bins, range=[[0.0, e_hi], [u_lo, u_hi]],
    )
    return {"hist": hist, "err_edges": err_edges, "unc_edges": unc_edges}


def regression_fit(error, uncertainty, mask):
    """Least-squares fit of |error| ~ uncertainty, plus the same fit in
    log-log space (reference statistics.py:914-1053 regression fits).

    Returns slope/intercept/r/p per fit; ``r`` close to 1 means the
    uncertainty magnitude tracks the error magnitude, not just its rank.
    """
    linregress = require("scipy.stats", "the regression fit").linregress

    err, unc = _flatten_valid(error, uncertainty, mask)
    abs_err = np.abs(err)
    if abs_err.size < 3:
        return {}

    def _fit(x, y):
        res = linregress(x, y)
        return {
            "slope": float(res.slope),
            "intercept": float(res.intercept),
            "r": float(res.rvalue),
            "p": float(res.pvalue),
            "stderr": float(res.stderr),
        }

    out = {"linear": _fit(unc, abs_err)}
    pos = (unc > 0) & (abs_err > 0)
    if pos.sum() >= 3:
        out["loglog"] = _fit(np.log(unc[pos]), np.log(abs_err[pos]))
    return out


def plot_density(path, error, uncertainty, mask, bins: int = 50):
    """Heatmap of the |error|-vs-uncertainty joint density with the linear
    regression fit overlaid (reference statistics.py:395-635, 914-1053)."""
    plt = pyplot("the density plot")

    dens = error_uncertainty_density(error, uncertainty, mask, bins=bins)
    fit = regression_fit(error, uncertainty, mask)
    fig, ax = plt.subplots(figsize=(6, 5))
    if dens["err_edges"] is not None:
        # log1p counts: the near-origin bulk would otherwise saturate.
        ax.pcolormesh(dens["unc_edges"], dens["err_edges"],
                      np.log1p(dens["hist"]), cmap="viridis")
        if fit:
            u = np.array([dens["unc_edges"][0], dens["unc_edges"][-1]])
            lin = fit["linear"]
            ax.plot(u, lin["slope"] * u + lin["intercept"], "r--",
                    label=f"|err| ~ {lin['slope']:.2f}u + {lin['intercept']:.2f} "
                          f"(r={lin['r']:.2f})")
            ax.legend(loc="upper left")
    ax.set_xlabel("predicted uncertainty")
    ax.set_ylabel("|depth error|")
    ax.set_title("error vs uncertainty density (log1p counts)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def summarize(error, uncertainty, mask):
    """Headline scalars: masked MAE/RMSE, mean uncertainty, Spearman
    correlation between |error| and uncertainty."""
    spearmanr = require("scipy.stats", "the error summary").spearmanr

    err, unc = _flatten_valid(error, uncertainty, mask)
    if err.size == 0:
        return {}
    rho = spearmanr(np.abs(err), unc).statistic if err.size > 2 else float("nan")
    return {
        "mae": float(np.abs(err).mean()),
        "rmse": float(np.sqrt((err**2).mean())),
        "mean_uncertainty": float(unc.mean()),
        "spearman_err_unc": float(rho),
        "valid_pixels": int(err.size),
    }


def plot_means_comparison(path, means: dict):
    """Grouped bar chart of mean aleatoric/epistemic uncertainty per entry
    (per scene or per training step) — the reference's cross-scene means
    comparison, statistics.py:1352-1365.

    Args:
      means: ``{label: {"aleatoric": float, "epistemic": float}}``.
    """
    plt = pyplot("the means comparison plot")

    labels = list(means)
    alea = [means[k].get("aleatoric", 0.0) for k in labels]
    epis = [means[k].get("epistemic", 0.0) for k in labels]
    x = np.arange(len(labels))
    fig, ax = plt.subplots(figsize=(max(6, 0.8 * len(labels)), 4))
    ax.bar(x - 0.2, alea, width=0.4, label="aleatoric")
    ax.bar(x + 0.2, epis, width=0.4, label="epistemic")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("mean uncertainty")
    ax.set_title("mean uncertainty comparison")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_report(path, ref_image, depth_est, depth_gt, mask, aleatoric, epistemic):
    """Figure grid: image / error / aleatoric / epistemic + curves
    (reference evidential/plot.py:8-123 + statistics heatmaps)."""
    plt = pyplot("the report figure")

    error = (depth_est - depth_gt) * (mask > 0.5)
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for ax, (title, img) in zip(
        axes.flat,
        [
            ("reference", ref_image),
            ("|error|", np.abs(error)),
            ("aleatoric", aleatoric),
            ("epistemic", epistemic),
        ],
    ):
        im = ax.imshow(img if img.ndim == 2 else img.astype(np.uint8))
        ax.set_title(title)
        ax.axis("off")
        if img.ndim == 2:
            fig.colorbar(im, ax=ax, fraction=0.046)

    total_unc = aleatoric + epistemic
    spars = sparsification_curve(error, total_unc, mask)
    axes[1, 1].plot(spars["fractions"], spars["curve"], label="by uncertainty")
    axes[1, 1].plot(spars["fractions"], spars["oracle"], label="oracle")
    axes[1, 1].set_title(f"sparsification (AUSE {spars['ause']:.3f})")
    axes[1, 1].legend()

    cal = calibration_curve(error, total_unc, mask)
    axes[1, 2].plot(cal["bin_uncertainty"], cal["bin_abs_error"], marker="o")
    axes[1, 2].set_xlabel("predicted uncertainty")
    axes[1, 2].set_ylabel("observed |error|")
    axes[1, 2].set_title("calibration")

    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
