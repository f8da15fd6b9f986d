"""Evaluation curve plots: PR, F1, Precision, Recall PNGs (the port's
own copy of `tpu_yolo/eval/plots.py`).

Four PNGs (PR_curve, F1_curve, P_curve, R_curve) with per-class traces
(when the class list is small enough to read) and an emphasized
all-class aggregate: one generic renderer driven by a small spec,
per-class legends capped at MAX_LEGEND_CLASSES, and the aggregate
annotated with its peak. matplotlib is imported only when a figure is
drawn, and raises ImportError where it is not installed.
"""
from __future__ import annotations

import os

import numpy as np

# Above this many classes a per-class legend is unreadable; draw the
# individual traces as a faint background instead.
MAX_LEGEND_CLASSES = 20


def _render(out_path, x, per_class, aggregate, *, xlabel, ylabel,
            class_labels, aggregate_label):
    """One curve figure: faint-or-labelled per-class traces + bold mean.

    per_class: (C, N) rows over the x grid (C may be 0);
    class_labels: legend text per row, or None for unlabelled traces.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 5.5))
    ax = fig.add_subplot()
    for i, row in enumerate(per_class):
        if class_labels is not None:
            ax.plot(x, row, lw=0.8, alpha=0.8, label=class_labels[i])
        else:
            ax.plot(x, row, lw=0.6, alpha=0.35, color="0.5")
    if aggregate is not None:
        ax.plot(x, aggregate, lw=2.5, color="tab:red", label=aggregate_label)

    ax.set(xlabel=xlabel, ylabel=ylabel, xlim=(0, 1), ylim=(0, 1.02))
    ax.grid(alpha=0.25)
    if class_labels is not None or aggregate is not None:
        ax.legend(loc="center left", bbox_to_anchor=(1.01, 0.5),
                  fontsize="small")
    fig.savefig(out_path, dpi=160, bbox_inches="tight")
    plt.close(fig)


def _labels_or_none(names, values=None, fmt="{name} {v:.3f}"):
    """Per-class legend labels, or None when there are too many to show."""
    if not 0 < len(names) <= MAX_LEGEND_CLASSES:
        return None
    if values is None:
        return [str(n) for n in names]
    return [fmt.format(name=n, v=v) for n, v in zip(names, values)]


def plot_pr_curve(px, pr_curves, ap, names, out_path):
    """Precision-recall traces per class + mean, annotated with AP@0.5."""
    py = (np.stack(pr_curves, axis=0) if len(pr_curves)
          else np.zeros((0, len(px))))
    mean = py.mean(axis=0) if py.shape[0] else None
    agg = (f"all classes {ap[:, 0].mean():.3f} mAP@0.5"
           if py.shape[0] else None)
    _render(out_path, px, py, mean, xlabel="Recall", ylabel="Precision",
            class_labels=_labels_or_none(names, ap[:, 0] if len(names) else None),
            aggregate_label=agg)


def plot_curve(px, py, names, out_path, xlabel="Confidence", ylabel="Metric"):
    """Per-class metric-vs-confidence traces + smoothed mean with peak."""
    from tpu_yolo_torch.eval.metrics import smooth

    mean = smooth(py.mean(axis=0), 0.05)
    peak = int(np.argmax(mean))
    _render(out_path, px, py, mean, xlabel=xlabel, ylabel=ylabel,
            class_labels=_labels_or_none(names),
            aggregate_label=(f"all classes {mean[peak]:.2f} "
                             f"at {px[peak]:.3f}"))


def plot_all_curves(px, pr_curves, ap, p_curve, r_curve, f1, names, plot_dir):
    os.makedirs(plot_dir, exist_ok=True)
    plot_pr_curve(px, pr_curves, ap, names,
                  os.path.join(plot_dir, "PR_curve.png"))
    for data, ylabel, fname in ((f1, "F1", "F1_curve.png"),
                                (p_curve, "Precision", "P_curve.png"),
                                (r_curve, "Recall", "R_curve.png")):
        plot_curve(px, data, names, os.path.join(plot_dir, fname),
                   ylabel=ylabel)
