"""Training-curve extraction & plotting from metric logs (the port's own copy
of the JAX package's ``viz/curves.py``).

Replaces ``visualization/extract_scores_from_summaries.py`` (which scraped
TensorBoard event files with ``tf.train.summary_iterator``): metrics live in
JSONL (``utils.logging.MetricLogger``), so extraction is a dict comprehension;
plotting (optional, needs matplotlib, imported when called) reproduces the
val-mIoU comparison figures (ref :26-35, :73-117).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics


def extract_curve(path: str, key: str) -> Tuple[List[int], List[float]]:
    """(steps, values) for one metric key from a JSONL metrics file."""
    steps, values = [], []
    for rec in read_metrics(path):
        if key in rec:
            steps.append(rec["step"])
            values.append(rec[key])
    return steps, values


def plot_curves(
    runs: Dict[str, str], key: str = "val_miou",
    out_path: Optional[str] = None, title: Optional[str] = None,
):
    """Plot one metric across named runs {label: metrics.jsonl path}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for label, path in runs.items():
        steps, values = extract_curve(path, key)
        ax.plot(steps, values, label=label)
    ax.set_xlabel("step")
    ax.set_ylabel(key)
    ax.legend()
    if title:
        ax.set_title(title)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
