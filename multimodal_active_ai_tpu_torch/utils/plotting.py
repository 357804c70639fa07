"""Training-history plotting.

Port of ``multimodal_active_ai_tpu/utils/plotting.py`` (reference
``SimCLR/Model_Util.plot_features_stats``, ``Model_Util.py:133-146``): three
stacked panels, loss and contrastive top-1 and top-5 over epochs, written
to a PNG file (headless hosts have no display), or nothing where matplotlib
is not installed, so that the caller prints the histories instead.
"""

from __future__ import annotations


def plot_training_stats(losses, top1_acc, top5_acc,
                        out_path: str = "training_history.png") -> str | None:
    """Render the three-panel history figure; returns the written path, or
    None when matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, (loss_ax, t1_ax, t5_ax) = plt.subplots(3, 1, sharex=True, figsize=(10, 10))
    fig.suptitle("Training process history", fontweight="bold", size=20)
    loss_ax.plot(list(losses))
    loss_ax.set(ylabel="Loss")
    t1_ax.plot(list(top1_acc), "tab:green")
    t1_ax.set(ylabel="Top 1 contrastive accuracy")
    t5_ax.plot(list(top5_acc), "tab:orange")
    t5_ax.set(ylabel="Top 5 contrastive accuracy", xlabel="Epochs")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
