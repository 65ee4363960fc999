"""Per-layer: model flops of the window's completed work over the window and
the chips' dense TF32 peak, in percent."""

from benchmark.lib.work import PEAK_TF32


def read(run: dict):
    if not run["flops"] or run["window_s"] <= 0:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * run["chips"] * PEAK_TF32)
