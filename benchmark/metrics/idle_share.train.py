"""Per-layer: percent of the traced slice in which no device operation ran
(the union of device operations over the slice's window)."""


def read(run: dict):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
