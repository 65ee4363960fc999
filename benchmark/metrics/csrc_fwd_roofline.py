"""Per-layer: the port's kernel calls' summed least times
(:mod:`benchmark.lib.work`) over their summed device time in the traced
slice, in percent."""


def read(run: dict):
    t = run["trace"]
    if not t or t["port_kernel_s"] <= 0 or t.get("least_s", 0) <= 0:
        return None
    return 100.0 * t["least_s"] / t["port_kernel_s"]
