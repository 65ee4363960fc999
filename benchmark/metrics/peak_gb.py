"""End-to-end: the device's peak allocated memory over the window."""


def read(run: dict):
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
