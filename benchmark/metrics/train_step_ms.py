"""End-to-end: the window over the training steps it completed."""


def read(run: dict):
    return 1e3 * run["window_s"] / run["steps"] if run.get("steps") else None
