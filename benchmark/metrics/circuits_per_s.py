"""End-to-end: circuit evaluations completed in the window over the window."""


def read(run: dict):
    if run["window_s"] <= 0 or not run["circuits"]:
        return None
    return run["circuits"] / run["window_s"]
