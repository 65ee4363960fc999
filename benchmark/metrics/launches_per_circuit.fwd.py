"""Per-layer: the program's kernel launches in the window per circuit
evaluation (``cuda_kernels.LAUNCHES``), reported by a traced run."""


def read(run: dict):
    if run["trace"] is None or not run["circuits"]:
        return None
    return sum(run["launches"].values()) / run["circuits"]
