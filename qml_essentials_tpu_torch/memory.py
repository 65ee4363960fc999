"""Reference-layout shim: ``qml_essentials_tpu_torch.memory``."""
from qml_essentials_tpu_torch.core.memory import *  # noqa: F401,F403
from qml_essentials_tpu_torch.core.memory import (  # noqa: F401
    estimate_peak_bytes, available_memory_bytes, compute_chunk_size,
    execute_chunked, CLEAR_CACHES_BETWEEN_CHUNKS,
)
