"""Reference-layout shim: ``qml_essentials_tpu_torch.simulation``."""
from qml_essentials_tpu_torch.ops.simulation import *  # noqa: F401,F403
from qml_essentials_tpu_torch.ops.simulation import (  # noqa: F401
    infer_n_qubits, uses_density, simulate_pure, simulate_mixed,
    simulate_and_measure, measure_state, measure_density, sample_shots,
    plan_contractions, set_fusion,
)
