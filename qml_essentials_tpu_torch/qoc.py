"""Reference-layout shim: ``qml_essentials_tpu_torch.qoc``."""
from qml_essentials_tpu_torch.pulse.qoc import *  # noqa: F401,F403
from qml_essentials_tpu_torch.pulse.qoc import (  # noqa: F401
    QOC, Cost, CostFnRegistry, default_qoc_params, profile_pulse_pipeline,
    fidelity_cost_fn, unitary_cost_fn, joint_unitary_cost_fn,
    pulse_width_cost_fn, evolution_time_cost_fn, spectral_density_cost_fn,
    main,
)

if __name__ == "__main__":
    main()
