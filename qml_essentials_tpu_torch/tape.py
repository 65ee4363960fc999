"""Reference-layout shim: ``qml_essentials_tpu_torch.tape``."""
from qml_essentials_tpu_torch.ops.tape import *  # noqa: F401,F403
from qml_essentials_tpu_torch.ops.tape import (  # noqa: F401
    active_tape, recording, active_pulse_tape, pulse_recording,
    shift_and_append, copy_to_tape,
)
