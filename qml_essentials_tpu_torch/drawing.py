"""Reference-layout shim: ``qml_essentials_tpu_torch.drawing``."""
from qml_essentials_tpu_torch.utils.drawing import *  # noqa: F401,F403
from qml_essentials_tpu_torch.utils.drawing import (  # noqa: F401
    draw_text, draw_mpl, draw_tikz, draw_pulse_schedule,
    TikzFigure, QuanTikz, PulseEvent, LEAF_META,
)
