#!/usr/bin/env python3
"""Times the batch backward entries B2b / B4b on one NVIDIA GPU at several
CTA targets of their launch geometry.

    python3 tools/batch_bwd_sweep.py [--targets 64,128,256]

For each shape (the 6q batched gradient's calls at Bt = 256, and the edges
of ``chip_smoke.BATCH_EDGE_CASES``, float32) and each target it sets
``cuda_kernels._BWD_TARGET``, prints the geometry that
``batch_bwd_geometry`` then chooses (CTAs, elements a CTA, tile columns,
tiles a CTA, parts), the device time held behind a spin
(``chip_smoke._events_ms(..., hold=True)``: no host gaps) and the kernels'
device time and count a call from ``torch.profiler``.  The empty kernel of
``qml_batch_empty`` is timed first (the launch floor).  It changes no
file; the package's own target is restored after each shape.  Exits
non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [(6, 0, 3, False, 256), (6, 0, 3, True, 256), (6, 3, 3, False, 256),
          (6, 0, 2, False, 256), (6, 3, 3, True, 256)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--targets", default="64,128,256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batch_bwd_sweep: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    def device_us(fn, reps: int = 10) -> tuple:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return sum(e.time_range.elapsed_us() for e in events) / reps, len(events) / reps

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = cs.np.random.default_rng(cs.SEED)
    lib, own = ck._load(), ck._BWD_TARGET
    probe = torch.zeros(8, device="cuda")
    empty = lambda: lib.qml_batch_empty(ck._stream(probe))  # noqa: E731
    print(f"launch floor: {cs._events_ms(empty) * 1e3:.1f} us "
          f"(held {cs._events_ms(empty, hold=True) * 1e3:.1f} us)")
    edges = [(n, a, k, per, bt) for n, a, k, bt in cs.BATCH_EDGE_CASES for per in (False, True)]
    for n, a, k, per, bt in SHAPES + edges:
        x, g = cs._batch_state(n, bt, gen), cs._batch_state(n, bt, gen)
        w = cs._batch_window(k, bt, per, rng)
        if a + k == n:
            fn = lambda: ck.window_apply_top_bwd(w, g, x, k, n, torch.float32)  # noqa: E731
        else:
            fn = lambda: ck.window_apply_bwd(w, g, x, a, k, n, torch.float32)  # noqa: E731
        for target in (int(t) for t in args.targets.split(",")):
            ck._BWD_TARGET = target
            ck.batch_bwd_geometry.cache_clear()
            geom = ck.batch_bwd_geometry(bt, 2**a, 2**k, 2 ** (n - a - k), per, False)
            held = cs._events_ms(fn, hold=True) * 1e3
            dev, kernels = device_us(fn)
            print(f"n={n} a={a} k={k} {'own' if per else 'one'} W Bt={bt} target={target}: "
                  f"{geom.grid} CTAs, group {geom.group}, tc {geom.tc}, tpc {geom.tpc}, parts "
                  f"{geom.parts}: held {held:.1f} us, profiler {dev:.1f} us, {kernels:g} "
                  f"kernel(s) a call", flush=True)
        ck._BWD_TARGET = own
        ck.batch_bwd_geometry.cache_clear()
        del x, g, w
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
