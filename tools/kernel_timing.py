#!/usr/bin/env python3
"""Times some of the port's kernels at one plan's shapes on one NVIDIA GPU.

    python3 tools/kernel_timing.py [--root DIR] [--n 24] [--kernels a,b] [--max-k K]

``--kernels`` picks from B1 ``window_apply``, B6 ``rotmat_apply``, B10
``rotwin_apply``, B8 ``matrot_apply``, B3 ``window_apply_top``, B15
``adjoint_matrot``, B9 ``matrot_apply_bwd``, B11 ``rotwin_apply_bwd``, B4
``window_apply_top_bwd``, B13 ``adjoint_step_top``, B17 ``chain_apply``
and B18 ``adjoint_chain``, and the batch entries B1b ``window_apply_batch``,
B3b ``window_apply_top_batch``, B2b ``window_apply_bwd_batch`` and B4b
``window_apply_top_bwd_batch`` (default: the first two); each runs at every call
of its kind in the n-qubit Circuit_19 plan (B17 and B18 at every step of its
chain plan, ``chip_smoke.chain_plan``: at 24 qubits ``CHAIN_PLAN_24``)
(``chip_smoke.plan_shapes``; B4, B9, B11, B13 and B15 with the cotangent
dtypes of one gradient, ``chip_smoke.backward_calls``), calls whose
K = 2^k is above ``--max-k`` left out.  B3, B4 and B13 need a plan with a
top window (``--n 22``), B8, B9 and B15 one with matrot steps (``--n 24``),
B10 and B11 one with rotwin steps (24: K = 512, L = 256; 22: K = 256, 512
and 1024).  The kernels come from the package under ``--root`` (by
default this checkout); the shapes, the library products and the timing come
from this checkout's ``chip_smoke.py``, so that pointing ``--root`` at a
second tree compares two versions of the kernels by one method in one call
on one card.  It builds the kernels, prints ptxas's lines for the forward
wgmma kernel and the top-window, matrot and rotation-layout kernels, then
for every call: the kernel against its plain version in float64 (max|err|
/ max|ref|: 1e-5; for B4, B9, B11, B13 and B15 the rebuilt state 1e-5, a
float32 cotangent 1e-5, a bfloat16 one one ulp, gw 1e-4), its time and the
cuBLAS complex64 products' of the same shapes (``torch.matmul``, TF32 off),
and for the forward kernels the TFLOP/s issued in split TF32 (3 passes x
8K flops an amplitude).  B3 is also timed on the split-TF32 tile
(``qml_window_apply_top_tile``, where the tree has it), B8 and B10 beside
B6 ``rotmat_apply`` at the same K and column count, B15 beside B14
``adjoint_rotmat``, B9 and B11 beside B7 ``rotmat_apply_bwd``, B13 beside
B12 ``adjoint_step`` (the window on ``[0, k)``) and B4 beside B13 likewise.
B17 and B18 are held to float64 as ``chip_smoke.check_chain`` holds them
(states 1e-5, each descriptor's cotangent 1e-4), timed beside their
library yardstick (``chip_smoke._chain_lib``: the step's window products
and diagonal multiplies), with the TFLOP/s issued in split TF32 (3 passes x
8K flops an amplitude a window for B17, 9 for B18), and summed per step
kind (H, L): one launch is one step.  The batch entries run at phase 6's
calls (``chip_smoke.batch_shapes``: one FCC Circuit_19 and one KL request's
forward calls, the 6q batched gradient's backward calls, float32; the FCC
request's forward calls again in float64, totalled apart as ``name/f64``),
held to float64 as ``chip_smoke.check_batch`` holds them (a forward call
also repeated bit for bit), beside ``torch.bmm``
(``chip_smoke.lib_window_batch*``), with each kernel a call launches from
``torch.profiler`` and, where the tree has ``qml_batch_empty``, an empty
kernel through the same ctypes path (the launch floor); with
``--batch-edges`` B2b and B4b also at ``chip_smoke.BATCH_EDGE_CASES`` (an
element split over CTAs, a wide batch, a K = 32 top window; both window
modes, float32), left out of the totals.
Times are ``chip_smoke._events_ms`` (CUDA events, best of 3 means of 10
after a warm-up, as phase 6 takes them), each also "held": the calls queued
behind a spinning kernel, device time without the host's launch gaps; and
"host": the host's time to issue one call while the stream is held (best of
3 means of 10), which bounds the unheld time from below.  For B4, B9, B11,
B13, B15 and B18 the device time of each CUDA kernel a call launches (the
products, the split gram's ordered sum, G0 W) follows, from
``torch.profiler`` over 10 calls.
Exits non-zero without CUDA or on a failed check.
"""

from __future__ import annotations

import argparse
import importlib.util
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
KINDS = ("window_apply", "rotmat_apply", "rotwin_apply", "matrot_apply", "window_apply_top",
         "adjoint_matrot", "matrot_apply_bwd", "rotwin_apply_bwd", "window_apply_top_bwd",
         "adjoint_step_top", "chain_apply", "adjoint_chain", "window_apply_batch",
         "window_apply_top_batch", "window_apply_bwd_batch", "window_apply_top_bwd_batch")
BATCH_KINDS = KINDS[-4:]
TOL = 1e-5
TOL_GW = 1e-4


def _load_chip_smoke(root: Path):
    """This checkout's chip_smoke, importing the package from root."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _short(kernel: str) -> str:
    """A CUDA kernel's name as the profiler gives it, cut to its function
    and template arguments: tc_cgemm_kernel<TopPullbackMap,f32,bf16,bf16>."""
    m = re.match(r"(?:void )?(?:\w+::|\(anonymous namespace\)::)*(\w+)(?:<([^>]*)>)?", kernel)
    if m is None:
        return kernel[:48]
    name, args = m.group(1)[:48], m.group(2)
    if args:
        kinds = {"float": "f32", "__nv_bfloat16": "bf16"}
        args = [a.strip().split("::")[-1] for a in args.split(",")]
        name += "<" + ",".join(kinds.get(a, a) for a in args if a not in ("true", "false")) + ">"
    return name


def _rel(got, ref) -> float:
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--kernels", default="window_apply,rotmat_apply")
    ap.add_argument("--max-k", type=int, default=2**30, help="largest K (2^k) timed")
    ap.add_argument("--batch-edges", action="store_true",
                    help="also time B2b/B4b at chip_smoke.BATCH_EDGE_CASES")
    ap.add_argument("--chain-ranks", default="",
                    help="CTAs a chain cluster, one pass of B17/B18 each (e.g. 8,4); "
                         "default: the package's")
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if set(kinds) - set(KINDS):
        ap.error(f"--kernels: pick from {','.join(KINDS)}")
    if not torch.cuda.is_available():
        print("kernel_timing: CUDA is not available", file=sys.stderr)
        return 1
    cs = _load_chip_smoke(args.root.resolve())
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {args.root}  card: {smi}", flush=True)
    path, seconds = ck.build()
    print(f"built {path.name} in {seconds:.1f} s", flush=True)
    entry = None  # ptxas's lines for these kernels: registers, stack, spills, shared memory
    for line in ck.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            entry = line if any(k in line for k in ("forward_wgmma", "WindowMap", "Top",
                                                    "Matrot", "RotPullback", "RotGram",
                                                    "chain")) else None
            if entry:
                print(f"  {line.strip()}")
        elif entry and ("Used" in line or "spill" in line):
            print(f"    {line.strip()}")
        elif "wgmma" in line.lower():
            print(f"  ptxas: {line.strip()}")

    def host_ms(fn, reps: int = 10, trials: int = 3) -> float:
        """Best-of-trials mean host ms to issue fn(), the stream held busy
        so that no call waits for the card."""
        best = float("inf")
        for _ in range(trials):
            cs._hold_stream(20.0)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps * 1e3)
            torch.cuda.synchronize()
        return best

    def times(fn) -> tuple:
        return cs._events_ms(fn), cs._events_ms(fn, hold=True), host_ms(fn)

    def parts(fn, reps: int = 10) -> str:
        """Device us a call spends in each CUDA kernel it launches, from
        torch.profiler over `reps` calls, in launch order."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spent, launched = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = _short(e.name)
                spent[key] = spent.get(key, 0.0) + e.time_range.elapsed_us() / reps
                launched += 1
        if not spent:
            return "    parts: the profiler saw no device time"
        return "    parts: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + \
            f" (sum {sum(spent.values()):.1f} us; {launched / reps:g} kernels a call)"

    def us(t: tuple) -> str:
        return f"{t[0] * 1e3:8.1f} us (held {t[1] * 1e3:8.1f}, host {t[2] * 1e3:6.1f})"

    n = args.n
    shapes = cs.plan_shapes(n)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = cs.np.random.default_rng(cs.SEED)
    lib = ck._load()
    x = cs._state(n, gen)
    calls = []
    if "window_apply" in kinds:
        calls += [("window_apply", (a, k)) for a, k in shapes["window_apply"]]
    if "rotmat_apply" in kinds:
        calls += [("rotmat_apply", (r,)) for r in shapes["rotmat_apply"]]
    if "rotwin_apply" in kinds:
        calls += [("rotwin_apply", (r, k)) for r, k in shapes["rotwin_apply"]]
    if "matrot_apply" in kinds:
        calls += [("matrot_apply", (r,)) for r in shapes["matrot_apply"]]
    if "window_apply_top" in kinds:
        calls += [("window_apply_top", (k,)) for k in shapes["window_apply_top"]]
    totals, ok = {}, True
    for name, geom in calls:
        k = n - geom[0] if name == "matrot_apply" else geom[-1]
        if 2**k > args.max_k:
            continue
        K = 2**k
        run = {"window_apply_top": 2 ** (n - k), "matrot_apply": 2 ** geom[0],
               "rotwin_apply": min(2 ** (n - k), 2 ** geom[0])}.get(name, 2 ** (n - sum(geom)))
        w = cs._unitary(k, rng)
        kern = lambda: getattr(ck, name)(x, w, *geom, n)  # noqa: E731
        lib_fn = {"window_apply": cs.lib_window, "rotmat_apply": cs.lib_rotmat,
                  "matrot_apply": cs.lib_matrot, "window_apply_top": cs.lib_window_top,
                  "rotwin_apply": lambda *a: cs.lib_rotwin(ck, *a)}[name](x, w, *geom, n)
        ref = getattr(kn, f"{name}_plain")(x.double(), w.double(), *geom, n)
        rel = _rel(kern(), ref)
        ok &= rel <= TOL
        t_k, t_l = times(kern), times(lib_fn)
        route = (("wgmma" if ck.forward_path(K, run) else "tile")
                 if hasattr(ck, "forward_path") else "-")
        if name == "window_apply_top" and not hasattr(lib, "qml_window_apply_top_tile"):
            route = "fma"  # a tree whose B3 is still the float32-FMA tile
        if name == "matrot_apply" and len(ck._argtypes()["matrot_apply"]) == 6:
            route = "fma"  # a tree whose B8 takes no split-W workspace: the float32-FMA tile
        if name == "rotwin_apply" and len(ck._argtypes()["rotwin_apply"]) == 7:
            route = "fma"  # a tree whose B10 takes no split-W workspace: the float32-FMA tile
        tflops = 3 * 8 * K * 2**n / t_k[0] / 1e9
        print(f"  {name:16s} {str(geom):8s} K={K:5d} run={run:6d} {route:5s} rel {rel:.2e}  "
              f"kernel {us(t_k)}  cuBLAS {us(t_l)}  {tflops:6.1f} TFLOP/s issued", flush=True)
        if name in ("matrot_apply", "rotwin_apply"):
            print(f"  {name:16s} {str(geom):8s} rotmat_apply (same K, columns) "
                  f"{us(times(lambda: ck.rotmat_apply(x, w, k, n)))}", flush=True)
        if name == "window_apply_top" and hasattr(lib, "qml_window_apply_top_tile"):
            rel = _rel(cs._top_tile(ck, x, w, k, n), ref)
            ok &= rel <= TOL
            print(f"  {name:16s} {str(geom):8s} the tile rel {rel:.2e}  "
                  f"kernel {us(times(lambda: cs._top_tile(ck, x, w, k, n)))}", flush=True)
        del ref
        tot = totals.setdefault(name, [0.0, 0.0])
        tot[0] += t_k[0]
        tot[1] += t_l[0]

    def backward_row(name, label, kern, ref, lib_fn, out_dt, datum_label, datum):
        """One backward or adjoint call: its outputs against float64 (the
        state-sized ones 1e-5, one ulp in bfloat16; gw 1e-4), its times,
        cuBLAS's and the datum's on the same shapes; returns whether it
        held."""
        got = kern()
        rels = [_rel(a, b) for a, b in zip(got, ref)]
        tols = [TOL] * (len(rels) - 2) + [TOL if out_dt == torch.float32 else 2.0**-8, TOL_GW]
        del got
        t_k, t_l = times(kern), times(lib_fn)
        tot = totals.setdefault(name, [0.0, 0.0])
        tot[0] += t_k[0]
        tot[1] += t_l[0]
        print(f"  {name} {label} rel {'/'.join(f'{r:.1e}' for r in rels)}  kernel {us(t_k)}  "
              f"cuBLAS {us(t_l)}  {datum_label} {us(times(datum))}", flush=True)
        print(parts(kern), flush=True)
        return all(r <= t for r, t in zip(rels, tols))

    g = cs._state(n, gen)
    for kind, shape, l_dt, out_dt in cs.backward_calls(shapes["steps"]):
        lam = g.to(l_dt)
        tag = f"{cs._dt(l_dt)} out={cs._dt(out_dt)}"
        if kind == "matrot" and 2 ** (n - shape) <= args.max_k:
            r, k = shape, n - shape
            w = cs._unitary(k, rng)
            if "adjoint_matrot" in kinds:
                ref = kn.adjoint_matrot_plain(w.double(), x.double(), lam.double(), r, n,
                                              torch.float64)
                ok &= backward_row(
                    "adjoint_matrot", f"r={r} k={k} lam={tag}",
                    lambda: ck.adjoint_matrot(w, x, lam, r, n, out_dt), ref,
                    cs.lib_adjoint_matrot(w, x, lam, r, n), out_dt,
                    "adjoint_rotmat (same K, columns)",
                    lambda: ck.adjoint_rotmat(w, x, lam, k, n, out_dt))
                del ref
            if "matrot_apply_bwd" in kinds:
                ref = kn.matrot_apply_bwd_plain(w.double(), lam.double(), x.double(), r, n,
                                                torch.float64)
                ok &= backward_row(
                    "matrot_apply_bwd", f"r={r} k={k} g={tag}",
                    lambda: ck.matrot_apply_bwd(w, lam, x, r, n, out_dt), ref,
                    cs.lib_matrot_bwd(w, lam, x, r, n), out_dt,
                    "rotmat_apply_bwd (same K, columns)",
                    lambda: ck.rotmat_apply_bwd(w, lam, x, k, n, out_dt))
                del ref
        if kind == "rotwin" and "rotwin_apply_bwd" in kinds and 2 ** shape[1] <= args.max_k:
            r, k = shape
            w = cs._unitary(k, rng)
            ref = kn.rotwin_apply_bwd_plain(w.double(), lam.double(), x.double(), r, k, n,
                                            torch.float64)
            ok &= backward_row(
                "rotwin_apply_bwd", f"r={r} k={k} g={tag}",
                lambda: ck.rotwin_apply_bwd(w, lam, x, r, k, n, out_dt), ref,
                cs.lib_rotwin_bwd(ck, w, lam, x, r, k, n), out_dt,
                "rotmat_apply_bwd (same K, columns)",
                lambda: ck.rotmat_apply_bwd(w, lam, x, k, n, out_dt))
            del ref
        if kind == "top" and "window_apply_top_bwd" in kinds and 2 ** shape[1] <= args.max_k:
            k = shape[1]
            w = cs._unitary(k, rng)
            ref = kn.window_apply_top_bwd_plain(w.double(), lam.double(), x.double(), k, n,
                                                torch.float64)
            ok &= backward_row(
                "window_apply_top_bwd", f"k={k} g={tag}",
                lambda: ck.window_apply_top_bwd(w, lam, x, k, n, out_dt), ref,
                cs.lib_window_top_bwd(w, lam, x, k, n), out_dt,
                "adjoint_step_top (same K, rows)",
                lambda: ck.adjoint_step_top(w, x, lam, k, n, out_dt))
            del ref
        if kind == "top" and "adjoint_step_top" in kinds and 2 ** shape[1] <= args.max_k:
            k = shape[1]
            w = cs._unitary(k, rng)
            ref = kn.adjoint_step_top_plain(w.double(), x.double(), lam.double(), k, n,
                                            torch.float64)
            ok &= backward_row(
                "adjoint_step_top", f"k={k} lam={tag}",
                lambda: ck.adjoint_step_top(w, x, lam, k, n, out_dt), ref,
                cs.lib_adjoint_top(w, x, lam, k, n), out_dt,
                "adjoint_step a=0 (same K, columns)",
                lambda: ck.adjoint_step(w, x, lam, 0, k, n, out_dt))
            del ref
    chain = [k for k in ("chain_apply", "adjoint_chain") if k in kinds]
    plan = cs.chain_plan(n) if chain else None
    if chain and plan is None:
        print(f"kernel_timing: the {n}q model has no chain plan", file=sys.stderr)
        return 1
    by_kind = {}
    ranks = [int(r) for r in args.chain_ranks.split(",") if r] or [0]  # 0: the package's
    by_kernel = isinstance(ck._CHAIN_RANKS, dict)  # a tree from before the tensor-core kernels: no
    package_ranks = dict(ck._CHAIN_RANKS) if by_kernel else {}
    for geom, descs, pairs, r in [(*step, r) for r in ranks for step in plan or []]:
        want = {k: r or package_ranks[k] for k in package_ranks}
        if by_kernel and ck._CHAIN_RANKS != want:  # tables and counts are built for one size
            ck._CHAIN_RANKS.update(want)
            ck._chain_tables.clear()
            ck._chain_active.clear()
        if by_kernel and (geom, descs) == plan[0][:2]:
            print("  chain clusters: " + ", ".join(
                f"{k} {ck.chain_active_clusters(k, x.device)} of {ck._CHAIN_RANKS[k]} CTAs at once"
                for k in chain), flush=True)
        wins = [2 ** (d[2] - d[1]) for d in descs if d[0] == "win"]
        label = f"{geom[0]} {len(descs)} desc K={wins}" + (f" r{r}" if len(ranks) > 1 else "")
        p64 = [p.double() for p in pairs]
        for name in chain:
            adj = name == "adjoint_chain"
            if adj:
                kern = lambda: ck.adjoint_chain(x, g, pairs, geom, descs, n)  # noqa: E731
                ref = kn.adjoint_chain_plain(x.double(), g.double(), p64, geom, descs, n)
                got = kern()
                rels = [_rel(a, b) for a, b in zip((got[0], got[1], *got[2]),
                                                   (ref[0], ref[1], *ref[2]))]
                ok &= max(rels[:2]) <= TOL and max(rels[2:]) <= TOL_GW
            else:
                kern = lambda: ck.chain_apply(x, pairs, geom, descs, n)  # noqa: E731
                ref = kn.chain_apply_plain(x.double(), p64, geom, descs, n)
                got = kern()
                rels = [_rel(got, ref)]
                ok &= rels[0] <= TOL
            del got, ref
            t_k, t_l = times(kern), times(cs._chain_lib(x, g if adj else None, pairs, descs, n))
            tflops = (9 if adj else 3) * 8 * sum(wins) * 2**n / t_k[0] / 1e9
            print(f"  {name:13s} {label:28s} rel {'/'.join(f'{r:.1e}' for r in rels)}  "
                  f"kernel {us(t_k)}  library {us(t_l)}  {tflops:6.1f} TFLOP/s issued",
                  flush=True)
            if adj:
                print(parts(kern), flush=True)
            tot = totals.setdefault(name if len(ranks) == 1 else f"{name}/{r}", [0.0, 0.0])
            tot[0] += t_k[0]
            tot[1] += t_l[0]
            kind = by_kind.setdefault((name, r, geom[0]), [0, 0.0])
            kind[0] += 1
            kind[1] += t_k[0]
    batch = [k for k in BATCH_KINDS if k in kinds]
    if batch:
        if hasattr(lib, "qml_batch_empty"):
            empty = lambda: lib.qml_batch_empty(ck._stream(x))  # noqa: E731
            print(f"  launch floor: an empty kernel through ctypes {us(times(empty))}", flush=True)
        else:
            print("  launch floor: this tree has no qml_batch_empty", flush=True)
        bshapes = cs.batch_shapes()
        # (n, a, k, per-element W, batch, float64, backward, edge)
        calls = [(*c[:5], False, False, False) for label in ("FCC Circuit_19", "KL")
                 for c in bshapes["calls"][label]]
        calls += [(*c[:5], True, False, False) for c in bshapes["calls"]["FCC Circuit_19"]]
        calls += [(*c[:5], False, True, False) for c in reversed(bshapes["calls"]["grad"])]
        if args.batch_edges:
            calls += [(nb, a, k, per, bt, False, True, True) for nb, a, k, bt in
                      cs.BATCH_EDGE_CASES for per in (False, True)]
        for nb, a, k, per, bt, f64, bwd, edge in calls:
            top = a + k == nb
            name = ("window_apply_top" if top else "window_apply") + \
                ("_bwd_batch" if bwd else "_batch")
            if name not in batch:
                continue
            xb, gb = cs._batch_state(nb, bt, gen, f64), cs._batch_state(nb, bt, gen, f64)
            wb = cs._batch_window(k, bt, per, rng, f64)
            x64, g64, w64 = xb.double(), gb.double(), wb.double()
            tol = 1e-12 if f64 else TOL
            if bwd:
                kern = (lambda: ck.window_apply_top_bwd(wb, gb, xb, k, nb, torch.float32)) \
                    if top else (lambda: ck.window_apply_bwd(wb, gb, xb, a, k, nb, torch.float32))
                ref = kn.window_apply_top_bwd_plain(w64, g64, x64, k, nb, torch.float64) \
                    if top else kn.window_apply_bwd_plain(w64, g64, x64, a, k, nb, torch.float64)
                lib_fn = cs.lib_window_batch_bwd(wb, gb, xb, a, k, nb)
                rels = [_rel(t, r) for t, r in zip(kern(), ref)]
                ok &= rels[0] <= TOL and rels[1] <= TOL_GW
            else:
                kern = (lambda: ck.window_apply_top(xb, wb, k, nb)) if top else \
                    (lambda: ck.window_apply(xb, wb, a, k, nb))
                ref = kn.window_apply_top_plain(x64, w64, k, nb) if top else \
                    kn.window_apply_plain(x64, w64, a, k, nb)
                lib_fn = cs.lib_window_batch(xb, wb, a, k, nb)
                first = kern()
                rels = [_rel(first, ref)]
                ok &= rels[0] <= tol and torch.equal(first, kern())  # bit for bit
                del first
            t_k, t_l = times(kern), times(lib_fn)
            dt = "f64" if f64 else "f32"
            flops, bytes_ = cs.work_batch(2**k, nb, bt, per, bwd, esize=8 if f64 else 4)
            bound = max(flops / (cs.PEAK_FP64 if f64 else cs.PEAK_FP32), bytes_ / cs.PEAK_HBM) * 1e3
            print(f"  {name:26s} n={nb} a={a} k={k} {'own' if per else 'one'} W Bt={bt:6d} {dt} "
                  f"rel {'/'.join(f'{r:.1e}' for r in rels)}  kernel {us(t_k)}  "
                  f"bmm {us(t_l)}  bound {bound * 1e3:8.1f} us ({bound / t_k[0]:.0%}; "
                  f"held {bound / t_k[1]:.0%})", flush=True)
            print(parts(kern), flush=True)
            if edge:
                del xb, gb, wb, x64, g64, w64, ref
                continue
            tot = totals.setdefault(name + ("/f64" if f64 else ""), [0.0, 0.0, 0.0, 0.0])
            tot[0] += t_k[0]
            tot[1] += t_l[0]
            tot[2] += t_k[1]
            tot[3] += bound
            del xb, gb, wb, x64, g64, w64, ref
    for (name, r, kind), (steps, ms) in sorted(by_kind.items()):
        print(f"  {name:13s} ranks {r} {kind} steps: {steps}, {ms:.4f} ms "
              f"({ms / steps:.4f} ms a step)")
    for name, (t_k, t_l, *held) in totals.items():
        f64 = ", FCC in float64" if name.endswith("/f64") else ""
        per = (f"per batch workload (phase 6's calls{f64})"
               if name.split("/")[0] in BATCH_KINDS else f"per {n}q request")
        held = f"  held {held[0]:.4f} ms  bound {held[1]:.4f} ms" if held else ""
        print(f"  total {name:16s} kernel {t_k:.4f} ms  cuBLAS {t_l:.4f} ms{held} {per}")
    print(f"card: {smi}")
    if not ok:
        print("kernel_timing: a kernel missed its bound against float64", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
