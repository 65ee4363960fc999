#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (and, where the
machine has four, the sharded route on four).

    python3 chip_smoke.py

Drives the port's main path — ``Model(n_qubits, n_layers=2,
circuit_type="Circuit_19", device="cuda")`` answering forward requests and
computing the gradient of the mean <Z> with respect to ``params`` at 22 and
24 qubits through the saved-residual executor, and through the adjoint-state
executor at 22, 24 and 26 qubits, all on the reference's default plan
(``FUSE_LAYOUT_ROT`` on: fused rotation steps), the same 22 and 24 qubit
models through the chain route (``USE_CHAINS`` on), the reference
bench's 13-qubit noisy Circuit_19 (``{"Depolarizing": 0.01}``) as a density
matrix on the 26-wire interleaved doubled register, and the analysis stack
(the Fourier spectra of both, FourierTree, entanglement, expressibility and
QFI on small registers), the batch route, pulse mode (the 24-qubit
Circuit_19 in ``gate_mode="pulse"``, forward and gradient, a small batch,
the pulse goldens and a QOC run), and the API surface (the complex-state
``simulate_pure`` / ``simulate_mixed`` / ``apply_to_state``, checkpointing,
drawing, pulse events, profiling) — and checks it phase by phase:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: the eighteen CUDA kernels compile from ``qml_essentials_tpu_torch/csrc``
   (one nvcc per source, in parallel), with ptxas's register and
   shared-memory use and any wgmma warning; the SASS of the split-TF32 tile
   (``csrc/adjoint_tc.cuh``, under window_apply_bwd, window_apply_top_bwd,
   rotmat_apply_bwd, matrot_apply_bwd, rotwin_apply_bwd, adjoint_step,
   adjoint_step_top, adjoint_rotmat and adjoint_matrot, and window_apply /
   rotmat_apply / rotwin_apply / matrot_apply / window_apply_top's shapes
   under the wgmma kernel's rule) must hold tensor-core HMMA instructions in
   every instantiation (counted with cuobjdump, named by their maps, each map
   in as many objects, one a source, as sources instantiate it: TopPullbackMap
   in adjoint_step_top's and window_apply_top_bwd's, TopGramMap in those and
   adjoint_matrot's, RotWindowMap, B6's and B10's tile off the wgmma rule, in
   rotmat_apply's and rotwin_apply's; TC_MAPS), and the forward wgmma kernel
   (``csrc/forward_wgmma.cuh``, window_apply, rotmat_apply, rotwin_apply,
   matrot_apply and window_apply_top) warpgroup HGMMA instructions in every
   instantiation, under each of its maps the same way (WindowMap,
   RotWindowMap in rotmat_apply's and rotwin_apply's objects,
   MatrotForwardMap, TopForwardMap); the chain kernels
   (``chain_apply_kernel``, ``adjoint_chain_kernel``,
   ``csrc/chain_block.cuh``) HGMMA in every instantiation (B17's window
   products, B18's grams and pullbacks) and HMMA (their products under the
   wgmma rule) in one of each; the clusters of each chain kernel (8 CTAs
   for chain_apply, 4 for adjoint_chain) the card holds at once
   (``cudaOccupancyMaxActiveClusters``) are printed; the 22q/24q/26q
   plans are printed (24q: 14 steps), and the 13q density plans (noisy,
   every noise knob, noise-free; 26 wires, the noisy one 16 steps) with
   their residual estimates;
3. kernel parity: each kernel against its plain PyTorch version run in
   float64 on the card, at the main path's shapes and at edge shapes
   (window kernels, fused or not: max|err| / max|ref| <= 1e-5; the backward
   kernels' state cotangent 1e-5 in float32 and one bf16 ulp in bfloat16,
   their matrix cotangent 1e-4 (an fp32 sum over up to 2^16 columns); the
   adjoint steps the same, with the rebuilt state at 1e-5; rotation and
   paired rotation, float32 and bfloat16: bit-exact).  The fused kernels run
   at the 22q, 24q and 26q plans' rotmat / matrot / rotwin shapes, and
   matrot's at K = 512 on a 26q plane, on both sides of its 16-byte copy
   rule (K = 8 / B = 16; K = 16 / B = 4, K = 4 / B = 8) and of the wgmma
   kernel's (K = 256 and 8 with B = 32; K = 256 / B = 16), rotwin's on both
   sides of its backward's copy rule (L = 8 with X = 32 and 8; X = 4,
   L = 4) and of its forward's wgmma rule (L = 32 with X = 32; L = 16,
   X = 16); adjoint_step_top
   at the 22q plan's top window, K = 64 on 24q and 26q planes and K = 8 with
   A = 16.  Every window, top-window, rotation (forward and backward amount)
   and fused shape of the 13q density plans runs the same way on 26 wires
   (the forward, backward and fused kernels; the density path runs no
   adjoint kernel).
   window_apply runs at the 22q and 24q plans' windows and at K = 8 and 16
   on both sides of the wgmma kernel's shape rule (B = 2 and 64),
   window_apply_top at K = 8 and 16 on both sides of it (A = 16; 512 and
   256); the library's rule (``cuda_kernels.forward_path``) must send every
   window, rotmat, rotwin (run min(X, L)), matrot and top-window shape of the
   22q, 24q and 26q plans to the wgmma kernel.  At the 22q plan's top window, window_apply_top is timed
   once beside the split-TF32 mma.sync tile on the same shape (the datum its
   wgmma route replaced, through the library's ``window_apply_top_tile``
   entry, held to the plain version too) and cuBLAS, each also with its
   calls queued behind a spinning kernel (device time without launch gaps;
   a diagnostic: phase 6 times without it);
4. the forward slice: 3 single requests and one batch of 3 per width, with
   launch counts reset just before and read just after; every forward
   kernel launches exactly once per plan step of its kind.  One request per
   width is held against the port's plain CPU path in float64
   (max |delta <Z>| <= 1e-4), and single and batched answers must agree;
5. the gradient slice: ``loss = model(inputs=...).mean(); loss.backward()``
   for one input and for the batch of 3, with the bfloat16 and the float32
   cotangent (lambda) of the saved executor, launch counts reset before and
   read after: one backward kernel per payload step (window_apply_bwd,
   window_apply_top_bwd, rotmat/matrot/rotwin_apply_bwd), no adjoint
   kernel.  22q: the card's gradient against the port's CPU float64 path
   (f32 lambda <= 1e-4 absolute, bf16 <= 5e-4).  24q: the f32-lambda saved
   executor against the per-kernel autograd loop (<= 1e-6), bf16 against
   f32 lambda (<= 5e-4), a central finite difference of the card's forward
   along g/|g| (eps 1e-2, within 2 % of |g| + 2e-4), the forward value under
   autograd against inference mode (<= 1e-6), a batch against its single
   requests, and three plain SGD steps;
5b. the adjoint slice: gradients through the adjoint-state executor, forced
   (``BACKWARD_MODE = "adjoint"``) or chosen by the residual rule, with
   launch counts reset before the phase and read after each run (one
   adjoint_step per window and per rotwin step, one adjoint_step_top per
   top window, one adjoint_rotmat / adjoint_matrot per such step,
   rotate_pair at least once per rotation and rotwin step, no backward
   kernel; the 24q plan's gradient is 9 adjoint_step and 2 adjoint_rotmat
   launches).  22q forced: against the CPU float64 gradient (f32 lambda
   <= 1e-4, bf16 <= 5e-4).  24q forced: against the saved executor (f32
   lambda, <= 1e-4 max|g| + 1e-6) and bf16 against f32 lambda (<= 5e-4).
   Two 24q batches bracket the rule's 0.35 line, sized from the rule's
   estimate per input and the line this run reads (both printed): the
   smallest batch >= 10 % over it under ``"auto"`` takes the adjoint for
   every element, matches the saved executor on the same batch, and takes
   three SGD steps; the largest batch under it reads free memory once and
   takes the saved executor for every element, where a rule re-reading
   free memory per element would flip part-way (checked from the memory
   free after the forward).  26q: the executor ``"auto"`` picks, forced
   adjoint against forced saved, bf16 against f32 lambda, and a central
   finite difference;
5c. the fused plan against the unfused one (``FUSE_LAYOUT_ROT`` off) on the
   same 24q model and input: <Z> within 1e-6, the saved and the adjoint
   gradients (f32 lambda) within 1e-4 max|g| + 1e-6, no fused kernel with
   the flag off; each plan's residual estimate and saved fwd+grad peak;
5d. the chain route (``simulation.USE_CHAINS = True``, B17 chain_apply and
   B18 adjoint_chain): the 22q and 24q chain plans are printed (24q: the 9
   steps of ``CHAIN_PLAN_24``), 26q has none and keeps its scheduled plan;
   every window of both plans takes the wgmma product by the library's rule
   (``cuda_kernels.forward_path`` on the descriptor table's K and run);
   both kernels against their plain versions in float64 at every step of
   both plans (states 1e-5, each descriptor's cotangent 1e-4, relative);
   then, with launch counts reset before and read after each request, a
   forward request launches exactly one chain_apply per chain step and no
   other kernel (<Z> within 1e-5 of the scheduled plan's, within 1e-4 of the
   CPU float64 path), a forced-adjoint gradient one chain_apply and one
   adjoint_chain per step and no other kernel (within 1e-4 max|g| + 1e-6 of
   the scheduled plan's saved gradient, f32 lambda; 22q within 1e-4 of the
   CPU float64 gradient), an ``"auto"`` gradient under the residual line
   the per-step loop over the steps' expansion (one forward and one backward
   window kernel per window, no chain kernel; the same tolerance), and three
   SGD steps on the adjoint route;
5e. the noisy density slice: the 13q model's forward requests (three
   expval, a probs, a density and the density of qubits [0, 1]) launch one
   kernel per plan step; <Z> within 1e-5 of the same plan through the plain
   versions in float64 on the card and of the ket-then-bra engine
   (``simulate_mixed_ri``) on the card; the noise-free lowered tape's
   diagonal within 1e-5 of |psi|^2 of the 13q pure path; density answers of
   trace 1 +- 1e-5, Hermitian to 1e-6, their diagonal equal to the probs;
   a 13q model with every noise knob (ThermalRelaxation t2 > t1) answers,
   its tape within 1e-5 of float64; the gradient of the mean <Z> through
   the saved executor (f32 lambda) within 1e-4 max|g| + 1e-6 of float64
   autograd through the plain versions (each step checkpointed), bf16
   lambda within 5e-4, a central finite difference, the same launches and
   gradient with ``BACKWARD_MODE = "adjoint"`` and ``USE_CHAINS`` on (the
   plan unchanged; B12-B18 launch zero times over the phase), the peak
   memory beside the residual estimate; ``shots=10000`` within 5 standard
   errors of the exact <Z>, the same seed giving the same estimate, and
   ``density`` with shots raising ``ValueError``;
5f. the analysis slice: ``Coefficients.get_spectrum`` of the 24q model
   (97 grid inputs in one model call) launches exactly the forward plan's
   kernels per grid input and nothing else; the grid's outputs within 1e-5
   (its coefficients within 1e-5 max|c|) of the same grid through the plain
   versions in float64 on the card; the spectrum's imaginary leak within the float32
   budget (the reference's own check, which raises); the Fourier series at
   three off-grid inputs within 1e-4 of the card's forward; the same for
   the 13q noisy density model (53 grid inputs on 26 wires, without the
   float64 grid).  Then the small registers, whose every window, top-window
   and backward shape phase 3 has held in float64 first (read off the same
   analyses run on the CPU, plus n = 1 and 2 whole-register windows), with
   no plain version called on the card: the 1q RX spectrum (1/2 at +-1);
   FourierTree of 2q and 4q Circuit_19 against the card's FFT spectrum
   (1e-4), the native leaf enumerator loaded; Meyer-Wallach of 4q
   Circuit_1 and Circuit_9 (200 samples) within 2e-2 of 0 and 1 and Bell
   measurements within 1e-5 of it on the stored sets; the 2q GHZ's
   concentratable entanglement within 1e-5 of the CPU float64 one; the KL
   divergence of 4q Circuit_9 on [0, 4 pi] (5000 samples, 75 bins) within
   40 % of Sim et al.'s 0.6773; the 4q Circuit_19 QFI (reverse-mode
   Jacobian through the backward kernels) within 1e-4 max|F| of the CPU
   float64 one.  Times: each spectrum and its ms a grid input beside a
   single forward request, the Meyer-Wallach, Bell, KL, FourierTree and
   QFI runs, and a 4q batch element's ms (record, plan, run);
5g. the batch route: a batch is recorded once, planned once and run with a
   leading batch axis, one launch of a B1-B4 batch entry per matrix step a
   chunk below 22 qubits (counted against its cached plan): the FCC Fig. 3a
   protocol (416,000 6q elements, one call a circuit, float64 for the
   goldens within 3e-2 and float32 reported; Hardware_Efficient's FCC
   reported, not held: its vanishing coefficients' rounding noise sets it,
   and those coefficients are held instead, in float64 against the CPU's
   and at rounding level where they vanish, 1e-12 of max|c|), Sim et al.'s
   KL (10,000 elements, within 40 %), the 24q spectrum (route "per
   element", one record, one plan, 97 x the 14-step plan's launches), a 6q
   batch of 256 forward + gradient against the loop route (float32 1e-5,
   gradients 1e-4 max|g| + 1e-6; float64 1e-12, and 1e-12 of the CPU's
   float64 model) and three SGD steps, a 10q density batch of 20 in chunks
   of 5 equal to the unchunked one under 1 GB, and the 24q batch of 18
   under ``"auto"`` reading free memory once; each batch call also records
   its last element alone (the executor's check); phase 3 holds the batch
   entries first at every shape these run (read off them on the CPU),
   float64 ones at 1e-12, and at the backward's geometry edges
   (``BATCH_EDGE_CASES``), each backward call repeated for the same bits;
5h. pulse mode (``gate_mode="pulse"``, the gaussian envelope): the 24q
   Circuit_19 pulse tape (its operations by name; recorded and planned on
   the CPU for phase 3, which holds every forward, backward, adjoint and
   fused shape of its plan and of this phase's small registers first) and
   a forward request with exact launches per plan step and one batched
   solve per Hamiltonian family (five: the RX and RY drives, virtual RZ,
   CZ, H's correction), <Z> within 1e-4 of the CPU's float64 pulse request,
   its time and where it goes (record, of which the solves, plan, run);
   forward + gradient in params and pulse_params through the saved
   executor (f32 lambda; exact backward launches) against the forced
   adjoint executor (1e-4 max|g| + 1e-6) and a central difference along
   (g, g_pulse); a 6q batch of 3 inputs x 2 parameter sets x 2 pulse
   scalers on the vectorised route (one batch record, one of its last
   element) equal to the loop route (float32 1e-5, float64 1e-12); the
   goldens (``BASELINE.md:20-21``): every leaf and composite pulse gate
   over 20 angles, state fidelity >= 0.99 and phase error <= 1e-2 (CPhase's
   phase excepted: its recipe carries the global phase e^{-iw/4}), and the
   gaussian RX against the analytic RX, gate fidelity 1 +- 1e-2; a QOC run
   of RX (tests/test_qoc.py's budget, two restarts) whose loss falls, with
   its seconds;
5i. utils and the API surface: the 24q Circuit_19 tape (recorded on the
   card) through the complex-state ``simulate_pure``, with phase 4's
   launches once per plan step and nothing else, the state equal bit for
   bit to ``from_ri(simulate_pure_ri(...))`` and <Z> from |psi|^2 (float64
   marginals) within 1e-6 of the Model's; ``Operation.apply_to_state`` on
   a 24q state for a mid-register window (one window_apply), a top window
   (one window_apply_top) and a ring-wrap gate (two rotate, one
   window_apply), each within 1e-5 of the plain version in float64;
   ``simulate_mixed`` of a 10q noisy tape (ket-then-bra, 20 wires) against
   the CPU's float64 (1e-5, Hermitian to 1e-6); a checkpoint round trip of
   the 24q model (``utils/checkpointing.py``) with bit-identical <Z>; the
   24q model's text drawing, symbolic and with gate values, equal to the
   CPU's; the 24q pulse model's ``Script.pulse_events`` equal to the CPU's
   (no mpl or pulse figure: the card's machine has no matplotlib); the
   24q ``simulate_pure`` request's ms (host clock, CUDA events), the
   profiler's kernels and the device's idle share (the union of the
   kernels' intervals over the traced request, from the Chrome trace of
   ``utils/profiling.xla_trace``) of one 24q forward request and one 4q KL
   batch of 10,000 elements, and ``timed``'s mean of the 24q forward;
5j. the sharded route (``parallel/``) on this card: a one-rank NCCL group
   in this process (``state=1``) and four spawned gloo ranks sharing the
   card (``state=4``, and ``data=2 x state=2`` for a batch of 8; every
   exchange staged through pinned host memory): the 24q forward and
   forward + gradient (float32 cotangents on both routes) and the 13q
   density expval and probs held to the single-device route (1e-5;
   gradients 1e-4 max|g| + 1e-6), every request on a sharded route,
   B1/B3 (B12/B13 on gradients, B1b/B3b on the batch) launched on every
   rank and none of B6-B11, B14, B15, B17, B18;
5k. with four cards, the sharded route with one NCCL rank a card: four
   spawned processes, rank r on card r (made current before any
   allocation and bound to the group, whose collectives fail after
   ``CARD_TIMEOUT`` s), exchanges card to card (not staged): the 30q
   Circuit_19 forward and forward + gradient on ``state=4`` held to the
   single-device route on card 0 as in 5j; the 32q forward and forward +
   gradient (bfloat16 lambda), which no card holds, held to the closed
   form cos(2x + the qubit's RX angles) at seeded RX angles, a different
   one for each qubit and layer, every other angle zero (1e-5), and to central
   differences along two seeded directions (1e-3 + 2e-2 |g.d|), and to
   the single-card forward where that fits; 5j's batch of 8 on
   ``data=2 x state=2`` with both batched exchange forms, and the 13q
   density expval and probs; on every rank every card tensor the
   requests make on its own card, no tensor as large as the 30q or 32q
   register, the routes and launches as in 5j; ms at one card and four,
   exchanges and GB sent, every rank's peak memory, NCCL's transports
   and the share of NCCL kernels in rank 0's traced 32q forward.  With
   fewer than four cards it logs that it did not run;
6. times: ms per forward request and per forward + gradient request (best
   of 3 after warm-up, and the median of 10), where a gradient request's
   time goes (record, plan, forward run, backward run), the same for the
   24q forced adjoint, 26q adjoint and saved, the 24q batch over the line
   under ``"auto"``; the 24q forward, saved fwd+grad and adjoint fwd+grad
   with the flag off and on in turns (off, on, on, off; medians of 10) and
   the forward plan's device time; the 24q forward and forced-adjoint
   fwd+grad with ``USE_CHAINS`` off and on, in turns the same way, and the
   chain plan's device time; the 13q density forward and saved fwd+grad
   (best of 3, median of 10, peak memory), where their time goes, their
   plan's device time and its kernels' device time per forward and per
   gradient beside their library yardsticks and bounds; and each kernel's
   time on one request's shapes
   beside its plain version's, its library yardstick's (the cuBLAS complex64
   products of the same shapes through ``torch.matmul``, a transpose copy,
   or for the chain kernels the products of the step's windows and its
   diagonals' multiplies, summed) and its bound, CUDA events, best of 3
   after warm-up.  The bound is max(flops / 67 TFLOP/s, bytes / 3.35 TB/s)
   for the kernels on the float32 CUDA cores; for those whose products run
   on the tensor cores in split TF32 (``TC_KERNELS``) it is max(passes x 8K
   flops an amplitude / 495 TFLOP/s + CUDA-core flops / 67 TFLOP/s,
   bytes / 3.35 TB/s), with 3 passes for a product of two float32 operands
   and 2 for one with a bfloat16 cotangent: window_apply, rotmat_apply,
   rotwin_apply, matrot_apply and window_apply_top (one product, on wgmma) 3
   a call; adjoint_step, adjoint_step_top, adjoint_rotmat and adjoint_matrot
   (three products and the 8K^3 flops of gw = G0 W on the CUDA cores) 9 a
   call with a float32 lambda, 7 with bfloat16; window_apply_bwd,
   window_apply_top_bwd, rotmat_apply_bwd, matrot_apply_bwd and
   rotwin_apply_bwd (two products) 6 a call with a float32 g, 4 with
   bfloat16; chain_apply 3 a window (its diagonals' 6 flops an amplitude on
   the CUDA cores) and adjoint_chain 9 a window (float32 lambda; the
   diagonals' 20 flops an amplitude and the 8K^3 of G0 W on the CUDA
   cores).  The float32-core figure is printed beside it.  The batch
   entries' rows are also timed held behind a spin, beside an empty kernel
   launched through the same ctypes path (the launch floor), and one B1b,
   B2b, B3b and B4b call must launch exactly one kernel
   (``torch.profiler``'s device events; "not measured" where it shows
   none).  One FCC Circuit_19 request's forward calls are also timed in
   float64, the dtype phase 5g runs FCC in, logged beside the kernels line
   (8 bytes a value; the bound at the fp64 peak, 67 TFLOP/s; ``torch.bmm``
   in complex128).

Any failed phase exits non-zero.  The line before the last is a JSON object
with one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WIDTHS = (22, 24)
WIDE = 26  # the reference bench's second width: the adjoint phase only
N_LAYERS = 2
SEED = 7
DEVICE = "cuda"
REQUESTS = (0.37, -0.81, 1.42)
TOL_WINDOW = 1e-5  # max|kernel - plain64| / max|plain64|, fp32 accumulation over K <= 1024
TOL_EXPVAL = 1e-4  # max|<Z> card fp32 - <Z> CPU fp64| over 13-19 fused steps
TOL_BATCH = 1e-6  # single vs batched request: same kernels on the same inputs
TOL_GRAM = 1e-4  # backward kernels' gw: fp32 sum over up to 2^16 columns, in chunks
TOL_GRAD_F32 = 1e-4  # 22q card gradient (f32 lambda) vs CPU fp64, absolute
TOL_GRAD_BF16 = 5e-4  # bf16-lambda budget of the JAX package (docs/performance.md)
TOL_GRAD_LOOP = 1e-6  # saved executor (f32 lambda) vs per-kernel loop: same products
FD_EPS = 1e-2
FD_REL, FD_ABS = 0.02, 2e-4  # |fd - g.v| <= 2 % of |g| + 2e-4 (fp32 forward, O(eps^2))
SGD_LR = 1.0
TOL_ADJ_REL, TOL_ADJ_ABS = 1e-4, 1e-6  # adjoint vs saved: <= 1e-4 max|g| + 1e-6
BATCH_MARGIN = 0.10  # the batch over the 0.35 line is >= 10 % over it
TOL_FUSE_FWD = 1e-6  # fused vs unfused plan: <Z> (same windows, other pass order)
TOL_CHAIN_FWD = 1e-5  # chain vs scheduled plan: <Z> (other windows, composed in other groups)
PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
PEAK_FP64 = 67e12  # H100 SXM fp64 tensor-core FLOP/s (data sheet; 34 on the CUDA cores)
# Split TF32 on the tensor cores: csrc/forward_wgmma.cuh (the first five),
# csrc/adjoint_tc.cuh, and csrc/chain_block.cuh (the last two).
TC_KERNELS = ("window_apply", "rotmat_apply", "rotwin_apply", "matrot_apply", "window_apply_top",
              "window_apply_bwd", "window_apply_top_bwd", "rotmat_apply_bwd", "matrot_apply_bwd",
              "rotwin_apply_bwd", "adjoint_step", "adjoint_step_top", "adjoint_rotmat",
              "adjoint_matrot", "chain_apply", "adjoint_chain")
PEAK_HBM = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# The noisy density slice: the reference bench's 13-qubit noisy Circuit_19
# (bench.py:47, :140), simulated on the 26-wire interleaved doubled register.
DENSITY_N = 13
DENSITY_NOISE = {"Depolarizing": 0.01}
# Every noise knob at once; ThermalRelaxation with t2 > t1 (the Choi branch).
DENSITY_ALL_NOISE = {
    "BitFlip": 0.01, "PhaseFlip": 0.01, "Depolarizing": 0.01, "MultiQubitDepolarizing": 0.01,
    "AmplitudeDamping": 0.01, "PhaseDamping": 0.01, "GateError": 0.01,
    "StatePreparation": 0.01, "Measurement": 0.01,
    "ThermalRelaxation": {"t1": 100.0, "t2": 150.0, "t_factor": 0.1},
}
TOL_DENSITY = 1e-5  # <Z> / probabilities: card fp32 vs fp64 plain versions, other engines
TOL_HERMITIAN = 1e-6  # max|rho - rho^dag| of a density answer
SHOTS = 10000
SHOT_SIGMAS = 5  # a shot estimate lies within 5 standard errors of the exact value
# The analysis slice (phase 5f).
TOL_SPECTRUM = 1e-5  # 24q grid outputs, and coefficients times max|c|: card fp32 vs fp64 plain
TOL_SERIES = 1e-4  # Fourier series off the grid vs the card's forward (fp32 phases up to 48 rad)
TOL_TREE = 1e-4  # FourierTree coefficients vs the card's FFT spectrum
MW_SAMPLES, MW_SEED, MW_TOL = 200, 1000, 2e-2  # tests/test_golden.py:264-282
TOL_BELL = 1e-5  # Bell measurements vs Meyer-Wallach on the same stored sets (fp32)
TOL_CE = 1e-5  # 2q GHZ concentratable entanglement: card fp32 vs CPU fp64
KL_SAMPLES, KL_BINS, KL_GOLDEN, KL_REL = 5000, 75, 0.6773, 0.40  # tests/test_golden.py:315-347
TOL_QFI = 1e-4  # 4q QFI: card fp32 vs CPU fp64, relative to max|F|
OFF_GRID = (0.123, 1.7, 4.4)
# The batch route (phase 5g).  FCC Fig. 3a (arXiv:2508.20868): 6q, one layer,
# RY encoding, 2**6 x 500 parameter sets x 13 grid inputs; tests/test_golden.py:352-376.
# Hardware_Efficient's FCC is reported, not held to Fig. 3a: three of its
# seven correlated coefficients (frequencies 4-6) vanish in exact arithmetic,
# so its FCC is set by how their rounding noise correlates, which no choice
# of precision pins (tools/fcc_noise.py on the CPU: the port 0.093 in float64
# and 0.122 in float32, the JAX package 0.108 in float32; the card 0.137 in
# float64 and 0.114 in float32).  What is held instead: its float64
# coefficients against the CPU's float64 plain path on FCC_SUBSAMPLE
# parameter sets, and those from |frequency| FCC_VANISHING up at rounding
# level, both within TOL_FCC_COEFF of max|c|.
FCC_GOLDENS = (("Circuit_20", 0.004), ("Circuit_19", 0.010), ("Circuit_17", 0.078),
               ("Hardware_Efficient", 0.080))
FCC_REPORTED = ("Hardware_Efficient",)
FCC_N, FCC_SAMPLES, FCC_ATOL = 6, 500, 3e-2
FCC_SUBSAMPLE, FCC_VANISHING, TOL_FCC_COEFF = 64, 4, 1e-12
GRAD_BATCH_N, GRAD_BATCH = 6, 256  # a 6q training step over a batch of inputs
TOL_GRAD_BATCH = (1e-4, 1e-6)  # |g_vectorised - g_loop| <= 1e-4 max|g| + 1e-6
# Vectorised vs loop forward on the card: in float32 two routes of their own
# rounding (the loop's windows in split TF32 on the tensor cores, the batch
# entries' in float32 FMA), in float64 one kernel.
TOL_BATCH_LOOP = 1e-5
TOL_BATCH_LOOP64 = 1e-12
# The float64 batch entries against their plain versions (states and both
# cotangents, relative), and the 6q float64 batch against the CPU's float64
# model (outputs absolute; gradients relative to max|g|).
TOL_BATCH64 = 1e-12
# Edges of the batch backward's geometry held in phase 3 beside phase 5g's
# shapes, both window modes and both dtypes: an element split over CTAs
# (20q, K = 32), a wide batch, a K = 32 top window and a whole-register
# window (K = 1024, read in place in float64); (n, a, k, Bt).
BATCH_EDGE_CASES = ((20, 3, 5, 2), (6, 3, 3, 65536), (10, 5, 5, 7), (10, 0, 10, 2))
# BASELINE.md:18: a chunked 10q density batch of 20 in chunks of 5 under 1 GB.
CHUNK_N, CHUNK_BATCH, CHUNK_ROWS, CHUNK_PEAK = 10, 20, 5, 1e9
TOL_CHUNK = 1e-6

KERNELS = {
    "window_apply": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:247",
    ),
    "window_apply_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:301",
    ),
    "window_apply_top": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:511",
    ),
    "window_apply_top_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:547",
    ),
    "rotate": dict(
        source="qml_essentials_tpu_torch/csrc/rotate.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:763",
    ),
    "rotmat_apply": dict(
        source="qml_essentials_tpu_torch/csrc/rotmat_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:846",
    ),
    "rotmat_apply_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/rotmat_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:881",
    ),
    "matrot_apply": dict(
        source="qml_essentials_tpu_torch/csrc/matrot_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1051",
    ),
    "matrot_apply_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/matrot_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1087",
    ),
    "rotwin_apply": dict(
        source="qml_essentials_tpu_torch/csrc/rotwin_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1329",
    ),
    "rotwin_apply_bwd": dict(
        source="qml_essentials_tpu_torch/csrc/rotwin_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1367",
    ),
    "adjoint_step": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_step.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:403",
    ),
    "adjoint_step_top": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_step_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:635",
    ),
    "adjoint_rotmat": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_rotmat.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:962",
    ),
    "adjoint_matrot": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_matrot.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1168",
    ),
    "rotate_pair": dict(
        source="qml_essentials_tpu_torch/csrc/rotate_pair.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:724",
    ),
    "chain_apply": dict(
        source="qml_essentials_tpu_torch/csrc/chain_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1713",
    ),
    "adjoint_chain": dict(
        source="qml_essentials_tpu_torch/csrc/adjoint_chain.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:1821",
    ),
    # The batch entries of B1-B4 (csrc/window_batch.cuh, built into their
    # kernels' sources): the counterpart of the vmapped pallas_call.
    "window_apply_batch": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:247",
    ),
    "window_apply_bwd_batch": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:301",
    ),
    "window_apply_top_batch": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:511",
    ),
    "window_apply_top_bwd_batch": dict(
        source="qml_essentials_tpu_torch/csrc/window_apply_top_bwd.cu",
        replaces="qml_essentials_tpu/ops/pallas_kernels.py:547",
    ),
}
FWD_KERNELS = ("window_apply", "window_apply_top", "rotate", "rotmat_apply", "matrot_apply",
               "rotwin_apply")
BWD_KERNELS = ("window_apply_bwd", "window_apply_top_bwd", "rotmat_apply_bwd",
               "matrot_apply_bwd", "rotwin_apply_bwd")
ADJOINT_KERNELS = ("adjoint_step", "adjoint_step_top", "adjoint_rotmat", "adjoint_matrot",
                   "rotate_pair")
CHAIN_KERNELS = ("chain_apply", "adjoint_chain")
BATCH_KERNELS = ("window_apply_batch", "window_apply_bwd_batch", "window_apply_top_batch",
                 "window_apply_top_bwd_batch")

# The 24q chain plan (geometry, descriptors) of the JAX package's planner on
# this model's tape: H and L blocks in turns, 23 windows (sum of K 4992) and
# 3 two-bit ring-wrap diagonals.
_L4 = (("win", 0, 8), ("win", 7, 15), ("win", 0, 8), ("win", 7, 14), ("win", 9, 17))
_H3 = (("win", 16, 24), ("diag", (23, 0)), ("win", 17, 24))
CHAIN_PLAN_24 = [
    (("H", 8), (("win", 16, 24),)),
    (("L", 17), (("win", 10, 17), ("win", 0, 8), ("win", 8, 16))),
    (("H", 8), (("diag", (23, 0)), ("win", 17, 24))),
    (("L", 17), _L4), (("H", 8), _H3), (("L", 17), _L4), (("H", 8), _H3),
    (("L", 17), (("win", 0, 8), ("win", 7, 15), ("win", 10, 17))),
    (("H", 8), (("win", 16, 24),)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Shapes of the main path
# ---------------------------------------------------------------------------


class _Flag:
    """``with _Flag(name, on):`` runs with ``simulation.<name> = on``."""

    def __init__(self, name: str, on: bool) -> None:
        self.name, self.on = name, on

    def __enter__(self):
        from qml_essentials_tpu_torch.ops import simulation

        self.before = getattr(simulation, self.name)
        setattr(simulation, self.name, self.on)

    def __exit__(self, *exc):
        from qml_essentials_tpu_torch.ops import simulation

        setattr(simulation, self.name, self.before)


def fusion(on: bool) -> _Flag:
    """Plans with fused rotation steps (``FUSE_LAYOUT_ROT``) on or off."""
    return _Flag("FUSE_LAYOUT_ROT", on)


def chain_route(on: bool) -> _Flag:
    """Plans with the chain route (``USE_CHAINS``) on or off."""
    return _Flag("USE_CHAINS", on)


def model_tape(n: int) -> list:
    """The tape of one forward of the n-qubit Circuit_19 model (on the CPU)."""
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops.tape import recording

    model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED,
                  device="cpu")
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([REQUESTS[0]]))
    return tape


def chain_plan(n: int):
    """The n-qubit model's chain plan as (geometry, descriptors, payload
    pairs on the card) per step, or None where the planner has none."""
    from qml_essentials_tpu_torch.ops import chains

    plan = chains.plan_chains(model_tape(n), n)
    if plan is None:
        return None
    return [(geom, descs, [torch.stack([p.real, p.imag]).to(DEVICE).contiguous() for p in pays])
            for _, (geom, descs, pays), _ in plan]


def plan_shapes(n: int, fused: bool = True) -> dict:
    """Kernel calls of one forward of the n-qubit Circuit_19 model, read off
    the port's scheduled plan (:func:`shapes_of`)."""
    from qml_essentials_tpu_torch.ops import simulation

    with fusion(fused):
        plan, _ = simulation.scheduled_plan(model_tape(n), n)
    return shapes_of(plan, n)


def shapes_of(plan: list, n: int) -> dict:
    """Kernel calls of a scheduled plan on n wires: window (a, k), top-window
    k, rotation r, the fused steps (rotmat r, matrot r, rotwin (r, k)), and
    the steps in plan order (the backward walks them in reverse)."""
    shapes = {name: [] for name in FWD_KERNELS}
    shapes["steps"] = []
    for kind, payload, wires in plan:
        if kind == "rot":
            shapes["rotate"].append(int(payload))
            shapes["steps"].append(("rot", int(payload)))
        elif kind in ("rotmat", "matrot"):
            r, k = int(payload[0]), len(wires)
            if list(wires) != list(range(k)) or (kind == "matrot" and k != n - r):
                raise AssertionError(f"{kind} step r={r} on wires {wires} at {n} qubits")
            if kind == "matrot":
                shapes["matrot_apply"].append(r)
                shapes["steps"].append(("matrot", r))
            elif k == r:
                shapes["rotmat_apply"].append(r)
                shapes["steps"].append(("rotmat", r))
            else:
                shapes["rotwin_apply"].append((r, k))
                shapes["steps"].append(("rotwin", (r, k)))
        elif kind == "mat":
            a, k = min(wires), len(wires)
            if sorted(wires) != list(range(a, a + k)):
                raise AssertionError(f"window on scattered wires {wires} at {n} qubits")
            if a + k == n:
                shapes["window_apply_top"].append(k)
                shapes["steps"].append(("top", (a, k)))
            else:
                shapes["window_apply"].append((a, k))
                shapes["steps"].append(("win", (a, k)))
        else:
            raise AssertionError(f"unexpected plan step {kind!r} at {n} qubits")
    return shapes


def backward_calls(steps: list) -> list:
    """The backward kernel calls of either plan-level executor for a plan
    with a bfloat16 cotangent: (kind, shape, g dtype, out dtype) in the order
    they run (the adjoint runs the same sequence of lambda dtypes)."""
    n_payload = sum(kind != "rot" for kind, _ in steps)
    calls, lam, slot = [], torch.float32, n_payload
    for kind, shape in reversed(steps):
        if kind == "rot":
            calls.append((kind, shape, lam, lam))
            continue
        slot -= 1
        out = torch.bfloat16 if slot > 0 else torch.float32
        calls.append((kind, shape, lam, out))
        lam = out
    return calls


def describe(shape: dict) -> str:
    return (f"{len(shape['steps'])} steps: windows {shape['window_apply']}  top "
            f"{shape['window_apply_top']}  rotations {shape['rotate']}  rotmat "
            f"{shape['rotmat_apply']}  matrot {shape['matrot_apply']}  rotwin "
            f"{shape['rotwin_apply']}")


def residual_bytes(shape: dict, n: int) -> int:
    """The residual rule's estimate for one input: one float32 pair a step."""
    return len(shape["steps"]) * 8 * 2**n


def saved_counts(shape: dict, requests: int = 1) -> dict:
    """Backward and adjoint launches of saved-executor gradients: one
    backward kernel per payload step, no adjoint kernel."""
    want = dict.fromkeys((*BWD_KERNELS, *ADJOINT_KERNELS), 0)
    want["window_apply_bwd"] = requests * len(shape["window_apply"])
    want["window_apply_top_bwd"] = requests * len(shape["window_apply_top"])
    for kind in ("rotmat", "matrot", "rotwin"):
        want[f"{kind}_apply_bwd"] = requests * len(shape[f"{kind}_apply"])
    return want


def adjoint_counts(shape: dict, requests: int = 1) -> dict:
    """Backward and adjoint launches of adjoint-executor gradients: one
    adjoint step per window (rotwin's window too: the JAX package has no
    fused rotwin adjoint), one rotate_pair per rotation and per rotwin step,
    the fused adjoint steps, no backward kernel."""
    want = dict.fromkeys((*BWD_KERNELS, *ADJOINT_KERNELS), 0)
    want["adjoint_step"] = requests * (len(shape["window_apply"]) + len(shape["rotwin_apply"]))
    want["adjoint_step_top"] = requests * len(shape["window_apply_top"])
    want["adjoint_rotmat"] = requests * len(shape["rotmat_apply"])
    want["adjoint_matrot"] = requests * len(shape["matrot_apply"])
    want["rotate_pair"] = requests * (len(shape["rotate"]) + len(shape["rotwin_apply"]))
    return want


def density_model(noise, device=None, dtype=torch.float32, shots=None):
    """The 13-qubit Circuit_19 model of the density slice with *noise*, on
    the card unless *device* says otherwise."""
    from qml_essentials_tpu_torch.models.model import Model

    model = Model(n_qubits=DENSITY_N, n_layers=N_LAYERS, circuit_type="Circuit_19",
                  random_seed=SEED, device=device or DEVICE, dtype=dtype, shots=shots)
    model.noise_params = noise
    return model


def density_tape(model, x: float, seed: int = SEED) -> list:
    """The tape of one forward of a density model on input x, its noise
    (GateError) drawn from a generator seeded *seed*."""
    from qml_essentials_tpu_torch.ops.tape import recording

    inputs = torch.tensor([x], dtype=model.dtype, device=model.device)
    with recording() as tape:
        model._variational(model.params[0], inputs, random_key=torch.Generator().manual_seed(seed),
                           noise_params=model.noise_params)
    return tape


def density_plan(tape: list, dtype=torch.float32, device=None) -> tuple:
    """The interleaved plan of a 13q tape on 26 doubled wires (composed on
    the card unless *device* says otherwise), and its start."""
    from qml_essentials_tpu_torch.ops import simulation

    dtape = simulation._lower_interleaved_tape(tape, DENSITY_N)
    _check(dtape is not None, "the 13q tape has no interleaved form")
    return simulation.interleaved_plan(dtape, 2 * DENSITY_N, dtype, device or DEVICE)


def density_shapes(noise) -> dict:
    """Kernel calls of one forward of the 13q model with *noise* (None: the
    noise-free tape, lowered all the same), planned on the card."""
    model = density_model(noise)
    with torch.no_grad():
        plan, _ = density_plan(density_tape(model, REQUESTS[0]))
    return shapes_of(plan, 2 * DENSITY_N)


def describe_steps(shape: dict) -> str:
    return ", ".join(f"{kind} {val}" for kind, val in shape["steps"])


# The maps the split-TF32 tile is instantiated with, each with the number of
# sources (objects of the library: one cubin a source) that instantiate it:
# the pullbacks and grams of window_apply_bwd / adjoint_step (window layout;
# WindowGramMap also adjoint_rotmat's), rotmat_apply_bwd / rotwin_apply_bwd /
# adjoint_rotmat (rotation layout; RotGramMap only under the saved
# backwards), matrot_apply_bwd / adjoint_matrot (MatrotPullbackMap;
# MatrotGramMap, the saved gram, only under matrot_apply_bwd) and
# adjoint_step_top / window_apply_top_bwd (TopPullbackMap; TopGramMap, also
# adjoint_matrot's), and the forward products at the shapes off the wgmma
# kernel: window_apply's (WindowMap), rotmat_apply's and rotwin_apply's
# (RotWindowMap), matrot_apply's (MatrotMap) and window_apply_top's (TopMap).
TC_MAPS = {"WindowPullbackMap": 2, "WindowGramMap": 3, "RotPullbackMap": 3, "RotGramMap": 2,
           "MatrotPullbackMap": 2, "MatrotGramMap": 1, "TopPullbackMap": 2, "TopGramMap": 3,
           "WindowMap": 1, "RotWindowMap": 2, "MatrotMap": 1, "TopMap": 1}


# The maps the forward wgmma kernel is instantiated with, and their sources:
# window_apply's, rotmat_apply's and rotwin_apply's, matrot_apply's and
# window_apply_top's.
WGMMA_MAPS = {"WindowMap": 1, "RotWindowMap": 2, "MatrotForwardMap": 1, "TopForwardMap": 1}


def _has_map(function: str, m: str) -> bool:
    """The mangled name names map m (RotWindowMap's name holds WindowMap's)."""
    return m in function and (m != "WindowMap" or "RotWindowMap" not in function)


def _sass_counts(out: str) -> list:
    """(object, function, HMMA, HGMMA) for every function in cuobjdump's SASS
    listing; a new object (one source's cubin) starts at each "Fatbin elf
    code" header."""
    rows, obj = [], -1
    for line in out.splitlines():
        if "Fatbin elf code" in line:
            obj += 1
        elif "Function :" in line:
            rows.append([obj, line.split("Function :", 1)[1].strip(), 0, 0])
        elif rows and "HGMMA" in line:
            rows[-1][3] += 1
        elif rows and "HMMA" in line:
            rows[-1][2] += 1
    return rows


def _check_maps(rows: list, kernel: str, maps: dict, col: int, what: str) -> None:
    """Every instantiation of *kernel* issues *what*, and each map is
    instantiated, with *what*, in at least as many objects as *maps* says."""
    fns = [r for r in rows if kernel in r[1]]
    log(f"  SASS: {len(fns)} {kernel} instantiations in {len({r[0] for r in fns})} objects, "
        f"with {sorted({r[col] for r in fns})} {what} instructions each")
    for m, need in maps.items():
        counts = sorted(r[col] for r in fns if _has_map(r[1], m))
        objs = len({r[0] for r in fns if _has_map(r[1], m) and r[col]})
        log(f"    {m:18s} {len(counts)} instantiations in {objs} objects (of {need}), "
            f"{what} {counts}")
        _check(bool(counts) and objs >= need,
               f"{m}: {kernel} with {what} in {objs} objects, not {need}")
    _check(bool(fns) and all(r[col] for r in fns), f"a {kernel} without {what}")


# The chain kernels: their window products, B18's grams and pullbacks on
# wgmma (HGMMA) and the products of windows under the wgmma rule on
# mma.sync (HMMA) in chain_apply_kernel<true> (a step with such a window)
# and adjoint_chain_kernel (cuobjdump lists a kernel's callees under it).
CHAIN_FUNCTIONS = ("chain_apply_kernel", "adjoint_chain_kernel")


def check_sass(path: Path) -> None:
    """Every instantiation of the split-TF32 tile (``tc_cgemm_kernel``, under
    TC_KERNELS) issues tensor-core HMMA instructions, and each map of TC_MAPS
    has one in as many sources as it names; every instantiation of the
    forward wgmma kernel (``forward_wgmma_kernel``) issues warpgroup HGMMA
    instructions, and each map of WGMMA_MAPS has one the same way; every
    instantiation of each chain kernel (CHAIN_FUNCTIONS) issues HGMMA, and
    one of each also HMMA; counted in the library's SASS with
    cuobjdump, beside nvcc."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    tool = Path(ck._nvcc()).with_name("cuobjdump")
    _check(tool.is_file(), f"no cuobjdump beside {ck._nvcc()}")
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    rows = _sass_counts(out)
    other = sum(r[2] for r in rows if "tc_cgemm_kernel" not in r[1])
    log(f"  SASS: {len({r[0] for r in rows})} objects; {other} HMMA outside tc_cgemm_kernel, "
        f"{sum(r[3] for r in rows if 'forward_wgmma_kernel' not in r[1])} HGMMA outside "
        f"forward_wgmma_kernel")
    _check_maps(rows, "tc_cgemm_kernel", TC_MAPS, 2, "HMMA")
    _check_maps(rows, "forward_wgmma_kernel", WGMMA_MAPS, 3, "HGMMA")
    for kernel in CHAIN_FUNCTIONS:
        fns = [r for r in rows if kernel in r[1]]
        log(f"  SASS: {len(fns)} {kernel} instantiations, HGMMA {[r[3] for r in fns]}, "
            f"HMMA {[r[2] for r in fns]}")
        _check(bool(fns) and all(r[3] for r in fns) and any(r[2] for r in fns),
               f"{kernel}: an instantiation without HGMMA, or no HMMA")


# ---------------------------------------------------------------------------
# Phase 3: kernel parity
# ---------------------------------------------------------------------------


def _state(n: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn((2, 2**n), generator=gen, device=DEVICE, dtype=torch.float32)
    return x / x.norm()


def _unitary(k: int, rng: np.random.Generator) -> torch.Tensor:
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return torch.as_tensor(np.stack([q.real, q.imag]), dtype=torch.float32, device=DEVICE)


def check_windows(ck, kn, cases, top: bool, gen, rng) -> float:
    """Window kernel vs its plain version in float64; returns the max abs error."""
    worst = 0.0
    for n, a, k in cases:
        x, w = _state(n, gen), _unitary(k, rng)
        if top:
            y = ck.window_apply_top(x, w, k, n)
            ref = kn.window_apply_top_plain(x.double(), w.double(), k, n)
        else:
            y = ck.window_apply(x, w, a, k, n)
            ref = kn.window_apply_plain(x.double(), w.double(), a, k, n)
        torch.cuda.synchronize()
        err = (y.double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        name = "window_apply_top" if top else "window_apply"
        log(f"  {name:20s} n={n:2d} a={a:2d} k={k:2d}  max|err|={err:.3e}  rel={rel:.3e}")
        if not rel <= TOL_WINDOW:
            raise AssertionError(f"{name} n={n} a={a} k={k}: rel err {rel:.3e} > {TOL_WINDOW}")
        worst = max(worst, err)
    return worst


_BWD_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp of each element: 2^-8 of the top of its binade."""
    _, e = torch.frexp(t)
    return torch.ldexp(torch.ones_like(t), e - 8)


def _cmp_state(label, got, ref, out_dt) -> tuple:
    """A state-sized output against float64: float32 within 1e-5 of the
    largest magnitude, bfloat16 within one bf16 ulp plus that floor.
    Returns (ok, rel, abs err counted for float32)."""
    if got.dtype != out_dt:
        raise AssertionError(f"{label}: output dtype {got.dtype}, want {out_dt}")
    err = (got.double() - ref).abs()
    floor = TOL_WINDOW * ref.abs().max()
    if out_dt == torch.bfloat16:
        ok = bool((err <= _bf16_ulp(ref) + floor).all())
    else:
        ok = bool(err.max() <= floor)
    top = err.max().item()
    return ok, top / ref.abs().max().item(), top if out_dt == torch.float32 else 0.0


def _cmp_bwd(label, got, ref, out_dt) -> float:
    """(gp, gw) of a backward kernel against float64; returns the max abs err."""
    (gp, gw), (rp, rw) = got, ref
    ok_p, rel_p, e_p = _cmp_state(label, gp, rp, out_dt)
    if gw.dtype != torch.float32:
        raise AssertionError(f"{label}: gw dtype {gw.dtype}")
    e_w = (gw.double() - rw).abs().max().item()
    rel_w = e_w / rw.abs().max().item()
    log(f"  {label} gp rel={rel_p:.3e} gw rel={rel_w:.3e}")
    if not (ok_p and rel_w <= TOL_GRAM):
        raise AssertionError(f"{label}: gp rel {rel_p:.3e}, gw rel {rel_w:.3e}")
    return max(e_w, e_p)


def _cmp_adjoint(label, got, ref, out_dt) -> float:
    """(psi_prev, lam_prev, gw) of an adjoint step against float64."""
    (pp, lp, gw), (rp, rl, rw) = got, ref
    ok_s, rel_s, e_s = _cmp_state(label, pp, rp, torch.float32)
    ok_l, rel_l, _ = _cmp_state(label, lp, rl, out_dt)
    if gw.dtype != torch.float32:
        raise AssertionError(f"{label}: gw dtype {gw.dtype}")
    e_w = (gw.double() - rw).abs().max().item()
    rel_w = e_w / rw.abs().max().item()
    log(f"  {label} psi rel={rel_s:.3e} lam rel={rel_l:.3e} gw rel={rel_w:.3e}")
    if not (ok_s and ok_l and rel_w <= TOL_GRAM):
        raise AssertionError(f"{label}: psi rel {rel_s:.3e}, lam rel {rel_l:.3e}, "
                             f"gw rel {rel_w:.3e}")
    return max(e_s, e_w)


def _dt(t: torch.dtype) -> str:
    return str(t)[6:]


def check_bwd(ck, kn, cases, top: bool, gen, rng) -> float:
    """Backward kernel vs its plain version in float64, for float32 and
    bfloat16 cotangents in and out; returns the max abs error."""
    name = "window_apply_top_bwd" if top else "window_apply_bwd"
    worst = 0.0
    for n, a, k in cases:
        x, w, g32 = _state(n, gen), _unitary(k, rng), _state(n, gen)
        for g_dt, out_dt in _BWD_DTYPES:
            g = g32.to(g_dt)
            if top:
                got = ck.window_apply_top_bwd(w, g, x, k, n, out_dt)
                ref = kn.window_apply_top_bwd_plain(
                    w.double(), g.double(), x.double(), k, n, torch.float64)
            else:
                got = ck.window_apply_bwd(w, g, x, a, k, n, out_dt)
                ref = kn.window_apply_bwd_plain(
                    w.double(), g.double(), x.double(), a, k, n, torch.float64)
            torch.cuda.synchronize()
            label = f"{name:20s} n={n:2d} a={a:2d} k={k:2d} g={_dt(g_dt):8s} out={_dt(out_dt):8s}"
            worst = max(worst, _cmp_bwd(label, got, ref, out_dt))
    return worst


def check_adjoint(ck, kn, cases, top: bool, gen, rng) -> float:
    """Adjoint step kernel vs its plain version in float64, for float32 and
    bfloat16 cotangents in and out; returns the max abs error."""
    name = "adjoint_step_top" if top else "adjoint_step"
    worst = 0.0
    for n, a, k in cases:
        psi, w, lam32 = _state(n, gen), _unitary(k, rng), _state(n, gen)
        for l_dt, out_dt in _BWD_DTYPES:
            lam = lam32.to(l_dt)
            if top:
                got = ck.adjoint_step_top(w, psi, lam, k, n, out_dt)
                ref = kn.adjoint_step_top_plain(
                    w.double(), psi.double(), lam.double(), k, n, torch.float64)
            else:
                got = ck.adjoint_step(w, psi, lam, a, k, n, out_dt)
                ref = kn.adjoint_step_plain(
                    w.double(), psi.double(), lam.double(), a, k, n, torch.float64)
            torch.cuda.synchronize()
            label = f"{name:20s} n={n:2d} a={a:2d} k={k:2d} lam={_dt(l_dt):8s} out={_dt(out_dt):8s}"
            worst = max(worst, _cmp_adjoint(label, got, ref, out_dt))
            del got, ref
    return worst


def _fused_geom(kind: str, r: int, k: int) -> tuple:
    return (r, k) if kind == "rotwin" else (r,)


def check_fused(ck, kn, cases, gen, rng, adjoint: bool = True) -> dict:
    """The fused (rotation, window) kernels against their plain versions in
    float64: (kind, n, r, k) with k == r for rotmat, k == n - r for matrot and
    r < k for rotwin.  Each case runs the forward kernel, the backward kernel
    with float32 and bfloat16 cotangents in and out, and, for rotmat and
    matrot with *adjoint*, the adjoint step the same way.  Returns the max
    abs error per kernel."""
    errs = {}
    for kind, n, r, k in cases:
        geom = _fused_geom(kind, r, k)
        x, w, g32 = _state(n, gen), _unitary(k, rng), _state(n, gen)
        name = f"{kind}_apply"
        y = getattr(ck, name)(x, w, *geom, n)
        ref = getattr(kn, f"{name}_plain")(x.double(), w.double(), *geom, n)
        torch.cuda.synchronize()
        err = (y.double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        log(f"  {name:20s} n={n:2d} r={r:2d} k={k:2d}  max|err|={err:.3e}  rel={rel:.3e}")
        if not rel <= TOL_WINDOW:
            raise AssertionError(f"{name} n={n} r={r} k={k}: rel err {rel:.3e} > {TOL_WINDOW}")
        errs[name] = max(errs.get(name, 0.0), err)
        del y, ref
        for g_dt, out_dt in _BWD_DTYPES:
            g = g32.to(g_dt)
            bwd = f"{kind}_apply_bwd"
            got = getattr(ck, bwd)(w, g, x, *geom, n, out_dt)
            ref = getattr(kn, f"{bwd}_plain")(w.double(), g.double(), x.double(), *geom, n,
                                              torch.float64)
            torch.cuda.synchronize()
            label = f"{bwd:20s} n={n:2d} r={r:2d} k={k:2d} g={_dt(g_dt):8s} out={_dt(out_dt):8s}"
            errs[bwd] = max(errs.get(bwd, 0.0), _cmp_bwd(label, got, ref, out_dt))
            del got, ref
            if kind == "rotwin" or not adjoint:
                continue
            adj = f"adjoint_{kind}"
            got = getattr(ck, adj)(w, x, g, r, n, out_dt)
            ref = getattr(kn, f"{adj}_plain")(w.double(), x.double(), g.double(), r, n,
                                              torch.float64)
            torch.cuda.synchronize()
            label = f"{adj:20s} n={n:2d} r={r:2d} k={k:2d} lam={_dt(g_dt):8s} out={_dt(out_dt):8s}"
            errs[adj] = max(errs.get(adj, 0.0), _cmp_adjoint(label, got, ref, out_dt))
            del got, ref
    return errs


def check_rotate_pair(ck, kn, cases, gen) -> float:
    for n, r in cases:
        psi = _state(n, gen)
        for l_dt in (torch.float32, torch.bfloat16):
            lam = _state(n, gen).to(l_dt)
            yp, yl = ck.rotate_pair(psi, lam, r, n)
            torch.cuda.synchronize()
            exact = (yp.dtype == torch.float32 and yl.dtype == l_dt
                     and torch.equal(yp, kn.rotate_plain(psi, r, n))
                     and torch.equal(yl, kn.rotate_plain(lam, r, n)))
            log(f"  rotate_pair f32+{str(l_dt)[6:]:8s} n={n:2d} r={r:2d}  bit-exact={exact}")
            if not exact:
                raise AssertionError(f"rotate_pair {l_dt} n={n} r={r} is not bit-exact")
    return 0.0


def check_rotations(ck, kn, cases, gen, dtype=torch.float32) -> float:
    for n, r in cases:
        x = _state(n, gen).to(dtype)
        y = ck.rotate(x, r, n)
        ref = kn.rotate_plain(x, r, n)
        torch.cuda.synchronize()
        exact = y.dtype == dtype and torch.equal(y, ref) and torch.equal(
            y.double(), kn.rotate_plain(x.double(), r, n))
        log(f"  rotate {str(dtype)[6:]:8s}      n={n:2d} r={r:2d}  bit-exact={exact}")
        if not exact:
            raise AssertionError(f"rotate {dtype} n={n} r={r} is not bit-exact")
    return 0.0


def check_chain(ck, kn, n: int, steps: list, gen) -> dict:
    """B17 and B18 against their plain versions in float64 at every step of
    a chain plan, on a random state and cotangent: the states within
    TOL_WINDOW and each descriptor's cotangent within TOL_GRAM of the largest
    magnitude.  Returns the max abs error per kernel."""
    errs = dict.fromkeys(CHAIN_KERNELS, 0.0)
    for geom, descs, pairs in steps:
        x, lam = _state(n, gen), _state(n, gen)
        y = ck.chain_apply(x, pairs, geom, descs, n)
        pp, lp, gs = ck.adjoint_chain(x, lam, pairs, geom, descs, n)
        p64 = [p.double() for p in pairs]
        ry = kn.chain_apply_plain(x.double(), p64, geom, descs, n)
        rp, rl, rg = kn.adjoint_chain_plain(x.double(), lam.double(), p64, geom, descs, n)
        torch.cuda.synchronize()
        _check(lp.dtype == torch.float32 and len(gs) == len(descs)
               and all(g.dtype == torch.float32 and g.shape == p.shape
                       for g, p in zip(gs, pairs)),
               f"chain step {geom} {descs}: adjoint_chain outputs {lp.dtype}, "
               f"{[(g.dtype, tuple(g.shape)) for g in gs]}")
        abs_err = [(a.double() - b).abs().max().item() for a, b in
                   ((y, ry), (pp, rp), (lp, rl), *zip(gs, rg))]
        rel = [e / b.abs().max().item() for e, b in zip(abs_err, (ry, rp, rl, *rg))]
        log(f"  chain n={n:2d} {geom[0]} {len(descs)} descriptors: chain_apply rel={rel[0]:.3e}  "
            f"adjoint_chain psi rel={rel[1]:.3e} lam rel={rel[2]:.3e} "
            f"cotangents rel<={max(rel[3:]):.3e}")
        _check(max(rel[:3]) <= TOL_WINDOW and max(rel[3:]) <= TOL_GRAM,
               f"chain step n={n} {geom} {descs}: rel errors {rel}")
        errs["chain_apply"] = max(errs["chain_apply"], abs_err[0])
        errs["adjoint_chain"] = max(errs["adjoint_chain"], *abs_err[1:])
        del y, pp, lp, gs, ry, rp, rl, rg
    return errs


def forward_calls(plans: list) -> tuple:
    """(K, column run) of the forward kernel calls of (width, shape) plans:
    (all, matrot, top-window, rotwin) sets (rotwin's run: the shorter of X
    and L)."""
    calls = {(2**k, 2 ** (w - a - k)) for w, sh in plans for a, k in sh["window_apply"]}
    calls |= {(2**r, 2 ** (w - r)) for w, sh in plans for r in sh["rotmat_apply"]}
    matrots = {(2 ** (w - r), 2**r) for w, sh in plans for r in sh["matrot_apply"]}
    tops = {(2**k, 2 ** (w - k)) for w, sh in plans for k in sh["window_apply_top"]}
    rotwins = {(2**k, min(2 ** (w - k), 2**r)) for w, sh in plans for r, k in sh["rotwin_apply"]}
    return calls | matrots | tops | rotwins, matrots, tops, rotwins


def check_forward_path(ck, shapes: dict, dshapes: list) -> None:
    """Every window, rotmat, rotwin, matrot and top-window shape of the 22q,
    24q and 26q plans takes the forward wgmma kernel, by the library's own
    shape rule; the 13q density plans' shapes (26 wires) are listed with the
    route the rule gives them."""
    calls, matrots, tops, rotwins = forward_calls(list(shapes.items()))
    _check(bool(tops), "no top window in the plans")
    _check(bool(matrots), "no matrot step in the plans")
    _check(bool(rotwins), "no rotwin step in the plans")
    off = sorted((K, run) for K, run in calls if not ck.forward_path(K, run))
    log(f"  forward wgmma path: {len(calls) - len(off)} of {len(calls)} (K, column run) shapes "
        f"of the {'/'.join(f'{w}q' for w in shapes)} plans' windows, rotmat, rotwin and "
        f"matrot steps and top windows ({len(rotwins)} rotwin, {len(matrots)} matrot and "
        f"{len(tops)} top-window shapes)")
    _check(not off, f"plan shapes (K, run) off the forward wgmma kernel: {off}")
    dcalls = forward_calls([(2 * DENSITY_N, sh) for sh in dshapes])[0]
    log(f"  13q density plans' forward (K, column run) shapes: "
        f"{[(K, run, 'wgmma' if ck.forward_path(K, run) else 'tile') for K, run in sorted(dcalls)]}")


def _top_tile(ck, x, w, k, n):
    """The top window on the split-TF32 mma.sync tile at any shape, through
    the library's ``qml_window_apply_top_tile`` entry (no wrapper, no launch
    count): the datum window_apply_top's wgmma route is timed against."""
    y = torch.empty_like(x)
    code = ck._load().qml_window_apply_top_tile(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                 2 ** (n - k), 2**k, ck._stream(x))
    ck._raise_on("window_apply_top_tile", code)
    return y


def time_top_datum(ck, kn, shapes: dict, gen, rng) -> None:
    """At each top window of the 22q plan: window_apply_top (the wgmma
    kernel) beside the datum it replaced, the split-TF32 tile on the same
    shape, and cuBLAS; the tile is held to the plain version as well."""
    m = WIDTHS[0]
    for k in shapes[m]["window_apply_top"]:
        x, w = _state(m, gen), _unitary(k, rng)
        ref = kn.window_apply_top_plain(x.double(), w.double(), k, m)
        y = _top_tile(ck, x, w, k, m)
        torch.cuda.synchronize()
        rel = ((y.double() - ref).abs().max() / ref.abs().max()).item()
        _check(rel <= TOL_WINDOW, f"the top-window tile n={m} k={k}: rel err {rel:.3e}")
        del y, ref
        t_k, t_t, t_l = (_both_us(f) for f in (lambda: ck.window_apply_top(x, w, k, m),
                                               lambda: _top_tile(ck, x, w, k, m),
                                               lib_window_top(x, w, k, m)))
        log(f"  window_apply_top n={m} k={k}: wgmma kernel {t_k}, the tile (datum) {t_t} "
            f"(rel err {rel:.3e}), cuBLAS {t_l}")


def density_parity_cases(dshapes: list) -> dict:
    """Every kernel shape the density phase launches (26 wires): windows,
    top windows, the forward and backward rotations, the fused steps."""
    n2 = 2 * DENSITY_N
    rot = {r for sh in dshapes for r in sh["rotate"]}
    return dict(
        windows=sorted({(n2, a, k) for sh in dshapes for a, k in sh["window_apply"]}),
        tops=sorted({(n2, n2 - k, k) for sh in dshapes for k in sh["window_apply_top"]}),
        rotations=sorted({(n2, r) for r in rot | {(n2 - r) % n2 for r in rot}}),
        fused=sorted({("rotmat", n2, r, r) for sh in dshapes for r in sh["rotmat_apply"]}
                     | {("matrot", n2, r, n2 - r) for sh in dshapes for r in sh["matrot_apply"]}
                     | {("rotwin", n2, r, k) for sh in dshapes for r, k in sh["rotwin_apply"]}))


def phase_parity(shapes: dict, dshapes: list, ashapes: dict, bshapes: dict,
                 pshapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    n, m = WIDTHS[-1], WIDTHS[0]
    main_windows = sorted({(n, a, k) for a, k in shapes[n]["window_apply"]})
    # K = 2 and 4 and two-column states (the scalar-staged tile), and K = 8
    # and 16 on both sides of the wgmma kernel's rule (B = 2; B = 64).
    edge_windows = [(14, 3, 1), (14, 0, 2), (14, 12, 1), (14, 11, 2), (10, 1, 5), (9, 2, 3),
                    (10, 6, 3), (12, 3, 3), (11, 6, 4), (12, 2, 4)]
    main_top = [(w, w - k, k) for w in (22, 23, 25) for k in (6, 7, 8)]
    # K = 2, 4 and 64 with one row (the tile), K = 32, and K = 8 and 16 on both
    # sides of the wgmma kernel's rule (A = 16: the tile; A = 512 and 256).
    edge_top = [(12, 11, 1), (12, 10, 2), (6, 0, 6), (11, 6, 5), (7, 4, 3), (12, 9, 3),
                (8, 4, 4), (12, 8, 4)]
    grad_top = sorted({(m, m - k, k) for k in shapes[m]["window_apply_top"]})
    main_rot = sorted({(n, r) for r in shapes[n]["rotate"]})
    edge_rot = [(24, 1), (24, 23), (13, 1), (13, 12), (5, 2), (11, 4)]

    log("phase 3: kernel parity against the plain versions in float64 on the card")
    check_forward_path(ck, shapes, dshapes)
    errs = {
        "window_apply": check_windows(ck, kn, main_windows + sorted(
            {(m, a, k) for a, k in shapes[m]["window_apply"]}), False, gen, rng),
        "window_apply_top": check_windows(ck, kn, main_top, True, gen, rng),
        "rotate": check_rotations(ck, kn, main_rot, gen),
        "window_apply_bwd": check_bwd(ck, kn, main_windows, False, gen, rng),
        "window_apply_top_bwd": check_bwd(ck, kn, grad_top, True, gen, rng),
    }
    check_rotations(ck, kn, main_rot, gen, torch.bfloat16)
    time_top_datum(ck, kn, shapes, gen, rng)
    log("  edge shapes:")
    check_windows(ck, kn, edge_windows, False, gen, rng)
    check_windows(ck, kn, edge_top, True, gen, rng)
    check_rotations(ck, kn, edge_rot, gen)
    check_rotations(ck, kn, edge_rot, gen, torch.bfloat16)
    # K = 2, 4 and 8 with B = 2 (the tensor-core tile's scalar staging), K = 8
    # and 16 with B = 8 (its smallest 16-byte copies).
    check_bwd(ck, kn, [(14, 3, 1), (14, 0, 2), (14, 12, 1), (12, 0, 4), (12, 8, 3), (14, 3, 3),
                       (12, 5, 4)], False, gen, rng)
    check_bwd(ck, kn, [(12, 11, 1), (12, 10, 2), (6, 0, 6), (11, 6, 5)], True, gen, rng)

    log("  adjoint kernels (main-path shapes at 24q and 26q, the 22q top window, edges):")
    # Every adjoint_step shape of the 24q and 26q plans: the windows and the
    # rotwin steps' windows on [0, k).
    adj_windows = sorted({(w, a, k) for w in (n, WIDE) for a, k in shapes[w]["window_apply"]}
                         | {(w, 0, k) for w in (n, WIDE) for _, k in shapes[w]["rotwin_apply"]})
    adj_rot = main_rot + sorted({(WIDE, r) for r in shapes[WIDE]["rotate"]})
    errs["adjoint_step"] = check_adjoint(ck, kn, adj_windows, False, gen, rng)
    errs["adjoint_step_top"] = check_adjoint(ck, kn, grad_top, True, gen, rng)
    errs["rotate_pair"] = check_rotate_pair(ck, kn, adj_rot, gen)
    check_adjoint(ck, kn, [(14, 3, 1), (14, 0, 2), (14, 12, 1), (12, 0, 4), (12, 8, 3),
                           (14, 3, 3), (12, 5, 4)], False, gen, rng)
    # The top window at K = 2, 64 (on a 16q plane, with one row, on 24q and
    # 26q planes), 32, and K = 8 with A = 16 (the smallest 16-byte copies).
    check_adjoint(ck, kn, [(12, 11, 1), (16, 10, 6), (6, 0, 6), (11, 6, 5), (7, 4, 3),
                           (24, 18, 6), (26, 20, 6)], True, gen, rng)
    check_rotate_pair(ck, kn, [(24, 1), (24, 23), (13, 1), (13, 12), (5, 2)], gen)

    log("  fused rotation kernels (the main path's 22q, 24q and 26q shapes, edges):")
    main_fused = sorted(
        {("rotmat", w, r, r) for w in (m, n, WIDE) for r in shapes[w]["rotmat_apply"]}
        | {("matrot", w, r, w - r) for w in (m, n, WIDE) for r in shapes[w]["matrot_apply"]}
        | {("rotwin", w, r, k) for w in (m, n, WIDE) for r, k in shapes[w]["rotwin_apply"]})
    errs.update(check_fused(ck, kn, main_fused, gen, rng))
    # rotmat's K = 2 / X = 32, K = 4 / X = 8, K = 8 / X = 2 (scalar staging),
    # K = 8 / X = 256 (16-byte copies) and K = 256 / X = 2, backward and adjoint;
    # matrot's K = 8 / B = 16 (16-byte copies), K = 16 / B = 4 and K = 4 / B = 8
    # (scalar staging), K = 256 and K = 8 with B = 32 (the forward's wgmma
    # kernel at its column and K edges), K = 256 / B = 16 (its tile), and
    # K = 512 on a 26q plane; rotwin's backward with L = 8 / K = 128 / X = 32
    # and L = 8 / X = 8 (16-byte copies, a column tile across a-groups), X = 4
    # and L = 4 (scalar staging), L = 2 / K = 8 and L = 128 / X = 8; rotwin's
    # forward on both sides of its wgmma rule (L = 32 with X = 32: wgmma at
    # both edges; L = 16 and X = 16: the tile).
    check_fused(ck, kn, [("rotmat", 6, 1, 1), ("rotmat", 5, 2, 2), ("rotmat", 4, 3, 3),
                         ("rotmat", 11, 3, 3), ("rotmat", 9, 8, 8), ("matrot", 6, 5, 1),
                         ("matrot", 9, 1, 8), ("matrot", 7, 4, 3), ("matrot", 6, 2, 4),
                         ("matrot", 5, 3, 2), ("matrot", 13, 5, 8), ("matrot", 8, 5, 3),
                         ("matrot", 12, 4, 8), ("matrot", 26, 17, 9), ("rotwin", 6, 1, 3),
                         ("rotwin", 10, 2, 5), ("rotwin", 12, 7, 9), ("rotwin", 12, 3, 7),
                         ("rotwin", 8, 3, 5), ("rotwin", 7, 3, 5), ("rotwin", 9, 2, 5),
                         ("rotwin", 12, 5, 7), ("rotwin", 12, 4, 7), ("rotwin", 11, 5, 7)],
                gen, rng)
    log("  the 13q density plans' shapes on 26 wires (forward, backward, fused):")
    dcases = density_parity_cases(dshapes)
    log(f"    {dcases}")
    for name, e in (("window_apply", check_windows(ck, kn, dcases["windows"], False, gen, rng)),
                    ("window_apply_bwd", check_bwd(ck, kn, dcases["windows"], False, gen, rng)),
                    ("window_apply_top", check_windows(ck, kn, dcases["tops"], True, gen, rng)),
                    ("window_apply_top_bwd", check_bwd(ck, kn, dcases["tops"], True, gen, rng)),
                    ("rotate", check_rotations(ck, kn, dcases["rotations"], gen)),
                    *check_fused(ck, kn, dcases["fused"], gen, rng, adjoint=False).items()):
        errs[name] = max(errs.get(name, 0.0), e)
    check_rotations(ck, kn, dcases["rotations"], gen, torch.bfloat16)
    # Phase 5f's small registers: every shape its analyses run (1-4 qubits,
    # 6 and 8 wires), whole-register windows included, and n = 1 and 2
    # whatever they run; QFI's backward at its forward's windows.
    log("  the analysis slice's small registers (phase 5f), from its runs on the CPU:")
    log(f"    {ashapes}")
    tops = sorted(set(ashapes["tops"]) | {(1, 0, 1), (2, 1, 1), (2, 0, 2)})
    windows = sorted(set(ashapes["windows"]) | {(2, 0, 1)})
    for name, e in (("window_apply", check_windows(ck, kn, windows, False, gen, rng)),
                    ("window_apply_top", check_windows(ck, kn, tops, True, gen, rng)),
                    ("rotate", check_rotations(ck, kn, ashapes["rotations"], gen)),
                    ("window_apply_bwd", check_bwd(ck, kn, ashapes["bwd_windows"], False, gen,
                                                   rng)),
                    ("window_apply_top_bwd", check_bwd(ck, kn, ashapes["bwd_tops"], True, gen,
                                                       rng))):
        errs[name] = max(errs.get(name, 0.0), e)
    # Phase 5g's batches: the batch entries of B1-B4 at every shape and batch
    # it runs (forward and backward shapes both ways), and at Bt = 1 and 7.
    log("  the batch entries at phase 5g's shapes (from its workloads on the CPU):")
    cases = sorted({c[:4] + (bt, c[5]) for c in bshapes["fwd"] + bshapes["bwd"]
                    for bt in (1, 7, c[4])}
                   | {(n, a, k, per, bt, f64) for n, a, k, bt in BATCH_EDGE_CASES
                      for per in (False, True) for f64 in (False, True)})
    errs.update(check_batch(ck, kn, cases, gen, rng))
    # Phase 5h: the 24q pulse plan's shapes (forward, the saved executor's
    # backward, the forced adjoint) and its small registers' (the goldens,
    # the 6q batch, QOC), read off the same workloads on the CPU.
    log("  the 24q pulse plan and phase 5h's small registers (from its workloads on the CPU):")
    ps, pn = pshapes["main"], PULSE_N
    pw = sorted({(pn, a, k) for a, k in ps["window_apply"]})
    pt = sorted({(pn, pn - k, k) for k in ps["window_apply_top"]})
    prot = set(ps["rotate"])
    pr = sorted({(pn, r) for r in prot | {(pn - r) % pn for r in prot}})
    padj = sorted(set(pw) | {(pn, 0, k) for _, k in ps["rotwin_apply"]})
    pf = sorted({("rotmat", pn, r, r) for r in ps["rotmat_apply"]}
                | {("matrot", pn, r, pn - r) for r in ps["matrot_apply"]}
                | {("rotwin", pn, r, k) for r, k in ps["rotwin_apply"]})
    log(f"    24q windows {pw}, top windows {pt}, rotations {pr}, fused {pf}; small windows "
        f"{pshapes['windows']}, top windows {pshapes['tops']}, batch entries {pshapes['batch']}")
    for name, e in (("window_apply", check_windows(ck, kn, pw + pshapes["windows"], False, gen,
                                                   rng)),
                    ("window_apply_bwd", check_bwd(ck, kn, pw, False, gen, rng)),
                    ("adjoint_step", check_adjoint(ck, kn, padj, False, gen, rng)),
                    ("window_apply_top", check_windows(ck, kn, pt + pshapes["tops"], True, gen,
                                                       rng)),
                    ("window_apply_top_bwd", check_bwd(ck, kn, pt, True, gen, rng)),
                    ("adjoint_step_top", check_adjoint(ck, kn, pt, True, gen, rng)),
                    ("rotate", check_rotations(ck, kn, pr, gen)),
                    ("rotate_pair", check_rotate_pair(ck, kn, pr, gen)),
                    *check_fused(ck, kn, pf, gen, rng).items(),
                    *check_batch(ck, kn, pshapes["batch"], gen, rng).items()):
        errs[name] = max(errs.get(name, 0.0), e)
    check_rotations(ck, kn, pr, gen, torch.bfloat16)
    missing = set(KERNELS) - set(errs) - set(CHAIN_KERNELS)  # those in phase 5d
    _check(not missing, f"phase 3 checked no case of {sorted(missing)}")
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the forward slice
# ---------------------------------------------------------------------------


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def phase_slice(shapes: dict) -> tuple:
    """Returns the models, the launches and, per width, the card's <Z> for
    the first request and the CPU float64 path's."""
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    log("phase 4: Circuit_19 forward requests on the card")
    models = {
        n: Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                 random_seed=SEED, device=DEVICE)
        for n in WIDTHS
    }
    answers, per_width, refs = {}, {}, {}
    ck.reset_launch_counts()
    with torch.inference_mode():
        for n, model in models.items():
            before = ck.launch_counts()
            singles = [model(inputs=x) for x in REQUESTS]
            batched = model(inputs=list(REQUESTS))
            torch.cuda.synchronize()
            per_width[n] = _diff(ck.launch_counts(), before)
            answers[n] = (torch.stack(singles), batched)
    launches = ck.launch_counts()

    for n, (singles, batched) in answers.items():
        if tuple(singles.shape) != (3, n) or tuple(batched.shape) != (3, n):
            raise AssertionError(f"{n}q: shapes {tuple(singles.shape)} / {tuple(batched.shape)}")
        if not (torch.isfinite(singles).all() and torch.isfinite(batched).all()):
            raise AssertionError(f"{n}q: non-finite expectation values")
        d_batch = (singles - batched).abs().max().item()
        log(f"  {n}q launches {per_width[n]}  single vs batched max|delta|={d_batch:.3e}")
        if not d_batch <= TOL_BATCH:
            raise AssertionError(f"{n}q: single vs batched differ by {d_batch:.3e}")

        ref_model = _cpu_f64_model(models[n], n)
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = ref_model(inputs=REQUESTS[0])
        d_ref = (singles[0].double().cpu() - ref).abs().max().item()
        log(f"  {n}q card fp32 vs CPU fp64 plain path: max|delta <Z>|={d_ref:.3e} "
            f"(CPU reference took {time.perf_counter() - t0:.1f} s)")
        if not d_ref <= TOL_EXPVAL:
            raise AssertionError(f"{n}q: card vs CPU reference differ by {d_ref:.3e}")
        refs[n] = (singles[0], ref)

    # Six requests per width (three single, one batch of three): each runs
    # every step of its plan once.
    for n in WIDTHS:
        want = {name: 6 * len(shapes[n][name]) for name in FWD_KERNELS}
        got = {name: per_width[n][name] for name in FWD_KERNELS}
        _check(got == want, f"{n}q forward launches {got}, the plan wants {want}")
    for name in FWD_KERNELS:
        _check(launches[name] > 0, f"kernel {name} was never launched on the forward path")
    log(f"  launches over the forward run: {launches}")
    return models, launches, refs


def _cpu_f64_model(model, n: int):
    from qml_essentials_tpu_torch.models.model import Model

    ref_model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                      dtype=torch.float64, device="cpu")
    ref_model.load_numpy(model.params.detach().cpu().numpy())
    return ref_model


# ---------------------------------------------------------------------------
# Phase 5: the gradient slice
# ---------------------------------------------------------------------------


def _grad_request(model, inputs) -> tuple:
    """loss = mean <Z>; loss.backward(); returns (loss, d loss / d params)."""
    model.params.grad = None
    loss = model(inputs=inputs).mean()
    loss.backward()
    return loss.detach(), model.params.grad.detach().clone()


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double().cpu() - b.double().cpu()).abs().max().item()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_grad(models: dict, shapes: dict) -> tuple:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved

    log("phase 5: gradient of the mean <Z> w.r.t. params on the card (saved executor)")
    res, per_width, per_single = {}, {}, {}
    ck.reset_launch_counts()
    for n, model in models.items():
        before = ck.launch_counts()
        for mode in ("bf16", "f32"):
            saved.set_lambda_mode(mode)
            b1 = ck.launch_counts()
            single = _grad_request(model, REQUESTS[0])
            torch.cuda.synchronize()
            per_single[(n, mode)] = _diff(ck.launch_counts(), b1)
            batch = _grad_request(model, list(REQUESTS))
            res[(n, mode)] = (single, batch)
        torch.cuda.synchronize()
        per_width[n] = _diff(ck.launch_counts(), before)
    launches = ck.launch_counts()
    saved.set_lambda_mode("bf16")

    for (n, mode), ((loss, g), (bloss, bg)) in res.items():
        _check(tuple(g.shape) == tuple(models[n].params.shape) and g.shape == bg.shape,
               f"{n}q {mode}: gradient shapes {tuple(g.shape)} / {tuple(bg.shape)}")
        _check(bool(torch.isfinite(g).all() and torch.isfinite(bg).all()
                    and torch.isfinite(loss) and torch.isfinite(bloss)),
               f"{n}q {mode}: non-finite loss or gradient")
        log(f"  {n}q lambda={mode}: loss {loss.item():.6f}, |g| {g.norm().item():.6f}, "
            f"batch loss {bloss.item():.6f}; one request launched {per_single[(n, mode)]}")
    for n in WIDTHS:
        log(f"  {n}q launches over its gradient run: {per_width[n]}")
    # One backward kernel per payload step of the plan, and none of the
    # adjoint's.
    for (n, mode), counts in per_single.items():
        want = saved_counts(shapes[n])
        got = {name: counts[name] for name in (*BWD_KERNELS, *ADJOINT_KERNELS)}
        _check(got == want, f"{n}q {mode}: backward launches {got}, the plan wants {want}")

    # Batch against its single requests (f32 lambda): loss is the mean of
    # the three requests' means.
    saved.set_lambda_mode("f32")
    for n, model in models.items():
        singles = [_grad_request(model, x)[1] for x in REQUESTS]
        d = _maxdiff(res[(n, "f32")][1][1], sum(singles) / len(singles))
        log(f"  {n}q batch of 3 vs mean of single gradients: max|delta|={d:.3e}")
        _check(d <= TOL_BATCH, f"{n}q: batch vs single gradients differ by {d:.3e}")

    # 22q: the card against the port's CPU path in float64.
    m = WIDTHS[0]
    ref_model = _cpu_f64_model(models[m], m)
    t0 = time.perf_counter()
    _, g64 = _grad_request(ref_model, REQUESTS[0])
    for mode, tol in (("f32", TOL_GRAD_F32), ("bf16", TOL_GRAD_BF16)):
        d = _maxdiff(res[(m, mode)][0][1], g64)
        log(f"  {m}q card (lambda={mode}) vs CPU fp64: max|delta g|={d:.3e} "
            f"(max|g|={g64.abs().max().item():.3e}, tol {tol})")
        _check(d <= tol, f"{m}q lambda={mode}: gradient differs from CPU fp64 by {d:.3e}")
    log(f"  (CPU fp64 gradient took {time.perf_counter() - t0:.1f} s)")

    # 24q: the saved executor against the per-kernel autograd loop, bf16
    # against f32 lambda, a finite difference, and the forward value.
    n = WIDTHS[-1]
    model = models[n]
    (loss, g), (loss16, g16) = res[(n, "f32")][0], res[(n, "bf16")][0]
    saved.set_saved_executor(False)
    try:
        b1 = ck.launch_counts()
        loss_loop, g_loop = _grad_request(model, REQUESTS[0])
        torch.cuda.synchronize()
        loop_counts = _diff(ck.launch_counts(), b1)
    finally:
        saved.set_saved_executor(True)
    d = _maxdiff(g, g_loop)
    log(f"  {n}q saved (f32 lambda) vs per-kernel loop: max|delta g|={d:.3e} "
        f"(loop launched {loop_counts})")
    loop_want = {name: v for name, v in saved_counts(shapes[n]).items() if name in BWD_KERNELS}
    _check(d <= TOL_GRAD_LOOP and all(loop_counts[k] == v for k, v in loop_want.items()),
           f"{n}q: saved vs per-kernel loop differ by {d:.3e} (loop launches {loop_counts}, "
           f"want {loop_want})")
    d = _maxdiff(g16, g)
    log(f"  {n}q bf16 vs f32 lambda: max|delta g|={d:.3e}")
    _check(d <= TOL_GRAD_BF16, f"{n}q: bf16 vs f32 lambda differ by {d:.3e}")

    with torch.inference_mode():
        v_inf = model(inputs=REQUESTS[0]).mean().item()
    d = abs(loss.item() - v_inf)
    log(f"  {n}q forward under autograd vs inference mode: |delta|={d:.3e}")
    _check(d <= TOL_BATCH, f"{n}q: forward under autograd differs by {d:.3e}")

    _finite_difference(model, g, REQUESTS[0], f"{n}q")

    saved.set_lambda_mode("bf16")
    p0 = model.params.detach().clone()
    losses = []
    for step in range(3):
        loss, grad = _grad_request(model, REQUESTS[0])
        with torch.no_grad():
            model.params.sub_(SGD_LR * grad)
        losses.append(loss.item())
        log(f"  {n}q SGD step {step}: loss {loss.item():.6f}")
    model.params.data = p0
    _check(all(np.isfinite(losses)), f"{n}q: non-finite SGD losses {losses}")
    return launches, g64


# ---------------------------------------------------------------------------
# Phase 5b: the adjoint slice
# ---------------------------------------------------------------------------


def _adjoint_grad(model, inputs, mode: str, lam: str) -> tuple:
    """One gradient request under BACKWARD_MODE = mode and lambda mode lam;
    returns (loss, grad, launches of this request)."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    simulation.set_backward_mode(mode)
    saved.set_lambda_mode(lam)
    before = ck.launch_counts()
    loss, g = _grad_request(model, inputs)
    torch.cuda.synchronize()
    return loss, g, _diff(ck.launch_counts(), before)


def _check_adjoint_counts(counts: dict, shape: dict, what: str, requests: int = 1) -> None:
    """The launches of adjoint_counts(), with rotate_pair at least that many."""
    want = adjoint_counts(shape, requests)
    ok = all(counts[k] == v for k, v in want.items() if k != "rotate_pair")
    ok = ok and counts["rotate_pair"] >= want["rotate_pair"]
    log(f"  {what} launched {counts}")
    _check(ok, f"{what}: launches {counts}, want {want} (rotate_pair at least)")


def _within(g, ref, what: str, rel: float = TOL_ADJ_REL, abs_: float = TOL_ADJ_ABS) -> None:
    d = _maxdiff(g, ref)
    tol = rel * ref.abs().max().item() + abs_
    log(f"  {what}: max|delta g|={d:.3e} (max|g|={ref.abs().max().item():.3e}, tol {tol:.3e})")
    _check(d <= tol, f"{what}: gradients differ by {d:.3e} > {tol:.3e}")


def _finite_difference(model, g, inputs, what: str) -> None:
    """Central difference of the card's forward along g/|g| against |g|."""
    gnorm = g.norm().item()
    v = (g / gnorm).to(model.params.device)
    p0 = model.params.detach().clone()
    f_pm = []
    try:
        for p in (p0 + FD_EPS * v, p0 - FD_EPS * v):
            model.params.data = p
            with torch.inference_mode():
                f_pm.append(model(inputs=inputs).mean().item())
    finally:
        model.params.data = p0
    fd = (f_pm[0] - f_pm[1]) / (2 * FD_EPS)
    tol = FD_REL * gnorm + FD_ABS
    log(f"  {what} central difference along g/|g| (eps {FD_EPS}): {fd:.6f} vs |g| {gnorm:.6f} "
        f"(|delta|={abs(fd - gnorm):.3e}, tol {tol:.3e})")
    _check(abs(fd - gnorm) <= tol, f"{what}: finite difference {fd} vs |g| {gnorm}")


def _batch_under_the_line(model, shape: dict, n: int, size: int) -> None:
    """A batch whose residuals fit under the 0.35 line before it starts, but
    not in what is free once most of them are held: one decision sends every
    element to the saved executor, and free memory is read once.  (A rule
    that re-read free memory per element would flip to the adjoint part-way
    through; the memory read after the forward shows that it would.)"""
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    batch = [float(x) for x in np.linspace(-1, 1, size)]
    frac = simulation._RESIDUAL_MEM_FRACTION
    need = size * residual_bytes(shape, n)
    real = memory.available_memory_bytes
    reads = []

    def counted(device=None):
        reads.append(real(device))
        return reads[-1]

    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    before = ck.launch_counts()
    memory.available_memory_bytes = counted
    try:
        model.params.grad = None
        loss = model(inputs=batch).mean()
        held = real(DEVICE)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        memory.available_memory_bytes = real
    c = _diff(ck.launch_counts(), before)
    _check(len(reads) == 1, f"{n}q batch of {size}: free memory read {len(reads)} times")
    # What the last element would have read: all but one element's residuals held.
    last = reads[0] - (size - 1) / size * (reads[0] - held)
    log(f"  {n}q batch of {size}: residuals {need / 1e9:.2f} GB against 0.35 x free "
        f"{frac * reads[0] / 1e9:.2f} GB before the batch; a per-element re-read would see "
        f"{frac * last / 1e9:.2f} GB at the last element")
    _check(need <= frac * reads[0], f"{n}q batch of {size} is not under the line")
    _check(need > frac * last, f"{n}q batch of {size}: a per-element rule would not "
                               "flip, so the check cannot tell one decision from many")
    want = saved_counts(shape, size)
    log(f"  {n}q batch of {size} under auto launched {c}")
    _check(all(c[k] == v for k, v in want.items()),
           f"{n}q batch of {size}: launches {c}, want {want}")
    _check(bool(torch.isfinite(model.params.grad).all()) and bool(torch.isfinite(loss)),
           f"{n}q batch of {size}: non-finite loss or gradient")


def batch_sizes(shape: dict, n: int) -> tuple:
    """The 24q batches either side of the residual rule's line, from its
    estimate per input and the line this run reads: the largest batch under
    it, and the smallest at least BATCH_MARGIN over it."""
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.ops import simulation

    per = residual_bytes(shape, n)
    line = simulation._RESIDUAL_MEM_FRACTION * memory.available_memory_bytes(DEVICE)
    under = int(line // per)
    over = math.ceil((1 + BATCH_MARGIN) * line / per)
    log(f"  {n}q residual estimate {per / 1e9:.3f} GB per input ({len(shape['steps'])} steps); "
        f"line 0.35 x free = {line / 1e9:.2f} GB: batch of {under} = {under * per / 1e9:.2f} GB "
        f"({100 * (1 - under * per / line):.1f} % under), batch of {over} = "
        f"{over * per / 1e9:.2f} GB ({100 * (over * per / line - 1):.1f} % over)")
    return under, over


def phase_adjoint(models: dict, shapes: dict, g64: torch.Tensor) -> tuple:
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    log("phase 5b: gradients through the adjoint-state executor (B12-B16)")
    ck.reset_launch_counts()
    m, n = WIDTHS
    x0 = REQUESTS[0]

    # 22q, forced: reaches the top window (B13); against the CPU float64 path.
    for lam, tol in (("f32", TOL_GRAD_F32), ("bf16", TOL_GRAD_BF16)):
        loss, g, c = _adjoint_grad(models[m], x0, "adjoint", lam)
        _check_adjoint_counts(c, shapes[m], f"{m}q adjoint (lambda={lam})")
        _check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(loss)),
               f"{m}q adjoint: non-finite loss or gradient")
        _within(g, g64, f"{m}q adjoint (lambda={lam}) vs CPU fp64", 0.0, tol)

    # 24q, forced, one input: against the saved executor, and bf16 vs f32 lambda.
    want = adjoint_counts(shapes[n])
    _check(want["adjoint_step"] == 9 and want["adjoint_rotmat"] == 2,
           f"{n}q plan: {want['adjoint_step']} adjoint_step and {want['adjoint_rotmat']} "
           "adjoint_rotmat launches a gradient, not 9 and 2")
    model = models[n]
    _, g_adj, c = _adjoint_grad(model, x0, "adjoint", "f32")
    _check_adjoint_counts(c, shapes[n], f"{n}q adjoint (lambda=f32)")
    _, g_sav, c = _adjoint_grad(model, x0, "autodiff", "f32")
    _check(all(c[k] == v for k, v in saved_counts(shapes[n]).items()),
           f"{n}q autodiff did not run the saved executor: {c}")
    _within(g_adj, g_sav, f"{n}q adjoint vs saved (lambda=f32)")
    _, g_adj16, c = _adjoint_grad(model, x0, "adjoint", "bf16")
    _check_adjoint_counts(c, shapes[n], f"{n}q adjoint (lambda=bf16)")
    _within(g_adj16, g_adj, f"{n}q adjoint bf16 vs f32 lambda", 0.0, TOL_GRAD_BF16)

    # 24q, a batch over the rule's line under "auto": every element takes
    # the adjoint (one decision).
    under, over = batch_sizes(shapes[n], n)
    batch = [float(x) for x in np.linspace(-1, 1, over)]  # bench.py's input range
    _, gb_adj, c = _adjoint_grad(model, batch, "auto", "f32")
    _check_adjoint_counts(c, shapes[n], f"{n}q batch of {over} under auto", over)
    torch.cuda.reset_peak_memory_stats()
    _, gb_sav, c = _adjoint_grad(model, batch, "autodiff", "f32")
    log(f"  {n}q batch under forced autodiff: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    _check(c["adjoint_step"] == 0, f"{n}q batch under autodiff ran the adjoint: {c}")
    _within(gb_adj, gb_sav, f"{n}q batch of {over}: auto (adjoint) vs saved")
    p0 = model.params.detach().clone()
    losses = []
    for step in range(3):
        loss, grad, c = _adjoint_grad(model, batch, "auto", "bf16")
        _check(c["adjoint_step"] == adjoint_counts(shapes[n], over)["adjoint_step"],
               f"{n}q batch SGD step {step}: launches {c}")
        with torch.no_grad():
            model.params.sub_(SGD_LR * grad)
        losses.append(loss.item())
        log(f"  {n}q batch of {over} SGD step {step} (auto, bf16 lambda): "
            f"loss {loss.item():.6f}")
    model.params.data = p0
    _check(all(np.isfinite(losses)), f"{n}q batch: non-finite SGD losses {losses}")
    _batch_under_the_line(model, shapes[n], n, under)

    # 26q, one input.
    model26 = Model(n_qubits=WIDE, n_layers=N_LAYERS, circuit_type="Circuit_19",
                    random_seed=SEED, device=DEVICE)
    _, _, c = _adjoint_grad(model26, x0, "auto", "bf16")
    picked = "adjoint" if c["adjoint_step"] else "saved"
    log(f"  {WIDE}q auto picks the {picked} executor (residuals "
        f"{residual_bytes(shapes[WIDE], WIDE) / 1e9:.2f} GB per input)")
    _, g_adj, c = _adjoint_grad(model26, x0, "adjoint", "f32")
    _check_adjoint_counts(c, shapes[WIDE], f"{WIDE}q adjoint (lambda=f32)")
    _, g_sav, c = _adjoint_grad(model26, x0, "autodiff", "f32")
    _check(c["adjoint_step"] == 0, f"{WIDE}q autodiff ran the adjoint: {c}")
    _within(g_adj, g_sav, f"{WIDE}q adjoint vs saved (lambda=f32)")
    _, g_adj16, _ = _adjoint_grad(model26, x0, "adjoint", "bf16")
    _within(g_adj16, g_adj, f"{WIDE}q adjoint bf16 vs f32 lambda", 0.0, TOL_GRAD_BF16)
    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    _finite_difference(model26, g_adj, x0, f"{WIDE}q adjoint (f32 lambda)")

    launches = ck.launch_counts()
    log(f"  launches over the adjoint phase: {launches}")
    for name in ADJOINT_KERNELS:
        _check(launches[name] > 0, f"kernel {name} was never launched on the adjoint path")
    return model26, launches, batch


# ---------------------------------------------------------------------------
# Phase 5c: the fused plan against the unfused one
# ---------------------------------------------------------------------------


def phase_fusion_ab(model, shapes: dict, n: int) -> None:
    """The same 24q model and input with FUSE_LAYOUT_ROT off and on: the
    forward <Z> within 1e-6, the saved and the adjoint gradient (f32 lambda)
    within 1e-4 max|g| + 1e-6; with the flag off no fused kernel launches."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    log("phase 5c: the fused plan (FUSE_LAYOUT_ROT on) against the unfused plan (off)")
    fused = ("rotmat_apply", "matrot_apply", "rotwin_apply", "rotmat_apply_bwd",
             "matrot_apply_bwd", "rotwin_apply_bwd", "adjoint_rotmat", "adjoint_matrot")
    x0, res = REQUESTS[0], {}
    for on in (False, True):
        with fusion(on):
            before = ck.launch_counts()
            with torch.inference_mode():
                z = model(inputs=x0).detach().clone()
            _, g_sav, _ = _adjoint_grad(model, x0, "autodiff", "f32")
            _, g_adj, _ = _adjoint_grad(model, x0, "adjoint", "f32")
            torch.cuda.reset_peak_memory_stats()
            _adjoint_grad(model, x0, "autodiff", "bf16")
            peak = torch.cuda.max_memory_allocated()
            c = _diff(ck.launch_counts(), before)
        res[on] = (z, g_sav, g_adj)
        shape = shapes[n] if on else plan_shapes(n, fused=False)
        log(f"  {n}q flag {'on ' if on else 'off'}: {describe(shape)}; residual estimate "
            f"{residual_bytes(shape, n) / 1e9:.3f} GB per input; saved fwd+grad peak "
            f"{peak / 1e9:.2f} GB; fused launches {[c[k] for k in fused]}")
        _check(on == any(c[k] for k in fused), f"{n}q flag {on}: fused launches {c}")
    from qml_essentials_tpu_torch.ops import simulation

    simulation.set_backward_mode("auto")
    d = _maxdiff(res[True][0], res[False][0])
    log(f"  {n}q <Z> on vs off: max|delta|={d:.3e} (tol {TOL_FUSE_FWD})")
    _check(d <= TOL_FUSE_FWD, f"{n}q fused vs unfused <Z> differ by {d:.3e}")
    _within(res[True][1], res[False][1], f"{n}q saved gradient on vs off (lambda=f32)")
    _within(res[True][2], res[False][2], f"{n}q adjoint gradient on vs off (lambda=f32)")


# ---------------------------------------------------------------------------
# Phase 5d: the chain route
# ---------------------------------------------------------------------------


def _only(counts: dict, want: dict, what: str) -> None:
    """Exactly the launches in *want*, and none of any other kernel."""
    extra = {k: v for k, v in counts.items() if v and k not in want}
    log(f"  {what} launched {dict((k, v) for k, v in counts.items() if v)}")
    _check(all(counts[k] == v for k, v in want.items()) and not extra,
           f"{what}: launches {counts}, want exactly {want}")


def phase_chains(models: dict, shapes: dict, refs: dict, g64: torch.Tensor) -> tuple:
    """The chain route on the 22q and 24q models; returns the launches of
    its requests and the parity errors of B17 and B18."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn, saved, simulation

    log("phase 5d: the chain route (USE_CHAINS on): B17 chain_apply, B18 adjoint_chain")
    plans = {n: chain_plan(n) for n in (*WIDTHS, WIDE)}
    for n in WIDTHS:
        log(f"  {n}q chain plan, {len(plans[n])} steps:")
        for geom, descs, _ in plans[n]:
            log(f"    {geom[0]} {list(descs)}")
    n24 = WIDTHS[-1]
    _check([(g, d) for g, d, _ in plans[n24]] == CHAIN_PLAN_24,
           f"{n24}q chain plan differs from the JAX package's 9 steps")
    for n in WIDTHS:  # (K, run) of every window, by the descriptor table the kernels read
        wins = sorted({(2 ** row[2], row[7]) for geom, descs, _ in plans[n]
                       for row in ck._chain_table("chain", geom, descs, n)[0] if row[0] != 2})
        off = [w for w in wins if not ck.forward_path(*w)]
        log(f"  {n}q chain windows (K, run): {wins}; off the wgmma product: {off}")
        _check(not off, f"{n}q chain windows off the wgmma product: {off}")
    _check(plans[WIDE] is None, f"{WIDE}q has a chain plan")
    with chain_route(True):
        wide = plan_shapes(WIDE)  # raises on a chain step
    log(f"  {WIDE}q with the flag on: no chain plan, the scheduled plan of "
        f"{len(wide['steps'])} steps")
    _check(wide["steps"] == shapes[WIDE]["steps"], f"{WIDE}q plan changed with the flag on")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    errs = dict.fromkeys(CHAIN_KERNELS, 0.0)
    for n in WIDTHS:
        for name, e in check_chain(ck, kn, n, plans[n], gen).items():
            errs[name] = max(errs[name], e)

    # The scheduled plan's saved gradients (f32 lambda), before the counts.
    x0 = REQUESTS[0]
    g_ref = {n: _adjoint_grad(model, x0, "autodiff", "f32")[1] for n, model in models.items()}

    ck.reset_launch_counts()
    with chain_route(True):
        for n, model in models.items():
            steps = len(plans[n])
            windows = [d for _, descs, _ in plans[n] for d in descs if d[0] == "win"]
            top = sum(d[1] == 0 for d in windows)  # a window from bit 0 ends at wire n - 1
            before = ck.launch_counts()
            with torch.inference_mode():
                z = model(inputs=x0)
            torch.cuda.synchronize()
            _only(_diff(ck.launch_counts(), before), {"chain_apply": steps},
                  f"{n}q chain forward")
            d_sched = _maxdiff(z, refs[n][0])
            d_cpu = _maxdiff(z, refs[n][1])
            log(f"  {n}q chain <Z> vs scheduled plan: max|delta|={d_sched:.3e} (tol "
                f"{TOL_CHAIN_FWD}); vs CPU fp64: {d_cpu:.3e} (tol {TOL_EXPVAL})")
            _check(bool(torch.isfinite(z).all()) and d_sched <= TOL_CHAIN_FWD
                   and d_cpu <= TOL_EXPVAL, f"{n}q chain <Z> off by {d_sched:.3e} / {d_cpu:.3e}")

            loss, g, c = _adjoint_grad(model, x0, "adjoint", "f32")
            _only(c, {"chain_apply": steps, "adjoint_chain": steps}, f"{n}q chain adjoint")
            _check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(loss)),
                   f"{n}q chain adjoint: non-finite loss or gradient")
            _within(g, g_ref[n], f"{n}q chain adjoint vs scheduled saved (lambda=f32)")
            if n == WIDTHS[0]:
                _within(g, g64, f"{n}q chain adjoint vs CPU fp64", 0.0, TOL_GRAD_F32)

            _, g, c = _adjoint_grad(model, x0, "auto", "f32")
            want = {"window_apply": len(windows) - top, "window_apply_top": top,
                    "window_apply_bwd": len(windows) - top, "window_apply_top_bwd": top,
                    "chain_apply": 0, "adjoint_chain": 0}
            log(f"  {n}q chain auto (under the line: the expansion) launched "
                f"{dict((k, v) for k, v in c.items() if v)}")
            _check(all(c[k] == v for k, v in want.items())
                   and not any(c[k] for k in ADJOINT_KERNELS),
                   f"{n}q chain auto: launches {c}, want {want}")
            _within(g, g_ref[n], f"{n}q chain auto (expansion) vs scheduled saved (lambda=f32)")

        model = models[n24]
        p0 = model.params.detach().clone()
        losses = []
        for step in range(3):
            loss, grad, c = _adjoint_grad(model, x0, "adjoint", "f32")
            _check(c["adjoint_chain"] == len(plans[n24]), f"{n24}q chain SGD step {step}: {c}")
            with torch.no_grad():
                model.params.sub_(SGD_LR * grad)
            losses.append(loss.item())
            log(f"  {n24}q chain SGD step {step} (adjoint): loss {loss.item():.6f}")
        model.params.data = p0
    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    _check(all(np.isfinite(losses)), f"{n24}q chain SGD: non-finite losses {losses}")
    launches = ck.launch_counts()
    log(f"  launches over the chain phase: {launches}")
    for name in CHAIN_KERNELS:
        _check(launches[name] > 0, f"kernel {name} was never launched on the chain route")
    return launches, errs, plans


# ---------------------------------------------------------------------------
# Phase 5e: the noisy density slice
# ---------------------------------------------------------------------------


def plain_step(psi2: torch.Tensor, kind: str, payload, wires, n: int) -> torch.Tensor:
    """One scheduled plan step through the kernels' plain versions, in the
    state's dtype and on its device (float64 on the card: the reference)."""
    from qml_essentials_tpu_torch.ops import kernels as kn

    if kind == "rot":
        return kn.rotate_plain(psi2, int(payload), n)
    if kind in ("rotmat", "matrot"):
        r, mat = payload
        w2, k = kn._pair_of(mat, psi2), len(wires)
        if kind == "matrot":
            return kn.matrot_apply_plain(psi2, w2, r, n)
        return kn.rotmat_apply_plain(psi2, w2, r, n) if k == r else \
            kn.rotwin_apply_plain(psi2, w2, r, k, n)
    _check(kind == "mat", f"no plain version for plan step {kind!r}")
    wires = [int(w) for w in wires]
    srt, k, mat = sorted(wires), len(wires), payload
    _check(srt == list(range(srt[0], srt[0] + k)), f"window on scattered wires {wires}")
    if wires != srt:
        rank = {w: i for i, w in enumerate(srt)}
        mat = kn.permute_gate_qubits(mat, [rank[w] for w in wires], k)
    w2 = kn._pair_of(mat, psi2)
    if srt[0] + k == n:
        return kn.window_apply_top_plain(psi2, w2, k, n)
    return kn.window_apply_plain(psi2, w2, srt[0], k, n)


def plain_density(model, x: float, seed: int = SEED) -> tuple:
    """<Z> of a float64 CPU density model through the plain versions in
    float64 on the card (its tape planned there in complex128, each step
    checkpointed), and its plan; backward() on the result reaches the
    model's params."""
    from torch.utils.checkpoint import checkpoint

    from qml_essentials_tpu_torch.ops import kernels as kn, simulation

    n2 = 2 * DENSITY_N
    plan, start = density_plan(density_tape(model, x, seed), torch.float64, DEVICE)
    psi2 = start if start is not None else kn.zero_state_ri(n2, torch.float64, DEVICE)
    for kind, payload, wires in plan:
        psi2 = checkpoint(lambda p, s=(kind, payload, wires): plain_step(p, *s, n2), psi2,
                          use_reentrant=False)
    z = simulation._measure_interleaved_ri(psi2, DENSITY_N, "expval", model._build_obs()[1])
    return z, plan


def _check_density_answer(rho: torch.Tensor, dim: int, what: str) -> None:
    """A density answer: (dim, dim), finite, trace 1, Hermitian."""
    _check(tuple(rho.shape) == (dim, dim) and bool(torch.isfinite(torch.view_as_real(rho)).all()),
           f"{what}: shape {tuple(rho.shape)} or non-finite entries")
    tr = torch.trace(rho)
    herm = (rho - rho.conj().T).abs().max().item()
    log(f"  {what}: trace {tr.real.item():.7f}{tr.imag.item():+.1e}i, max|rho - rho^dag| {herm:.2e}")
    _check(abs(tr.real.item() - 1) <= TOL_DENSITY and abs(tr.imag.item()) <= TOL_DENSITY
           and herm <= TOL_HERMITIAN, f"{what}: trace {tr.item()} or Hermitian error {herm:.2e}")


def phase_density(dshapes: dict) -> tuple:
    """The 13q noisy Circuit_19 density model on the card: forward requests
    (expval, probs, density) with exact launch counts, held to the float64
    plain versions, the ket-then-bra engine and the pure path; another model
    with every noise knob; the saved-executor gradient (forced adjoint and
    chains change nothing, B12-B18 never launch); shots.  Returns the model
    and the launches of its counted requests."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation

    n2 = 2 * DENSITY_N
    dshape = dshapes["noisy"]
    log(f"phase 5e: the {DENSITY_N}q noisy Circuit_19 density model, {DENSITY_NOISE}, on the "
        f"{n2}-wire interleaved doubled register")
    launches = dict.fromkeys(KERNELS, 0)

    def count(fn):
        before = ck.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c = _diff(ck.launch_counts(), before)
        for k in launches:
            launches[k] += c[k]
        return out, c

    def plan_counts(shape: dict, requests: int) -> dict:
        return {name: requests * len(shape[name]) for name in FWD_KERNELS}

    model = density_model(DENSITY_NOISE)
    x0 = REQUESTS[0]
    ck.reset_launch_counts()

    def other_types():
        probs = model(inputs=x0, execution_type="probs")
        rho = model(inputs=x0, execution_type="density")
        model.output_qubit = [0, 1]
        return probs, rho, model(inputs=x0, execution_type="density")

    # Forward: three expval requests, then probs, the full density and the
    # density of qubits [0, 1].
    with torch.inference_mode():
        zs, c = count(lambda: torch.stack([model(inputs=x) for x in REQUESTS]))
        _only(c, plan_counts(dshape, 3), f"{DENSITY_N}q density: 3 expval requests")
        (probs, rho, rho01), c = count(other_types)
    _check(tuple(zs.shape) == (3, DENSITY_N) and bool(torch.isfinite(zs).all()),
           f"{DENSITY_N}q density <Z>: shape {tuple(zs.shape)} or non-finite")
    _only(c, plan_counts(dshape, 3), f"{DENSITY_N}q density: probs and density requests")
    dim = 2**DENSITY_N
    p = probs.reshape(-1)
    _check(bool(torch.isfinite(p).all()) and abs(p.sum().item() - 1) <= TOL_DENSITY,
           f"{DENSITY_N}q probs sum {p.sum().item()}")
    _check_density_answer(rho, dim, f"{DENSITY_N}q density (all qubits)")
    d = (torch.diagonal(rho).real - p).abs().max().item()
    log(f"  {DENSITY_N}q diag(density) vs probs: max|delta|={d:.3e}")
    _check(d <= TOL_HERMITIAN, f"{DENSITY_N}q diag(density) vs probs differ by {d:.3e}")
    _check_density_answer(rho01, 4, f"{DENSITY_N}q density of qubits [0, 1]")
    del rho
    model.output_qubit = -1
    model.execution_type = "expval"

    # The same tape through the plain versions in float64 on the card, the
    # ket-then-bra engine and, noise-free, against the pure path.
    ref64 = density_model(DENSITY_NOISE, device="cpu", dtype=torch.float64)
    ref64.load_numpy(model.params.detach().cpu().numpy())
    z64, plan64 = plain_density(ref64, x0)
    with torch.inference_mode():
        plan32, _ = density_plan(density_tape(model, x0))
    _check(shapes_of(plan32, n2)["steps"] == shapes_of(plan64, n2)["steps"],
           f"{DENSITY_N}q float32 and float64 plans differ")
    d = _maxdiff(zs[0], z64)
    log(f"  {DENSITY_N}q card fp32 <Z> vs the plain versions in fp64 on the card: "
        f"max|delta|={d:.3e} (tol {TOL_DENSITY})")
    _check(d <= TOL_DENSITY, f"{DENSITY_N}q <Z> vs fp64 plain versions differ by {d:.3e}")

    obs = model._build_obs()[1]
    t0 = time.perf_counter()
    with torch.inference_mode():
        rho2 = simulation.simulate_mixed_ri(density_tape(model, x0), DENSITY_N, device=DEVICE)
        z_kb = simulation.measure_density_ri(rho2, DENSITY_N, "expval", obs)
        torch.cuda.synchronize()
    del rho2
    d = _maxdiff(zs[0], z_kb)
    log(f"  {DENSITY_N}q interleaved vs ket-then-bra engine (simulate_mixed_ri, "
        f"{time.perf_counter() - t0:.1f} s): max|delta <Z>|={d:.3e} (tol {TOL_DENSITY})")
    _check(d <= TOL_DENSITY, f"{DENSITY_N}q interleaved vs ket-then-bra differ by {d:.3e}")

    pure = density_model(None)
    with torch.inference_mode():
        tape = density_tape(pure, x0)
        rho2il = simulation._simulate_interleaved_ri(
            simulation._lower_interleaved_tape(tape, DENSITY_N), n2, device=DEVICE)
        p_il = simulation._pair_diag(rho2il[0], DENSITY_N)
        psi2 = simulation.simulate_pure_ri(tape, DENSITY_N, device=DEVICE)
        d = _maxdiff(p_il, psi2[0] ** 2 + psi2[1] ** 2)
    del rho2il
    log(f"  {DENSITY_N}q noise-free lowered tape's diagonal vs |psi|^2 of the pure path: "
        f"max|delta|={d:.3e} (tol {TOL_DENSITY})")
    _check(d <= TOL_DENSITY, f"{DENSITY_N}q lowered noise-free diagonal off by {d:.3e}")

    # Every noise knob: a forward request, and its tape against float64.
    allm = density_model(DENSITY_ALL_NOISE)
    with torch.inference_mode():
        z_all, c = count(lambda: allm(inputs=x0))
        _only(c, plan_counts(dshapes["all"], 1), f"{DENSITY_N}q every noise knob: one request")
        z32 = simulation.simulate_and_measure(density_tape(allm, x0, SEED + 1), DENSITY_N,
                                              "expval", obs, True, device=DEVICE)
    all64 = density_model(DENSITY_ALL_NOISE, device="cpu", dtype=torch.float64)
    all64.load_numpy(allm.params.detach().cpu().numpy())
    with torch.no_grad():
        z64_all, _ = plain_density(all64, x0, SEED + 1)
    d = _maxdiff(z32, z64_all)
    log(f"  {DENSITY_N}q every noise knob ({describe(dshapes['all'])}): <Z> in [-1, 1]: "
        f"{bool((z_all.abs() <= 1).all())}; card fp32 vs fp64 plain versions on one tape: "
        f"max|delta|={d:.3e} (tol {TOL_DENSITY})")
    _check(bool(torch.isfinite(z_all).all() and (z_all.abs() <= 1 + TOL_DENSITY).all())
           and d <= TOL_DENSITY, f"{DENSITY_N}q every noise knob: <Z> {z_all} / {d:.3e}")

    # Gradient of the mean <Z> through the saved executor.
    saved.set_lambda_mode("f32")
    (loss, g), c = count(lambda: _grad_request(model, x0))
    want = {**plan_counts(dshape, 1), **saved_counts(dshape),
            "rotate": 2 * len(dshape["rotate"])}  # the backward rotates lambda back
    _only(c, want, f"{DENSITY_N}q density gradient (lambda=f32)")
    z64.mean().backward()
    g64 = ref64.params.grad
    _within(g, g64, f"{DENSITY_N}q density saved gradient (lambda=f32) vs fp64 plain versions")
    saved.set_lambda_mode("bf16")
    torch.cuda.reset_peak_memory_stats()
    (_, g16), c = count(lambda: _grad_request(model, x0))
    peak = torch.cuda.max_memory_allocated()
    _only(c, want, f"{DENSITY_N}q density gradient (lambda=bf16)")
    _within(g16, g, f"{DENSITY_N}q density bf16 vs f32 lambda", 0.0, TOL_GRAD_BF16)
    payload = sum(kind != "rot" for kind, _ in dshape["steps"])
    log(f"  {DENSITY_N}q density fwd+grad peak {peak / 1e9:.2f} GB; residual rule's estimate "
        f"{residual_bytes(dshape, n2) / 1e9:.2f} GB ({len(dshape['steps'])} steps), the "
        f"saved residuals {payload * 8 * 2**n2 / 1e9:.2f} GB ({payload} payload steps)")
    _finite_difference(model, g, x0, f"{DENSITY_N}q density")
    with chain_route(True):
        _check(density_shapes(DENSITY_NOISE)["steps"] == dshape["steps"],
               f"{DENSITY_N}q density plan changed with USE_CHAINS on")
        (_, g_adj, _), c = count(lambda: _adjoint_grad(model, x0, "adjoint", "f32"))
    simulation.set_backward_mode("auto")
    saved.set_lambda_mode("bf16")
    _only(c, want, f"{DENSITY_N}q density gradient, BACKWARD_MODE adjoint and USE_CHAINS on")
    _within(g_adj, g, f"{DENSITY_N}q density gradient, adjoint forced + chains on, vs saved",
            0.0, TOL_BATCH)

    # Shots: 10000 draws on the card; the same seed gives the same counts.
    shot_models = [density_model(DENSITY_NOISE, shots=SHOTS) for _ in range(2)]
    with torch.inference_mode():
        (est, est2), c = count(lambda: [m(inputs=x0) for m in shot_models])
    _only(c, plan_counts(dshape, 2), f"{DENSITY_N}q shots: two requests")
    exact = zs[0].double().cpu()
    err = (est.double().cpu() - exact).abs()
    bound = SHOT_SIGMAS * torch.sqrt((1 - exact**2).clamp_min(0) / SHOTS) + 1e-6
    log(f"  {DENSITY_N}q shots={SHOTS}: max |estimate - exact| {err.max().item():.4f}, "
        f"worst in standard errors {(err / (bound / SHOT_SIGMAS)).max().item():.2f}; "
        f"same seed, same estimate: {torch.equal(est, est2)}")
    _check(bool((err <= bound).all()) and torch.equal(est, est2),
           f"{DENSITY_N}q shots: estimates {est} vs exact {exact}")
    try:
        shot_models[0].execution_type = "density"
        raise AssertionError("density with shots did not raise")
    except ValueError as e:
        log(f"  density with shots raises ValueError: {e}")

    for name in (*ADJOINT_KERNELS, *CHAIN_KERNELS):
        _check(launches[name] == 0, f"{name} launched on the density path: {launches}")
    for name, v in {**plan_counts(dshape, 1), **saved_counts(dshape)}.items():
        _check(not v or launches[name] > 0, f"kernel {name} of the density path never launched")
    log(f"  launches over the density phase: {launches}")
    return model, launches


# ---------------------------------------------------------------------------
# Phase 5f: the analysis slice
# ---------------------------------------------------------------------------


def analysis_models(device=None, dtype=torch.float32) -> dict:
    """The small-register models of phase 5f, on the card unless *device*
    says otherwise: Circuit_19 at 1, 2 and 4 qubits (spectra, FourierTree,
    QFI), the Sim et al. 4q Circuit_1 / Circuit_9 (Meyer-Wallach, Bell,
    expressibility on [0, 4 pi]) and the 2q GHZ (concentratable
    entanglement)."""
    from qml_essentials_tpu_torch.models.model import Model

    kw = dict(device=device or DEVICE, dtype=dtype)
    nodru = dict(data_reupload=False, **kw)
    return {
        "1q": Model(n_qubits=1, n_layers=1, circuit_type="No_Ansatz", **nodru),
        "2q": Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", random_seed=SEED, **kw),
        "4q": Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", random_seed=SEED, **kw),
        "mw1": Model(n_qubits=4, n_layers=1, circuit_type="Circuit_1", **nodru),
        "mw9": Model(n_qubits=4, n_layers=1, circuit_type="Circuit_9", **nodru),
        "kl9": Model(n_qubits=4, n_layers=1, circuit_type="Circuit_9",
                     initialization_domain=[0, 4 * np.pi], **nodru),
        "ghz": Model(n_qubits=2, n_layers=1, circuit_type="GHZ", **nodru),
    }


def _run_small_analyses(models: dict, samples: int, kl_samples: int) -> dict:
    """Every analysis phase 5f runs on small registers, at the given sample
    counts; returns their results."""
    from qml_essentials_tpu_torch.analysis.coefficients import Coefficients, FourierTree
    from qml_essentials_tpu_torch.analysis.entanglement import Entanglement
    from qml_essentials_tpu_torch.analysis.expressibility import Expressibility
    from qml_essentials_tpu_torch.analysis.math import quantum_fisher_information

    gen = torch.Generator().manual_seed
    out, seconds = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        if models["4q"].device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return result

    with torch.no_grad():
        out["1q"] = Coefficients.get_spectrum(models["1q"], shift=True)
        for key in ("2q", "4q"):
            out[f"fft{key}"] = Coefficients.get_spectrum(models[key], shift=True)
            out[f"tree{key}"] = timed("FourierTree", lambda: FourierTree(models[key])
                                      .get_spectrum(force_mean=True))
        for key in ("mw1", "mw9"):
            m = models[key]
            out[key] = timed("Meyer-Wallach", lambda: float(Entanglement.meyer_wallach(
                m, n_samples=samples, random_key=gen(MW_SEED))))
            out[f"{key} stored"] = float(Entanglement.meyer_wallach(m, n_samples=-1))
            out[f"bell {key}"] = timed("Bell", lambda: Entanglement.bell_measurements(
                m, n_samples=-1))
        out["ce"] = Entanglement.concentratable_entanglement(models["ghz"], n_samples=-1)
        out["kl"] = timed("KL", lambda: float(Expressibility.kl_divergence_to_haar(
            models["kl9"], n_samples=kl_samples, n_bins=KL_BINS, random_key=gen(MW_SEED))[0]))
    m = models["4q"]
    out["qfi"] = timed("QFI", lambda: quantum_fisher_information(
        lambda p: m(params=p, inputs=REQUESTS[0], execution_type="state"), m.params[0].detach()))
    out["seconds"] = seconds
    return out


class _ShapeSpy:
    """Records the shapes the window, top-window and rotation wrappers are
    called at, while it is entered (each call still runs)."""

    NAMES = ("window_apply", "window_apply_top", "rotate")

    def __enter__(self):
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck

        self.ck, self.saved = ck, {name: getattr(ck, name) for name in self.NAMES}
        self.windows, self.tops, self.rotations = set(), set(), set()

        def window(psi2, w2, a, k, n):
            self.windows.add((n, a, k))
            return self.saved["window_apply"](psi2, w2, a, k, n)

        def top(psi2, w2, k, n):
            self.tops.add((n, n - k, k))
            return self.saved["window_apply_top"](psi2, w2, k, n)

        def rot(psi2, r, n):
            self.rotations.add((n, r))
            return self.saved["rotate"](psi2, r, n)

        ck.window_apply, ck.window_apply_top, ck.rotate = window, top, rot
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)


def analysis_shapes() -> dict:
    """Every window, top-window and rotation shape of phase 5f's small
    registers (1-4 qubits, and 8 and 6 wires for Bell and the SWAP test),
    read off the same analyses run on the CPU with two samples; QFI's
    backward runs the backward kernels at its forward's windows."""
    models = analysis_models(device="cpu")
    with _ShapeSpy() as spy:
        _run_small_analyses(models, samples=2, kl_samples=2)
    with _ShapeSpy() as qfi:
        m = models["4q"]
        with torch.no_grad():
            m(inputs=REQUESTS[0], execution_type="state")
    return dict(windows=sorted(spy.windows), tops=sorted(spy.tops),
                rotations=sorted(spy.rotations), bwd_windows=sorted(qfi.windows),
                bwd_tops=sorted(qfi.tops))


class _PlainOnCardSpy:
    """Counts calls of the kernels' plain versions on CUDA tensors (the
    wrappers take them only for CPU tensors): phase 5f requires none."""

    NAMES = ("window_apply_plain", "window_apply_top_plain", "rotate_plain",
             "window_apply_bwd_plain", "window_apply_top_bwd_plain")

    def __enter__(self):
        from qml_essentials_tpu_torch.ops import kernels as kn

        self.kn, self.saved, self.calls = kn, {n: getattr(kn, n) for n in self.NAMES}, 0

        def wrap(fn):
            def counted(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    self.calls += 1
                return fn(*args, **kw)
            return counted

        for name, fn in self.saved.items():
            setattr(kn, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.kn, name, fn)


def _plain_grid_expvals(model, n: int, grid: np.ndarray) -> torch.Tensor:
    """The mean <Z> of *model*'s parameters at each grid input, through the
    kernels' plain versions in float64 on the card (a float64 CPU model
    records each tape; planned on the card in complex128)."""
    from qml_essentials_tpu_torch.ops import kernels as kn, simulation
    from qml_essentials_tpu_torch.ops.tape import recording

    ref = _cpu_f64_model(model, n)
    obs = ref._build_obs()[1]
    out = []
    with torch.no_grad():
        for x in grid:
            with recording() as tape:
                ref._variational(ref.params[0], torch.tensor([float(x)], dtype=torch.float64))
            plan, psi2 = simulation.scheduled_plan(tape, n, torch.float64, DEVICE)
            if psi2 is None:
                psi2 = kn.zero_state_ri(n, torch.float64, DEVICE)
            for kind, payload, wires in plan:
                psi2 = plain_step(psi2, kind, payload, wires, n)
            out.append(simulation.measure_state_ri(psi2, n, "expval", obs).mean())
    return torch.stack(out)


def _spectrum_on_card(model, what: str, plan_calls: dict, grid_ref=None) -> dict:
    """``Coefficients.get_spectrum(model)`` with the launch counts reset
    before and read after: exactly *plan_calls* a grid input and nothing
    else; the leak (the reference's own check raised on a larger one) and
    the reconstruction at three off-grid inputs against the card's forward
    (TOL_SERIES).  With *grid_ref* (n), the grid's outputs and coefficients
    are held to the plain versions in float64 on the card.  Returns times
    and launches."""
    from qml_essentials_tpu_torch.analysis.coefficients import Coefficients
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    n_grid = model.degree[0]
    before = ck.launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        coeffs, freqs = Coefficients.get_spectrum(model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _diff(ck.launch_counts(), before)
    _only(counts, {k: n_grid * v for k, v in plan_calls.items()},
          f"{what} spectrum: {n_grid} grid inputs")
    leak = float(coeffs.sum().imag)
    _check(tuple(coeffs.shape) == (n_grid,) and bool(torch.isfinite(torch.view_as_real(coeffs)).all()),
           f"{what} spectrum: shape {tuple(coeffs.shape)} or non-finite")
    log(f"  {what} spectrum: {n_grid} grid inputs in {seconds:.2f} s "
        f"({seconds / n_grid * 1e3:.2f} ms a grid input); imaginary leak {leak:.2e} "
        f"(float32 budget 1e-4); max|c| {coeffs.abs().max().item():.4e}")
    xs = np.array(OFF_GRID)
    with torch.no_grad():
        series = Coefficients.evaluate_Fourier_series(coeffs, freqs, xs)
        direct = torch.stack([model(inputs=float(x)).mean() for x in xs])
    d = _maxdiff(series, direct)
    log(f"  {what} Fourier series at {OFF_GRID} vs the card's forward: max|delta|={d:.3e} "
        f"(tol {TOL_SERIES})")
    _check(d <= TOL_SERIES, f"{what}: the series misses the forward by {d:.3e}")
    if grid_ref is not None:
        grid = np.arange(0, 2 * np.pi, 2 * np.pi / n_grid)
        t0 = time.perf_counter()
        ref_out = _plain_grid_expvals(model, grid_ref, grid)
        card_out = torch.fft.ifft(coeffs.cdouble() * n_grid).real
        ref_c = torch.fft.fft(ref_out) / n_grid
        d_out = _maxdiff(card_out, ref_out)
        d_c = (coeffs.cdouble() - ref_c).abs().max().item()
        scale = ref_c.abs().max().item()
        log(f"  {what} grid vs the plain versions in float64 on the card "
            f"({time.perf_counter() - t0:.1f} s): outputs max|delta|={d_out:.3e} (tol "
            f"{TOL_SPECTRUM}), coefficients max|delta|={d_c:.3e} = {d_c / scale:.2e} max|c| "
            f"(tol {TOL_SPECTRUM} max|c|)")
        _check(d_out <= TOL_SPECTRUM and d_c <= TOL_SPECTRUM * scale,
               f"{what} grid off the float64 plain versions: {d_out:.3e} / {d_c:.3e}")
    return dict(seconds=seconds, launches=counts)


def _element_breakdown(model, n: int, reps: int = 50) -> dict:
    """Median ms of one element of a density batch split into record (the
    tape, gate matrices on the card), plan (window composition) and run
    (the kernels, the outer product and the readout)."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    inputs = torch.zeros((1, model.n_input_feat), device=DEVICE)
    parts = {"record": [], "plan": [], "run": []}
    with torch.no_grad():
        for i in range(reps + 1):
            t = [time.perf_counter()]
            tape = model.script._record(model.params[i % model.params.shape[0]], inputs,
                                        enc_params=model.enc_params)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            plan, start = simulation.scheduled_plan(tape, n, device=DEVICE)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
            for kind, payload, wires in plan:
                psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
            simulation.measure_density_ri(simulation._outer_ri(psi2), n, "density", [])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            if i:  # the first element is the warm-up
                for (name, acc), t0, t1 in zip(parts.items(), t, t[1:]):
                    acc.append((t1 - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in parts.items()}


def phase_analysis(models: dict, shapes: dict, dmodel, dshapes: dict, smi: str) -> dict:
    """The analysis slice on the card: the 24q spectrum through the forward
    kernels (held to float64 plain versions), the 13q density spectrum, and
    the small-register analyses against their goldens and CPU float64
    answers.  Returns the launches of its counted runs."""
    from qml_essentials_tpu_torch import native
    from qml_essentials_tpu_torch.analysis.entanglement import Entanglement
    from qml_essentials_tpu_torch.analysis.math import quantum_fisher_information
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    n24 = WIDTHS[-1]
    log(f"phase 5f: the analysis slice ({smi})")
    launches = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def plan_calls(shape):
        return {name: len(shape[name]) for name in FWD_KERNELS if shape[name]}

    ck.reset_launch_counts()
    m24 = models[n24]
    s24 = _spectrum_on_card(m24, f"{n24}q Circuit_19 L={N_LAYERS}", plan_calls(shapes[n24]),
                            grid_ref=n24)
    add(s24["launches"])
    with torch.inference_mode():
        req_ms, _, _ = _host_ms(lambda: m24(inputs=REQUESTS[0]))
    log(f"  {n24}q: {s24['seconds'] / m24.degree[0] * 1e3:.2f} ms a grid input in the spectrum's "
        f"batch beside {req_ms:.2f} ms for a single forward request (best of 3)")

    dplan = plan_calls(dshapes["noisy"])
    s13 = _spectrum_on_card(dmodel, f"{DENSITY_N}q noisy density", dplan)
    add(s13["launches"])
    with torch.inference_mode():
        dreq_ms, _, _ = _host_ms(lambda: dmodel(inputs=REQUESTS[0]))
    log(f"  {DENSITY_N}q density: {s13['seconds'] / dmodel.degree[0] * 1e3:.2f} ms a grid input "
        f"beside {dreq_ms:.2f} ms for a single forward request (best of 3)")

    # Small registers, every window on a kernel and no plain version on the card.
    _check(native.native_available(), "the native FourierTree enumerator did not load")
    log(f"  native FourierTree enumerator loaded: {native.library_path().relative_to(ROOT)}")
    small = analysis_models()
    before = ck.launch_counts()
    t0 = time.perf_counter()
    with _PlainOnCardSpy() as plain:
        res = _run_small_analyses(small, MW_SAMPLES, KL_SAMPLES)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _diff(ck.launch_counts(), before)
    add(counts)
    log(f"  small registers: {seconds:.1f} s, launched {dict((k, v) for k, v in counts.items() if v)}; "
        f"plain versions on the card: {plain.calls}")
    _check(plain.calls == 0, f"{plain.calls} plain-version calls on the card in phase 5f")
    # Below 14 qubits a ring-wrap gate moves its wires to the front (no
    # rotation kernel), so the small registers run no rotate; their batches
    # run the batch entries.
    for name in ("window_apply", "window_apply_top", "window_apply_bwd", "window_apply_top_bwd"):
        _check(counts[name] + counts[f"{name}_batch"] > 0,
               f"phase 5f small registers never launched {name} or its batch entry")
    for name in (*ADJOINT_KERNELS, *CHAIN_KERNELS):
        _check(counts[name] == 0, f"{name} launched on the small registers: {counts}")

    c1, f1 = res["1q"]
    one = dict(zip(np.asarray(f1).tolist(), c1.cpu().tolist()))
    log(f"  1q RX(x) spectrum: c(+1) = {one[1.0]:.6f}, c(0) = {abs(one[0.0]):.2e} (want 1/2, 0)")
    _check(abs(one[1.0] - 0.5) <= TOL_TREE and abs(one[0.0]) <= TOL_TREE, "1q spectrum off")
    for key in ("2q", "4q"):
        fc, ff = res[f"fft{key}"]
        fft = dict(zip(np.asarray(ff).tolist(), fc.cpu().tolist()))
        tc, tf = res[f"tree{key}"]
        d = max(abs(c - fft[f]) for f, c in zip(np.asarray(tf[0]).tolist(), tc[0].cpu().tolist()))
        log(f"  {key} Circuit_19 FourierTree ({len(tf[0])} frequencies) vs the card's FFT "
            f"spectrum: max|delta|={d:.3e} (tol {TOL_TREE})")
        _check(d <= TOL_TREE, f"{key} FourierTree off the FFT spectrum by {d:.3e}")
    for key, want in (("mw1", 0.0), ("mw9", 1.0)):
        log(f"  Meyer-Wallach {key} ({MW_SAMPLES} samples): {res[key]:.4f} (want {want} +- "
            f"{MW_TOL}); Bell measurements on the stored sets {res[f'bell {key}']:.6f} vs "
            f"Meyer-Wallach {res[f'{key} stored']:.6f}")
        _check(abs(res[key] - want) < MW_TOL, f"Meyer-Wallach {key} {res[key]} vs {want}")
        _check(abs(res[f"bell {key}"] - res[f"{key} stored"]) <= TOL_BELL,
               f"Bell {key} {res[f'bell {key}']} vs MW {res[f'{key} stored']}")
    cpu = analysis_models(device="cpu", dtype=torch.float64)
    ce64 = Entanglement.concentratable_entanglement(cpu["ghz"], n_samples=-1)
    log(f"  concentratable entanglement, 2q GHZ: {res['ce']:.7f} vs CPU float64 {ce64:.7f}")
    _check(abs(res["ce"] - ce64) <= TOL_CE, f"CE {res['ce']} vs {ce64}")
    rel = abs(res["kl"] - KL_GOLDEN) / KL_GOLDEN
    log(f"  expressibility 4q Circuit_9, [0, 4 pi], {KL_SAMPLES} samples, {KL_BINS} bins: KL "
        f"{res['kl']:.4f} vs Sim et al. {KL_GOLDEN} ({rel:.1%} off, tol {KL_REL:.0%})")
    _check(rel < KL_REL, f"KL {res['kl']} off Sim et al.'s {KL_GOLDEN} by {rel:.1%}")
    m64 = cpu["4q"]
    m64.load_numpy(small["4q"].params.detach().cpu().numpy())
    q64 = quantum_fisher_information(
        lambda p: m64(params=p, inputs=REQUESTS[0], execution_type="state"), m64.params[0])
    d = _maxdiff(res["qfi"], q64)
    scale = q64.abs().max().item()
    log(f"  QFI 4q Circuit_19 ({tuple(q64.shape)}): card vs CPU float64 max|delta|={d:.3e} = "
        f"{d / scale:.2e} max|F| (tol {TOL_QFI})")
    _check(d <= TOL_QFI * scale, f"QFI off the CPU float64 one by {d:.3e}")

    # What one element of a 4q batch costs, for the batching slice.
    sec = res["seconds"]
    log("  times: " + ", ".join(f"{k} {v:.2f} s" for k, v in sec.items())
        + f" ({MW_SAMPLES} + {MW_SAMPLES} Meyer-Wallach elements, 2 x {MW_SAMPLES} Bell "
        f"elements on 8 wires, {2 * KL_SAMPLES} KL elements)")
    br = _element_breakdown(small["kl9"], 4)
    log(f"  4q density batch (Circuit_9): {sec['KL'] / (2 * KL_SAMPLES) * 1e3:.3f} ms an element "
        f"over the KL run's {2 * KL_SAMPLES}; one element's parts (median of 50): record "
        f"{br['record']:.3f} ms, plan {br['plan']:.3f} ms, run + outer product + readout "
        f"{br['run']:.3f} ms")
    log(f"  launches over the analysis phase: {dict((k, v) for k, v in launches.items() if v)}")
    log(f"  phase 5f took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 5g: the batch route
# ---------------------------------------------------------------------------


class _RouteCounter:
    """Counts, while entered, the recordings of every Script (``_record``):
    of a batch (``records``) and of one element (``alone``: the check of a
    batch's last element, or a single request), and the planner's
    structural runs (``plan_contractions``), and holds the launch counts of
    its start.  Replacing the planner function makes a new plan-cache key,
    so a request inside runs the planner once, as a cold one does."""

    def __enter__(self):
        from qml_essentials_tpu_torch.core import executor
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck, recipes, simulation

        self.ex, self.sim, self.ck = executor, simulation, ck
        self.record, self.plan = executor.Script._record, simulation.plan_contractions
        self.records = self.alone = self.plans = 0

        def record(script, *a, **kw):
            tape = self.record(script, *a, **kw)
            if recipes.batch_of(tape) is None:
                self.alone += 1
            else:
                self.records += 1
            return tape

        def plan(*a, **kw):
            self.plans += 1
            return self.plan(*a, **kw)

        executor.Script._record, simulation.plan_contractions = record, plan
        self.before = ck.launch_counts()
        return self

    def launches(self) -> dict:
        torch.cuda.synchronize()
        return _diff(self.ck.launch_counts(), self.before)

    def __exit__(self, *exc):
        self.ex.Script._record, self.sim.plan_contractions = self.record, self.plan


def batch_plan_calls(plan: list, n: int) -> dict:
    """The batch kernels one vectorised run of a small-register plan
    launches: one window_apply_batch (window_apply_top_batch when the
    support, gathered to the front when scattered, ends at the register
    top) per matrix step; a diagonal step multiplies on the host's
    tensors and launches none."""
    from qml_essentials_tpu_torch.ops.operations import DiagonalQubitUnitary

    calls = dict.fromkeys(("window_apply_batch", "window_apply_top_batch"), 0)
    for kind, payload, wires in plan:
        if kind == "op" and isinstance(payload, DiagonalQubitUnitary) or kind == "diag":
            continue
        _check(kind in ("mat", "op"), f"unexpected small-register plan step {kind!r}")
        srt = sorted(wires)
        lo = srt[0] if srt == list(range(srt[0], srt[0] + len(srt))) else 0
        top = lo + len(srt) == n
        calls["window_apply_top_batch" if top else "window_apply_batch"] += 1
    return calls


def _skeleton(model, engine: str = "pure") -> list:
    """The plan of the model's newest plan-cache entry for *engine*: steps
    with their kinds and wires (the payloads are recipes)."""
    slot = list(model.script._plans.values())[-1]
    sk = slot.skeletons[engine]
    return sk[0] if isinstance(sk, tuple) else sk


def _chunks_of(model, batch: int) -> int:
    sizes = [c for (key, b), c in model.script._chunks.items() if b == batch]
    _check(len(sizes) == 1, f"{len(sizes)} chunk sizes for a batch of {batch}")
    return -(-batch // sizes[0])


def _loop_route():
    """``with _loop_route():`` sends every batched request through the
    per-element loop (the route the vectorised one is held against)."""
    from qml_essentials_tpu_torch.core import executor

    class _Loop:
        def __enter__(self):
            self.saved = executor.Script._execute_vectorised

            def refuse(*a, **kw):
                raise executor._NotVectorisable("forced by chip_smoke")

            executor.Script._execute_vectorised = refuse

        def __exit__(self, *exc):
            executor.Script._execute_vectorised = self.saved

    return _Loop()


def fcc_model(circuit: str, device=None, dtype=torch.float64):
    """A Fig. 3a model.  The goldens run in float64: the FCC correlates
    coefficients that vanish in exact arithmetic, so their rounding noise
    moves it (Circuit_17 on the CPU: 0.104-0.110 in float32, 0.058-0.068 in
    float64 against Fig. 3a's 0.078; tools/fcc_noise.py)."""
    from qml_essentials_tpu_torch.models.model import Model

    return Model(n_qubits=FCC_N, n_layers=1, circuit_type=circuit, output_qubit=-1,
                 encoding=["RY"], device=device or DEVICE, dtype=dtype)


class _CoefficientSpy:
    """Keeps, while entered, what ``FCC._calculate_coefficients`` returns
    (parameter sets, coefficients, frequencies) in ``out``."""

    def __enter__(self):
        from qml_essentials_tpu_torch.analysis.coefficients import FCC

        self.fcc, self.real = FCC, FCC.__dict__["_calculate_coefficients"]
        spy = self

        def calc(cls, *a, **kw):
            spy.out = spy.real.__func__(cls, *a, **kw)
            return spy.out

        FCC._calculate_coefficients = classmethod(calc)
        return self

    def __exit__(self, *exc):
        self.fcc._calculate_coefficients = self.real


def _check_vanishing(circuit: str, model, params, coeffs, freqs) -> None:
    """A reported FCC circuit's float64 coefficients on the card: on
    FCC_SUBSAMPLE parameter sets against the CPU's float64 plain path, and
    everywhere from |frequency| FCC_VANISHING up at rounding level, both
    within TOL_FCC_COEFF of max|c|."""
    from qml_essentials_tpu_torch.analysis.coefficients import Coefficients

    top = coeffs.abs().max().item()
    far = torch.as_tensor(np.abs(np.asarray(freqs)) >= FCC_VANISHING, device=coeffs.device)
    vanishing = coeffs[far].abs().max().item()
    idx = torch.linspace(0, params.shape[0] - 1, FCC_SUBSAMPLE, device=params.device).long()
    cpu = fcc_model(circuit, "cpu")
    cpu.load_numpy(params[idx].detach().cpu().numpy(), model.enc_params.detach().cpu().numpy())
    with torch.no_grad():
        ref, _ = Coefficients.get_spectrum(cpu, shift=True, trim=True)
    d = (coeffs[:, idx].cpu() - ref).abs().max().item()
    log(f"    {circuit} float64 coefficients: max|c| {top:.3e}; on {FCC_SUBSAMPLE} parameter sets "
        f"vs the CPU's float64 {d / top:.2e} of it; |frequency| >= {FCC_VANISHING} at most "
        f"{vanishing / top:.2e} of it (tol {TOL_FCC_COEFF} each)")
    _check(d <= TOL_FCC_COEFF * top, f"{circuit} coefficients off the CPU's float64: {d}")
    _check(vanishing <= TOL_FCC_COEFF * top,
           f"{circuit} coefficients from frequency {FCC_VANISHING} are {vanishing / top} of max")


def grad_batch_model(device=None, dtype=torch.float32):
    from qml_essentials_tpu_torch.models.model import Model

    return Model(n_qubits=GRAD_BATCH_N, n_layers=2, circuit_type="Circuit_19",
                 random_seed=SEED, device=device or DEVICE, dtype=dtype)


def chunk_model(device=None):
    from qml_essentials_tpu_torch.models.model import Model

    return Model(n_qubits=CHUNK_N, n_layers=1, circuit_type="Circuit_19", random_seed=SEED,
                 device=device or DEVICE)


def _grad_batch_inputs(device) -> torch.Tensor:
    return torch.linspace(-np.pi, np.pi, GRAD_BATCH, device=device)


def batch_shapes() -> dict:
    """Every (n, a, k, per-element, batch) shape the batch entries run in
    phase 5g, read off its workloads on the CPU at small batches (the FCC
    circuits, the KL model, the 6q batched gradient, the 10q density
    batch), each with the batch it runs at on the card; the backward runs
    the 6q gradient's forward shapes.  Also the forward calls in order of
    one FCC Circuit_19 request and one KL request, and the 6q gradient's,
    for phase 6's times."""
    from qml_essentials_tpu_torch.analysis.coefficients import FCC
    from qml_essentials_tpu_torch.analysis.expressibility import Expressibility

    spy = _BatchSpy()
    with spy, torch.no_grad():
        for circuit, _ in FCC_GOLDENS:
            spy.start(f"FCC {circuit}", FCC_SAMPLES * 2**FCC_N * 13)
            FCC.get_fcc(model=fcc_model(circuit, "cpu"), n_samples=1, scale=True)
        spy.start("KL", 2 * KL_SAMPLES)
        Expressibility.kl_divergence_to_haar(analysis_models(device="cpu")["kl9"], n_samples=2,
                                             n_bins=KL_BINS)
        spy.start("chunk", CHUNK_ROWS)
        chunk_model("cpu")(inputs=torch.linspace(0, 1, 3), execution_type="density")
        spy.start("grad", GRAD_BATCH)
        grad_batch_model("cpu")(inputs=torch.linspace(0, 1, 3))
    fwd = sorted({c for calls in spy.calls.values() for c in calls})
    return dict(fwd=fwd, bwd=sorted(set(spy.calls["grad"])), calls=spy.calls)


class _BatchSpy:
    """Records the shapes the forward window wrappers take batched states at,
    in order, per workload: (n, a, k, per-element W, batch on the card,
    float64)."""

    def __init__(self):
        self.calls, self.label, self.bt = {}, None, 1

    def start(self, label: str, bt: int) -> None:
        self.label, self.bt = label, bt
        self.calls[label] = []

    def __enter__(self):
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck

        self.ck = ck
        self.saved = {name: getattr(ck, name) for name in ("window_apply", "window_apply_top")}

        def window(psi2, w2, a, k, n):
            self._add(psi2, w2, n, a, k)
            return self.saved["window_apply"](psi2, w2, a, k, n)

        def top(psi2, w2, k, n):
            self._add(psi2, w2, n, n - k, k)
            return self.saved["window_apply_top"](psi2, w2, k, n)

        ck.window_apply, ck.window_apply_top = window, top
        return self

    def _add(self, psi2, w2, n, a, k) -> None:
        if psi2.dim() == 3:
            self.calls[self.label].append((n, a, k, w2.dim() == 4, self.bt,
                                           psi2.dtype == torch.float64))

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)


def _batch_state(n: int, bt: int, gen: torch.Generator, f64: bool = False) -> torch.Tensor:
    x = torch.randn((2, bt, 2**n), generator=gen, device=DEVICE,
                    dtype=torch.float64 if f64 else torch.float32)
    return x / x.square().sum(dim=(0, 2), keepdim=True).sqrt()


def _batch_window(k: int, bt: int, per_element: bool, rng, f64: bool = False) -> torch.Tensor:
    dtype = torch.float64 if f64 else torch.float32
    if not per_element:
        return _unitary(k, rng).to(dtype)
    return torch.stack([_unitary(k, rng) for _ in range(min(bt, 64))]).repeat(
        -(-bt // 64), 1, 1, 1)[:bt].to(dtype).contiguous()


def check_batch(ck, kn, cases, gen, rng) -> dict:
    """B1-B4's batch entries against their plain versions in float64 at
    every (n, a, k, per-element, batch, float64) of phase 5g, relative: the
    float32 entries' states 1e-5 and matrix cotangents (per element, or
    summed over the batch) 1e-4, the float64 entries' all three 1e-12; and
    all four called again on the same inputs give the same bits."""
    errs = dict.fromkeys(BATCH_KERNELS, 0.0)
    for n, a, k, per_element, bt, f64 in cases:
        x, g = _batch_state(n, bt, gen, f64), _batch_state(n, bt, gen, f64)
        w = _batch_window(k, bt, per_element, rng, f64)
        top = a + k == n
        fwd = "window_apply_top_batch" if top else "window_apply_batch"
        bwd = "window_apply_top_bwd_batch" if top else "window_apply_bwd_batch"
        if top:
            got = ck.window_apply_top(x, w, k, n)
            ref = kn.window_apply_top_plain(x.double(), w.double(), k, n)
            gp, gw = ck.window_apply_top_bwd(w, g, x, k, n, x.dtype)
            rp, rw = kn.window_apply_top_bwd_plain(w.double(), g.double(), x.double(), k, n,
                                                   torch.float64)
        else:
            got = ck.window_apply(x, w, a, k, n)
            ref = kn.window_apply_plain(x.double(), w.double(), a, k, n)
            gp, gw = ck.window_apply_bwd(w, g, x, a, k, n, x.dtype)
            rp, rw = kn.window_apply_bwd_plain(w.double(), g.double(), x.double(), a, k, n,
                                               torch.float64)
        again = (ck.window_apply_top_bwd(w, g, x, k, n, x.dtype) if top else
                 ck.window_apply_bwd(w, g, x, a, k, n, x.dtype))
        fwd_again = ck.window_apply_top(x, w, k, n) if top else ck.window_apply(x, w, a, k, n)
        torch.cuda.synchronize()
        _check(torch.equal(gp, again[0]) and torch.equal(gw, again[1]),
               f"{bwd} at n={n} a={a} k={k} Bt={bt}: a second call gave other bits")
        _check(torch.equal(got, fwd_again),
               f"{fwd} at n={n} a={a} k={k} Bt={bt}: a second call gave other bits")
        del again, fwd_again
        e = [_maxdiff(got, ref) / ref.abs().max().item(), _maxdiff(gp, rp) / rp.abs().max().item(),
             _maxdiff(gw, rw) / rw.abs().max().item()]
        if not f64:  # the row's max_abs_err: the float32 entries, as every other kernel's
            errs[fwd] = max(errs[fwd], _maxdiff(got, ref))
            errs[bwd] = max(errs[bwd], _maxdiff(gp, rp), _maxdiff(gw, rw))
        log(f"    n={n} a={a} k={k} {'per-element' if per_element else 'shared'} W, Bt={bt}, "
            f"{'float64' if f64 else 'float32'}: {fwd} {e[0]:.2e}, {bwd} gp {e[1]:.2e} "
            f"gw {e[2]:.2e}")
        tol = (TOL_BATCH64,) * 3 if f64 else (TOL_WINDOW, TOL_WINDOW, TOL_GRAM)
        _check(all(x <= t for x, t in zip(e, tol)),
               f"batch entries off their plain versions at n={n} a={a} k={k} Bt={bt} "
               f"{'float64' if f64 else 'float32'}: {e}")
    return errs


def phase_batch(models: dict, shapes: dict, batch: list, smi: str) -> dict:
    """The batch route on the card: the FCC Fig. 3a goldens, Sim et al.'s
    KL, the 24q spectrum, a 6q batched gradient, a chunked 10q density batch
    and the 24q batch over the residual line, each with one record, one plan
    and its launches counted.  Returns the counted launches."""
    from qml_essentials_tpu_torch.analysis.coefficients import Coefficients, FCC
    from qml_essentials_tpu_torch.analysis.expressibility import Expressibility
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    log(f"phase 5g: the batch route ({smi})")
    launches = dict.fromkeys(KERNELS, 0)
    times = {}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def routed(model, what, want="vectorised"):
        _check(model.script.routes and model.script.routes[-1].startswith(want),
               f"{what}: route {model.script.routes[-1:]}, want {want}")

    def vectorised(model, what):
        routed(model, what)

    def once(rc, what):
        """One record of the batch and one of its last element (the
        executor's check), one plan."""
        _check(rc.records == 1 and rc.alone == 1 and rc.plans == 1,
               f"{what}: {rc.records} batch records, {rc.alone} single ones, {rc.plans} plans")

    # FCC Fig. 3a: 32000 parameter sets x 13 grid inputs a circuit, one call,
    # in float64 (the golden check) and in float32 (reported).
    for circuit, golden in FCC_GOLDENS:
        model = fcc_model(circuit)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _RouteCounter() as rc, _CoefficientSpy() as spy, torch.no_grad():
            t0 = time.perf_counter()
            fcc = float(FCC.get_fcc(model=model, n_samples=FCC_SAMPLES, scale=True))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = rc.launches()
        bt = FCC_SAMPLES * 2**FCC_N * model.degree[0]
        chunks = _chunks_of(model, bt)
        plan = _skeleton(model)
        want = {k: v * chunks for k, v in batch_plan_calls(plan, FCC_N).items() if v}
        peak = torch.cuda.max_memory_allocated() - base
        vectorised(model, f"FCC {circuit}")
        m32 = fcc_model(circuit, dtype=torch.float32)
        with torch.no_grad():
            t1 = time.perf_counter()
            fcc32 = float(FCC.get_fcc(model=m32, n_samples=FCC_SAMPLES, scale=True))
            torch.cuda.synchronize()
            sec32 = time.perf_counter() - t1
        vectorised(m32, f"FCC {circuit} float32")
        log(f"  FCC {circuit}: {fcc:.4f} (float64) vs Fig. 3a {golden} (atol {FCC_ATOL}) in "
            f"{sec:.3f} s: {bt} elements ({sec / bt * 1e6:.3f} us an element), {chunks} "
            f"chunk(s), {len(plan)} plan steps, {rc.records} batch record(s) + {rc.alone} "
            f"single, {rc.plans} plan(s), peak {peak / 1e9:.2f} GB; float32 {fcc32:.4f} in "
            f"{sec32:.3f} s")
        _only(counts, want, f"FCC {circuit}")
        once(rc, f"FCC {circuit}")
        if circuit not in FCC_REPORTED:
            _check(abs(fcc - golden) <= FCC_ATOL, f"FCC {circuit} {fcc} off Fig. 3a's {golden}")
        else:
            log(f"    (reported, not held to Fig. 3a: its vanishing coefficients' rounding "
                f"noise sets it; {abs(fcc - golden):.4f} off in float64, "
                f"{abs(fcc32 - golden):.4f} in float32)")
            _check_vanishing(circuit, model, *spy.out)
        times[f"FCC {circuit}"] = sec
        times[f"FCC {circuit} float32"] = sec32
        add(counts)

    # Sim et al.'s KL of 4q Circuit_9 on [0, 4 pi]: one density batch.
    kl_model = analysis_models()["kl9"]
    with _RouteCounter() as rc, torch.no_grad():
        t0 = time.perf_counter()
        kl = float(Expressibility.kl_divergence_to_haar(
            kl_model, n_samples=KL_SAMPLES, n_bins=KL_BINS,
            random_key=torch.Generator().manual_seed(MW_SEED))[0])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = rc.launches()
    bt = 2 * KL_SAMPLES
    chunks = _chunks_of(kl_model, bt)
    want = {k: v * chunks for k, v in batch_plan_calls(_skeleton(kl_model), 4).items() if v}
    vectorised(kl_model, "KL")
    rel = abs(kl - KL_GOLDEN) / KL_GOLDEN
    log(f"  KL 4q Circuit_9: {kl:.4f} vs Sim et al. {KL_GOLDEN} ({rel:.1%} off, tol "
        f"{KL_REL:.0%}) in {sec:.3f} s: {bt} elements ({sec / bt * 1e3:.4f} ms an element), "
        f"{chunks} chunk(s), {rc.records} record(s), {rc.plans} plan(s)")
    _only(counts, want, "KL")
    once(rc, "KL")
    _check(rel < KL_REL, f"KL {kl} off Sim et al.'s {KL_GOLDEN} by {rel:.1%}")
    times["KL"] = sec
    add(counts)
    # Where one 4q batch's time goes: record, plan (structure and payloads;
    # then the payloads alone, from the cache), run + readout.
    parts = _batch_breakdown(kl_model, bt)
    times["KL parts"] = parts
    log(f"  4q density batch of {bt} (Circuit_9), median of 5: record {parts['record']:.2f} ms, "
        f"plan {parts['plan']:.2f} ms (payloads from the cache {parts['payloads']:.2f} ms), "
        f"run + readout {parts['run']:.2f} ms; {parts['total'] / bt * 1e3:.3f} us an element")

    # The 24q spectrum: 97 grid inputs in one call, recorded and planned once.
    n24 = WIDTHS[-1]
    m24 = models[n24]
    calls = {name: len(shapes[n24][name]) for name in FWD_KERNELS if shapes[n24][name]}
    with _RouteCounter() as rc, torch.no_grad():
        t0 = time.perf_counter()
        coeffs, _ = Coefficients.get_spectrum(m24)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = rc.launches()
    n_grid = m24.degree[0]
    routed(m24, f"{n24}q spectrum", "per element: ")
    log(f"  {n24}q spectrum: {n_grid} grid inputs in {sec:.2f} s ({sec / n_grid * 1e3:.2f} ms a "
        f"grid input), {rc.records} record(s), {rc.plans} plan(s)")
    _only(counts, {k: n_grid * v for k, v in calls.items()}, f"{n24}q spectrum")
    once(rc, f"{n24}q spectrum")
    times[f"{n24}q spectrum"] = sec
    add(counts)

    # A 6q training step over a batch of inputs: the vectorised gradient
    # (per-element windows' backward on B2 / B4's batch entries) against
    # the loop route's, in float32 and in float64 (where a single state on
    # the card runs the batch entries as a batch of one), and both float32
    # routes against the CPU's float64.
    xs = _grad_batch_inputs(DEVICE)
    grads = {}
    p32 = grad_batch_model().params.detach().cpu().numpy()
    for dtype in (torch.float32, torch.float64):
        model = grad_batch_model(dtype=dtype)
        model.load_numpy(p32)  # one set of parameters for every route
        for route in ("loop", "vectorised"):
            model.params.grad = None
            with _RouteCounter() as rc:
                if route == "loop":
                    with _loop_route():
                        out = model(inputs=xs.to(dtype))
                        out.mean().backward()
                else:
                    t0 = time.perf_counter()
                    out = model(inputs=xs.to(dtype))
                    out.mean().backward()
                    torch.cuda.synchronize()
                    times[f"6q batched gradient {_dt(dtype)}"] = time.perf_counter() - t0
                counts = rc.launches()
            grads[route, dtype] = (out.detach().clone(), model.params.grad.detach().clone())
            if route == "vectorised":
                add(counts)
                vectorised(model, f"6q batched gradient {_dt(dtype)}")
                log(f"  6q batch of {GRAD_BATCH} forward + gradient ({_dt(dtype)}): "
                    f"{times[f'6q batched gradient {_dt(dtype)}'] * 1e3:.1f} ms, {rc.records} "
                    f"record(s), launched {dict((k, v) for k, v in counts.items() if v)}")
                _check(rc.records == 1 and rc.alone == 1,
                       f"6q batched gradient: {rc.records} batch records, {rc.alone} single")
                _check(all(counts[k] for k in BATCH_KERNELS),
                       f"6q batched gradient launched {counts}: a batch entry is missing")
    cpu = grad_batch_model("cpu", torch.float64)
    cpu.load_numpy(p32)
    cpu(inputs=xs.cpu().double()).mean().backward()
    y64, g64 = cpu(inputs=xs.cpu().double()).detach(), cpu.params.grad
    for dtype, tol_y in ((torch.float32, TOL_BATCH_LOOP), (torch.float64, TOL_BATCH_LOOP64)):
        (yl, gl), (yv, gv) = grads["loop", dtype], grads["vectorised", dtype]
        dy, dg = _maxdiff(yv, yl), _maxdiff(gv, gl)
        if dtype == torch.float64:
            tol = TOL_BATCH64 * gl.abs().max().item()
            for route, (y, g) in (("vectorised", (yv, gv)), ("loop", (yl, gl))):
                ey, eg = _maxdiff(y.cpu(), y64), _maxdiff(g.cpu(), g64)
                _check(ey <= TOL_BATCH64 and eg <= TOL_BATCH64 * g64.abs().max().item(),
                       f"6q float64 batch, {route} route, off the CPU's float64: {ey}, {eg}")
        else:
            tol = TOL_GRAD_BATCH[0] * gl.abs().max().item() + TOL_GRAD_BATCH[1]
        log(f"  6q batch ({_dt(dtype)}) vectorised vs the loop route: forward max|delta|="
            f"{dy:.3e} (tol {tol_y}), gradient {dg:.3e} (tol {tol:.3e}); against the CPU's "
            f"float64: vectorised {_maxdiff(yv.cpu().double(), y64):.3e} / "
            f"{_maxdiff(gv.cpu().double(), g64):.3e}, loop {_maxdiff(yl.cpu().double(), y64):.3e}"
            f" / {_maxdiff(gl.cpu().double(), g64):.3e}")
        _check(dy <= tol_y and dg <= tol, f"6q batch ({_dt(dtype)}) off the loop route: {dy}, {dg}")
    sgd = grad_batch_model()
    with torch.no_grad():
        before = sgd(inputs=xs).mean().item()
    for _ in range(3):
        sgd.params.grad = None
        sgd(inputs=xs).mean().backward()
        with torch.no_grad():
            sgd.params.sub_(SGD_LR * sgd.params.grad)
    with torch.no_grad():
        after = sgd(inputs=xs).mean().item()
    log(f"  6q batch, three SGD steps on the mean <Z>: {before:.5f} -> {after:.5f}")
    _check(after < before, "6q batched SGD did not lower the loss")

    # A chunked 10q density batch of 20 in chunks of 5 (BASELINE.md:18).
    cm = chunk_model()
    xs = torch.linspace(0, 2 * np.pi, CHUNK_BATCH, device=DEVICE)
    with torch.no_grad():
        whole = cm(inputs=xs, execution_type="density")
        real = memory.compute_chunk_size
        memory.compute_chunk_size = lambda *a, **kw: CHUNK_ROWS
        cm.script._chunks.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            with _RouteCounter() as rc:
                chunked = cm(inputs=xs, execution_type="density")
                counts = rc.launches()
        finally:
            memory.compute_chunk_size = real
        peak = torch.cuda.max_memory_allocated() - base
    d = (chunked - whole).abs().max().item()
    want = {k: v * (CHUNK_BATCH // CHUNK_ROWS)
            for k, v in batch_plan_calls(_skeleton(cm), CHUNK_N).items() if v}
    log(f"  {CHUNK_N}q density batch of {CHUNK_BATCH} in chunks of {CHUNK_ROWS}: max|delta| vs "
        f"unchunked {d:.3e} (tol {TOL_CHUNK}), peak {peak / 1e6:.1f} MB (limit "
        f"{CHUNK_PEAK / 1e9:.0f} GB), {rc.records} record(s)")
    _only(counts, want, f"{CHUNK_N}q chunked density")
    _check(d <= TOL_CHUNK and peak < CHUNK_PEAK and rc.records == 1 and rc.alone == 1,
           f"chunked density: {d}, {peak} bytes, {rc.records} batch records, {rc.alone} single")
    add(counts)

    # The 24q batch over the residual line under "auto": one decision.
    _batch_one_decision(models[n24], shapes[n24], n24, batch)
    log(f"  phase 5g took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _batch_one_decision(model, shape: dict, n: int, inputs: list) -> None:
    """The 24q batch over the 0.35 line under ``"auto"``: free memory read
    once, every element on the adjoint executor (one decision a batch)."""
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.ops import simulation

    size = len(inputs)
    real = memory.available_memory_bytes
    reads = []

    def counted(device=None):
        reads.append(real(device))
        return reads[-1]

    simulation.set_backward_mode("auto")
    model.script._chunks.clear()
    memory.available_memory_bytes = counted
    try:
        with _RouteCounter() as rc:
            model.params.grad = None
            t0 = time.perf_counter()
            model(inputs=inputs).mean().backward()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = rc.launches()
    finally:
        memory.available_memory_bytes = real
    want = adjoint_counts(shape, size)
    log(f"  {n}q batch of {size} under auto: {sec * 1e3:.1f} ms, free memory read {len(reads)} "
        f"time(s), {rc.records} record(s), {rc.plans} plan(s), launched "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    _check(len(reads) == 1 and rc.records == 1 and rc.alone == 1 and rc.plans == 1,
           f"{n}q batch of {size}: {len(reads)} reads, {rc.records} batch records, {rc.alone} "
           f"single, {rc.plans} plans")
    route = model.script.routes[-1]
    _check(route.startswith("per element: "), f"{n}q batch of {size}: route {route}")
    _check(all(counts[k] == v for k, v in want.items()),
           f"{n}q batch of {size}: launches {counts}, want {want}")


def _batch_breakdown(model, bt: int, reps: int = 5) -> dict:
    """Median ms of one vectorised density batch of *bt* rows of *model*'s
    parameters split into record (one tape of (Bt, K, K) gates), plan (the
    structure and the payloads; and the payloads alone, from a cached
    skeleton) and run + readout."""
    from qml_essentials_tpu_torch.ops import recipes, simulation

    params = model.params[:bt]
    inputs = torch.zeros((1, model.n_input_feat), device=DEVICE)
    parts = {"record": [], "plan": [], "payloads": [], "run": [], "total": []}
    with torch.no_grad():
        for i in range(reps + 1):
            t = [time.perf_counter()]
            tape = model.script._record(params, inputs, enc_params=model.enc_params)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            slot = simulation.PlanSlot()
            plan, start = slot.get("pure", simulation._pure_build(4, torch.float32, DEVICE), tape)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            recipes.materialize(slot.skeletons["pure"], tape)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            psi2 = simulation._run_pure(plan, start, 4, torch.float32, DEVICE, bt, None, bt)
            simulation.measure_density_ri(simulation._outer_ri(psi2), 4, "density", [])
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            if i:
                parts["record"].append((t[1] - t[0]) * 1e3)
                parts["plan"].append((t[2] - t[1]) * 1e3)
                parts["payloads"].append((t[3] - t[2]) * 1e3)
                parts["run"].append((t[4] - t[3]) * 1e3)
                parts["total"].append((t[4] - t[0] - (t[3] - t[2])) * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


# ---------------------------------------------------------------------------
# Phase 5h: pulses
# ---------------------------------------------------------------------------

PULSE_N = 24
PULSE_FAMILIES = 5  # the RX and RY drives, virtual RZ, CZ, H's correction phase
PULSE_BATCH_N = 6  # 3 inputs x 2 parameter sets x 2 pulse scalers
PULSE_BATCH_SCALES = (1.0, 1.03)
PULSE_SAMPLES = 20  # golden angles a gate (QOC's default sample)
GOLDEN_FIDELITY, GOLDEN_PHASE, GOLDEN_RX = 0.99, 1e-2, 1e-2  # BASELINE.md:20-21
# Composites outside QOC's gate library, probed from |+>|+>.
GOLDEN_EXTRA = ("RZZ", "RXX", "RYY", "RZX")
QOC_KNOBS = dict(envelope="gaussian", cost_fns=[("unitary", (0.5, 0.5))], t_target=0.5,
                 n_steps=15, n_samples=3, learning_rate=5e-3, log_interval=5, n_restarts=2,
                 scan_steps=0, random_seed=7)  # tests/test_qoc.py:114-126, two restarts
QOC_INIT_SCALE = 1.15


def pulse_model(n: int, device=None, dtype=torch.float32):
    """The n-qubit Circuit_19 model (bench.py's, seed 7; the pulse envelope
    the Model's default, gaussian) for pulse-mode requests."""
    from qml_essentials_tpu_torch.models.model import Model

    return Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED,
                 device=device or DEVICE, dtype=dtype)


def pulse_tape(n: int) -> list:
    """The pulse-mode tape of one forward of the n-qubit model (on the CPU)."""
    from qml_essentials_tpu_torch.ops.tape import recording

    model = pulse_model(n, "cpu")
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([REQUESTS[0]]),
                           pulse_params=model.pulse_params[0], gate_mode="pulse")
    return tape


def _golden_scripts(name: str, device) -> tuple:
    """(pulse script, target script, wires) of one gate: QOC's pair with its
    probe preparation where its gate library has one, else both wires of a
    two-qubit rotation prepared in |+>; float64 (QOC's precision)."""
    from qml_essentials_tpu_torch.models.gates import Gates
    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.pulse import qoc

    if name in qoc._GATE_LIBRARY:
        pulse, target = qoc._pair_from_spec(name)
        nw = qoc._GATE_LIBRARY[name].wires
    else:
        nw = 2

        def pulse(w, pp):
            op.H(wires=0), op.H(wires=1)
            getattr(Gates, name)(w, wires=[0, 1], pulse_params=pp, gate_mode="pulse")

        def target(w):
            op.H(wires=0), op.H(wires=1)
            getattr(op, name)(w, wires=[0, 1])

    return qoc._script(pulse, nw, device), qoc._script(target, nw, device), nw


def pulse_goldens(device) -> dict:
    """Every leaf and composite pulse gate (gaussian, RWA) over PULSE_SAMPLES
    angles: min state fidelity and max phase error against its exact gate,
    from QOC's probes (and the same circuit after a layer of H).  Returns
    {gate: (min fidelity, max phase error)} and the gaussian RX's min gate
    fidelity |Tr(U_pulse^dag U_RX)| / 2 against the analytic RX."""
    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.ops.tape import recording
    from qml_essentials_tpu_torch.pulse import qoc
    from qml_essentials_tpu_torch.pulse.pulses import PulseGates, PulseInformation

    PulseInformation.set_envelope("gaussian", rwa=True)
    ws = qoc._sample_rotation_angles(PULSE_SAMPLES, device)
    out = {}
    for name in list(qoc._GATE_LIBRARY) + list(GOLDEN_EXTRA):
        pulse, target, nw = _golden_scripts(name, device)
        pp = PulseInformation.gate_by_name(name).params.to(device)
        got = pulse.execute(type="state", args=(ws, pp), in_axes=(0, None))
        want = target.execute(type="state", args=(ws,), in_axes=(0,))
        overlap = torch.sum(want.conj() * got, dim=-1)
        out[name] = (overlap.abs().square().min().item(), torch.angle(overlap).abs().max().item())
    with recording() as tape:
        PulseGates.RX(ws, wires=0)
    with recording() as exact:
        op.RX(ws, wires=0)
    fid = torch.einsum("sji,sji->s", exact[0].matrix.conj(), tape[0].matrix).abs() / 2
    return out, fid.min().item()


def _pulse_batch_model(device, dtype):
    model = pulse_model(PULSE_BATCH_N, device, dtype)
    gen = torch.Generator().manual_seed(SEED)
    model.params = torch.rand((2,) + model._params_shape, generator=gen, dtype=dtype) * 2 * np.pi
    return model


def _pulse_batch_args(model) -> tuple:
    dev, dt = model.device, model.dtype
    pp = torch.stack([torch.full(model._pulse_params_shape, s, dtype=dt, device=dev)
                      for s in PULSE_BATCH_SCALES])
    return torch.tensor(REQUESTS, dtype=dt, device=dev), model.params.detach().clone(), pp


def pulse_batch(model, loop: bool = False) -> torch.Tensor:
    """The 6q batch over all three axes (inputs x params x pulse scalers),
    one vectorised call, or (*loop*) element by element."""
    xs, params, pp = _pulse_batch_args(model)
    if not loop:
        return model(inputs=xs, params=params, pulse_params=pp, gate_mode="pulse")
    out = torch.stack([model(inputs=x, params=params[i], pulse_params=pp[j], gate_mode="pulse")
                       for x in xs for i in range(len(params)) for j in range(len(pp))])
    model.params = params
    return out.reshape((len(xs), len(params), len(pp), -1))


def qoc_run(device) -> tuple:
    """QOC of the gaussian RX from 15 % off its calibration: returns the
    loss history, the best parameters and the seconds."""
    from qml_essentials_tpu_torch.pulse import qoc
    from qml_essentials_tpu_torch.pulse.pulses import PulseInformation

    out_dir = ROOT / "build" / "qoc"
    q = qoc.QOC(**QOC_KNOBS, file_dir=str(out_dir), device=device)
    init = PulseInformation.gate_by_name("RX").params * QOC_INIT_SCALE
    t0 = time.perf_counter()
    best, history = q.optimize(wires=1)(q.create_RX)(init_pulse_params=init)
    return [float(h) for h in history], best, time.perf_counter() - t0


class _PulseSpy:
    """Records the shapes the forward window wrappers run at while entered:
    float32 single states as (n, a, k) windows / top windows, and batched
    or float64 states (the batch entries) as (n, a, k, per-element W,
    batch, float64)."""

    def __enter__(self):
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck

        self.ck = ck
        self.saved = {name: getattr(ck, name) for name in ("window_apply", "window_apply_top")}
        self.windows, self.tops, self.batch = set(), set(), set()

        def add(psi2, w2, n, a, k):
            if psi2.dim() == 3 or psi2.dtype == torch.float64:
                bt = psi2.shape[1] if psi2.dim() == 3 else 1
                self.batch.add((n, a, k, w2.dim() == 4, bt, psi2.dtype == torch.float64))
            else:
                (self.tops if a + k == n else self.windows).add((n, a, k))

        def window(psi2, w2, a, k, n):
            add(psi2, w2, n, a, k)
            return self.saved["window_apply"](psi2, w2, a, k, n)

        def top(psi2, w2, k, n):
            add(psi2, w2, n, n - k, k)
            return self.saved["window_apply_top"](psi2, w2, k, n)

        ck.window_apply, ck.window_apply_top = window, top
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)


def pulse_shapes() -> dict:
    """The 24q pulse plan's kernel calls (its tape: operations by name), and
    every shape phase 5h's small registers run (the goldens, the 6q batch
    both routes in float32 and float64, and a QOC cost and gradient), read
    off the same workloads on the CPU."""
    from qml_essentials_tpu_torch.ops import simulation
    from qml_essentials_tpu_torch.pulse import qoc
    from qml_essentials_tpu_torch.pulse.pulses import PulseInformation

    t0 = time.perf_counter()
    tape = pulse_tape(PULSE_N)
    plan, _ = simulation.scheduled_plan(tape, PULSE_N)
    names = {}
    for o in tape:
        names[o.name] = names.get(o.name, 0) + 1
    main = shapes_of(plan, PULSE_N)
    record_s = time.perf_counter() - t0
    with _PulseSpy() as spy:
        with torch.no_grad():
            pulse_goldens("cpu")
            for dtype in (torch.float32, torch.float64):
                model = _pulse_batch_model("cpu", dtype)
                pulse_batch(model)
                pulse_batch(model, loop=True)
        q = qoc.QOC(**dict(QOC_KNOBS, n_steps=1, n_restarts=1), file_dir=None, device="cpu")
        pulse, target = q.create_RX()
        cost = qoc.Cost(qoc.unitary_cost_fn, (0.5, 0.5), dict(
            pulse_basis_scripts=qoc._basis_scripts(pulse, 1, "cpu"),
            target_basis_scripts=qoc._basis_scripts(target, 1, "cpu"), n_samples=3,
            n_qubits=1))
        qoc._value_and_grad(cost, PulseInformation.RX.params.clone())
    return dict(main=main, ops=len(tape), by_name=names, record_s=record_s,
                windows=sorted(spy.windows), tops=sorted(spy.tops), batch=sorted(spy.batch))


def _pulse_request(model, x, grad: bool = True) -> tuple:
    """loss = mean <Z> of a pulse-mode request; with *grad* its gradients
    with respect to params and pulse_params."""
    model.params.grad = model.pulse_params.grad = None
    if not grad:
        with torch.inference_mode():
            return model(inputs=x, gate_mode="pulse").mean(), None, None
    loss = model(inputs=x, gate_mode="pulse").mean()
    loss.backward()
    return (loss.detach(), model.params.grad.detach().clone(),
            model.pulse_params.grad.detach().clone())


def _pulse_fd(model, g: torch.Tensor, gp: torch.Tensor, x) -> None:
    """Central difference of the card's pulse forward along (g, gp)/|(g, gp)|
    against the gradient's norm."""
    norm = torch.cat([g.flatten(), gp.flatten()]).norm().item()
    p0, q0 = model.params.detach().clone(), model.pulse_params.detach().clone()
    f_pm = []
    try:
        for s in (FD_EPS, -FD_EPS):
            model.params.data = p0 + s * g / norm
            model.pulse_params.data = q0 + s * gp / norm
            with torch.inference_mode():
                f_pm.append(model(inputs=x, gate_mode="pulse").mean().item())
    finally:
        model.params.data, model.pulse_params.data = p0, q0
    fd = (f_pm[0] - f_pm[1]) / (2 * FD_EPS)
    tol = FD_REL * norm + FD_ABS
    log(f"  {PULSE_N}q pulse central difference along (g, g_pulse)/|.| (eps {FD_EPS}): {fd:.6f} "
        f"vs |g| {norm:.6f} (|delta|={abs(fd - norm):.3e}, tol {tol:.3e})")
    _check(abs(fd - norm) <= tol, f"{PULSE_N}q pulse finite difference {fd} vs |g| {norm}")


class _SolveTimer:
    """Host ms spent in the batched pulse solves while entered (each solve
    synchronised before and after), and their number."""

    def __enter__(self):
        from qml_essentials_tpu_torch.pulse.evolution import Evolution

        self.ev, self.real, self.ms, self.calls = Evolution, Evolution.resolve.__func__, 0.0, 0
        timer = self

        def resolve(cls, ops):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), cls.solve_calls
            timer.real(cls, ops)
            torch.cuda.synchronize()
            timer.ms += (time.perf_counter() - t0) * 1e3
            timer.calls += cls.solve_calls - c0

        Evolution.resolve = classmethod(resolve)
        return self

    def __exit__(self, *exc):
        self.ev.resolve = classmethod(self.real)


def _pulse_breakdown(model, n: int) -> None:
    """Where one pulse-mode forward request's time goes: recording (of which
    the batched solves), planning and running the plan plus readout."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)

    def record():
        return model.script._record(model.params, inputs, pulse_params=model.pulse_params,
                                    enc_params=model.enc_params, gate_mode="pulse")

    with torch.inference_mode():
        record()
        with _SolveTimer() as st:
            rec_ms, _, tape = _host_ms(record)
        plan_ms, _, (plan, start) = _host_ms(
            lambda: simulation.scheduled_plan(tape, n, device=DEVICE))

        def run():
            psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
            for kind, payload, wires in plan:
                psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
            return simulation.measure_state_ri(psi2, n, meas_type, obs)

        run_ms, _, _ = _host_ms(run)
        slot = simulation.PlanSlot()
        slot.get("pure", simulation._pure_build(n, torch.float32, DEVICE), tape)
        hit_ms, _, _ = _host_ms(lambda: slot.get("pure", None, tape))
    log(f"    pulse forward breakdown {n}q: record {rec_ms:.3f} ms (of which {st.calls // 3} "
        f"batched solves {st.ms / 3:.3f} ms), plan {plan_ms:.3f} ms (from the plan cache "
        f"{hit_ms:.3f} ms), run {len(plan)} steps + readout {run_ms:.3f} ms")


def phase_pulses(pshapes: dict, smi: str) -> dict:
    """Pulse mode on the card: the 24q Circuit_19 request (exact launches,
    one batched solve per Hamiltonian family, <Z> against the CPU's float64
    pulse request), its gradient in params and pulse_params (saved against
    forced adjoint and a finite difference), a 6q batch over the three
    batch axes (vectorised, equal to the loop), the goldens and a QOC run.
    Returns the launches counted."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved, simulation
    from qml_essentials_tpu_torch.pulse.evolution import Evolution

    t_phase = time.perf_counter()
    log(f"phase 5h: pulses ({smi})")
    n, shape = PULSE_N, pshapes["main"]
    log(f"  {n}q pulse-mode Circuit_19 tape: {pshapes['ops']} operations {pshapes['by_name']} "
        f"(recorded and planned on the CPU in {pshapes['record_s']:.1f} s)")
    log(f"  {n}q pulse plan: {describe(shape)}")
    log(f"    in order: {describe_steps(shape)}")
    ck.reset_launch_counts()
    model = pulse_model(n)
    x = REQUESTS[0]

    # The forward request: exact launches, one solve per family.
    _pulse_request(model, x, grad=False)  # warm-up: the solvers' first calls
    torch.cuda.synchronize()
    c0, before = Evolution.solve_calls, ck.launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(inputs=x, gate_mode="pulse")
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) * 1e3
    calls, fwd = Evolution.solve_calls - c0, _diff(ck.launch_counts(), before)
    want = {name: len(shape[name]) for name in FWD_KERNELS}
    got = {name: fwd[name] for name in FWD_KERNELS}
    log(f"  {n}q pulse forward: {req_ms:.1f} ms, {calls} batched solves, launched {got}")
    _check(got == want and not any(fwd[k] for k in (*BWD_KERNELS, *ADJOINT_KERNELS)),
           f"{n}q pulse forward launches {fwd}, the plan wants {want}")
    _check(calls == PULSE_FAMILIES,
           f"{n}q pulse forward: {calls} solves, want one per family ({PULSE_FAMILIES})")
    _check(tuple(out.shape) == (n,) and bool(torch.isfinite(out).all()),
           f"{n}q pulse forward: shape {tuple(out.shape)} or non-finite values")
    ref_model = pulse_model(n, "cpu", torch.float64)
    ref_model.load_numpy(model.params.detach().cpu().numpy(),
                         pulse_params=model.pulse_params.detach().cpu().numpy())
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = ref_model(inputs=x, gate_mode="pulse")
    d_ref = _maxdiff(out, ref)
    log(f"  {n}q pulse card fp32 vs CPU fp64: max|delta <Z>|={d_ref:.3e} (CPU reference took "
        f"{time.perf_counter() - t0:.1f} s)")
    _check(d_ref <= TOL_EXPVAL, f"{n}q pulse: card vs CPU fp64 differ by {d_ref:.3e}")
    best, med, _ = _host_ms(lambda: _pulse_request(model, x, grad=False), reps=10)
    log(f"  {n}q pulse forward request: best {best:.3f} ms, median of 10 {med:.3f} ms")
    _pulse_breakdown(model, n)

    # The gradient in params and pulse_params: saved (f32 lambda) against
    # forced adjoint, the saved executor's launches, a finite difference.
    saved.set_lambda_mode("f32")
    grads = {}
    try:
        for mode in ("autodiff", "adjoint"):
            simulation.set_backward_mode(mode)
            before = ck.launch_counts()
            loss, g, gp = _pulse_request(model, x)
            torch.cuda.synchronize()
            grads[mode] = (loss, g, gp, _diff(ck.launch_counts(), before))
    finally:
        simulation.set_backward_mode("auto")
        saved.set_lambda_mode("bf16")
    loss, g, gp, counts = grads["autodiff"]
    _check(all(bool(torch.isfinite(t).all()) for t in (loss, g, gp)) and gp.abs().max() > 0,
           f"{n}q pulse gradient: non-finite or vanishing")
    want = saved_counts(shape)
    got = {k: counts[k] for k in want}
    log(f"  {n}q pulse fwd+grad (saved, f32 lambda): loss {loss.item():.6f}, |g| "
        f"{g.norm().item():.6f}, |g_pulse| {gp.norm().item():.6f}; backward launches {got}")
    _check(got == want, f"{n}q pulse saved gradient launches {got}, want {want}")
    _check_adjoint_counts(grads["adjoint"][3], shape, f"{n}q pulse forced adjoint")
    _within(grads["adjoint"][1], g, f"{n}q pulse d/d params, adjoint vs saved")
    _within(grads["adjoint"][2], gp, f"{n}q pulse d/d pulse_params, adjoint vs saved")
    _pulse_fd(model, g, gp, x)
    best, med, _ = _host_ms(lambda: _pulse_request(model, x), reps=5)
    log(f"  {n}q pulse forward + gradient (saved, bf16 lambda): best {best:.3f} ms, median of 5 "
        f"{med:.3f} ms")
    launches = ck.launch_counts()

    # The 6q batch over the three axes: vectorised, equal to the loop.
    for dtype, tol in ((torch.float32, TOL_BATCH_LOOP), (torch.float64, TOL_BATCH64)):
        bmodel = _pulse_batch_model(DEVICE, dtype)
        with torch.inference_mode(), _RouteCounter() as rc:
            c0 = Evolution.solve_calls
            got = pulse_batch(bmodel)
            calls = Evolution.solve_calls - c0
            counts = rc.launches()
        route = bmodel.script.routes[-1]
        with torch.inference_mode():
            loop = pulse_batch(bmodel, loop=True)
        d = _maxdiff(got, loop)
        log(f"  {PULSE_BATCH_N}q pulse batch {tuple(got.shape[:3])} {_dt(dtype)}: route {route!r}, "
            f"{rc.records} batch record(s), {rc.alone} single, {calls} batched solves, launched "
            f"{dict((k, v) for k, v in counts.items() if v)}; vs the loop max|delta|={d:.3e}")
        _check(route == "vectorised" and rc.records == 1 and rc.alone == 1,
               f"{PULSE_BATCH_N}q pulse batch: route {route}, {rc.records} records")
        _check(calls <= 2 * PULSE_FAMILIES, f"{PULSE_BATCH_N}q pulse batch: {calls} solves")
        _check(d <= tol, f"{PULSE_BATCH_N}q pulse batch vs loop differ by {d:.3e} > {tol}")
        for k in launches:
            launches[k] += counts[k]

    # The goldens (BASELINE.md:20-21).
    with _RouteCounter() as rc, torch.inference_mode():
        t0 = time.perf_counter()
        goldens, rx_fid = pulse_goldens(DEVICE)
        sec = time.perf_counter() - t0
        counts = rc.launches()
    for k in launches:
        launches[k] += counts[k]
    for name, (fid, phase) in goldens.items():
        log(f"  golden {name}: min state fidelity {fid:.6f}, max phase error {phase:.3e}")
        _check(fid >= GOLDEN_FIDELITY, f"golden {name}: fidelity {fid:.6f} < {GOLDEN_FIDELITY}")
        # CPhase's recipe is ControlledPhaseShift times the global phase
        # e^{-i w/4}: its phase is not the gate's error.
        _check(name == "CPhase" or phase <= GOLDEN_PHASE,
               f"golden {name}: phase error {phase:.3e} > {GOLDEN_PHASE}")
    log(f"  golden gaussian RX vs analytic RX: min gate fidelity {rx_fid:.6f} over "
        f"{PULSE_SAMPLES} angles ({sec:.1f} s for the goldens)")
    _check(abs(rx_fid - 1) <= GOLDEN_RX, f"golden RX: gate fidelity {rx_fid}")

    # QOC.
    with _RouteCounter() as rc:
        history, best, sec = qoc_run(DEVICE)
        counts = rc.launches()
    for k in launches:
        launches[k] += counts[k]
    log(f"  QOC RX (gaussian, {QOC_KNOBS['n_steps']} steps x {QOC_KNOBS['n_restarts']} restarts, "
        f"{QOC_KNOBS['n_samples']} angles, init x{QOC_INIT_SCALE}): loss {history[0]:.6e} -> "
        f"{min(history[1:]):.6e} in {sec:.2f} s ({smi}); best {best.tolist()}")
    _check(min(history[1:]) < history[0] and all(np.isfinite(history)),
           f"QOC RX: the loss did not fall: {history}")
    log(f"  launches over phase 5h: {dict((k, v) for k, v in launches.items() if v)}")
    log(f"  phase 5h took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 5i: utils and the API surface
# ---------------------------------------------------------------------------

API_N = 10  # the ket-then-bra simulate_mixed register (20 wires)
API_NOISE = {"Depolarizing": 0.01, "AmplitudeDamping": 0.02}
TOL_ZREAD = 1e-6  # <Z> from |psi|^2 (float64 marginals) vs the Model's float32 readout
API_GATES = (  # (what, gate, angle, wires mod n, the kernels one application launches)
    ("mid-register window", "CRY", 0.7, (10, 11), {"window_apply": 1}),
    ("top window", "RXX", 0.4, (-2, -1), {"window_apply_top": 1}),
    ("ring-wrap", "CRX", 0.5, (-1, 0), {"rotate": 2, "window_apply": 1}),
)
TRACE_DIR = ROOT / "build" / "traces"
CKPT_DIR = ROOT / "build" / "checkpoints"


def _union_ms(intervals: list, lo: float, hi: float) -> float:
    """Length (ms) of the union of (start, end) intervals in us, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _traced(label: str, fn) -> dict:
    """One call of fn() (ending in a synchronize) under the port's profiler
    trace (``utils.profiling.xla_trace``), inside a ``qml:request`` range;
    returns the window (the range on the host clock), the union of the
    kernels' device intervals within it, the idle share and the kernels by
    name, read off the Chrome trace the profiler wrote."""
    from qml_essentials_tpu_torch.utils.profiling import TRACE_FILE, xla_trace

    log_dir = TRACE_DIR / label
    with xla_trace(str(log_dir)):
        with torch.profiler.record_function("qml:request"):
            fn()
            torch.cuda.synchronize()
    with open(log_dir / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    windows = [e for e in events if e.get("name") == "qml:request" and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    _check(len(windows) == 1, f"{label}: {len(windows)} qml:request ranges in the trace")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    out = {"window_ms": (hi - lo) / 1e3, "kernels": len(kernels), "by_name": {}}
    if not kernels:
        out.update(busy_ms=None, idle=None)
        return out
    out["busy_ms"] = _union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                for e in kernels], lo, hi)
    out["idle"] = 1.0 - out["busy_ms"] / out["window_ms"]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + float(e["dur"]))
    out["by_name"] = by_name
    return out


def _log_trace(label: str, t: dict, smi: str) -> None:
    if t["busy_ms"] is None:
        log(f"  {label}: window {t['window_ms']:.3f} ms; device idle share not measured "
            f"(the profiler's trace holds no kernel event) ({smi})")
        return
    log(f"  {label}: window {t['window_ms']:.3f} ms on the host clock, kernels busy "
        f"{t['busy_ms']:.3f} ms (union of {t['kernels']} kernel intervals), device idle share "
        f"{t['idle']:.4f} ({smi})")
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in top[:10]:
        log(f"    {n:6d} x {us / 1e3:9.3f} ms  {name[:110]}")
    if len(top) > 10:
        rest = sum(us for _, (_, us) in top[10:]) / 1e3
        log(f"    ... {len(top) - 10} more kernel names, {rest:.3f} ms")


def phase_api(models: dict, shapes: dict, smi: str) -> dict:
    """The complex-state API and utils on the card: the 24q Circuit_19 tape
    through ``simulate_pure`` (exact launches per plan step, the state equal
    to ``from_ri(simulate_pure_ri(...))``, <Z> from |psi|^2 against the
    Model's), ``Operation.apply_to_state`` on a 24q state (B1, B3, B5 + B1
    against the plain version in float64), ``simulate_mixed`` of a 10q noisy
    tape against the CPU's float64, a checkpoint round trip of the 24q model,
    its text drawing against the CPU's, the 24q pulse model's events against
    the CPU's, and the measurements: the 24q ``simulate_pure`` request, the
    profiler's kernels and the device's idle share of a 24q forward request
    and of the 4q KL batch, and ``timed``'s mean of the 24q forward.  Returns
    the launches of the API's own calls."""
    import shutil

    from qml_essentials_tpu_torch.analysis.expressibility import Expressibility
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels, simulation
    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.ops.tape import recording
    from qml_essentials_tpu_torch.utils import checkpointing, profiling

    t_phase = time.perf_counter()
    log(f"phase 5i: utils and the API surface ({smi})")
    ck.reset_launch_counts()
    launches = dict.fromkeys(KERNELS, 0)
    n = WIDTHS[-1]
    model, shape = models[n], shapes[n]
    x = REQUESTS[0]

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # The 24q tape through simulate_pure: phase 4's kernels, once a plan step.
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([x], device=DEVICE))
    with torch.inference_mode():
        simulation.simulate_pure(tape, n, device=DEVICE)  # warm-up
        torch.cuda.synchronize()
        before = ck.launch_counts()
        psi = simulation.simulate_pure(tape, n, device=DEVICE)
        torch.cuda.synchronize()
        counts = _diff(ck.launch_counts(), before)
        ref = kernels.from_ri(simulation.simulate_pure_ri(tape, n, torch.float32, DEVICE))
        z_model = model(inputs=x)
    add(counts)
    want = {name: len(shape[name]) for name in FWD_KERNELS}
    got = {name: counts[name] for name in FWD_KERNELS}
    others = {k: v for k, v in counts.items() if v and k not in FWD_KERNELS}
    log(f"  {n}q simulate_pure: {tuple(psi.shape)} {psi.dtype} on {psi.device}, launched {got}")
    _check(got == want and not others,
           f"{n}q simulate_pure launches {counts}, phase 4's plan wants {want}")
    _check(psi.shape == (2**n,) and psi.dtype == torch.complex64 and psi.is_cuda,
           f"{n}q simulate_pure gave {tuple(psi.shape)} {psi.dtype} on {psi.device}")
    _check(torch.equal(psi, ref), f"{n}q simulate_pure differs from from_ri(simulate_pure_ri)")
    probs = psi.real.double() ** 2 + psi.imag.double() ** 2
    marg = torch.stack([kernels.marginal_qubit_probs(probs, q) for q in range(n)])
    z_psi = marg[:, 0] - marg[:, 1]
    d_z = _maxdiff(z_psi, z_model)
    log(f"  {n}q <Z> from |psi|^2 vs the Model's request: max|delta|={d_z:.3e} "
        f"(tol {TOL_ZREAD}); norm {probs.sum().item():.9f}")
    _check(d_z <= TOL_ZREAD and torch.isfinite(psi).all(), f"{n}q <Z> from |psi|^2 off by {d_z}")
    with torch.inference_mode():
        best, med, _ = _host_ms(lambda: simulation.simulate_pure(tape, n, device=DEVICE), reps=5)
        ev_ms = _events_ms(lambda: simulation.simulate_pure(tape, n, device=DEVICE), reps=3, trials=3)
        run_best, run_med, _ = _host_ms(lambda: simulation.simulate_pure_ri(
            tape, n, torch.float32, DEVICE), reps=5)
    log(f"  {n}q simulate_pure request (plan + run, the tape recorded): best {best:.2f} ms, "
        f"median {med:.2f} ms of 5 (host clock); CUDA events {ev_ms:.2f} ms a call; "
        f"simulate_pure_ri alone best {run_best:.2f} / median {run_med:.2f} ms ({smi})")

    # Gate application on a 24q state: one window, one top window, a ring-wrap.
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    psi0 = torch.complex(torch.randn(2**n, generator=g, device=DEVICE),
                         torch.randn(2**n, generator=g, device=DEVICE))
    psi0 = psi0 / torch.linalg.vector_norm(psi0)
    for what, name, theta, spec, kernels_want in API_GATES:
        wires = [w % n for w in spec]
        gate = getattr(op, name)(theta, wires=wires, record=False)
        with torch.no_grad():
            before = ck.launch_counts()
            out = gate.apply_to_state(psi0, n)
            torch.cuda.synchronize()
            counts = _diff(ck.launch_counts(), before)
            plain = kernels.apply_matrix_flat(psi0.to(torch.complex128), gate.matrix, wires, n)
        add(counts)
        err = (out.to(torch.complex128) - plain).abs().max().item() / plain.abs().max().item()
        fired = {k: v for k, v in counts.items() if v}
        log(f"  {name}{wires} ({what}) apply_to_state on {n}q: launched {fired}, max|err| / "
            f"max|ref| {err:.3e} against the plain version in float64")
        _check(fired == kernels_want, f"{name}{wires}: launched {fired}, want {kernels_want}")
        _check(out.dtype == torch.complex64 and err <= TOL_WINDOW,
               f"{name}{wires}: {out.dtype}, error {err:.3e}")

    # simulate_mixed of a 10q noisy tape against the CPU's float64.
    dmodel = Model(n_qubits=API_N, n_layers=N_LAYERS, circuit_type="Circuit_19",
                   random_seed=SEED, device=DEVICE)
    ref_model = _cpu_f64_model(dmodel, API_N)
    tapes = []
    for m, dt in ((dmodel, torch.float32), (ref_model, torch.float64)):
        with recording() as t, torch.no_grad():
            m._variational(m.params[0], torch.tensor([x], dtype=dt, device=m.device),
                           noise_params=API_NOISE, random_key=torch.Generator().manual_seed(SEED))
        tapes.append(t)
    with torch.inference_mode():
        t0 = time.perf_counter()
        before = ck.launch_counts()
        rho = simulation.simulate_mixed(tapes[0], API_N, device=DEVICE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _diff(ck.launch_counts(), before)
    add(counts)
    t0 = time.perf_counter()
    rho64 = simulation.simulate_mixed(tapes[1], API_N, torch.float64, device="cpu")
    cpu_sec = time.perf_counter() - t0
    d_rho = (rho.cpu().to(torch.complex128) - rho64).abs().max().item()
    herm = (rho - rho.mH).abs().max().item()
    fired = {k: v for k, v in counts.items() if v}
    log(f"  {API_N}q noisy simulate_mixed ({API_NOISE}, {len(tapes[0])} operations, "
        f"ket-then-bra on {2 * API_N} wires): {sec:.3f} s on the card, launched {fired}; "
        f"max|delta| vs the CPU's float64 ({cpu_sec:.1f} s) {d_rho:.3e}, max|rho - rho^dag| "
        f"{herm:.3e}, trace {torch.trace(rho).real.item():.7f}")
    _check(rho.shape == (2**API_N, 2**API_N) and rho.is_cuda, f"simulate_mixed {rho.shape}")
    _check(d_rho <= TOL_DENSITY and herm <= TOL_HERMITIAN and counts["window_apply"] > 0,
           f"{API_N}q simulate_mixed: delta {d_rho:.3e}, hermiticity {herm:.3e}, {fired}")

    # A checkpoint round trip of the 24q model: bit-identical <Z>.
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    with torch.inference_mode():
        z0 = model(inputs=x)
    original = model.params.detach().clone()
    target = checkpointing.save_model(str(CKPT_DIR), model, step=1)
    model.params = torch.zeros_like(model.params)
    step = checkpointing.latest_step(str(CKPT_DIR))
    checkpointing.restore_model(str(CKPT_DIR), model, step=step)
    with torch.inference_mode():
        z1 = model(inputs=x)
    log(f"  {n}q checkpoint: {Path(target).relative_to(ROOT)} "
        f"({Path(target).stat().st_size} bytes), step {step}, params back on "
        f"{model.params.device} {model.params.dtype}; <Z> bit-identical: {torch.equal(z0, z1)}")
    _check(step == 1 and torch.equal(model.params, original) and torch.equal(z0, z1),
           f"{n}q checkpoint round trip changed the model")
    shutil.rmtree(CKPT_DIR)

    # The 24q model's text drawing against the CPU's.
    cpu_model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19",
                      random_seed=SEED, device="cpu")
    text, cpu_text = str(model), str(cpu_model)
    values = model.draw(figure="text", gate_values=True)
    cpu_values = cpu_model.draw(figure="text", gate_values=True)
    log(f"  {n}q draw_text: {len(text.splitlines())} lines x {len(text.splitlines()[0])} "
        f"characters, equal to the CPU's: {text == cpu_text} (symbolic), {values == cpu_values} "
        f"(gate values)")
    _check(text == cpu_text and values == cpu_values, f"{n}q drawing differs from the CPU's")
    try:
        import matplotlib  # noqa: F401

        have_mpl = "matplotlib is installed on this machine"
    except ImportError:
        have_mpl = "this machine has no matplotlib"
    log(f"  no mpl or pulse figure is rendered on the card ({have_mpl}; draw_mpl and "
        "draw_pulse_schedule import it when called)")

    # The 24q pulse model's events (Script.pulse_events) against the CPU's.
    events = {}
    for where in (DEVICE, "cpu"):
        pm = pulse_model(n, where)
        t0 = time.perf_counter()
        with torch.no_grad():
            events[where] = pm.script.pulse_events(
                pm.params[0], torch.tensor([x], device=pm.device), pm.pulse_params[0],
                gate_mode="pulse", noise_params=None)
        events[where + " s"] = time.perf_counter() - t0
    card, cpu = events[DEVICE], events["cpu"]
    same = [(e.gate, e.wires, e.parent, e.carrier_phase) for e in card] == [
        (e.gate, e.wires, e.parent, e.carrier_phase) for e in cpu]
    d_ev = max(max(abs(float(a.w) - float(b.w)), abs(float(a.duration) - float(b.duration)))
               for a, b in zip(card, cpu))
    log(f"  {n}q pulse model: Script.pulse_events gave {len(card)} events on the card "
        f"({events[DEVICE + ' s']:.2f} s; the CPU {len(cpu)} in {events['cpu s']:.2f} s), "
        f"the same gates, wires and carrier phases: {same}, max|delta w, duration| {d_ev:.3e}")
    _check(same and len(card) > 0 and d_ev <= 1e-6, f"{n}q pulse events differ from the CPU's")

    # Measurements: the profiler's kernels and the device's idle share.
    with torch.inference_mode():
        model(inputs=x)
        torch.cuda.synchronize()
        t24 = _traced("forward_24q", lambda: model(inputs=x))
    _log_trace(f"{n}q forward request, one call traced", t24, smi)
    kl_model = analysis_models()["kl9"]
    kl_run = partial(Expressibility.kl_divergence_to_haar, kl_model, n_samples=KL_SAMPLES,
                     n_bins=KL_BINS, random_key=torch.Generator().manual_seed(MW_SEED))
    with torch.no_grad():
        kl_run()
        torch.cuda.synchronize()
        before = ck.launch_counts()
        tkl = _traced("kl_4q", kl_run)
        counts = _diff(ck.launch_counts(), before)
    fired = {k: v for k, v in counts.items() if v}
    _log_trace(f"4q KL batch ({2 * KL_SAMPLES} elements, {fired}), one call traced", tkl, smi)
    with torch.inference_mode():
        stats = profiling.timed(lambda: model(inputs=x), iters=10, warmup=2)
    log(f"  timed({n}q forward, iters=10, warmup=2): first call {stats['compile_s'] * 1e3:.2f} ms "
        f"(warm process), mean {stats['mean_s'] * 1e3:.3f} ms ({smi})")
    mem = profiling.device_memory_stats()
    log(f"  device_memory_stats(): {len(mem)} keys, allocated.all.peak "
        f"{mem.get('allocated_bytes.all.peak', 0) / 1e9:.2f} GB")
    _check(bool(mem) and stats["mean_s"] > 0, "profiling gave no memory stats or no time")
    log(f"  launches over phase 5i's API calls: {dict((k, v) for k, v in launches.items() if v)}")
    log(f"  phase 5i took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 5j: the sharded route (parallel/)
# ---------------------------------------------------------------------------

SHARD_RANKS = 4  # ranks of the gloo group that shares the card
SHARD_BATCH = 8  # the data=2 x state=2 batch
SHARD_REPS = 3  # timed calls of each request (best kept), after one that builds the program
TOL_SHARD_Z = 1e-5  # <Z> / probabilities: sharded vs single-device route on the card (fp32)
# |g_sharded - g_single| <= 1e-4 max|g| + 1e-6, both with float32 cotangents: a bf16
# cotangent rounds at each plan's own steps, and the sharded plan (40 windows at 24q)
# is not the single-device one (14 steps); their bf16 gradients differ by ~2e-3 max|g|.
TOL_SHARD_GRAD = (1e-4, 1e-6)
SHARD_TIMEOUT = 600  # seconds the parent waits for the gloo ranks
# Kernels the sharded route never runs: it fuses its own windows and
# schedules no layout (B6-B11, B14, B15) and no chains (B17, B18).
SHARD_NEVER = ("rotmat_apply", "rotmat_apply_bwd", "matrot_apply", "matrot_apply_bwd",
               "rotwin_apply", "rotwin_apply_bwd", "adjoint_rotmat", "adjoint_matrot",
               "chain_apply", "adjoint_chain")
SHARD_ROUTES = ("sharded:state", "sharded:density", "sharded:cached")


def _shard_model(params, dtype=torch.float32):
    from qml_essentials_tpu_torch.models.model import Model

    model = Model(n_qubits=WIDTHS[-1], n_layers=N_LAYERS, circuit_type="Circuit_19",
                  random_seed=SEED, device=DEVICE, dtype=dtype)
    model.load_numpy(params)
    return model


def _shard_batch() -> torch.Tensor:
    return torch.linspace(-1.0, 1.4, SHARD_BATCH, device=DEVICE)


def _device_watch():
    """A ``TorchDispatchMode`` that notes the devices of the card tensors
    every operation returns and the largest tensor (elements, operation)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.devices, self.largest = set(), (0, None)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    if t.is_cuda:
                        self.devices.add(str(t.device))
                    if t.numel() > self.largest[0]:
                        self.largest = (t.numel(), str(func))
            return out

    return Watch()


def _timed(fn, watch: bool = False) -> dict:
    """fn() once (it builds the program; with *watch* under a device watch),
    then ``SHARD_REPS`` calls, the launch and exchange counts reset before
    each and each ending in a synchronise.  Returns the last answer (float,
    on the CPU), the best and the first ms, the last call's launches,
    exchanges and bytes sent, the peak memory of the current card since the
    first call and, with *watch*, the card devices and the largest tensor of
    the first call."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck
    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    watcher = _device_watch() if watch else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with watcher:
        fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    best = float("inf")
    for _ in range(SHARD_REPS):
        ck.reset_launch_counts()
        ss.EXCHANGES = ss.EXCHANGE_BYTES = 0
        t0 = time.perf_counter()
        answer = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    out = dict(answer=answer.detach().float().cpu().numpy(), ms=best, first_ms=first,
               launches=ck.launch_counts(), exchanges=ss.EXCHANGES, bytes=ss.EXCHANGE_BYTES,
               peak=torch.cuda.max_memory_allocated())
    if watch:
        out.update(devices=sorted(watcher.devices), largest=watcher.largest)
    return out


def _run_requests(requests: list, meshes: dict, watch: bool = False) -> dict:
    """Each of *requests*, ``(name, mesh, fn, lambda mode, batched exchange
    form, register qubits or None)``, on its mesh of *meshes* under its
    lambda mode and exchange form, timed by ``_timed``; returns per name the
    timing with the qubits and the mesh."""
    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.ops import saved
    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    out = {}
    lambda_mode, form = saved.LAMBDA_MODE, ss.BATCHED_EXCHANGE
    try:
        for name, mesh, fn, lam, exchange, n in requests:
            parallel.set_mesh(meshes[mesh])
            saved.set_lambda_mode(lam)
            ss.BATCHED_EXCHANGE = exchange
            try:
                out[name] = dict(_timed(fn, watch), n=n, mesh=mesh)
            finally:
                parallel.set_mesh(None)
    finally:
        saved.set_lambda_mode(lambda_mode)
        ss.BATCHED_EXCHANGE = form
    return out


def shard_requests(params, dparams, composed: bool) -> dict:
    """This rank's sharded requests, the same on every rank: the 24q model's
    forward and forward + gradient on a ``state`` mesh over every rank, and
    with *composed* the batch on a ``data=2 x state=2`` mesh and the 13q
    density model's expval and probs on the ``state`` mesh, all with
    float32 cotangents and the all-to-all exchange.  Returns per request its
    timing (``_timed``), and the route logs."""
    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    world = torch.distributed.get_world_size()
    model = _shard_model(params)
    x = REQUESTS[0]
    meshes = {"state": parallel.make_mesh((world,), ("state",))}
    requests = [("fwd", "state", lambda: model(inputs=x)),
                ("grad", "state", lambda: _grad_request(model, x)[1])]
    if composed:
        dmodel = density_model(DENSITY_NOISE)
        dmodel.load_numpy(dparams)
        meshes["composed"] = parallel.make_mesh((2, world // 2), ("data", "state"))
        batch = _shard_batch()
        requests += [("batch", "composed", lambda: model(inputs=batch)),
                     ("density expval", "state", lambda: dmodel(inputs=x)),
                     ("density probs", "state",
                      lambda: dmodel(inputs=x, execution_type="probs"))]
    out = {"requests": _run_requests([(*r, "f32", "a2a", None) for r in requests], meshes)}
    out["routes"] = {"model": list(model.script.sharding_decisions)}
    if composed:
        out["routes"]["density"] = list(dmodel.script.sharding_decisions)
    out["staged"] = ss._Axis(meshes["state"], "state").staged
    return out


def _rank(rank: int, world: int, store: str, nccl: bool, requests, args: tuple,
          queue) -> None:
    """One rank of a spawned group: puts ``(rank, requests(*args))``, or the
    rank's traceback as soon as it fails, on *queue*.  A gloo rank runs on card 0.  With *nccl*,
    rank r runs on card r, made current before anything is allocated and
    before the group, which is bound to it and fails a collective that waits
    over ``CARD_TIMEOUT`` s; NCCL writes how it connects the ranks under
    ``build/cards``."""
    import os
    from datetime import timedelta

    import torch.distributed as dist

    try:
        kwargs = {}
        if nccl:
            os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT",
                              NCCL_DEBUG_FILE=str(CARD_DIR / f"nccl.{rank}.log"),
                              PYTORCH_CUDA_ALLOC_CONF=CARD_ALLOC_CONF)
            kwargs = dict(timeout=timedelta(seconds=CARD_TIMEOUT),
                          device_id=torch.device("cuda", rank))
            torch.set_num_threads(max(1, (os.cpu_count() or world) // world))  # the host's cores
            torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's plain versions
            torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank if nccl else 0)
        dist.init_process_group("nccl" if nccl else "gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world, **kwargs)
        queue.put((rank, requests(*args)))
    except Exception:  # noqa: BLE001 - the parent reports the traceback and stops the ranks
        import traceback

        queue.put((rank, traceback.format_exc()))
        return  # the other ranks may wait in a collective: no teardown of the group
    dist.destroy_process_group()


def _spawn(world: int, store: Path, nccl: bool, requests, args: tuple) -> dict:
    """The results of *world* spawned ``_rank`` processes by rank.  A rank
    that fails, a wait over ``SHARD_TIMEOUT`` s or a non-zero exit fails the
    phase; ranks still running then are stopped."""
    import multiprocessing as mp

    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, str(store), nccl, requests, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in range(world):
            rank, res = queue.get(timeout=SHARD_TIMEOUT)
            _check(not isinstance(res, str), f"rank {rank} failed:\n{res}")
            ranks[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60 if len(ranks) == world else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    _check(all(p.exitcode == 0 for p in procs),
           f"rank exit codes {[p.exitcode for p in procs]}")
    return ranks


def _check_requests(res: dict, refs: dict, label: str) -> dict:
    """One rank's requests: none of ``SHARD_NEVER`` launched, a finite
    answer, B12/B13 on a gradient and the window kernels (B1b/B3b on a
    batch) on the rest, and the answer held to the single-device route's in
    *refs* where it has one (``TOL_SHARD_Z``, gradients ``TOL_SHARD_GRAD``);
    notes each request's ``delta`` and returns the launches summed."""
    total = dict.fromkeys(KERNELS, 0)
    for name, r in res["requests"].items():
        c = r["launches"]
        for k in total:
            total[k] += c[k]
        never = {k: c[k] for k in SHARD_NEVER if c[k]}
        _check(not never, f"{label} {name}: kernels the sharded route never runs launched: {never}")
        got = torch.as_tensor(r["answer"])
        _check(bool(torch.isfinite(got).all()), f"{label} {name}: non-finite answer")
        if name.endswith("grad"):
            _check(c["adjoint_step"] > 0 and c["adjoint_step_top"] > 0,
                   f"{label} {name}: no B12/B13 launch: {c}")
        else:
            fwd = (("window_apply_batch", "window_apply_top_batch") if name.startswith("batch")
                   else ("window_apply", "window_apply_top"))
            _check(all(c[k] > 0 for k in fwd), f"{label} {name}: no launch of {fwd}: {c}")
        r["delta"] = None
        if name in refs:
            ref = torch.as_tensor(refs[name]["answer"])
            _check(tuple(got.shape) == tuple(ref.shape),
                   f"{label} {name}: shape {tuple(got.shape)}, want {tuple(ref.shape)}")
            d = _maxdiff(got, ref)
            tol = (TOL_SHARD_GRAD[0] * ref.abs().max().item() + TOL_SHARD_GRAD[1]
                   if name.endswith("grad") else TOL_SHARD_Z)
            _check(d <= tol, f"{label} {name}: max|delta| from the single-device route "
                             f"= {d:.3e} > {tol:.3e}")
            r["delta"] = d
    return total


def _single_refs(model, dmodel) -> dict:
    """The single-device route's timings (``_timed``) of 5j's requests."""
    x = REQUESTS[0]
    batch = _shard_batch()
    work = {"fwd": lambda: model(inputs=x), "grad": lambda: _grad_request(model, x)[1],
            "batch": lambda: model(inputs=batch), "density expval": lambda: dmodel(inputs=x),
            "density probs": lambda: dmodel(inputs=x, execution_type="probs")}
    return {name: _timed(fn) for name, fn in work.items()}


def _check_shard(res: dict, refs: dict, label: str) -> dict:
    """Routes, launches and answers of one rank's 5j requests, each held to
    the single-device route; returns its launches summed over the requests."""
    for script, routes in res["routes"].items():
        _check(bool(routes) and all(r.split(" (")[0] in SHARD_ROUTES for _, r in routes),
               f"{label}: the {script} requests did not all take the sharded route: {routes}")
    missing = set(res["requests"]) - set(refs)
    _check(not missing, f"{label}: no single-device reference for {missing}")
    return _check_requests(res, refs, label)


def phase_shard(models: dict, dmodel, smi: str) -> dict:
    """The sharded route on the card: a one-rank NCCL group in this process
    (``state=1``: the route's plumbing, no exchange) and a group of
    ``SHARD_RANKS`` gloo processes sharing the card (``state=4``, exchanges
    staged through pinned host memory; ``data=2 x state=2``), each request
    held to the single-device route on the card.  Returns the launches of
    phase 5j's sharded requests, every rank's summed."""
    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, saved

    t_phase = time.perf_counter()
    log(f"phase 5j: the sharded route, 1 rank (NCCL) and {SHARD_RANKS} ranks (gloo, one card) "
        f"({smi}); gradients with float32 cotangents on both routes")
    lambda_mode = saved.LAMBDA_MODE
    saved.set_lambda_mode("f32")
    try:
        return _phase_shard(models, dmodel, parallel, ck, t_phase)
    finally:
        saved.set_lambda_mode(lambda_mode)


def _phase_shard(models: dict, dmodel, parallel, ck, t_phase: float) -> dict:
    import torch.distributed as dist

    model = models[WIDTHS[-1]]
    params = model.params.detach().cpu().numpy()
    dparams = dmodel.params.detach().cpu().numpy()
    refs = _single_refs(_shard_model(params), dmodel)
    store_dir = ROOT / "build" / "shard"
    store_dir.mkdir(parents=True, exist_ok=True)

    # One rank: NCCL on this process's card.
    store1 = store_dir / "store_1"
    store1.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store1}", rank=0, world_size=1)
    try:
        one = shard_requests(params, dparams, composed=False)
    finally:
        parallel.set_mesh(None)
        dist.destroy_process_group()
    launches = _check_shard(one, refs, "1 rank")

    # SHARD_RANKS gloo ranks on the same card (kernels already built above).
    ranks = _spawn(SHARD_RANKS, store_dir / f"store_{SHARD_RANKS}", False, shard_requests,
                   (params, dparams, True))
    for rank in sorted(ranks):
        c = _check_shard(ranks[rank], refs, f"rank {rank} of {SHARD_RANKS}")
        for k in launches:
            launches[k] += c[k]
    _check(all(r["staged"] for r in ranks.values()),
           "the gloo ranks' exchanges were not staged through host memory")

    r0 = ranks[0]
    log(f"  routes (rank 0 of {SHARD_RANKS}): {r0['routes']}")
    log(f"  {'request':<16}{'single ms':>11}{'1 rank ms':>11}{'4 ranks ms':>12}"
        f"{'exch/req':>10}{'MB sent/req':>13}{'max|delta| 1 / 4 ranks':>26}")
    for name, ref in refs.items():
        a = one["requests"].get(name)
        b = r0["requests"][name]
        mb = sum(ranks[k]["requests"][name]["bytes"] for k in ranks) / 1e6
        log(f"  {name:<16}{ref['ms']:>11.2f}{(a['ms'] if a else float('nan')):>11.2f}"
            f"{b['ms']:>12.2f}{b['exchanges']:>10d}{mb:>13.1f}"
            f"{(a['delta'] if a else float('nan')):>13.2e}{b['delta']:>13.2e}")
    log(f"  (4 ranks: gloo processes sharing one card, every exchange staged through pinned "
        f"host memory; 'MB sent/req' sums the ranks; the batch ran on data=2 x state=2, "
        f"the rest on state={SHARD_RANKS}; 1 rank: state=1, no exchange)")
    log(f"  launches over phase 5j's sharded requests (every rank): "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    for name in SHARD_NEVER:
        _check(launches[name] == 0, f"phase 5j launched {name}")
    ck.reset_launch_counts()
    log(f"  phase 5j took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 5k: the sharded route on four cards, one NCCL rank a card
# ---------------------------------------------------------------------------

CARDS = 4  # NCCL ranks of phase 5k, one a card
# 30 qubits: held to the single-device route on card 0.  32 qubits: a
# float32 register of 34.4 GB, whose adjoint gradient (psi and lambda, each
# written out of place) no card holds; held to a closed form and a central
# difference.
CARD_WIDTHS = (30, 32)
CARD_TIMEOUT = 300  # seconds a collective of the NCCL group may wait before the phase fails
# The ranks' allocator: the 32q gradient holds ~60 GB of 8.6 GB blocks and
# 256 MiB pieces, and expandable segments keep it from stranding the gaps.
CARD_ALLOC_CONF = "expandable_segments:True"
TOL_CLOSED = 1e-5  # 32q <Z> at the closed-form angles against closed_form_z
FD_DIRECTIONS = 2  # seeded unit directions of the 32q central difference (step FD_EPS)
TOL_CARD_FD = (1e-3, 2e-2)  # |fd - g.d| <= 1e-3 + 2e-2 |g.d|
CARD_DIR = ROOT / "build" / "cards"


def _card_model(n: int, params=None):
    """The float32 Circuit_19 model (N_LAYERS layers, seed SEED) at n qubits
    on the current card, with *params* loaded when given."""
    from qml_essentials_tpu_torch.models.model import Model

    model = Model(n_qubits=n, n_layers=N_LAYERS, circuit_type="Circuit_19", random_seed=SEED,
                  device=DEVICE)
    if params is not None:
        model.load_numpy(params)
    return model


def closed_form_params(shape: tuple, n: int) -> tuple:
    """Circuit_19 parameters of *shape* (``(..., layers, 3 n)``: a layer's
    RX angles, then its RZ and CRX angles) whose only non-zero angles are
    seeded RX angles, a different one for each qubit and layer; returns
    (the parameters, the RX angles ``(layers, n)``)."""
    rx = np.random.default_rng(SEED).uniform(-np.pi, np.pi, (shape[-2], n))
    p = np.zeros(shape)
    p[..., :n] = rx
    return p, rx


def closed_form_z(x: float, rx: np.ndarray) -> np.ndarray:
    """<Z_i> of the Circuit_19 model at ``closed_form_params``: RZ(0) and
    CRX(0) are identities, so qubit i sees only rotations about X, its
    N_LAYERS encodings RX(x) (data reuploading) and its angles rx[:, i]:
    <Z_i> = cos(N_LAYERS x + sum_l rx[l, i]), different on every qubit."""
    return np.cos(N_LAYERS * x + rx.sum(axis=0))


def card_requests(params: dict, dparams, directions: list) -> dict:
    """This rank's phase 5k requests, the same on every rank: the 30q and
    32q models' forward and forward + gradient on a ``state`` mesh over
    every rank (30q with float32 cotangents, as the single-device route it
    is held to; 32q with the default bfloat16 lambda), 5j's 24q batch on
    ``data=2 x state=2`` with each batched exchange form, and the 13q
    density expval and probs on the ``state`` mesh, each timed by
    ``_timed`` under a device watch.  Then the 32q model at
    ``closed_form_params``, at the seeded parameters moved +-FD_EPS along
    each of *directions*, and (rank 0) one forward under the profiler.
    Returns per request its timing, the rank's card, group and route logs,
    and the checks' inputs."""
    import torch.distributed as dist

    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.ops import saved
    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    rank, world = dist.get_rank(), dist.get_world_size()
    x = REQUESTS[0]
    n30, n32 = CARD_WIDTHS
    models = {n: _card_model(n, params[n]) for n in CARD_WIDTHS}
    m24 = _shard_model(params[WIDTHS[-1]])
    dmodel = density_model(DENSITY_NOISE)
    dmodel.load_numpy(dparams)
    meshes = {"state": parallel.make_mesh((world,), ("state",)),
              "composed": parallel.make_mesh((2, world // 2), ("data", "state"))}
    batch = _shard_batch()
    requests = [
        (f"{n30}q fwd", "state", lambda: models[n30](inputs=x), "f32", "a2a", n30),
        (f"{n30}q grad", "state", lambda: _grad_request(models[n30], x)[1], "f32", "a2a", n30),
        (f"{n32}q fwd", "state", lambda: models[n32](inputs=x), "bf16", "a2a", n32),
        (f"{n32}q grad", "state", lambda: _grad_request(models[n32], x)[1], "bf16", "a2a", n32),
        ("batch", "composed", lambda: m24(inputs=batch), "f32", "a2a", None),
        ("batch (ppermute)", "composed", lambda: m24(inputs=batch), "f32", "ppermute", None),
        ("density expval", "state", lambda: dmodel(inputs=x), "f32", "a2a", None),
        ("density probs", "state", lambda: dmodel(inputs=x, execution_type="probs"), "f32",
         "a2a", None),
    ]
    out = {"requests": _run_requests(requests, meshes, watch=True),
           "card": torch.cuda.current_device(), "backend": dist.get_backend(),
           "name": torch.cuda.get_device_name()}

    # The 32q checks: the closed form, the central difference along each
    # direction, and rank 0's traced forward (every rank runs it: its
    # exchanges are collectives).
    parallel.set_mesh(meshes["state"])
    lambda_mode = saved.LAMBDA_MODE
    saved.set_lambda_mode("bf16")
    try:
        m = models[n32]
        p = np.asarray(params[n32], dtype=np.float64)
        with torch.no_grad():
            p0, out["closed_rx"] = closed_form_params(p.shape, n32)
            m.load_numpy(p0)
            out["closed"] = m(inputs=x).float().cpu().numpy()
            g = out["requests"][f"{n32}q grad"]["answer"].astype(np.float64)
            fd = []
            for d in directions:
                f = []
                for sign in (1.0, -1.0):
                    m.load_numpy(p + sign * FD_EPS * d)
                    f.append(float(m(inputs=x).double().mean()))
                fd.append(((f[0] - f[1]) / (2 * FD_EPS), float((g * d).sum())))
            out["fd"] = fd
            m.load_numpy(p)
            if rank == 0:
                out["trace"] = _traced(f"cards_{n32}q_fwd_rank0", lambda: m(inputs=x))
            else:
                m(inputs=x)
                torch.cuda.synchronize()
    finally:
        parallel.set_mesh(None)
        saved.set_lambda_mode(lambda_mode)
    out["routes"] = {f"{n}q": list(models[n].script.sharding_decisions) for n in CARD_WIDTHS}
    out["routes"]["batch"] = list(m24.script.sharding_decisions)
    out["routes"]["density"] = list(dmodel.script.sharding_decisions)
    out["staged"] = ss._Axis(meshes["state"], "state").staged
    dist.barrier()
    return out


def _card_refs(params: dict, dparams) -> tuple:
    """The single-device route on card 0 for phase 5k's requests: the 30q
    forward and gradient (float32 cotangent), 5j's batch and density
    requests, and the 32q forward under ``no_grad`` if it fits.  Returns
    (refs, what became of the 32q forward)."""
    import gc

    from qml_essentials_tpu_torch.ops import saved

    x = REQUESTS[0]
    n30, n32 = CARD_WIDTHS
    refs = {}
    lambda_mode = saved.LAMBDA_MODE
    saved.set_lambda_mode("f32")
    try:
        model = _card_model(n30, params[n30])
        refs[f"{n30}q fwd"] = _timed(lambda: model(inputs=x))
        refs[f"{n30}q grad"] = _timed(lambda: _grad_request(model, x)[1])
        del model
        m24 = _shard_model(params[WIDTHS[-1]])
        dmodel = density_model(DENSITY_NOISE)
        dmodel.load_numpy(dparams)
        batch = _shard_batch()
        refs["batch"] = refs["batch (ppermute)"] = _timed(lambda: m24(inputs=batch))
        refs["density expval"] = _timed(lambda: dmodel(inputs=x))
        refs["density probs"] = _timed(lambda: dmodel(inputs=x, execution_type="probs"))
        del m24, dmodel
    finally:
        saved.set_lambda_mode(lambda_mode)
    gc.collect()
    torch.cuda.empty_cache()
    model = _card_model(n32, params[n32])
    try:
        with torch.no_grad():
            refs[f"{n32}q fwd"] = _timed(lambda: model(inputs=x))
        fits = f"fits on card 0: {refs[f'{n32}q fwd']['ms']:.2f} ms"
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError, or CUDA's own out-of-memory
        if not isinstance(e, torch.cuda.OutOfMemoryError) and "out of memory" not in str(e):
            raise
        fits = "does not fit on card 0 (" + str(e).splitlines()[0][:200] + ")"
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return refs, fits


def _check_card(res: dict, refs: dict, rank: int) -> dict:
    """One rank's phase 5k: its card and group, routes, devices, B16 where
    a forward rotates, the whole-register check, ``_check_requests`` and
    the 32q checks; returns its launches summed over the requests."""
    label = f"rank {rank} of {CARDS}"
    n32 = CARD_WIDTHS[-1]
    _check(res["card"] == rank, f"{label}: current card cuda:{res['card']}")
    _check(res["backend"] == "nccl" and not res["staged"],
           f"{label}: backend {res['backend']}, staged {res['staged']}: not NCCL card to card")
    for script, routes in res["routes"].items():
        want = "sharded:density" if script == "density" else "sharded:state"
        _check(bool(routes) and all(r in (want, "sharded:cached") for _, r in routes),
               f"{label}: the {script} requests did not all take {want}: {routes}")
    for name, r in res["requests"].items():
        _check(r["devices"] == [f"cuda:{rank}"],
               f"{label} {name}: card tensors on {r['devices']}, not only cuda:{rank}")
        if r["n"] is not None:
            _check(r["largest"][0] < 2 * 2 ** r["n"],
                   f"{label} {name}: a tensor of {r['largest'][0]} elements ({r['largest'][1]}), "
                   f"the whole {r['n']}q register or more")
        if name.endswith("grad"):
            c, fwd = r["launches"], res["requests"][name.replace("grad", "fwd")]["launches"]
            _check(c["rotate_pair"] > 0 or fwd["rotate"] == 0,
                   f"{label} {name}: no B16 launch where the forward rotates: {c}")
    total = _check_requests(res, refs, label)
    fwd32 = res["requests"][f"{n32}q fwd"]["answer"]
    _check(fwd32.shape == (n32,), f"{label}: the {n32}q forward's shape is {fwd32.shape}")
    res["closed_err"] = float(np.abs(res["closed"] - closed_form_z(REQUESTS[0],
                                                                    res["closed_rx"])).max())
    _check(res["closed_err"] <= TOL_CLOSED,
           f"{label}: {n32}q <Z> at the closed-form angles is {res['closed_err']:.3e} from "
           f"cos(L x + sum of each qubit's RX angles)")
    for fd, gd in res["fd"]:
        tol = TOL_CARD_FD[0] + TOL_CARD_FD[1] * abs(gd)
        _check(abs(fd - gd) <= tol, f"{label}: {n32}q central difference {fd:.6e} against "
                                    f"g.d {gd:.6e} (tolerance {tol:.3e})")
    return total


def _nccl_transports() -> dict:
    """How NCCL connected the ranks, from its INIT logs: counts of the
    channel lines by transport (``via P2P/...``, ``via SHM/...``, ``via NET/...``)."""
    import re

    out = {}
    for path in sorted(CARD_DIR.glob("nccl.*.log")):
        for line in path.read_text(errors="replace").splitlines():
            m = re.search(r"\bvia (\S+)", line)
            if m:
                out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def phase_cards(models: dict, dmodel, smi: str) -> dict:
    """The sharded route on four cards: ``CARDS`` spawned NCCL ranks, rank r
    on card r, every exchange card to card; each request held to the
    single-device route on card 0 where one card holds it, the 32q register
    to a closed form and a central difference.  With fewer cards it says
    so and runs nothing.  Returns the launches of phase 5k's requests,
    every rank's summed."""
    launches = dict.fromkeys(KERNELS, 0)
    count = torch.cuda.device_count()
    if count < CARDS:
        log(f"phase 5k: the sharded route on {CARDS} cards, one NCCL rank a card, needs {CARDS} "
            f"cards; this machine shows {count}: not run")
        return launches
    t_phase = time.perf_counter()
    n30, n32 = CARD_WIDTHS
    log(f"phase 5k: the sharded route on {CARDS} cards, one NCCL rank a card ({smi}): "
        f"{n30}q and {n32}q Circuit_19 forward and forward + gradient on state={CARDS}, the 24q "
        f"batch of {SHARD_BATCH} on data=2 x state={CARDS // 2}, the {DENSITY_N}q density")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    for line in (topo.stdout.splitlines() if topo.returncode == 0 else ["(not available)"]):
        log(f"  topo: {line}")
    return _phase_cards(models, dmodel, launches, smi, t_phase)


def _phase_cards(models: dict, dmodel, launches: dict, smi: str, t_phase: float) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    n30, n32 = CARD_WIDTHS
    params = {n: _card_model(n).params.detach().cpu().numpy() for n in CARD_WIDTHS}
    params[WIDTHS[-1]] = models[WIDTHS[-1]].params.detach().cpu().numpy()
    dparams = dmodel.params.detach().cpu().numpy()
    rng = np.random.default_rng(SEED)
    directions = []
    for _ in range(FD_DIRECTIONS):
        d = rng.standard_normal(params[n32].shape)
        directions.append(d / np.linalg.norm(d))
    refs, fits = _card_refs(params, dparams)
    log(f"  single-device references on card 0 (best of {SHARD_REPS}): "
        + ", ".join(f"{k} {v['ms']:.2f} ms" for k, v in refs.items()))
    log(f"  the {n32}q forward on one card (no_grad): {fits}")
    free, total = torch.cuda.mem_get_info(0)
    log(f"  card 0 before the ranks start: {free / 1e9:.2f} of {total / 1e9:.2f} GB free, this "
        f"process holding {torch.cuda.memory_allocated(0) / 1e9:.3f} GB")

    CARD_DIR.mkdir(parents=True, exist_ok=True)
    for old in CARD_DIR.glob("nccl.*.log"):
        old.unlink()
    ranks = _spawn(CARDS, CARD_DIR / "store", True, card_requests, (params, dparams, directions))
    for rank in sorted(ranks):
        c = _check_card(ranks[rank], refs, rank)
        for k in launches:
            launches[k] += c[k]

    r0 = ranks[0]
    log(f"  ranks' cards: {[ranks[r]['card'] for r in sorted(ranks)]} "
        f"({', '.join(sorted({ranks[r]['name'] for r in ranks}))}); backend "
        f"{r0['backend']}, exchanges staged: {r0['staged']}")
    log(f"  NCCL's channels by transport (its INIT logs, all ranks): {_nccl_transports()}")
    log(f"  routes (rank 0): {r0['routes']}")
    log(f"  {'request':<18}{'1 card ms':>11}{'4 cards ms':>12}{'first ms':>11}{'exch/req':>10}"
        f"{'GB sent/req':>13}{'max|delta|':>12}  peak GB a rank (ranks 0-3)")
    for name, r in r0["requests"].items():
        ref = refs.get(name)
        gb = sum(ranks[k]["requests"][name]["bytes"] for k in ranks) / 1e9
        deltas = [ranks[k]["requests"][name]["delta"] for k in ranks]
        delta = max(deltas) if None not in deltas else float("nan")
        peaks = " / ".join(f"{ranks[k]['requests'][name]['peak'] / 1e9:.2f}" for k in sorted(ranks))
        log(f"  {name:<18}{(ref['ms'] if ref else float('nan')):>11.2f}{r['ms']:>12.2f}"
            f"{r['first_ms']:>11.1f}{r['exchanges']:>10d}{gb:>13.3f}{delta:>12.2e}  {peaks}")
    log(f"  ('4 cards ms': rank 0, best of {SHARD_REPS} after the call that builds the program; "
        f"'GB sent/req' sums the ranks; 'max|delta|' over the ranks, from the single-device "
        f"route on card 0; nan: no card holds the request; the {n32}q gradient with the default "
        f"bf16 lambda, the {n30}q one with float32 cotangents on both routes; the ranks' "
        f"allocator {CARD_ALLOC_CONF})")
    for name, r in r0["requests"].items():
        if r["n"] is not None:
            most = max(ranks[k]["requests"][name]["largest"][0] for k in ranks)
            log(f"  {name}: the largest tensor a rank made has {most} elements (the whole "
                f"register {2 * 2 ** r['n']})")
    log(f"  {n32}q at seeded RX angles, every other angle zero: max|<Z_i> - cos({N_LAYERS} x + "
        f"sum_l rx[l, i])| over the ranks {max(ranks[k]['closed_err'] for k in ranks):.3e} "
        f"(<= {TOL_CLOSED})")
    for i, (fd, gd) in enumerate(r0["fd"]):
        log(f"  {n32}q central difference, direction {i}: {fd:.6e} against g.d {gd:.6e} "
            f"(|delta| {abs(fd - gd):.3e})")
    t = r0["trace"]
    _log_trace(f"rank 0's traced {n32}q forward", t, smi)
    if t["busy_ms"] is not None:
        nccl = sum(us for k, (_, us) in t["by_name"].items() if "nccl" in k.lower()) / 1e3
        alls = sum(us for _, us in t["by_name"].values()) / 1e3
        log(f"  rank 0's {n32}q forward: NCCL kernels {nccl:.3f} of {alls:.3f} ms of kernel time, "
            f"share {nccl / alls:.4f}")
    log(f"  launches over phase 5k's requests (every rank): "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    for name in SHARD_NEVER:
        _check(launches[name] == 0, f"phase 5k launched {name}")
    ck.reset_launch_counts()
    log(f"  phase 5k took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: times
# ---------------------------------------------------------------------------


_CYCLES_PER_MS = []


def _hold_stream(ms: float) -> None:
    """Keeps the current stream busy for about ms on the device (a spinning
    kernel), so that what the host queues meanwhile runs back to back."""
    if not _CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**6)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10**6 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def _events_ms(fn, reps: int = 10, trials: int = 3, hold: bool = False) -> float:
    """Best-of-trials mean device time of fn() in ms (CUDA events).  With
    `hold` (a diagnostic, used by no kernel row) the reps calls are queued
    behind a spin that outlasts their host time, so that a call whose launch
    costs the host more than its kernel costs the card is timed on the card."""
    fn()
    torch.cuda.synchronize()
    host_ms = 0.0
    if hold:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            _hold_stream(2 * reps * host_ms + 0.1)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _both_us(fn) -> str:
    """fn()'s time as phase 6 takes it, and held behind a spin (diagnostic)."""
    return f"{_events_ms(fn) * 1e3:.1f} us (held {_events_ms(fn, hold=True) * 1e3:.1f})"


def _host_ms(fn, reps: int = 3) -> tuple:
    """Host-clock ms of fn() ending in a synchronise, over reps runs; returns
    (best, median, last result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), float(np.median(times)), out


def _log_breakdown(model, n: int) -> None:
    """Where one forward request's time goes: recording the tape (gate
    matrices on the card), planning (window composition, layout DP,
    re-fusion) and running the plan (the kernels) plus the readout."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    rec_ms, _, tape = _host_ms(lambda: model.script._record(model.params, inputs,
                                                            enc_params=model.enc_params))
    plan_ms, _, (plan, start) = _host_ms(lambda: simulation.scheduled_plan(tape, n, device=DEVICE))

    def run():
        psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
        for kind, payload, wires in plan:
            psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
        return simulation.measure_state_ri(psi2, n, meas_type, obs)

    run_ms, _, _ = _host_ms(run)
    # The request's plan as the Script's cache serves it: the structure
    # cached, the payloads recomposed from the tape (ops/recipes.py).
    slot = simulation.PlanSlot()
    slot.get("pure", simulation._pure_build(n, torch.float32, DEVICE), tape)
    hit_ms, _, _ = _host_ms(lambda: slot.get("pure", None, tape))
    log(f"    forward breakdown {n}q: record {rec_ms:.3f} ms, plan {plan_ms:.3f} ms (from the "
        f"plan cache {hit_ms:.3f} ms), run {len(plan)} steps + readout {run_ms:.3f} ms")


def _log_grad_breakdown(model, n: int, executor: str = "saved") -> None:
    """Where one forward + gradient request's time goes: record, plan, the
    executor's forward run (``"saved"`` or ``"adjoint"``) plus the readout,
    and the backward run (the executor's reverse walk and autograd back
    through the window composition and the outer-product start to the
    parameters)."""
    from qml_essentials_tpu_torch.ops import adjoint, kernels, saved, simulation

    run_plan = {"saved": saved.execute_plan_saved_ri, "adjoint": adjoint.execute_plan_ri}[executor]

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    parts = {"record": [], "plan": [], "forward run": [], "backward run": []}
    for _ in range(4):
        model.params.grad = None
        t = [time.perf_counter()]
        tape = model.script._record(model.params, inputs, enc_params=model.enc_params)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plan, start = simulation.scheduled_plan(tape, n, device=DEVICE)
        static, payloads = adjoint.normalize_plan(plan, n)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if start is None:
            start = kernels.zero_state_ri(n, device=DEVICE)
        psi2 = run_plan(start, payloads, static, n)
        loss = simulation.measure_state_ri(psi2, n, meas_type, obs).mean()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for (name, acc), t0, t1 in zip(parts.items(), t, t[1:]):
            acc.append((t1 - t0) * 1e3)
    best = {name: min(v[1:]) for name, v in parts.items()}  # first run is the warm-up
    log(f"    fwd+grad breakdown {n}q, {executor} executor (best of 3): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in best.items())
        + f"; {len(plan)} steps")


def _grad_times(model, inputs, what: str, median: bool = False) -> None:
    """fwd+grad ms of one request or batch: warm-up, best of 3 (and the
    median of 10)."""
    _grad_request(model, inputs)
    torch.cuda.synchronize()
    best, _, _ = _host_ms(lambda: _grad_request(model, inputs))
    extra = ""
    if median:
        _, med, _ = _host_ms(lambda: _grad_request(model, inputs), reps=10)
        extra = f" (median of 10: {med:.3f} ms)"
    log(f"  forward + gradient {what}: {best:.3f} ms{extra}")


def _adjoint_times(models: dict, model26, batch: list) -> None:
    from qml_essentials_tpu_torch.ops import saved, simulation

    n = WIDTHS[-1]
    saved.set_lambda_mode("bf16")
    simulation.set_backward_mode("adjoint")
    _grad_times(models[n], REQUESTS[0],
                f"{n}q Circuit_19 L={N_LAYERS}, adjoint forced (bf16 lambda), per request",
                median=True)
    _log_grad_breakdown(models[n], n, "adjoint")
    for mode, label in (("adjoint", "adjoint forced"), ("autodiff", "saved forced")):
        simulation.set_backward_mode(mode)
        _grad_times(model26, REQUESTS[0],
                    f"{WIDE}q Circuit_19 L={N_LAYERS}, {label} (bf16 lambda), per request",
                    median=True)
    simulation.set_backward_mode("auto")
    _grad_times(models[n], batch,
                f"{n}q Circuit_19 L={N_LAYERS}, a batch of {len(batch)} under auto (adjoint, "
                f"bf16 lambda), per batch")


def _plan_run(model, n: int):
    """The forward plan of one request as a function that runs its steps on
    the card (inference mode), and the number of steps."""
    from qml_essentials_tpu_torch.ops import kernels, simulation

    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)
    with torch.inference_mode():
        tape = model.script._record(model.params, inputs, enc_params=model.enc_params)
        plan, start = simulation.scheduled_plan(tape, n, device=DEVICE)

    def run():
        with torch.inference_mode():
            psi2 = start if start is not None else kernels.zero_state_ri(n, device=DEVICE)
            for kind, payload, wires in plan:
                psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n)
            return psi2

    return run, len(plan)


def _ab_times(model, n: int) -> None:
    """24q requests with FUSE_LAYOUT_ROT off and on, in turns (off, on, on,
    off): each turn the median of 10 after a warm-up for a forward, a saved
    fwd+grad and an adjoint fwd+grad (bf16 lambda), and the device time of
    one forward plan's steps (CUDA events, best of 3 means of 10)."""
    from qml_essentials_tpu_torch.ops import saved, simulation

    saved.set_lambda_mode("bf16")
    rows = {False: [], True: []}

    def fwd():
        with torch.inference_mode():
            return model(inputs=REQUESTS[0])

    for on in (False, True, True, False):
        with fusion(on):
            run, steps = _plan_run(model, n)
            plan_ms = _events_ms(run)
            row = [plan_ms]
            for mode in (None, "autodiff", "adjoint"):
                if mode is not None:
                    simulation.set_backward_mode(mode)
                fn = fwd if mode is None else (lambda: _grad_request(model, REQUESTS[0]))
                fn()
                torch.cuda.synchronize()
                row.append(_host_ms(fn, reps=10)[1])
            simulation.set_backward_mode("auto")
        rows[on].append(row)
        log(f"  A/B {n}q flag {'on ' if on else 'off'} ({steps} steps): forward plan on the "
            f"device {row[0]:.3f} ms; median of 10: forward {row[1]:.3f} ms, saved fwd+grad "
            f"{row[2]:.3f} ms, adjoint fwd+grad {row[3]:.3f} ms")
    for on in (False, True):
        mean = np.mean(rows[on], axis=0)
        log(f"  A/B {n}q flag {'on ' if on else 'off'}, mean of its two turns: forward plan "
            f"{mean[0]:.3f} ms, forward {mean[1]:.3f} ms, saved fwd+grad {mean[2]:.3f} ms, "
            f"adjoint fwd+grad {mean[3]:.3f} ms")


def _chain_ab_times(model, n: int) -> None:
    """24q requests with USE_CHAINS off and on, in turns (off, on, on, off):
    each turn the device time of one forward plan's steps (CUDA events, best
    of 3 means of 10) and the median of 10 after a warm-up for a forward and
    a forced-adjoint fwd+grad (bf16 lambda, which a chain step casts to
    float32)."""
    from qml_essentials_tpu_torch.ops import saved, simulation

    saved.set_lambda_mode("bf16")
    rows = {False: [], True: []}

    def fwd():
        with torch.inference_mode():
            return model(inputs=REQUESTS[0])

    for on in (False, True, True, False):
        with chain_route(on):
            run, steps = _plan_run(model, n)
            row = [_events_ms(run)]
            simulation.set_backward_mode("adjoint")
            for fn in (fwd, lambda: _grad_request(model, REQUESTS[0])):
                fn()
                torch.cuda.synchronize()
                row.append(_host_ms(fn, reps=10)[1])
            simulation.set_backward_mode("auto")
        rows[on].append(row)
        log(f"  chains A/B {n}q flag {'on ' if on else 'off'} ({steps} steps): forward plan on "
            f"the device {row[0]:.3f} ms; median of 10: forward {row[1]:.3f} ms, adjoint "
            f"fwd+grad {row[2]:.3f} ms")
    for on in (False, True):
        mean = np.mean(rows[on], axis=0)
        log(f"  chains A/B {n}q flag {'on ' if on else 'off'}, mean of its two turns: forward "
            f"plan {mean[0]:.3f} ms, forward {mean[1]:.3f} ms, adjoint fwd+grad {mean[2]:.3f} ms")


def _density_times(model, smi: str) -> None:
    """The 13q noisy density model's requests: forward (expval) and forward
    + gradient (saved executor, bf16 lambda), best of 3 and median of 10,
    with their peak memory; where a request's time goes (record, plan, run
    for a forward; record, plan, forward run, backward run for a gradient);
    the forward plan's device time (CUDA events, best of 3 means of 10)."""
    from qml_essentials_tpu_torch.ops import adjoint, kernels, saved, simulation

    n2 = 2 * DENSITY_N
    saved.set_lambda_mode("bf16")
    log(f"  {DENSITY_N}q noisy density model, {DENSITY_NOISE} ({smi}):")

    def fwd():
        with torch.inference_mode():
            return model(inputs=REQUESTS[0])

    fwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best, _, _ = _host_ms(fwd)
    peak = torch.cuda.max_memory_allocated()
    _, med, _ = _host_ms(fwd, reps=10)
    log(f"  forward {DENSITY_N}q noisy density Circuit_19 L={N_LAYERS}: {best:.3f} ms per request "
        f"(median of 10: {med:.3f} ms); peak {peak / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    _grad_times(model, REQUESTS[0], f"{DENSITY_N}q noisy density Circuit_19 L={N_LAYERS} (saved, "
                f"bf16 lambda), per request", median=True)
    log(f"    fwd+grad peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    meas_type, obs = model._build_obs()
    inputs = torch.tensor([[REQUESTS[0]]], device=DEVICE)

    def record():
        return model.script._record(model.params, inputs, enc_params=model.enc_params,
                                    random_key=torch.Generator().manual_seed(SEED),
                                    noise_params=model.noise_params)

    with torch.inference_mode():
        rec_ms, _, tape = _host_ms(record)
        plan_ms, _, (plan, start) = _host_ms(lambda: density_plan(tape))

        def run():
            psi2 = start if start is not None else kernels.zero_state_ri(n2, device=DEVICE)
            for kind, payload, wires in plan:
                psi2 = simulation._apply_step_ri(psi2, kind, payload, wires, n2)
            return psi2

        run_ms, _, _ = _host_ms(
            lambda: simulation._measure_interleaved_ri(run(), DENSITY_N, meas_type, obs))
        dev_ms = _events_ms(run)
    log(f"    forward breakdown {DENSITY_N}q density: record {rec_ms:.3f} ms, plan (lower + "
        f"interleaved plan) {plan_ms:.3f} ms, run {len(plan)} steps + readout {run_ms:.3f} ms; "
        f"the plan on the device {dev_ms:.3f} ms (CUDA events)")

    parts = {"record": [], "plan": [], "forward run": [], "backward run": []}
    for _ in range(4):
        model.params.grad = None
        t = [time.perf_counter()]
        tape = record()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plan, start = density_plan(tape)
        static, payloads = adjoint.normalize_plan(plan, n2)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        psi2 = start if start is not None else kernels.zero_state_ri(n2, device=DEVICE)
        psi2 = saved.execute_plan_saved_ri(psi2, payloads, static, n2)
        loss = simulation._measure_interleaved_ri(psi2, DENSITY_N, meas_type, obs).mean()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for (name, acc), t0, t1 in zip(parts.items(), t, t[1:]):
            acc.append((t1 - t0) * 1e3)
    log(f"    fwd+grad breakdown {DENSITY_N}q density, saved executor (best of 3): "
        + ", ".join(f"{k} {min(v[1:]):.3f} ms" for k, v in parts.items()))
    _density_kernel_times()


def _density_kernel_times() -> None:
    """Device time of each kernel call of one 13q density forward and one
    saved gradient (bf16 lambda) at the plan's shapes, summed per kernel
    beside its library yardstick (phase 6's: cuBLAS complex64 products of
    the same shapes, a transpose copy for a rotation) and its bound as phase
    6 takes it (CUDA events, best of 3 means of 10, random unitary windows)."""
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck

    n2 = 2 * DENSITY_N
    steps = density_shapes(DENSITY_NOISE)["steps"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    x, g = _state(n2, gen), _state(n2, gen)
    rows = {}

    def add(name, fn, lib, work, tc=None):
        flop_ms = work[0] / PEAK_FP32 if tc is None else tc[0] / PEAK_TF32 + tc[1] / PEAK_FP32
        ms, lib_ms, bound = rows.get(name, (0.0, 0.0, 0.0))
        rows[name] = (ms + _events_ms(fn), lib_ms + _events_ms(lib),
                      bound + max(flop_ms, work[1] / PEAK_HBM) * 1e3)

    def window_k(kind, shape):
        if kind in ("win", "top"):
            return shape
        return 0, (shape[1] if kind == "rotwin" else n2 - shape)

    with torch.inference_mode():
        for kind, shape in steps:
            if kind == "rot":
                add("rotate", lambda: ck.rotate(x, shape, n2), lib_rotate(x, shape, n2),
                    work_rotate(n2, 4))
                continue
            a, k = window_k(kind, shape)
            w, K = _unitary(k, rng), 2**k
            fn, lib = {
                "win": (lambda: ck.window_apply(x, w, a, k, n2), lambda: lib_window(x, w, a, k, n2)),
                "top": (lambda: ck.window_apply_top(x, w, k, n2),
                        lambda: lib_window_top(x, w, k, n2)),
                "rotwin": (lambda: ck.rotwin_apply(x, w, shape[0], k, n2),
                           lambda: lib_rotwin(ck, x, w, shape[0], k, n2)),
                "rotmat": (lambda: ck.rotmat_apply(x, w, shape, n2),
                           lambda: lib_rotmat(x, w, shape, n2)),
                "matrot": (lambda: ck.matrot_apply(x, w, shape, n2),
                           lambda: lib_matrot(x, w, shape, n2)),
            }[kind]
            name = {"win": "window_apply", "top": "window_apply_top"}.get(kind, f"{kind}_apply")
            add(name, fn, lib(), work_fwd(K, n2), work_fwd_tc(K, n2))
        fwd = dict(rows)
        rows.clear()
        for kind, shape, g_dt, out_dt in backward_calls(steps):
            gg, eg, eo = g.to(g_dt), _esize(g_dt), _esize(out_dt)
            if kind == "rot":
                r = (n2 - shape) % n2
                add("rotate", lambda: ck.rotate(gg, r, n2), lib_rotate(gg, r, n2),
                    work_rotate(n2, eg))
                continue
            a, k = window_k(kind, shape)
            w, K = _unitary(k, rng), 2**k
            fn, lib = {
                "win": (lambda: ck.window_apply_bwd(w, gg, x, a, k, n2, out_dt),
                        lambda: lib_window_bwd(w, gg, x, a, k, n2)),
                "top": (lambda: ck.window_apply_top_bwd(w, gg, x, k, n2, out_dt),
                        lambda: lib_window_top_bwd(w, gg, x, k, n2)),
                "rotwin": (lambda: ck.rotwin_apply_bwd(w, gg, x, shape[0], k, n2, out_dt),
                           lambda: lib_rotwin_bwd(ck, w, gg, x, shape[0], k, n2)),
                "rotmat": (lambda: ck.rotmat_apply_bwd(w, gg, x, shape, n2, out_dt),
                           lambda: lib_rotmat_bwd(w, gg, x, shape, n2)),
                "matrot": (lambda: ck.matrot_apply_bwd(w, gg, x, shape, n2, out_dt),
                           lambda: lib_matrot_bwd(w, gg, x, shape, n2)),
            }[kind]
            name = {"win": "window_apply_bwd", "top": "window_apply_top_bwd"}.get(
                kind, f"{kind}_apply_bwd")
            add(name, fn, lib(), work_bwd(K, n2, eg, eo), work_bwd_tc(K, n2, eg))
        bwd = dict(rows)

    def fmt(d):
        return (", ".join(f"{k} {ms:.3f} ms (library {lib:.3f}, bound {b:.3f})"
                          for k, (ms, lib, b) in d.items())
                + f"; sum {sum(v[0] for v in d.values()):.3f} ms (library "
                f"{sum(v[1] for v in d.values()):.3f}, bound {sum(v[2] for v in d.values()):.3f})")

    log(f"    {DENSITY_N}q density kernels per forward: {fmt(fwd)}")
    log(f"    {DENSITY_N}q density kernels per saved gradient's backward (bf16 lambda): {fmt(bwd)}")


# The yardstick of each kernel (library_ms): the cuBLAS complex64 product(s)
# of the same shapes through torch.matmul, on operands made from the
# kernel's own inputs before the clock starts (TF32 off); for a rotation, one
# transpose copy.  Each builder returns the timed function.


def _c(t: torch.Tensor) -> torch.Tensor:
    """A real-split pair as one complex64 tensor."""
    return torch.complex(t[0].float(), t[1].float())


def _h(m: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes, materialised."""
    return m.conj_physical().transpose(-2, -1).contiguous()


def lib_window(x, w, a, k, n):
    W, X = _c(w), _c(x).view(2**a, 2**k, -1)
    return lambda: W @ X


def lib_window_top(x, w, k, n):
    WT, X = _c(w).T.contiguous(), _c(x).view(-1, 2**k)
    return lambda: X @ WT


def lib_rotate(x, r, n):
    return lambda: x.view(2, 2 ** (n - r), 2**r).transpose(1, 2).contiguous()


def lib_rotate_pair(psi, lam, r, n):
    f, g = lib_rotate(psi, r, n), lib_rotate(lam, r, n)
    return lambda: (f(), g())


def lib_rotmat(x, w, r, n):
    W, XT = _c(w), _c(x).view(-1, 2**r).T.contiguous()
    return lambda: W @ XT


def lib_matrot(x, w, r, n):
    WT, XT = _c(w).T.contiguous(), _c(x).view(2 ** (n - r), -1).T.contiguous()
    return lambda: XT @ WT


def _rotwin_operands(ck, w, x, r, k):
    """W with permuted columns as (A, K, L) blocks, x_pre as (A, X, L)."""
    K, L = 2**k, 2**r
    W3 = _c(ck._rotwin_wperm(w, r, k)).view(K, K // L, L).permute(1, 0, 2).contiguous()
    return W3, _c(x).view(K // L, -1, L)


def lib_rotwin(ck, x, w, r, k, n):
    W3, X3 = _rotwin_operands(ck, w, x, r, k)
    X3T = X3.transpose(1, 2).contiguous()
    return lambda: (W3 @ X3T).sum(0)


def lib_window_bwd(w, g, x, a, k, n):
    WH, G = _h(_c(w)), _c(g).view(2**a, 2**k, -1)
    XH = _h(_c(x).view(2**a, 2**k, -1))
    return lambda: (WH @ G, (G @ XH).sum(0))


def lib_window_top_bwd(w, g, x, k, n):
    Wc, G = _c(w).conj_physical(), _c(g).view(-1, 2**k)
    GT, Xc = G.T.contiguous(), _c(x).view(-1, 2**k).conj_physical()
    return lambda: (G @ Wc, GT @ Xc)


def lib_rotmat_bwd(w, g, x, r, n):
    Wc, G = _c(w).conj_physical(), _c(g).view(2**r, -1)
    GT, Xc = G.T.contiguous(), _c(x).view(-1, 2**r).conj_physical()
    return lambda: (GT @ Wc, G @ Xc)


def lib_matrot_bwd(w, g, x, r, n):
    K = 2 ** (n - r)
    WH, GT, XH = _h(_c(w)), _c(g).view(-1, K).T.contiguous(), _h(_c(x).view(K, -1))
    return lambda: (WH @ GT, GT @ XH)


def lib_rotwin_bwd(ck, w, g, x, r, k, n):
    W3, X3 = _rotwin_operands(ck, w, x, r, k)
    W3H, G, X3c = _h(W3), _c(g).view(2**k, -1), X3.conj_physical()
    return lambda: (W3H @ G, G @ X3c)


def lib_adjoint(w, psi, lam, a, k, n):
    W, P, L = _c(w), _c(psi).view(2**a, 2**k, -1), _c(lam).view(2**a, 2**k, -1)
    WH, PH = _h(W), _h(P)
    return lambda: (WH @ P, WH @ L, (L @ PH).sum(0) @ W)


def lib_adjoint_top(w, psi, lam, k, n):
    W, P, L = _c(w), _c(psi).view(-1, 2**k), _c(lam).view(-1, 2**k)
    Wc, LT, Pc = W.conj_physical(), L.T.contiguous(), P.conj_physical()
    return lambda: (P @ Wc, L @ Wc, (LT @ Pc) @ W)


def lib_adjoint_rotmat(w, psi, lam, r, n):
    W, P, L = _c(w), _c(psi).view(2**r, -1), _c(lam).view(2**r, -1)
    Wc, PT, LT, PH = W.conj_physical(), P.T.contiguous(), L.T.contiguous(), _h(P)
    return lambda: (PT @ Wc, LT @ Wc, (L @ PH) @ W)


def lib_adjoint_matrot(w, psi, lam, r, n):
    K = 2 ** (n - r)
    W, P, L = _c(w), _c(psi).view(-1, K), _c(lam).view(-1, K)
    WH, PT, LT, Pc = _h(W), P.T.contiguous(), L.T.contiguous(), P.conj_physical()
    return lambda: (WH @ PT, WH @ LT, (LT @ Pc) @ W)


def _diag_operands(x, d, bits):
    """The state as one complex axis of 2 per pattern bit (MSB first)
    between the other bits' runs, and the diagonal shaped to broadcast."""
    shape, prev = [], int(math.log2(x.shape[-1]))
    for b in bits:
        shape += [2 ** (prev - b - 1), 2]
        prev = b
    return _c(x).view(*shape, 2**prev), _c(d).view(*[s for _ in bits for s in (1, 2)], 1)


def _chain_lib(x, lam, pairs, descs, n):
    """A chain step's yardstick: for each window the cuBLAS products of its
    forward (``lam`` None) or its adjoint step, for each diagonal the
    broadcast multiply (and the adjoint's masked sum), all on x."""
    fns = []
    for d, w in zip(descs, pairs):
        if d[0] == "diag":
            X, D = _diag_operands(x, w, d[1])
            if lam is None:
                fns.append(lambda X=X, D=D: X * D)
            else:
                L, _ = _diag_operands(lam, w, d[1])
                Dc, Xc = D.conj_physical(), X.conj_physical()
                dims = tuple(range(0, 2 * len(d[1]) + 1, 2))  # the other bits' runs
                fns.append(lambda X=X, L=L, Dc=Dc, Xc=Xc, dims=dims:
                           (X * Dc, L * Dc, (L * Xc).sum(dims)))
            continue
        lo, hi = d[1], d[2]
        a, k = n - hi, hi - lo
        if lam is None:
            fns.append(lib_window_top(x, w, k, n) if lo == 0 else lib_window(x, w, a, k, n))
        else:
            fns.append(lib_adjoint_top(w, x, lam, k, n) if lo == 0
                       else lib_adjoint(w, x, lam, a, k, n))
    return lambda: [f() for f in fns]


# Work of one call, for its bound: flops and bytes (each input read once,
# each output written once).  e*: bytes per element of a cotangent.
def work_fwd(K, n):
    return 8 * K * 2**n, 16 * 2**n + 8 * K * K


def work_fwd_tc(K, n):
    """The forward wgmma kernel's work: (tensor-core flops, CUDA-core flops).
    Its one product of two float32 operands issues 3 passes x 8K flops an
    amplitude; nothing on the CUDA cores."""
    return 3 * 8 * K * 2**n, 0


def work_bwd(K, n, eg, eo):
    return 16 * K * 2**n, 16 * K * K + 2 * 2**n * (eg + 4 + eo)


def work_adjoint(K, n, el, eo):
    return 24 * K * 2**n + 8 * K**3, 16 * K * K + 2 * 2**n * (8 + el + eo)


def work_adjoint_tc(K, n, el):
    """The split-TF32 adjoint step's work: (tensor-core flops, CUDA-core
    flops).  Its three products issue 8K flops an amplitude per pass: 3
    passes for float32 x float32, 2 when the bfloat16 lambda (exact in TF32)
    is one operand; gw = G0 W stays on the CUDA cores."""
    passes = 3 + 2 * (3 if el == 4 else 2)
    return passes * 8 * K * 2**n, 8 * K**3


def work_bwd_tc(K, n, eg):
    """The split-TF32 saved backward's work: (tensor-core flops, CUDA-core
    flops).  Its two products (pullback, gram) take 3 passes each with a
    float32 g, 2 with a bfloat16 g (exact in TF32); nothing on the CUDA
    cores."""
    passes = 2 * (3 if eg == 4 else 2)
    return passes * 8 * K * 2**n, 0


def work_rotate(n, e):
    return 0, 4 * 2**n * e


def work_rotate_pair(n, el):
    return 0, 4 * 2**n * (4 + el)


def work_chain_tc(descs, n, adjoint: bool):
    """The split-TF32 chain kernel's work: (tensor-core flops, CUDA-core
    flops).  Per window 3 passes x 8K flops an amplitude (B17's product) or
    9 (B18's gram and two pullbacks, float32 lambda); on the CUDA cores the
    diagonals (6 flops an amplitude, 20 for the adjoint) and B18's G0 W
    (8K^3)."""
    tc = cuda = 0
    for d in descs:
        if d[0] == "win":
            K = 2 ** (d[2] - d[1])
            tc += (9 if adjoint else 3) * 8 * K * 2**n
            cuda += 8 * K**3 if adjoint else 0
        else:
            cuda += (20 if adjoint else 6) * 2**n
    return tc, cuda


def work_chain(descs, n, adjoint: bool):
    """A chain step: per window 8K flops an amplitude (24K and the K^3
    product G0 W for the adjoint), per diagonal 6 (20: the masked sum and
    two multiplies); one read and one write of the state (two of each, psi
    and lambda, for the adjoint) and the payloads (and their cotangents)."""
    flops = bytes_ = 0
    for d in descs:
        if d[0] == "win":
            K = 2 ** (d[2] - d[1])
            flops += (24 * K * 2**n + 8 * K**3) if adjoint else 8 * K * 2**n
            bytes_ += 8 * K * K
        else:
            flops += (20 if adjoint else 6) * 2**n
            bytes_ += 8 * 2 ** len(d[1])
    return flops, (2 if adjoint else 1) * (16 * 2**n + bytes_)


def _esize(t: torch.dtype) -> int:
    return torch.empty((), dtype=t).element_size()


def lib_window_batch(x, w, a, k, n):
    """cuBLAS batched products of a batch entry's forward, complex64 (or
    complex128 for a float64 state): one ``bmm`` of the per-element windows
    (one product for a shared window)."""
    bt, K = x.shape[1], 2**k
    X = torch.complex(x[0], x[1]).view(bt, 2**a, K, -1).transpose(1, 2).reshape(
        bt, K, -1).contiguous()
    if w.dim() == 4:
        W = torch.complex(w[:, 0], w[:, 1]).contiguous()
        return lambda: torch.bmm(W, X)
    W, X2 = torch.complex(w[0], w[1]), X.transpose(0, 1).reshape(K, -1).contiguous()
    return lambda: W @ X2


def lib_window_batch_bwd(w, g, x, a, k, n):
    """The backward's products as cuBLAS complex64 calls: the pullback
    ``W^dag G`` and the gram ``G X^dag`` per element (``bmm``), or over the
    whole batch's columns for a shared window."""
    bt, K = x.shape[1], 2**k

    def cols(t):
        return _c(t).view(bt, 2**a, K, -1).transpose(1, 2).reshape(bt, K, -1).contiguous()

    G, X = cols(g), cols(x)
    if w.dim() == 4:
        WH = _h(torch.complex(w[:, 0], w[:, 1]))
        XH = _h(X)
        return lambda: (torch.bmm(WH, G), torch.bmm(G, XH))
    WH = _h(_c(w))
    G2, XH2 = G.transpose(0, 1).reshape(K, -1).contiguous(), _h(X.transpose(0, 1).reshape(K, -1))
    return lambda: (WH @ G2, G2 @ XH2)


def work_batch(K, n, bt, per_element, bwd, esize=4):
    """A batch entry's work: per element 8K flops an amplitude (16K for the
    backward's pullback and gram), one read and one write of the state (the
    backward reads g and x and writes gp) and the windows (and grams): one
    an element or one for the batch; esize bytes a value."""
    mats = bt if per_element else 1
    if bwd:
        return 16 * K * 2**n * bt, 6 * esize * 2**n * bt + 4 * esize * K * K * mats
    return 8 * K * 2**n * bt, 4 * esize * 2**n * bt + 2 * esize * K * K * mats


def phase_times(models: dict, model26, shapes: dict, batch: list, plans: dict, dmodel,
                smi: str, bshapes: dict) -> dict:
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    log("phase 6: times (host clock ending in a synchronise: best of 3 after a warm-up, "
        "and the median of 10; kernels: CUDA events, best of 3 after warm-up)")
    for n, model in models.items():
        with torch.inference_mode():
            model(inputs=REQUESTS[0])
            torch.cuda.synchronize()
            best, _, _ = _host_ms(lambda: model(inputs=REQUESTS[0]))
            _, med, _ = _host_ms(lambda: model(inputs=REQUESTS[0]), reps=10)
        log(f"  forward {n}q Circuit_19 L={N_LAYERS}: {best:.3f} ms per request "
            f"(median of 10: {med:.3f} ms)")
        _log_breakdown(model, n)
    for n, model in models.items():
        _grad_request(model, REQUESTS[0])
        torch.cuda.synchronize()
        best, _, _ = _host_ms(lambda: _grad_request(model, REQUESTS[0]))
        _, med, _ = _host_ms(lambda: _grad_request(model, REQUESTS[0]), reps=10)
        log(f"  forward + gradient {n}q Circuit_19 L={N_LAYERS} (bf16 lambda): {best:.3f} ms "
            f"per request (median of 10: {med:.3f} ms)")
        _log_grad_breakdown(model, n)
    _adjoint_times(models, model26, batch)
    _density_times(dmodel, smi)
    _ab_times(models[WIDTHS[-1]], WIDTHS[-1])
    _chain_ab_times(models[WIDTHS[-1]], WIDTHS[-1])

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flop_ms=0.0,
                         byte_ms=0.0, fp32_bound_ms=0.0) for name in KERNELS}

    def add(name, label, kern, plain, lib, work, tc=None):
        """Times one call; *tc* = (tensor-core flops, CUDA-core flops) of a
        split-TF32 kernel, whose bound then counts the tensor cores' rate."""
        t_k, t_p, t_l = _events_ms(kern), _events_ms(plain), _events_ms(lib)
        fp32_ms, byte_ms = work[0] / PEAK_FP32 * 1e3, work[1] / PEAK_HBM * 1e3
        flop_ms = fp32_ms if tc is None else (tc[0] / PEAK_TF32 + tc[1] / PEAK_FP32) * 1e3
        tot = totals[name]
        tot["ms"] += t_k
        tot["plain_ms"] += t_p
        tot["library_ms"] += t_l
        tot["bound_ms"] += max(flop_ms, byte_ms)
        tot["flop_ms"] += flop_ms
        tot["byte_ms"] += byte_ms
        tot["fp32_bound_ms"] += max(fp32_ms, byte_ms)
        rate = f"  {work[0] / t_k / 1e9:6.1f} TFLOP/s" if work[0] else \
            f"  {work[1] / t_k / 1e9:6.2f} TB/s"
        if tc is not None:
            rate += f" (fp32-core bound {max(fp32_ms, byte_ms) * 1e3:.1f} us)"
        log(f"  {name:20s} {label:36s} kernel {t_k * 1e3:9.1f} us  plain {t_p * 1e3:9.1f} us  "
            f"library {t_l * 1e3:9.1f} us  bound {max(flop_ms, byte_ms) * 1e3:8.1f} us{rate}")

    with torch.inference_mode():
        n, m = WIDTHS[-1], WIDTHS[0]
        x, g = _state(n, gen), _state(n, gen)
        # One 24q forward, step by step.
        for kind, shape in shapes[n]["steps"]:
            if kind == "top":
                continue  # top windows are timed at the narrower width
            if kind == "rot":
                add("rotate", f"n={n} r={shape} float32", lambda: ck.rotate(x, shape, n),
                    lambda: kn.rotate_plain(x, shape, n), lib_rotate(x, shape, n),
                    work_rotate(n, 4))
            elif kind == "win":
                a, k = shape
                w = _unitary(k, rng)
                add("window_apply", f"n={n} a={a} k={k}", lambda: ck.window_apply(x, w, a, k, n),
                    lambda: kn.window_apply_plain(x, w, a, k, n), lib_window(x, w, a, k, n),
                    work_fwd(2**k, n), tc=work_fwd_tc(2**k, n))
            elif kind == "rotwin":
                r, k = shape
                w = _unitary(k, rng)
                add("rotwin_apply", f"n={n} r={r} k={k}",
                    lambda: ck.rotwin_apply(x, w, r, k, n),
                    lambda: kn.rotwin_apply_plain(x, w, r, k, n),
                    lib_rotwin(ck, x, w, r, k, n), work_fwd(2**k, n),
                    tc=work_fwd_tc(2**k, n))
            else:
                k = shape if kind == "rotmat" else n - shape
                w = _unitary(k, rng)
                name = f"{kind}_apply"
                lib = (lib_rotmat if kind == "rotmat" else lib_matrot)(x, w, shape, n)
                add(name, f"n={n} r={shape} k={k}",
                    lambda: getattr(ck, name)(x, w, shape, n),
                    lambda: getattr(kn, f"{name}_plain")(x, w, shape, n), lib, work_fwd(2**k, n),
                    tc=work_fwd_tc(2**k, n))
        xm, gm = _state(m, gen), _state(m, gen)
        for k in shapes[m]["window_apply_top"]:
            w = _unitary(k, rng)
            add("window_apply_top", f"n={m} k={k}", lambda: ck.window_apply_top(xm, w, k, m),
                lambda: kn.window_apply_top_plain(xm, w, k, m), lib_window_top(xm, w, k, m),
                work_fwd(2**k, m), tc=work_fwd_tc(2**k, m))
        # One 24q gradient through the saved executor, bf16 lambda.
        for kind, shape, g_dt, out_dt in backward_calls(shapes[n]["steps"]):
            if kind == "top":
                continue
            gg = g.to(g_dt)
            eg, eo = _esize(g_dt), _esize(out_dt)
            tag = f"g={_dt(g_dt)} out={_dt(out_dt)}"
            if kind == "rot":
                r = (n - shape) % n
                add("rotate", f"n={n} r={r} {_dt(g_dt)} (bwd)", lambda: ck.rotate(gg, r, n),
                    lambda: kn.rotate_plain(gg, r, n), lib_rotate(gg, r, n), work_rotate(n, eg))
            elif kind == "win":
                a, k = shape
                w = _unitary(k, rng)
                add("window_apply_bwd", f"n={n} a={a} k={k} {tag}",
                    lambda: ck.window_apply_bwd(w, gg, x, a, k, n, out_dt),
                    lambda: kn.window_apply_bwd_plain(w, gg, x, a, k, n, out_dt),
                    lib_window_bwd(w, gg, x, a, k, n), work_bwd(2**k, n, eg, eo),
                    tc=work_bwd_tc(2**k, n, eg))
            elif kind == "rotwin":
                r, k = shape
                w = _unitary(k, rng)
                add("rotwin_apply_bwd", f"n={n} r={r} k={k} {tag}",
                    lambda: ck.rotwin_apply_bwd(w, gg, x, r, k, n, out_dt),
                    lambda: kn.rotwin_apply_bwd_plain(w, gg, x, r, k, n, out_dt),
                    lib_rotwin_bwd(ck, w, gg, x, r, k, n), work_bwd(2**k, n, eg, eo),
                    tc=work_bwd_tc(2**k, n, eg))
            else:
                k = shape if kind == "rotmat" else n - shape
                w = _unitary(k, rng)
                name = f"{kind}_apply_bwd"
                lib = (lib_rotmat_bwd if kind == "rotmat" else lib_matrot_bwd)(w, gg, x, shape, n)
                add(name, f"n={n} r={shape} k={k} {tag}",
                    lambda: getattr(ck, name)(w, gg, x, shape, n, out_dt),
                    lambda: getattr(kn, f"{name}_plain")(w, gg, x, shape, n, out_dt),
                    lib, work_bwd(2**k, n, eg, eo),
                    tc=work_bwd_tc(2**k, n, eg))
        for kind, shape, g_dt, out_dt in backward_calls(shapes[m]["steps"]):
            if kind != "top":
                continue
            a, k = shape
            w, gg = _unitary(k, rng), gm.to(g_dt)
            add("window_apply_top_bwd", f"n={m} k={k} g={_dt(g_dt)} out={_dt(out_dt)}",
                lambda: ck.window_apply_top_bwd(w, gg, xm, k, m, out_dt),
                lambda: kn.window_apply_top_bwd_plain(w, gg, xm, k, m, out_dt),
                lib_window_top_bwd(w, gg, xm, k, m),
                work_bwd(2**k, m, _esize(g_dt), _esize(out_dt)),
                tc=work_bwd_tc(2**k, m, _esize(g_dt)))
        # One 24q gradient through the adjoint executor: the same lambda
        # dtypes, on the step's output state.
        for kind, shape, g_dt, out_dt in backward_calls(shapes[n]["steps"]):
            gg = g.to(g_dt)
            el, eo = _esize(g_dt), _esize(out_dt)
            tag = f"lam={_dt(g_dt)} out={_dt(out_dt)}"
            if kind in ("rot", "rotwin"):
                r = (n - (shape if kind == "rot" else shape[0])) % n
                add("rotate_pair", f"n={n} r={r} f32+{_dt(g_dt)}",
                    lambda: ck.rotate_pair(x, gg, r, n), lambda: kn.rotate_pair_plain(x, gg, r, n),
                    lib_rotate_pair(x, gg, r, n), work_rotate_pair(n, el))
            if kind in ("win", "rotwin"):
                a, k = shape if kind == "win" else (0, shape[1])
                w = _unitary(k, rng)
                add("adjoint_step", f"n={n} a={a} k={k} {tag}",
                    lambda: ck.adjoint_step(w, x, gg, a, k, n, out_dt),
                    lambda: kn.adjoint_step_plain(w, x, gg, a, k, n, out_dt),
                    lib_adjoint(w, x, gg, a, k, n), work_adjoint(2**k, n, el, eo),
                    tc=work_adjoint_tc(2**k, n, el))
            if kind in ("rotmat", "matrot"):
                k = shape if kind == "rotmat" else n - shape
                w = _unitary(k, rng)
                name = f"adjoint_{kind}"
                lib = (lib_adjoint_rotmat if kind == "rotmat" else lib_adjoint_matrot)(
                    w, x, gg, shape, n)
                add(name, f"n={n} r={shape} k={k} {tag}",
                    lambda: getattr(ck, name)(w, x, gg, shape, n, out_dt),
                    lambda: getattr(kn, f"{name}_plain")(w, x, gg, shape, n, out_dt),
                    lib, work_adjoint(2**k, n, el, eo),
                    tc=work_adjoint_tc(2**k, n, el))
        for kind, shape, g_dt, out_dt in backward_calls(shapes[m]["steps"]):
            if kind != "top":
                continue
            a, k = shape
            w, gg = _unitary(k, rng), gm.to(g_dt)
            add("adjoint_step_top", f"n={m} k={k} lam={_dt(g_dt)} out={_dt(out_dt)}",
                lambda: ck.adjoint_step_top(w, xm, gg, k, m, out_dt),
                lambda: kn.adjoint_step_top_plain(w, xm, gg, k, m, out_dt),
                lib_adjoint_top(w, xm, gg, k, m),
                work_adjoint(2**k, m, _esize(g_dt), _esize(out_dt)),
                tc=work_adjoint_tc(2**k, m, _esize(g_dt)))
        # One 24q chain forward (B17) and adjoint gradient (B18), step by step.
        for geom, descs, pairs in plans[n]:
            label = f"n={n} {geom[0]} {len(descs)} descriptors"
            add("chain_apply", label, lambda: ck.chain_apply(x, pairs, geom, descs, n),
                lambda: kn.chain_apply_plain(x, pairs, geom, descs, n),
                _chain_lib(x, None, pairs, descs, n), work_chain(descs, n, False),
                tc=work_chain_tc(descs, n, False))
            add("adjoint_chain", label, lambda: ck.adjoint_chain(x, g, pairs, geom, descs, n),
                lambda: kn.adjoint_chain_plain(x, g, pairs, geom, descs, n),
                _chain_lib(x, g, pairs, descs, n), work_chain(descs, n, True),
                tc=work_chain_tc(descs, n, True))
        # The batch entries: one FCC Circuit_19 request's and one KL request's
        # forward calls, and the 6q batched gradient's backward calls, each
        # also held behind a spin (its device time without the host's
        # launch gaps), beside an empty kernel launched through the same
        # ctypes path (the launch floor, unheld and held).
        lib, stream = ck._load(), ck._stream(x)
        empty = partial(lib.qml_batch_empty, stream)
        floor, floor_held = _events_ms(empty), _events_ms(empty, hold=True)
        log(f"  launch floor: an empty kernel through ctypes {floor * 1e3:.1f} us "
            f"(held {floor_held * 1e3:.1f} us)")
        held = dict.fromkeys(BATCH_KERNELS, 0.0)
        calls = dict.fromkeys(BATCH_KERNELS, 0)

        def batch_held(name, label, kern):
            t = _events_ms(kern, hold=True)
            held[name] += t
            calls[name] += 1
            log(f"  {name:20s} {label:36s} held   {t * 1e3:9.1f} us  "
                f"launch floor {floor * 1e3:.1f} us (held {floor_held * 1e3:.1f})")

        # The forward calls in float32 (the kernels line), then one FCC
        # Circuit_19 request's again in float64, the dtype phase 5g runs
        # FCC in (logged beside the line: 8 bytes a value, the bound at
        # the fp64 peak; torch.bmm in complex128).
        f64_rows = {name: dict(ms=0.0, held=0.0, library_ms=0.0, bound_ms=0.0, calls=0)
                    for name in ("window_apply_batch", "window_apply_top_batch")}
        fwd_calls = [(label, c, False) for label in ("FCC Circuit_19", "KL")
                     for c in bshapes["calls"][label]]
        fwd_calls += [("FCC Circuit_19", c, True) for c in bshapes["calls"]["FCC Circuit_19"]]
        counted_fwd = set()
        for label, (nb, a, k, per, bt, _), f64 in fwd_calls:
            xb, wb = _batch_state(nb, bt, gen, f64), _batch_window(k, bt, per, rng, f64)
            tag = (f"{label} n={nb} a={a} k={k} {'own' if per else 'one'} W Bt={bt}"
                   f"{' float64' if f64 else ''}")
            if a + k == nb:
                name = "window_apply_top_batch"
                kern = partial(ck.window_apply_top, xb, wb, k, nb)
                plain = partial(kn.window_apply_top_plain, xb, wb, k, nb)
            else:
                name = "window_apply_batch"
                kern = partial(ck.window_apply, xb, wb, a, k, nb)
                plain = partial(kn.window_apply_plain, xb, wb, a, k, nb)
            if not f64:
                add(name, tag, kern, plain, lib_window_batch(xb, wb, a, k, nb),
                    work_batch(2**k, nb, bt, per, False))
                batch_held(name, tag, kern)
            else:
                flops, bytes_ = work_batch(2**k, nb, bt, per, False, esize=8)
                bound = max(flops / PEAK_FP64, bytes_ / PEAK_HBM) * 1e3
                t_k, t_l = _events_ms(kern), _events_ms(lib_window_batch(xb, wb, a, k, nb))
                t_h = _events_ms(kern, hold=True)
                row = f64_rows[name]
                row["ms"] += t_k
                row["held"] += t_h
                row["library_ms"] += t_l
                row["bound_ms"] += bound
                row["calls"] += 1
                log(f"  {name:20s} {tag:36s} kernel {t_k * 1e3:9.1f} us  held {t_h * 1e3:9.1f} us"
                    f"  library {t_l * 1e3:9.1f} us  bound {bound * 1e3:8.1f} us "
                    f"({bytes_ / t_k / 1e9:.2f} TB/s; held {bytes_ / t_h / 1e9:.2f})")
            if (name, f64) not in counted_fwd and label == "FCC Circuit_19":
                counted_fwd.add((name, f64))
                _kernels_a_call(name, tag, kern)
            del xb, wb
        for name, row in f64_rows.items():
            log(f"  total {name:20s} float64, one FCC Circuit_19 request: kernel "
                f"{row['ms']:.3f} ms  held {row['held']:.3f} ms  library (complex128 bmm) "
                f"{row['library_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms over "
                f"{row['calls']} calls")
        counted = set()
        for nb, a, k, per, bt, _ in reversed(bshapes["calls"]["grad"]):
            xb, gb, wb = _batch_state(nb, bt, gen), _batch_state(nb, bt, gen), \
                _batch_window(k, bt, per, rng)
            tag = f"6q grad n={nb} a={a} k={k} {'own' if per else 'one'} W Bt={bt}"
            if a + k == nb:
                name = "window_apply_top_bwd_batch"
                kern = partial(ck.window_apply_top_bwd, wb, gb, xb, k, nb, torch.float32)
                plain = partial(kn.window_apply_top_bwd_plain, wb, gb, xb, k, nb, torch.float32)
            else:
                name = "window_apply_bwd_batch"
                kern = partial(ck.window_apply_bwd, wb, gb, xb, a, k, nb, torch.float32)
                plain = partial(kn.window_apply_bwd_plain, wb, gb, xb, a, k, nb, torch.float32)
            add(name, tag, kern, plain, lib_window_batch_bwd(wb, gb, xb, a, k, nb),
                work_batch(2**k, nb, bt, per, True))
            batch_held(name, tag, kern)
            if name not in counted:
                counted.add(name)
                _kernels_a_call(name, tag, kern)
    log(f"  (per kernel, summed over one request's calls: the forward kernels per {n}q "
        f"forward, the *_bwd kernels per {n}q saved gradient, the adjoint kernels and "
        f"rotate_pair per {n}q adjoint gradient, rotate per {n}q forward + saved gradient, "
        f"window_apply_top / window_apply_top_bwd / adjoint_step_top per {m}q forward / "
        f"gradient, chain_apply / adjoint_chain per {n}q chain forward / adjoint gradient, "
        f"window_apply_batch / window_apply_top_batch per FCC Circuit_19 request + KL "
        f"request, their backward batch entries per 6q batched gradient; "
        f"bound = max(flops / 67 TFLOP/s, bytes / 3.35 TB/s) per call, for "
        f"{', '.join(TC_KERNELS)} max(split-TF32 passes x 8K flops / 495 TFLOP/s + "
        f"CUDA-core flops (8K^3 of gw = G0 W for the adjoint steps and B18, the "
        f"chain diagonals) / 67 TFLOP/s, "
        f"bytes / 3.35 TB/s))")
    for name, t in totals.items():
        extra = f" (fp32-core bound {t['fp32_bound_ms']:.3f} ms)" if name in TC_KERNELS else ""
        if name in BATCH_KERNELS:
            extra = (f"  held {held[name]:.3f} ms  launch floor {calls[name] * floor:.3f} ms "
                     f"(held {calls[name] * floor_held:.3f}) over {calls[name]} calls")
        log(f"  total {name:20s} kernel {t['ms']:.3f} ms  plain {t['plain_ms']:.3f} ms  "
            f"library {t['library_ms']:.3f} ms  bound {t['bound_ms']:.3f} ms{extra}")
    return totals


def _kernels_a_call(name: str, label: str, fn) -> None:
    """The CUDA kernels one call of fn() launches, from torch.profiler's
    device events: exactly one, or "not measured" when the profiler shows
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"  {name} {label}: kernels a call not measured (the profiler shows no device event)")
        return
    log(f"  {name} {label}: {len(kernels)} kernel(s) a call: {kernels}")
    _check(len(kernels) == 1, f"{name}: {len(kernels)} kernels a call, want one: {kernels}")


# ---------------------------------------------------------------------------


def _bound_by(t: dict) -> str:
    return "bytes" if t["flop_ms"] < t["byte_ms"] else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from qml_essentials_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: device {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi}")

    path, seconds = ck.build()
    log(f"phase 2: built {path.relative_to(ROOT)} in {seconds:.1f} s")
    for line in ck.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "Used" in line or "wgmma" in line.lower():
            log(f"  {line.strip()}")
    check_sass(path)
    for name in CHAIN_KERNELS:
        log(f"  {name}: {ck.chain_active_clusters(name, torch.device(DEVICE))} clusters of "
            f"{ck._CHAIN_RANKS[name]} CTAs at once on the card (cudaOccupancyMaxActiveClusters)")

    shapes = {n: plan_shapes(n) for n in (*WIDTHS, WIDE)}
    for n in (*WIDTHS, WIDE):
        log(f"  {n}q plan (FUSE_LAYOUT_ROT on): {describe(shapes[n])}")
    n24 = WIDTHS[-1]
    _check(all(shapes[n24][f"{k}_apply"] for k in ("rotmat", "matrot", "rotwin")),
           f"{n24}q plan has no step of some fused kind: {describe(shapes[n24])}")
    t0 = time.perf_counter()
    dshapes = {"noisy": density_shapes(DENSITY_NOISE), "all": density_shapes(DENSITY_ALL_NOISE),
               "noise-free": density_shapes(None)}
    n2 = 2 * DENSITY_N
    for what, sh in dshapes.items():
        payload = sum(kind != "rot" for kind, _ in sh["steps"])
        log(f"  {DENSITY_N}q interleaved density plan ({what}, {n2} wires): {describe(sh)}")
        log(f"    in order: {describe_steps(sh)}")
        log(f"    residual estimate {residual_bytes(sh, n2) / 1e9:.2f} GB per input "
            f"({len(sh['steps'])} steps); saved residuals {payload * 8 * 2**n2 / 1e9:.2f} GB "
            f"({payload} payload steps)")
    log(f"  (density plans on the card in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ashapes = analysis_shapes()
    log(f"  phase 5f's small-register shapes, from its analyses on the CPU "
        f"({time.perf_counter() - t0:.1f} s): {ashapes}")
    t0 = time.perf_counter()
    bshapes = batch_shapes()
    log(f"  phase 5g's batch shapes (n, a, k, per-element W, batch), from its workloads on the "
        f"CPU ({time.perf_counter() - t0:.1f} s): forward {bshapes['fwd']}, backward "
        f"{bshapes['bwd']}")
    t0 = time.perf_counter()
    pshapes = pulse_shapes()
    log(f"  phase 5h's shapes, from the 24q pulse tape and its small workloads on the CPU "
        f"({time.perf_counter() - t0:.1f} s): the 24q pulse plan {describe(pshapes['main'])}")
    errs = phase_parity(shapes, list(dshapes.values()), ashapes, bshapes, pshapes)
    # The main path: serving (phase 4), saved-residual training (5),
    # adjoint training (5b), the chain route (5d), the noisy density
    # model (5e), the analysis slice (5f), the batch route (5g), pulse
    # mode (5h), the API surface (5i), the sharded route (5j) and, on four
    # cards, the sharded route with one NCCL rank a card (5k), each with
    # the counts reset just before it and read just after; every kernel must
    # launch over them.
    models, fwd_launches, refs = phase_slice(shapes)
    grad_launches, g64 = phase_grad(models, shapes)
    model26, adj_launches, batch = phase_adjoint(models, shapes, g64)
    phase_fusion_ab(models[n24], shapes, n24)
    chain_launches, chain_errs, plans = phase_chains(models, shapes, refs, g64)
    errs.update(chain_errs)
    dmodel, density_launches = phase_density(dshapes)
    analysis_launches = phase_analysis(models, shapes, dmodel, dshapes, smi)
    batch_launches = phase_batch(models, shapes, batch, smi)
    pulse_launches = phase_pulses(pshapes, smi)
    api_launches = phase_api(models, shapes, smi)
    shard_launches = phase_shard(models, dmodel, smi)
    card_launches = phase_cards(models, dmodel, smi)
    launches = {k: fwd_launches[k] + grad_launches[k] + adj_launches[k] + chain_launches[k]
                + density_launches[k] + analysis_launches[k] + batch_launches[k]
                + pulse_launches[k] + api_launches[k] + shard_launches[k] + card_launches[k]
                for k in KERNELS}
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    totals = phase_times(models, model26, shapes, batch, plans, dmodel, smi, bshapes)

    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
             max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
             bound_ms=t["bound_ms"],
             bound_by=_bound_by(t),
             library_ms=t["library_ms"])
        for name, t in totals.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
