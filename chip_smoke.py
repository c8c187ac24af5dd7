#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nequip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  0. device: require CUDA, print the card's name and power limit, TF32 off;
  1. build the CUDA kernels with nvcc from nequip_tpu_torch/csrc (one nvcc
     per source, all at once) and, beside them, the ops library
     (csrc/torch_ops.cpp, the registered ops in C++, linked with the objects
     of K1-K5);
  2. every kernel against its plain PyTorch version on the card, at the three
     conv-layer shapes of the flagship on the 23k-atom fcc Cu graph, f32 and
     f64, with median kernel and plain times (CUDA events): K1 conv_fwd
     (bitwise equal on a repeat call, what each call allocated within its
     output and carry rows, and beside it the time of the unfused
     composition it replaces: radial_weights through torch.mm, then K4), K2
     conv_bwd (inference) and conv_bwd_train (all five outputs, dw1/dw2
     bitwise equal on a repeat call), the dW reduction dw_reduce at both
     of its shapes (dW2 h_e x dW_e and dW1 emb x dh_pre_e, one line each,
     bitwise equal on a repeat call, with their f32 sums; beside the
     one-call times, the kernel and torch.mm timed ten calls back to back),
     K3 scatter_rows, K4 tri_fwd and K5 tri_bwd on the whole stream (each
     bitwise equal on a repeat call, its allocations within its outputs);
     K4-acc tri_fwd_acc, K6 jvp_fwd (with and without accumulators) and K7
     jvp_bwd on one of 4 edge slices whose first destination segment the
     slice boundary splits (the shapes the fr sweep gives them), each
     bitwise equal on a repeat call, its allocations within its outputs
     (for the accumulating forms: the copies of the accumulators the check
     adds onto) and, for K4, K4-acc and K6, their carry rows.  Beside each
     time: the kernel's bound (bytes over 3.35 TB/s or f32 operations over
     67 TFLOP/s, whichever is larger) and, where one PyTorch call computes
     the same function, that call's time (library_ms: torch.mm for the dW
     reduction, index_add_ for K3);
     the f32 per-layer times of the kernels on dense edge tiles (K1, K2, K2
     train, K4, K4-acc, K5, K6, K7) beside their bounds again on one line
     per kernel, K1's with the unfused radial_weights + K4 beside it;
  3. the port in f64, kernels on the card, against the golden E/F/stress the
     JAX package wrote (tests/data/torch_port_golden.npz);
  4. serving: the flagship in f32 with tp_impl="fused" answers three
     calculator requests on the 23k-atom frame; the launch counts of those
     requests are reported (K2's inference variant only), with the serving
     peak of device memory and what each inference K2 call allocated, which
     must stay within its outputs and W2^T (no per-edge [E, WN] or
     [E, hidden] buffer), and one request is checked against
     tp_impl="torch";
  5. golden training: the flagship's rr force loss and every parameter
     gradient in f64 through the kernels against the JAX package's
     (tests/data/torch_port_train_golden.npz); 5b: the same for fr with
     fr_edge_chunks 0 and 4 (fr's gradients are rr's), K6/K7/K4-acc
     launched only when chunked;
  6. training: Trainer.fit runs the flagship in f32 with tp_impl="fused",
     EnergyForceLoss and Adam for 2 epochs over three LJ-labelled 23k-atom
     frames (2 train, 1 val, batch 1); per-step times, peak memory, losses
     and launches; the first step's gradients are checked against
     tp_impl="torch" on the same batch;
  7. fr training: the same Trainer.fit with force_grad_mode="fr" and
     fr_edge_chunks=4 on phase 6's data; step times, peak memory and losses
     beside phase 6's rr numbers; the first step's gradients against rr
     "fused" on the same batch; K6, K7, K4-acc, K5 and K3 must launch;
  8. microbenchmarks (the port's tools, nequip_tpu_torch/tools): 8a every
     T1-T4 variant at the tool's full width (G=2048 steps of one 256-edge
     chunk, 128 rows) against its plain version, f32 HIGHEST at 1e-4
     max|ref|, f32 DEFAULT (TF32 MLP) at 1e-4 against plain with TF32
     rounding emulated and at 1e-2 against plain f32, f64 at G=4 at 1e-12,
     each bitwise equal on a repeat call, with kernel, plain and bound
     times (T2/T4's plain computes one step: a T2/T4 call at G=2048 must
     take 1.7-2.3x its time at G=1024; their launch shape is printed);
     8b the row gather T5 on the 23k-atom edge stream (430,080 rows
     of 288, f32 and bf16, four index patterns), bitwise equal to
     torch.index_select, with its time (at the wrapper's block shape, and
     at the tool's) beside index_select's; 8c both
     tools' run() at their defaults, whose launches the report counts;
  9. MD, as bench.py's MD row drives the JAX driver: the flagship in f32
     with tp_impl="fused" on the 23,328-atom fcc frame, VelocityVerlet at
     2 fs, masses 63.546, skin 0.5, blocks of 10 steps, Maxwell-Boltzmann
     velocities at 300 K from seed 1.  9a builds the C++ cell list with g++
     and times it and the kdtree backend at the MD cutoff (r_max + skin);
     their (dst, src, shift) edge sets must be equal.  9h the device cell
     list (csrc/device_nl.cu, f64) on that frame: against its plain twin
     (slots, stream and flag equal), against the C++ list (the same edge
     set), bitwise equal on a repeat call, its overflow flag under a small
     bucket, per-atom and stream capacity (as the twin's); kernel, plain
     and C++ times and the bound.  9b integration="host" and 9c
     integration="block" (one CUDA graph a block): a warm-up block, then
     100 timed steps from where it ended, with the step's median, min and
     max (host clock per step, or per block / 10), atom-steps/s, the force
     call's and the integrator's times alone (CUDA events),
     neighbour-list and re-layout time per rebuild, peak memory, for 9c
     the captures, capture time and the graph's replay time per step; the
     launches from the driver's construction on (K1, K2's inference
     variant and K3 must launch, no training kernel may).  9i:
     nl_backend="device" with block integration from the same start
     (rebuild and force refresh as two more graphs): the same numbers,
     device rebuild ms (CUDA events), at least one rebuild, device_nl
     launched, held against 9c at 9d's gates, median and mean step and
     atom-steps/s beside 9c's.  9d: host and block positions and forces
     after the same 110 steps from one start.  9e: skin 1e-6 (a rebuild
     after every block; one capture whose graph replays on layouts
     refilled in place): the last forces against a fresh neighbour list
     at the final positions, and a further replayed block against a fresh
     list from the positions of the last build.  9g: the force call on
     the MD graph against tp_impl="torch" (phase 4's gates).  9f: the
     host run's NVE drift per atom.  9j: K4's route (the flagship's widths
     with a depth-2 radial MLP) with nl_backend="device" and block
     integration from 9's start, 50 timed steps, against the host-list
     block run of the same model at 9d's gates, at least one device
     rebuild, K4, K5 and K3 (and the device list) launched, nothing else.
 10. the training CLI (nequip-torch-train) on the flagship: 10a train/val/
     test, 10b resume, 10c fr over edge slices, 10d the LJ accuracy gate;
 11. deployment: 11a the f64 golden flagship through save_compiled_model at
     the 23k-atom frame's capacities and the calculator's
     from_compiled_model, against the JAX golden at phase 3's gates; 11b
     nequip-torch-package build, info and list on 10a's best.ckpt, and the
     package's and the checkpoint's calculators bitwise equal on the
     23k-atom frame; 11c nequip-torch-compile --capacity-ladder 2 of
     best.ckpt with its self-check (compile s, artifact MiB, load s), the
     launches of one compiled request against one eager request (K1, K2,
     K3 alike, no training kernel); 11d 12 warm requests each, compiled and
     eager in turns, host-clock medians of prepare and model time, compiled
     against eager at E rel 1e-5, F and stress 1e-4 of their max; 11e a
     27k-atom frame served from rung 1 at the same gates; 11f the
     standalone consumer (nequip_tpu_torch/tools/standalone_artifact_consumer.py)
     in a subprocess where importing nequip_tpu_torch raises, on 11c's
     artifact (the trained f32 flagship, K1's route) and on the depth-2
     twin of the f32 flagship (K4's route) compiled on the card at one rung
     holding the 23k-atom frame, with one request after the first: each
     artifact carries the
     ops library built in phase 1 (csrc/torch_ops.cpp with the K1-K5
     objects) and names its ops; the consumer loads the library from the
     artifact alone, its nequip_torch schemas equal the package's, and its
     outputs equal load_compiled_model's on the same frame bitwise (both
     with deterministic algorithms); the library's build time and the
     consumer's request times are printed;
 12. the MD-engine pair style (flagship, f32, fused) on phase 9's frame
     with the C++ list's pairs at r_max: 12a energy (rel 1e-5) and edge
     forces summed onto atoms (1e-4 of max |F|) against the calculator,
     K1, K2 and K3 launched; 12b two x-slab domains with ghosts out to
     num_layers * r_max reproduce the undivided energy and forces; 12c the
     pair_nequip program against the eager wrapper.
 13. training from data files: 13a phase 6's three LJ frames (23,328 atoms,
     energy, forces, stress) written as extxyz (write_extxyz), an
     sGDML-layout NPZ and a shard (ShardDataset.save_from_iterator), each
     file's size and read time (host clock), read back bitwise equal (NPZ,
     shard) or within the writer's 1e-10 (extxyz); 13b one epoch of the
     flagship with a ZBL prior (f32, fused, EnergyForceLoss, Adam, batch 1,
     2 train + 1 val frames) from each file through a NequIPDataModule
     config naming NPZDataset, ShardDataset or ASEDataset, against the
     same frames in memory (deterministic index_add): the first-epoch
     training loss bitwise equal for NPZ and shard, within rel 1e-6 for
     extxyz; step times, peak memory and launches (K1, K2-train, K3, K4, K5
     must launch); 13c the capacity-bucket ladder: two frames each of 14^3,
     16^3 and 18^3 supercells, one epoch in order with n_buckets=3 and with
     n_buckets=1: the ladder, padding waste, step times by bucket, peak
     memory, losses within f32 rel 1e-5; 13d nequip-torch-train -cn tutorial
     as shipped (20 epochs, 25 frames of 32 atoms, stress in the loss) and
     -cn lj_accuracy ++trainer.max_epochs=2: main() seconds, test metrics,
     loss coefficients, all finite; 13e nequip-torch-compile of the
     tutorial's best.ckpt (ZBL through the export) against the eager model
     at phase 11's gates (E rel 1e-5, F 1e-4 of max|F|).
 14. the model builder's options: 14a the options golden
     (tests/data/torch_port_options_golden.npz: the norm nonlinearity, a
     categorical embedding, learnable shift, trainable leaves and remat;
     a depth-2 radial MLP; a narrowed preset M) in f64 through the kernels
     at phase 3's gates, each layer on K1's route or, for the depth-2 MLP,
     K4's (launch counters); 14b PresetNequIPGNNModel("M") at full width
     on the 23k-atom frame, f32: serving against tp_impl="torch" (phase
     4's gates) with its model time, peak and launches; each layer's shape
     and edges per tile, K1, K2, K2-train, K4, K5, K4-acc, K6 and K7 held
     against their plain versions on the layer's own inputs at phase 2's
     f32 gates, and their times beside their bounds; three rr steps each
     with no remat, remat_conv True and "save_tp" and remat_force (losses
     and gradients within the f32 gates, step medians, peaks, and the
     extra launches exactly the recomputed layers); one fr step over 4 slices with
     remat_conv True against False; and one rr and one fr step of preset
     M against the same weights at tp_impl="torch" on a 4,000-atom frame
     (smaller, to keep the plain conv's double backward in memory):
     losses within 1e-5 rel, gradients within 1e-4 of max; 14c the flagship's widths with a depth-2 radial MLP at
     tp_impl="fused": served against torch with K4, K5 and K3 launched and
     K1 not, then packaged and compiled through the registered ops
     nequip_torch::tri_fwd / tri_bwd against eager at phase 11's gates.
 15. the rest of training: 15a the optimizer golden
     (tests/data/torch_port_optim_golden.npz: a small all-trainable model
     on the 108-atom frame, 3 steps each of ConFIG with pinv, EMA-ConFIG
     with least squares, whose steps ConFIG with lsqr=True repeats, Muon +
     Adam, schedule-free with a 2-step warmup, Adam with eps_root and Adam
     under a warmup-cosine schedule) in f64 through the kernels: weights
     and evaluation weights within 1e-8 of max (Muon + Adam 1e-5), the rr
     training kernels launched; 15b Trainer.fit of the flagship in f32
     with tp_impl="fused" for 2 epochs on phase 6's data with EMA-ConFIG
     (lsqr), Muon + Adam and schedule-free, then Muon + Adam in fr over 4
     slices: step times, peaks and launches (K1, K2-train, the dW
     reduction, K3, K4 and K5 in rr; K3, K4-acc, K5, K6 and K7 in fr),
     finite losses; 15c ConFIG's k gradients from one graph against k
     separate passes, and its final gradient against tp_impl="torch", on
     phase 6's first batch (1e-4 of max).
 16. the bfloat16 fast mode (enable_bf16_fast_mode: float32 parameters,
     bf16 at use), with cuBLAS's bf16 products summed in float32 for the
     phase (allow_bf16_reduced_precision_reduction off, as JAX sums them):
     16a K1, K2's inference variant and K3 in bf16 against their plain
     versions at the flagship's three layer shapes on the 23k graph,
     within 8e-3 of max|out| (two bf16 ulps: the two round at the same
     points and differ by the order of their sums), each bitwise equal on
     a repeat call, with kernel, plain and bound ms (bytes at 2 B,
     operations at 989 TFLOP/s bf16) and index_add_ in bf16 and the f32
     K3 on the same values (timed in turns, single calls and ten back to
     back) beside K3, whose output must
     also be bitwise its edge-order float32 reference
     (scatter_rows_edge_order), there and on a values view 2 bytes off
     16-byte alignment with D = 36 (the kernel's 2-byte load path);
     16b phase 3's golden in bf16 through the kernels, E rel 1e-3 and F
     2e-2 of max|F| (JAX's bf16 gate); 16c three bf16 requests at 23k
     atoms beside three f32 requests on the same frames: launches K1, K2,
     K3 only, the bf16 serving peak within phase 4's limit, finite values,
     translation invariance, forces within 5e-2 of max|F| of the f32
     request's (a sanity bound), model times; 16d MD of the bf16 flagship
     (phase 9's settings, 50 timed steps) host, block and block with the
     device list, host against block and the device list against the
     host list at phase 9d's limits, step times beside phase 9's f32 runs,
     NVE drift (reported); 16e nequip-torch-compile --modifiers
     enable_bf16_fast_mode --no-check of a flagship checkpoint (the
     self-check refused with a KeyError, as in JAX), served with
     from_compiled_model against the eager bf16 model (E rel 1e-3, F 2e-2
     of max|F|), its launches K1, K2, K3.  16a also holds K4 and K5 (the
     whole stream) and K4-acc, K6 and K7 (one of 4 edge slices, their
     accumulating forms on float32 accumulators) in bf16 against their
     twins at the same gate, each bitwise equal on a repeat call, timed
     beside the f32 kernel on the same values in one call (the twin 3
     times), and K2's training variant (with its two dW reductions; dx,
     dsh and demb bitwise K2's inference variant's) at the same gate and
     the dW reduction alone at both shapes at phase 2's f32 gate, each
     bitwise equal on a repeat call, timed beside the f32 kernel on the
     same values, the dW reduction beside torch.mm on its bf16 operands
     (single calls and ten back to back; faster than the f32 kernel over
     the layers and both shapes, or the phase fails), and at preset M's
     layer-1 dW2 shape (hidden x 768) too;
     16f the flagship with a depth-2 radial MLP in bf16 (K4's
     route): three 23k-atom requests beside the f32 model's (model ms and
     peak; launches K4, K5, K3 only), the options golden's depth-2 model
     in bf16 against its f64 golden at JAX's bf16 gate, 16e's compile
     check of its checkpoint, and 20 host MD steps; 16g Trainer.fit at
     23k atoms (phase 6's frames, 2 epochs) in fr over 4 edge slices with
     remat_conv="save_tp" on the fused route, in rr on fused_tp and in rr
     on fused, each beside the same fit in f32 (later steps' median and
     peak), the bf16 fits launching K4-acc, K5, K6, K7, K3 (fr), K4, K5,
     K3 (rr on fused_tp) or K1, K2's training variant, the dW reduction,
     K3, K4, K5 (rr on fused, the only fit that launches the latter two);
     then rr on fused_tp, fr over 4 slices on fused, rr on fused and
     unsliced fr on fused, one step each of the bf16 flagship from the f64
     training golden's parameters against that golden: loss rel 1e-3,
     every gradient 0.1 of its tensor's max|grad| (JAX's own bf16 step
     meets both: loss 2.2e-4, gradients 4.2e-2), the gradients float32;
     and three rr steps of preset M in bf16 on fused at 23k atoms (median
     and peak beside 14b's f32 step).
 17. parallel execution (nequip_tpu_torch.parallel) as ranks: processes
     spawned on cuda:0 over gloo, asked for by name (NCCL refuses two ranks
     on one card; gloo copies every collective through the host, so no
     time here is a parallel speed), a process-group timeout and a join
     deadline, each rank loading phase 1's library and reporting its caps
     L, G and E, its step time (host clock, synced), peak memory and
     launches, each route's kernels launched on every rank or the phase
     fails.  Two ranks: (a) sharded serving of the f32 flagship (phase 4's
     weights and first frame) against the single-device request (E rel
     1e-5, F 1e-4 of max|F|), and the f64 golden frame against phase 3's
     golden (E rel 1e-10, F 1e-8); (b) sharded loss_and_grad on phase 6's
     first LJ frame, rr and fr over 4 edge slices, against the
     single-device rr step (loss rel 1e-4, gradients 1e-4 of max); (c)
     Trainer(devices=2), batch 1 a rank over phase 6's three frames (the
     second step's second micro-batch a masked filler), SGD, against the
     single-device trainer at batch 2 in this process (each step's loss
     and gradients, the final parameters, 1e-4), the parameters the same
     bytes on both ranks after every step.  Four ranks: (d)
     SpatialTrainModule on a (2, 2) mesh over two 6,912-atom LJ frames, an
     untimed rr step, then one rr and one fr step, against the
     single-device rr step on the same frames (1e-4), the parameters the
     same bytes on all four ranks.
The second-to-last line is the kernel report as JSON ("launches": the
kernel's launches on the path that runs it, phase 6 (rr) for K1, K2, K2
train, the dW reduction and K4, phase 7 (fr, chunked) for the other
kernels of K3-K7, phase 8c for T1-T5, phase 9i for the device list
(phase 10 prints its own); "ms"/"plain_ms"/"bound_ms"/"library_ms": phase-2 f32
medians and bounds summed over the three layer shapes (for the dW
reduction over both of its shapes too), for T1-T5 the
phase-8 numbers of the `full` HIGHEST (T1), `full_t` DEFAULT (T3, TF32
bound), CG-VJP (T2/T4; their plain_ms is one step) and f32
random-pattern gather (T5) rows, and phase 9h's f64 numbers for the
device list, whose "replaces" names the XLA function it replaces (no pallas_call); "max_abs_err": the largest
f32 difference from plain, 0 for the device list, whose output equals
its twin's); the rows conv_fwd_bf16 ... jvp_bwd_bf16 are phase 16a's
bf16 numbers (K4-acc, K6 and K7 on one of 4 slices; conv_bwd_train_bf16
with its dW reductions, dw_reduce_bf16 over both shapes, library_ms
torch.mm in bf16), the launches of K1, K2 and K3 phase 16c's three bf16
requests, of K4-K7, K2's training variant and the dW reduction phase
16f's three bf16 requests and 16g's three bf16 fits; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_port_train_golden.npz"
# the TPU kernels the CUDA kernels replace (pl.pallas_call sites)
REPLACES = {
    "conv_fwd": "nequip_tpu/ops/pallas/tp_scatter.py:1649",
    "conv_bwd": "nequip_tpu/ops/pallas/tp_scatter.py:1733",
    "conv_bwd_train": "nequip_tpu/ops/pallas/tp_scatter.py:1733",
    "dw_reduce": "nequip_tpu/ops/pallas/tp_scatter.py:1733",
    "scatter_rows": "nequip_tpu/ops/pallas/tp_scatter.py:1059",
    "tri_fwd": "nequip_tpu/ops/pallas/tp_scatter.py:949",
    "tri_fwd_acc": "nequip_tpu/ops/pallas/tp_scatter.py:949",
    "tri_bwd": "nequip_tpu/ops/pallas/tp_scatter.py:1210",
    "jvp_fwd": "nequip_tpu/ops/pallas/tp_scatter.py:2118",
    "jvp_bwd": "nequip_tpu/ops/pallas/tp_scatter.py:2306",
    "mb_fwd": "tools/kernel_microbench.py:142",
    "mb_bwd": "tools/kernel_microbench.py:189",
    "mb_fwd_t": "tools/kernel_microbench.py:271",
    "mb_bwd_t": "tools/kernel_microbench.py:313",
    "row_gather": "tools/gather_microbench.py:86",
    # no pallas_call: the XLA function the JAX MD driver rebuilds its list with
    "device_nl": "nequip_tpu/ops/device_nl.py:54",
}
MICROBENCH_KERNELS = ("mb_fwd", "mb_bwd", "mb_fwd_t", "mb_bwd_t", "row_gather")  # launches from phase 8c
SERVING_KERNELS = ("conv_fwd", "conv_bwd", "scatter_rows")
TRAINING_KERNELS = ("conv_fwd", "conv_bwd_train", "dw_reduce", "scatter_rows", "tri_fwd", "tri_bwd")
FR_CHUNKED_KERNELS = ("tri_fwd_acc", "jvp_fwd", "jvp_bwd", "tri_bwd", "scatter_rows")
RR_REPORTED = ("conv_fwd", "conv_bwd", "conv_bwd_train", "dw_reduce", "tri_fwd")  # launches from phase 6
N_CHUNKS = 4
# Phase 4's serving peak at 23k atoms may exceed by at most 2% the 1.179 GiB
# measured (H100, PyTorch 2.11) while K2 was one block per destination and
# kept W in shared memory; a per-edge [E, 96] f32 buffer would add 0.150 GiB.
# What the peak holds: the forward's saved node and edge tensors and the
# widest layer's K2 outputs (dx [E, 288]: 0.45 GiB); phase 2 checks K2's own
# allocations against its outputs.
SERVING_PEAK_LIMIT = int(1.02 * 1.179 * 2**30)
# published peaks of one H100 SXM (700 W): HBM bytes/s, f32 FLOP/s outside the tensor cores, TF32 dense
HBM_BYTES_S, F32_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 495e12
F64_FLOP_S = 34e12  # float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
FLAGSHIP = dict(
    type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2, parity=False, num_features=32,
    avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -3.5},
    per_type_energy_scales={"Cu": 0.5},
)


def fcc_frame(n_atoms: int, seed: int = 0, jitter: float = 0.05) -> dict:
    """Bulk-Cu fcc supercell (nearest cube >= n_atoms), as __graft_entry__._fcc_frame."""
    rng = np.random.RandomState(seed)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    reps = max(1, int(round((n_atoms / 4) ** (1 / 3))))
    if 4 * reps**3 < n_atoms:
        reps += 1
    pos = np.concatenate(
        [base + np.array([i, j, k]) * a for i in range(reps) for j in range(reps) for k in range(reps)]
    )
    pos = pos + rng.normal(0, jitter, pos.shape)
    return {
        "pos": pos,
        "cell": np.diag([reps * a] * 3),
        "pbc": np.array([True] * 3),
        "atomic_numbers": np.full(len(pos), 29),
    }


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 0: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"phase 0 device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}",
        flush=True,
    )
    return smi


def phase1_build():
    """Build the kernels and the ops library (one step); returns build.Built.
    Fails if either did not build."""
    from nequip_tpu_torch.ops.kernels import build

    built = build.build()
    if built.ops is None:
        raise RuntimeError(f"phase 1: {built.ops_error}")
    build.load_library()
    print(f"phase 1 build: {built.kernels.name} and {built.ops.name} in {built.seconds:.1f} s (the ops library's "
          f"binding compiled in {built.binding_seconds:.1f} s beside nvcc, linked in {built.ops_link_seconds:.1f} s; "
          f"{built.ops.stat().st_size / 2**20:.2f} MiB)", flush=True)
    return built


def graph(n_atoms: int, device, seed: int = 0, jitter: float = 0.05):
    """Padded, kernel-ordered 23k-style graph as the calculator builds it."""
    from nequip_tpu_torch.data import (
        batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors,
    )
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream

    frame = compute_neighborlist_(
        ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(fcc_frame(n_atoms, seed, jitter))), 4.0
    )
    batch = batched_from_list([frame])
    n, e = batch["pos"].shape[0], batch["edge_index"].shape[1]
    padded = pad_batch(batch, round_up(n, 128), round_up(e, 256), 2)
    return relayout_edge_stream(to_tensors(padded, device)), n, e


def cuda_median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def interleaved_median_ms(fns, reps: int = 10, rounds: int = 3) -> list:
    """cuda_median_ms of each function, over rounds in which the functions
    take turns, and the median of the rounds: a drift of the card's speed
    during the phase falls on all of them alike."""
    times = [[cuda_median_ms(f, reps) for f in fns] for _ in range(rounds)]
    return [float(np.median(t)) for t in zip(*times)]


def work(name: str, plan, n_edges: int, n_dst: int, n_src: int, n_nodes: int, hidden: int, n_emb: int,
         itemsize: int):
    """(operations, bytes) of one call: each input read once, each output
    written once.  ``n_edges`` real edges, ``n_dst`` destination rows the
    call touches, ``n_src`` distinct source rows it reads, ``n_nodes`` rows
    of a whole node array it writes; int32 indices count 4 bytes.  CG work:
    TC = sum over paths of (terms x channels), PY = sum of (SH width x
    channels); a multiply-add is 2 operations."""
    D, S, M, W, H, B = plan.dim_in, plan.sh_dim, plan.mid_dim, plan.weight_numel, hidden, n_emb
    TC = sum(len(p["terms"]) * p["mul"] for p in plan.paths)
    PY = sum(p["y_dim"] * p["mul"] for p in plan.paths)
    E, b = n_edges, itemsize
    idx = 4 * (E + n_dst + 1)
    mlp_fwd = 2 * B * H + 2 * H * W + 4 * H
    mlp_bwd = 2 * H * W + 2 * B * H + 6 * H
    ops, nbytes = {
        "conv_fwd": (E * (3 * TC + 2 * M + mlp_fwd), b * (n_src * D + E * (S + B) + B * H + H * W + n_nodes * M)),
        "conv_bwd": (E * (7 * TC + 4 * PY + mlp_fwd + mlp_bwd),
                     b * (n_src * D + n_dst * M + B * H + H * W + 2 * E * (D + S + B))),
        "conv_bwd_train": (E * (7 * TC + 4 * PY + mlp_fwd + mlp_bwd + 2 * B * H + 2 * H * W),
                           b * (n_src * D + n_dst * M + 2 * (B * H + H * W) + 2 * E * (S + B) + E * D)),
        "scatter_rows": (E * D, b * (E * D + n_nodes * D) + idx),
        "tri_fwd": (E * (3 * TC + 2 * M), b * (n_src * D + E * (S + W) + n_nodes * M)),
        "tri_fwd_acc": (E * (3 * TC + 2 * M), b * (n_src * D + E * (S + W) + 2 * n_dst * M)),
        "tri_bwd": (E * (7 * TC + 4 * PY), b * (n_src * D + n_dst * M + 2 * E * (S + W) + E * D)),
        "jvp_fwd": (E * (8 * TC + 6 * M), b * (2 * n_src * D + 2 * E * (S + W) + 2 * n_nodes * M)),
        "jvp_bwd": (E * (20 * TC + 12 * PY), b * (2 * n_src * D + 2 * n_dst * M + 4 * E * (S + W) + 2 * E * D)),
    }[name]
    return ops, nbytes + idx


def dw_work(n: int, P: int, Q: int, itemsize: int):
    """(operations, bytes) of one dw_reduce call: a [n, P] and b [n, Q] read
    once, out [P, Q] written once."""
    return 2 * n * P * Q, itemsize * (n * (P + Q) + P * Q)


def _bound_ms(ops: float, nbytes: float):
    """The f32 bound of a call (the f64 peak is not the table's)."""
    t_ops, t_bytes = ops / F32_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _check(name, got, ref, rtol, atol_rel, where, phase="phase 2"):
    """Largest |got - ref| over the outputs; raises beyond rtol |ref| +
    atol_rel max|ref| or on a non-finite value."""
    err = 0.0
    for out_i, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.abs().max())
        diff = (a - b).abs()
        if not bool(a.isfinite().all()) or bool((diff > rtol * b.abs() + atol_rel * scale).any()):
            raise RuntimeError(
                f"{phase}: {name} output {out_i} {where} disagrees with plain: "
                f"max |diff| {float(diff.max()):.3e}, max |ref| {scale:.3e}"
            )
        err = max(err, float(diff.max()))
    return err


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


def phase2_kernels(n_atoms: int, reps: int):
    """Each kernel against its plain version at the flagship's layer shapes."""
    import torch

    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    dev = torch.device("cuda")
    data, n, e = graph(n_atoms, dev)
    layout = data[K.LAYOUT_KEY]
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    n_real = layout.n_real
    # 4 slices of the fr sweep, every interior boundary moved 7 edges into a
    # destination segment (the fcc graph's 18-edge segments align with n/4)
    bounds = [0] + [s * n_real // N_CHUNKS + 7 for s in range(1, N_CHUNKS)] + [n_real]
    sl = K.edge_slices(layout, N_CHUNKS, bounds)[1]
    if sl.start in set(layout.dst_ptr.tolist()):
        raise RuntimeError("phase 2: the slice boundary does not split a destination segment")
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    n_touched_s = int((lay_s.dst_ptr[1:] > lay_s.dst_ptr[:-1]).sum())
    n_src_s = int(torch.unique(lay_s.edge_src).numel())
    n_src = int(torch.unique(layout.edge_src[:n_real]).numel())
    n_dst = int((layout.dst_ptr[1:] > layout.dst_ptr[:-1]).sum())
    print(f"phase 2 graph: {n} atoms, {e} edges, padded to {N} nodes, {E} edges; slice 1 of {N_CHUNKS}: "
          f"edges [{sl.start}, {sl.stop}), {n_touched_s} destinations, {n_src_s} sources", flush=True)
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    rng = np.random.RandomState(0)
    dw_sums = {}  # dw_reduce f32 per shape, ms over the layers: kernel, plain, bound, torch.mm, both back to back
    # f32 (kernel, bound) ms per layer of the kernels on dense edge tiles
    tile_layers = {k: [] for k in ("conv_fwd", "conv_bwd", "conv_bwd_train", "tri_fwd", "tri_fwd_acc", "tri_bwd",
                                   "jvp_fwd", "jvp_bwd")}
    unfused_ms = []  # f32 ms per layer of what K1 replaces: radial_weights (torch.mm) then K4
    report = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                  "library_ms": None} for k in K.KERNELS if k not in MICROBENCH_KERNELS + ("device_nl",)}
    for dtype, rtol, atol_rel in ((torch.float32, 1e-4, 1e-5), (torch.float64, 1e-10, 1e-10)):
        for li, blk in enumerate(blocks):
            plan = blk.tp_scatter.plan
            a0, a1 = blk.edge_mlp.alphas
            n_emb, hidden = blk.edge_mlp.w0.shape

            def t(*shape):
                return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

            x, sh, emb = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb)
            w1, w2, g = t(n_emb, hidden), t(hidden, plan.weight_numel), t(N, plan.mid_dim)
            w = t(E, plan.weight_numel)  # per-edge TP weights of K4/K5
            h_e, dw_e = t(n_real, hidden), t(n_real, plan.weight_numel)  # dW2's factors
            dh_pre = t(n_real, hidden)  # dW1's: emb [E, n_emb] (its first n_real rows) x dh_pre
            # the fr operands: tangents, the slice's rows, tmsg's cotangent, accumulators
            tx, tsh, dw, gt = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim)
            s_ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s)
            acc, tacc = t(N, plan.mid_dim), t(N, plan.mid_dim)
            acc_t = acc.clone()  # the timed K4-acc calls keep adding onto it
            calls = {
                "conv_fwd": (
                    lambda: K.conv_fwd(plan, x, sh, emb, w1, w2, a0, a1, layout),
                    lambda: K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout),
                ),
                "conv_bwd": (
                    lambda: K.conv_bwd(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                    lambda: K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                ),
                "conv_bwd_train": (
                    lambda: K.conv_bwd_train(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                    lambda: K.conv_bwd_train_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                ),
                "dw_reduce dW2": (
                    lambda: K.dw_reduce(h_e, dw_e, a1, n_real),
                    lambda: K.dw_reduce_plain(h_e, dw_e, a1, n_real),
                ),
                "dw_reduce dW1": (
                    lambda: K.dw_reduce(emb, dh_pre, a0, n_real),
                    lambda: K.dw_reduce_plain(emb, dh_pre, a0, n_real),
                ),
                "tri_fwd": (
                    lambda: K.tri_fwd(plan, x, sh, w, layout),
                    lambda: K.tri_fwd_plain(plan, x, sh, w, layout),
                ),
                "tri_bwd": (
                    lambda: K.tri_bwd(plan, x, sh, w, layout, g),
                    lambda: K.tri_bwd_plain(plan, x, sh, w, layout, g),
                ),
                "tri_fwd_acc": (
                    lambda: K.tri_fwd(plan, x, sh[rows], w[rows], lay_s, acc=acc_t),
                    lambda: K.tri_fwd_plain(plan, x, sh[rows], w[rows], lay_s, acc_t),
                ),
                "jvp_fwd": (lambda: K.jvp_fwd(plan, *s_ops), lambda: K.jvp_fwd_plain(plan, *s_ops)),
                "jvp_bwd": (lambda: K.jvp_bwd(plan, *s_ops, g, gt), lambda: K.jvp_bwd_plain(plan, *s_ops, g, gt)),
            }
            # checked once, not timed: the accumulating forms on fresh accumulators
            checks = {
                "tri_fwd_acc": (
                    lambda: K.tri_fwd(plan, x, sh[rows], w[rows], lay_s, acc=acc.clone()),
                    lambda: K.tri_fwd_plain(plan, x, sh[rows], w[rows], lay_s, acc.clone()),
                ),
                "jvp_fwd": (
                    lambda: K.jvp_fwd(plan, *s_ops, acc=(acc.clone(), tacc.clone())),
                    lambda: K.jvp_fwd_plain(plan, *s_ops, (acc.clone(), tacc.clone())),
                ),
            }
            dx_edge = K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g)[0]
            calls["scatter_rows"] = (
                lambda: K.scatter_rows(dx_edge, layout.src_perm, layout.src_ptr),
                lambda: K.scatter_rows_plain(dx_edge, layout.src_perm, layout.src_ptr),
            )
            src_idx = layout.edge_src[:n_real].long()
            buf = torch.zeros(N, plan.dim_in, dtype=dtype, device=dev)
            library = {
                "dw_reduce dW2": lambda: torch.mm(h_e.t(), dw_e),
                "dw_reduce dW1": lambda: torch.mm(emb[:n_real].t(), dh_pre),
                "scatter_rows": lambda: buf.index_add_(0, src_idx, dx_edge[:n_real]),
            }
            repeat_equal = ("conv_fwd", "conv_bwd_train", "dw_reduce", "tri_fwd", "tri_fwd_acc", "jvp_fwd", "tri_bwd",
                            "jvp_bwd")
            for label, (kern, plain) in calls.items():
                name = label.split()[0]  # the kernel; "dw_reduce dW1"/"dW2" are its two shapes
                sliced = name in ("tri_fwd_acc", "jvp_fwd", "jvp_bwd")
                where = f"layer {li} {dtype}"
                counter = K.KERNELS[name]
                err = 0.0
                checked = [checks[label]] if label in checks else []
                if name != "tri_fwd_acc":  # its timed form keeps adding onto acc_t: checked only above
                    checked.append((kern, plain))
                for run, ref_run in checked:
                    before = counter.launches
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                    got = _tuple(run())
                    torch.cuda.synchronize()
                    if counter.launches != before + 1:
                        raise RuntimeError(f"phase 2: {label} launch counter did not move")
                    if name == "conv_fwd":
                        _check_k1_allocations(torch.cuda.max_memory_allocated() - held, plan, x, w1, layout, where)
                    if name == "conv_bwd":
                        _check_k2_allocations(torch.cuda.max_memory_allocated() - held, plan, x, sh, emb, w2, where)
                    if name in ("tri_fwd", "tri_fwd_acc", "jvp_fwd", "tri_bwd", "jvp_bwd"):
                        _check_output_allocations(name, torch.cuda.max_memory_allocated() - held, got, where,
                                                  _carry_bytes(name, plan, x, lay_s if sliced else layout))
                    err = max(err, _check(label, got, _tuple(ref_run()), rtol, atol_rel, where))
                    if name in repeat_equal:
                        again = _tuple(run())
                        reduced = got[-2:] if name == "conv_bwd_train" else got
                        if not all(torch.equal(a, b) for a, b in zip(reduced, again[-len(reduced):])):
                            raise RuntimeError(f"phase 2: {label} differs on a repeat call")
                ms = cuda_median_ms(kern, reps)
                plain_ms = cuda_median_ms(plain, reps)
                lib_ms = cuda_median_ms(library[label], reps) if label in library else None
                itemsize = torch.finfo(dtype).bits // 8
                if name == "dw_reduce":
                    P, Q = (n_emb, hidden) if label.endswith("dW1") else (hidden, plan.weight_numel)
                    ops, nbytes = dw_work(n_real, P, Q, itemsize)
                else:
                    ops, nbytes = work(
                        name, plan, lay_s.n_real if sliced else n_real, n_touched_s if sliced else n_dst,
                        n_src_s if sliced else n_src, N, hidden, n_emb, itemsize,
                    )
                bound, by = _bound_ms(ops, nbytes)
                burst = ""
                if name == "conv_fwd":  # the unfused composition K1 replaces, as tp_impl="fused_tp" runs it
                    unfused = cuda_median_ms(
                        lambda: K.tri_fwd(plan, x, sh, K.radial_weights(emb, w1, w2, a0, a1), layout), reps)
                    burst = f"; unfused radial_weights + K4 {unfused:.3f} ms"
                if name == "dw_reduce":
                    ms10, lib10 = _ten_back_to_back((kern, library[label]), reps)
                    burst = f"; 10 back to back, per call: kernel {ms10:.3f} ms, library {lib10:.3f} ms"
                print(
                    f"phase 2 {label} layer {li} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e}, "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                    + (f", bound {bound:.3f} ms ({by})" if dtype == torch.float32 else "")
                    + ("" if lib_ms is None else f", library {lib_ms:.3f} ms") + burst,
                    flush=True,
                )
                if dtype == torch.float32:
                    if name in tile_layers:
                        tile_layers[name].append((ms, bound))
                    if name == "conv_fwd":
                        unfused_ms.append(unfused)
                    if name == "dw_reduce":
                        dw_sums.setdefault(label, np.zeros(6))[:] += (ms, plain_ms, bound, lib_ms, ms10, lib10)
                    r = report[name]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["ms"] += ms
                    r["plain_ms"] += plain_ms
                    r["bound_ms"] += bound
                    r["ops"] += ops
                    r["bytes"] += nbytes
                    if lib_ms is not None:
                        r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            del x, sh, emb, w1, w2, g, w, h_e, dw_e, dh_pre, dx_edge, calls, checks, tx, tsh, dw, gt, acc, tacc, acc_t
            del s_ops, library, buf
            torch.cuda.empty_cache()
    for name, rows in tile_layers.items():
        print(f"phase 2 {name} f32 per layer (kernel / bound ms): "
              + ", ".join(f"{ms:.3f} / {bound:.3f}" for ms, bound in rows)
              + f"; sum {sum(r[0] for r in rows):.3f} / {sum(r[1] for r in rows):.3f}"
              + (f"; unfused radial_weights + K4 per layer {', '.join(f'{u:.3f}' for u in unfused_ms)}, "
                 f"sum {sum(unfused_ms):.3f}" if name == "conv_fwd" else ""), flush=True)
    dw_sums["dw_reduce, both shapes (the report's row)"] = sum(dw_sums.values())
    for label, (ms, plain_ms, bound, lib_ms, ms10, lib10) in dw_sums.items():
        print(f"phase 2 {label} f32, sum of 3 layers: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound:.3f} ms, torch.mm {lib_ms:.3f} ms; 10 back to back, per call: kernel {ms10:.3f} ms, "
              f"torch.mm {lib10:.3f} ms", flush=True)
    for r in report.values():
        r["bound_by"] = "operations" if r.pop("ops") / F32_FLOP_S > r.pop("bytes") / HBM_BYTES_S else "bytes"
    return report


def _check_k1_allocations(nbytes: int, plan, x, w1, layout, where: str) -> None:
    """K1 may allocate its output out [N, mid_dim] and its carry rows
    [ceil(n_real / tile), mid_dim], with 32 MiB for its term tables and the
    allocator's rounding, and nothing per edge besides: a per-edge [E, WN]
    buffer would pass the limit by E x 96 x 4 B = 161 MB or more at the
    23k-atom stream."""
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    tile = K.conv_fwd_tile(plan, *w1.shape, x.dtype, x.device)
    rows = layout.num_nodes + K.conv_fwd_carry_rows(layout.n_real, tile)
    limit = x.element_size() * rows * plan.mid_dim + 32 * 2**20
    print(f"phase 2 conv_fwd {where}: allocated {nbytes / 2**20:.1f} MiB in one call, limit {limit / 2**20:.1f} MiB "
          f"(out, {tile}-edge tiles' carry rows and 32 MiB; no per-edge [E, WN] or [E, hidden] buffer)", flush=True)
    if nbytes > limit:
        raise RuntimeError(f"phase 2: K1 allocated more than out and its carry rows at {where} (a per-edge buffer?)")


def _check_k2_allocations(nbytes: int, plan, x, sh, emb, w2, where: str) -> None:
    """The inference K2 may allocate its outputs dx [E, dim_in], dsh [E,
    sh_dim] and demb [E, n_emb], W2^T and its term tables, with 32 MiB for
    the allocator's rounding, and nothing per edge besides: a per-edge [E,
    WN] or [E, hidden] buffer would pass the limit by E x 96 x 4 B = 161 MB
    or more at the 23k-atom stream."""
    E = sh.shape[0]
    limit = x.element_size() * (E * (plan.dim_in + plan.sh_dim + emb.shape[1]) + w2.numel()) + 32 * 2**20
    print(f"phase 2 conv_bwd {where}: allocated {nbytes / 2**20:.1f} MiB in one call, limit {limit / 2**20:.1f} MiB "
          f"(outputs, W2^T and 32 MiB; no per-edge [E, WN] or [E, hidden] buffer)", flush=True)
    if nbytes > limit:
        raise RuntimeError(f"phase 2: the inference K2 allocated more than its outputs at {where} (a per-edge buffer?)")


def _carry_bytes(name: str, plan, x, layout) -> int:
    """The carry rows of K4, K4-acc and K6 ([ceil(n_real / tile), mid_dim],
    K6 two of them; see csrc/cg_fwd.cuh); 0 for the other kernels."""
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    if name not in ("tri_fwd", "tri_fwd_acc", "jvp_fwd"):
        return 0
    entry = "jvp_fwd" if name == "jvp_fwd" else "tri_fwd"
    rows = K.conv_fwd_carry_rows(layout.n_real, K.tri_fwd_tile(plan, entry, x.dtype, x.device))
    return x.element_size() * rows * plan.mid_dim * (2 if entry == "jvp_fwd" else 1)


def _check_output_allocations(name: str, nbytes: int, outs, where: str, carry: int = 0) -> None:
    """K4, K4-acc, K5, K6 and K7 may allocate their outputs (K5, K7: per
    edge; the accumulating forms: none, the check's copies of the
    accumulators are counted as their outputs) and K4's and K6's carry rows
    (``carry`` bytes), with 32 MiB for the allocator's rounding, and nothing
    besides (no per-edge scratch)."""
    limit = sum(t.numel() * t.element_size() for t in outs) + carry + 32 * 2**20
    print(f"phase 2 {name} {where}: allocated {nbytes / 2**20:.1f} MiB in one call, limit {limit / 2**20:.1f} MiB "
          f"(outputs, {carry / 2**20:.1f} MiB of carry rows and 32 MiB)", flush=True)
    if nbytes > limit:
        raise RuntimeError(f"phase 2: {name} allocated more than its outputs at {where}")


def phase3_golden():
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params

    if not GOLDEN.exists():
        raise RuntimeError(f"phase 3: golden file {GOLDEN} is missing")
    z = np.load(GOLDEN)
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(model, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    calc = NequIPCalculator.from_model(model, device="cuda")
    frame = {"pos": z["pos"], "cell": z["cell"], "pbc": z["pbc"], "atomic_numbers": z["atomic_numbers"]}
    res = calc.calculate(frame)
    e_err = abs(res["energy"] - float(z["energy"])) / abs(float(z["energy"]))
    f_err = float(np.abs(res["forces"] - z["forces"]).max())
    s_err = float(np.abs(res["stress"] - z["stress"]).max())
    print(
        f"phase 3 golden (f64, kernels): energy rel err {e_err:.3e}, forces max err {f_err:.3e}, "
        f"stress max err {s_err:.3e}",
        flush=True,
    )
    if not (e_err <= 1e-10 and f_err <= 1e-8 and s_err <= 1e-8):
        raise RuntimeError("phase 3: the port disagrees with the JAX golden")
    del model, calc
    torch.cuda.empty_cache()


def phase4_serve(n_atoms: int, n_requests: int = 3):
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    calc = NequIPCalculator.from_model(model, device="cuda")
    frames = [fcc_frame(n_atoms, seed=s, jitter=0.05) for s in range(1, n_requests + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    results = []
    for i, frame in enumerate(frames):
        res = calc.calculate(frame)
        results.append(res)
        print(
            f"phase 4 request {i}: {len(frame['pos'])} atoms, neighbour list "
            f"{calc.timings['neighbor_list_s'] * 1e3:.1f} ms (of prep {calc.timings['prepare_s'] * 1e3:.1f} ms), "
            f"model {calc.timings['model_s'] * 1e3:.1f} ms, "
            f"E {res['energy']:.6f}",
            flush=True,
        )
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 4 launches {launches}, max_memory_allocated (serving peak) {peak / 2**30:.3f} GiB, "
          f"limit {SERVING_PEAK_LIMIT / 2**30:.3f} GiB", flush=True)
    if n_atoms == 23000 and peak > SERVING_PEAK_LIMIT:
        raise RuntimeError("phase 4: the serving peak grew (a per-edge buffer in the backward?)")
    for name in SERVING_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"phase 4: kernel {name} was not launched on the serving path")
    if any(launches[k] for k in launches if k not in SERVING_KERNELS):
        raise RuntimeError("phase 4: serving launched a training kernel")
    for i, res in enumerate(results):
        F = res["forces"]
        n = F.shape[0]
        drift = float(np.abs(F.sum(axis=0)).max())
        if not (math.isfinite(res["energy"]) and np.isfinite(F).all()):
            raise RuntimeError(f"phase 4: request {i} returned non-finite values")
        if drift > 1e-3 * float(np.abs(F).max()) * math.sqrt(n):
            raise RuntimeError(f"phase 4: request {i} net force {drift:.3e} breaks translation invariance")

    ref_model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="torch", **FLAGSHIP)
    ref_model.load_state_dict(model.state_dict())
    ref = NequIPCalculator.from_model(ref_model, device="cuda").calculate(frames[0])
    e_rel = abs(ref["energy"] - results[0]["energy"]) / abs(ref["energy"])
    f_err = float(np.abs(ref["forces"] - results[0]["forces"]).max())
    f_scale = float(np.abs(ref["forces"]).max())
    print(
        f"phase 4 fused vs torch (f32, card): energy rel err {e_rel:.3e}, "
        f"forces max err {f_err:.3e} (max |F| {f_scale:.3e})",
        flush=True,
    )
    if not (e_rel <= 1e-5 and f_err <= 1e-4 * f_scale):
        raise RuntimeError("phase 4: fused and torch paths disagree")
    return launches


def _grad_errors(got: dict, want: dict) -> float:
    """Largest per-tensor max |diff| / max |want| over the port's gradients
    (``want`` may hold more: the JAX tree has the frozen leaves too)."""
    if not got or not set(got) <= set(want):
        raise RuntimeError(f"gradients without a reference: {sorted(set(got) - set(want))}")
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-300) for k in got)


def phase5_train_golden():
    """rr (phase 5) and fr with 0 and N_CHUNKS edge slices (5b) against the
    rr training golden, f64, kernels."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads, load_jax_params
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    if not TRAIN_GOLDEN.exists():
        raise RuntimeError(f"phase 5: training golden file {TRAIN_GOLDEN} is missing")
    z, params = np.load(TRAIN_GOLDEN), np.load(GOLDEN)
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(model, {k[len("params/"):]: params[k] for k in params.files if k.startswith("params/")})
    model = model.to("cuda")
    frame = {k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "total_energy", "forces")}
    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    n_edges = data["edge_index"].shape[1]
    batch = to_tensors(pad_batch(batched_from_list([data]), 128, round_up(n_edges, 256), 2), "cuda")
    want = {k[len("grads/"):]: z[k] for k in z.files if k.startswith("grads/")}
    for label, mode, n_chunks in (("5", "rr", 0), ("5b", "fr", 0), ("5b", "fr", N_CHUNKS)):
        module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode,
                                   fr_edge_chunks=n_chunks)
        K.reset_launch_counts()
        if mode == "rr":
            loss, _, _ = module.compute_loss(batch)
            loss.backward()
        else:
            loss, _, _ = module.compute_grads_fr(batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in K.KERNELS.items()}
        loss_err = abs(float(loss.detach()) - float(z["loss"])) / abs(float(z["loss"]))
        grad_err = _grad_errors(jax_named_grads(model), want)
        model.zero_grad(set_to_none=True)
        print(
            f"phase {label} training golden ({mode}, fr_edge_chunks {n_chunks}, f64, kernels): "
            f"loss {float(loss.detach()):.10e} rel err {loss_err:.3e}, grads max err / max|grad| {grad_err:.3e}, "
            f"launches {launches}",
            flush=True,
        )
        expected = TRAINING_KERNELS if mode == "rr" else FR_CHUNKED_KERNELS if n_chunks else (
            "conv_fwd", "conv_bwd", "conv_bwd_train", "dw_reduce", "scatter_rows", "tri_fwd", "tri_bwd")
        for name in expected:
            if launches[name] == 0:
                raise RuntimeError(f"phase {label}: kernel {name} was not launched ({mode}, {n_chunks} slices)")
        chunked = [name for name in ("tri_fwd_acc", "jvp_fwd", "jvp_bwd") if launches[name]]
        if bool(chunked) != bool(n_chunks):
            raise RuntimeError(f"phase {label}: the chunked kernels' launches {chunked} do not match {n_chunks} slices")
        if not (loss_err <= 1e-10 and grad_err <= 1e-8):
            raise RuntimeError(f"phase {label}: the port's {mode} loss or gradients disagree with the JAX golden")
        del module, loss
    del model
    torch.cuda.empty_cache()


def lj_datamodule(phase: str, supercell: int = 18):
    """Phase 6's data: three LJ frames of the supercell (23,328 atoms at 18),
    two to train on and one to validate, on the card."""
    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform

    t0 = time.perf_counter()
    ds = LJTestDataset(supercell=(supercell,) * 3, num_frames=3, seed=0,
                       transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
    dm = NequIPDataModule(seed=0, split_dataset={"dataset": ds, "train": 2, "val": 1},
                          train_dataloader={"batch_size": 1}, val_dataloader={"batch_size": 1}, device="cuda")
    dm.setup("fit")
    print(f"{phase} data: 3 LJ frames of {len(ds.frames[0]['pos'])} atoms in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dm


def phase6_train(smi: str, supercell: int = 18, epochs: int = 2):
    """Trainer.fit of the flagship at full width on 23k-atom LJ frames."""
    import torch

    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

    dm = lj_datamodule("phase 6", supercell)

    def make(tp_impl):
        model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=tp_impl, **FLAGSHIP).to("cuda")
        return NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), val_metrics=EnergyForceMetrics(),
                                 optimizer={"_target_": "optax.adam", "learning_rate": 1e-3})

    module = make("fused")
    # the first step's gradients, fused against plain, on the trainer's first batch
    first = next(iter(DataLoader(dm.datasets["train"][0], batch_size=1, shuffle=True, seed=dm.seed, device="cuda")))
    grads = {}
    for impl, m in (("fused", module), ("torch", make("torch"))):
        if impl == "torch":
            m.model.load_state_dict(module.model.state_dict())
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = m.compute_loss(first)
        loss.backward()
        grads[impl] = jax_named_grads(m.model)
        m.optimizer.zero_grad(set_to_none=True)
        print(f"phase 6 first-step grads {impl}: loss {float(loss.detach()):.6e}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
        del loss
    grad_err = _grad_errors(grads["fused"], grads["torch"])
    print(f"phase 6 first-step grads fused vs torch (f32, card): max err / max|grad| {grad_err:.3e}", flush=True)
    if not grad_err <= 1e-4:
        raise RuntimeError("phase 6: fused and torch first-step gradients disagree")
    del grads, m
    torch.cuda.empty_cache()

    trainer = Trainer(max_epochs=epochs, ckpt_dir=str(ROOT / "chiprun_out" / "chip_smoke_train"), save_last=False,
                      save_best=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t1 = time.perf_counter()
    trainer.fit(module, dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = np.asarray(trainer.step_seconds[1:]) * 1e3
    print(
        f"phase 6 train ({smi}): {trainer.global_step} steps in {fit_s:.1f} s, first step "
        f"{trainer.step_seconds[0] * 1e3:.1f} ms, later steps median {np.median(steps):.1f} ms "
        f"(min {steps.min():.1f}, max {steps.max():.1f}), max_memory_allocated {peak / 2**30:.3f} GiB",
        flush=True,
    )
    for row in trainer.metrics_rows:
        print(
            f"phase 6 epoch {row['epoch']}: train loss {row['train_loss_epoch/weighted_sum']:.6e}, "
            f"val loss {row['val0_epoch/weighted_sum']:.6e} (forces rmse {row['val0_epoch/forces_rmse']:.4e})",
            flush=True,
        )
    print(f"phase 6 launches {launches}", flush=True)
    for name in TRAINING_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"phase 6: kernel {name} was not launched on the training path")
    _check_fit("phase 6", trainer, epochs)
    summary = dict(median_ms=float(np.median(steps)), peak_gib=peak / 2**30,
                   losses=[row["train_loss_epoch/weighted_sum"] for row in trainer.metrics_rows])
    return launches, dm, summary


def _check_fit(phase: str, trainer, epochs: int) -> None:
    for row in trainer.metrics_rows:
        if not all(math.isfinite(row[k]) for k in ("train_loss_epoch/weighted_sum", "val0_epoch/weighted_sum")):
            raise RuntimeError(f"{phase}: non-finite training or validation loss")
    if len(trainer.metrics_rows) != epochs or trainer.global_step != 2 * epochs:
        raise RuntimeError(f"{phase}: the trainer did not run 2 steps per epoch")


def phase7_train_fr(smi: str, dm, rr: dict, epochs: int = 2):
    """Trainer.fit with fr force-loss gradients over N_CHUNKS edge slices,
    beside phase 6's rr numbers."""
    import torch

    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP).to("cuda")

    def make(mode, n_chunks=0):
        return NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), val_metrics=EnergyForceMetrics(),
                                 optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                                 force_grad_mode=mode, fr_edge_chunks=n_chunks)

    module = make("fr", N_CHUNKS)
    # the first step's gradients, fr over slices against rr, on the trainer's first batch
    first = next(iter(DataLoader(dm.datasets["train"][0], batch_size=1, shuffle=True, seed=dm.seed, device="cuda")))
    grads = {}
    for mode, m in (("rr", make("rr")), ("fr", module)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mode == "rr":
            loss, _, _ = m.compute_loss(first)
            loss.backward()
        else:
            loss, _, _ = m.compute_grads_fr(first)
        torch.cuda.synchronize()
        grads[mode] = jax_named_grads(model)
        model.zero_grad(set_to_none=True)
        print(f"phase 7 first-step grads {mode}: loss {float(loss.detach()):.6e}, {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
        del loss
    grad_err = _grad_errors(grads["fr"], grads["rr"])
    print(f"phase 7 first-step grads fr ({N_CHUNKS} slices) vs rr (f32, card): max err / max|grad| {grad_err:.3e}",
          flush=True)
    if not grad_err <= 1e-4:
        raise RuntimeError("phase 7: fr and rr first-step gradients disagree")
    del grads
    torch.cuda.empty_cache()

    trainer = Trainer(max_epochs=epochs, ckpt_dir=str(ROOT / "chiprun_out" / "chip_smoke_train_fr"), save_last=False,
                      save_best=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t1 = time.perf_counter()
    trainer.fit(module, dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = np.asarray(trainer.step_seconds[1:]) * 1e3
    print(
        f"phase 7 train fr, {N_CHUNKS} edge slices ({smi}): {trainer.global_step} steps in {fit_s:.1f} s, first step "
        f"{trainer.step_seconds[0] * 1e3:.1f} ms, later steps median {np.median(steps):.1f} ms "
        f"(min {steps.min():.1f}, max {steps.max():.1f}), max_memory_allocated {peak / 2**30:.3f} GiB; "
        f"rr (phase 6): median {rr['median_ms']:.1f} ms, {rr['peak_gib']:.3f} GiB",
        flush=True,
    )
    for row, rr_loss in zip(trainer.metrics_rows, rr["losses"]):
        print(
            f"phase 7 epoch {row['epoch']}: train loss {row['train_loss_epoch/weighted_sum']:.6e} (rr {rr_loss:.6e}), "
            f"val loss {row['val0_epoch/weighted_sum']:.6e} (forces rmse {row['val0_epoch/forces_rmse']:.4e})",
            flush=True,
        )
    print(f"phase 7 launches {launches}", flush=True)
    for name in FR_CHUNKED_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"phase 7: kernel {name} was not launched on the fr training path")
    _check_fit("phase 7", trainer, epochs)
    return launches


def mb_work(plan, variant: str, be: int, rows: int, grid: int, itemsize: int = 4,
            n_emb: int = 8, hidden: int = 128):
    """(f32 operations, tensor-core operations, bytes) of one T1-T4 call:
    the function's arithmetic per chunk (not the TPU's one-hot matmul) times
    ``grid``; the chunk stays in L2, so its operands count once and the
    outputs once.  ``variant`` "cgvjp"/"cgvjp_t" is T2/T4."""
    M, W, D, S = plan.mid_dim, plan.weight_numel, plan.dim_in, plan.sh_dim
    TC = sum(len(p["terms"]) * p["mul"] for p in plan.paths)
    PY = sum(p["y_dim"] * p["mul"] for p in plan.paths)
    mm = be * 2 * (n_emb * hidden + hidden * W)  # the radial MLP's two products
    silu, cg, scatter = be * 4 * hidden, be * (3 * TC + M), be * M
    ops, mm_ops = {
        "dot": (scatter, 0), "mlp": (silu, mm), "cg": (cg, 0), "cg_t": (cg, 0), "xpose": (0, 0),
        "full": (silu + cg + scatter, mm), "full_t": (silu + cg + scatter, mm), "full_t_pre": (silu + cg + scatter, mm),
        "cgvjp": (be * (7 * TC + 4 * PY), 0), "cgvjp_t": (be * (7 * TC + 4 * PY), 0),
    }[variant]
    widths = {
        "dot": D + 1, "mlp": n_emb + n_emb * hidden / be + hidden * W / be, "cg": D + S, "cg_t": D + S + W,
        "xpose": D, "cgvjp": D + S + M + W + (D + S + W), "cgvjp_t": D + S + M + W + (D + S + W),
    }.get(variant, D + S + n_emb + 1 + (n_emb * hidden + hidden * W) / be)  # full*
    nbytes = itemsize * be * widths + (0 if variant.startswith("cgvjp") else itemsize * rows * M)
    return grid * ops, grid * mm_ops, nbytes


def _mb_bound(ops: float, mm_ops: float, nbytes: float, tf32: bool):
    t_ops = (ops / F32_FLOP_S + mm_ops / (TF32_FLOP_S if tf32 else F32_FLOP_S)) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _w2_mm_ms(ops: dict, G: int, tf32: bool, reps: int) -> float:
    """cuBLAS's time for the radial MLP's W2 product alone over the call's G x
    be rows (h of the chunk repeated G times), in f32 or with TF32 allowed
    (the setting restored after)."""
    import torch

    h = torch.nn.functional.silu(ops["emb"] @ ops["w1"]).repeat(G, 1)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return cuda_median_ms(lambda: torch.mm(h, ops["w2"]), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        del h
        torch.cuda.empty_cache()


def phase8a_microbench(smi: str, reps: int = 10, grid: int = 2048, rows: int = 128, be: int = 256):
    """T1-T4 at the tool's full width against their plain versions."""
    import torch

    from nequip_tpu_torch.ops.kernels import microbench as MB
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.tools.kernel_microbench import make_inputs, to_tensors

    plan, arrays = make_inputs(rows, be)
    report = {}
    for dtype, G in ((torch.float32, grid), (torch.float64, 4)):
        ops = to_tensors(arrays, "cuda", dtype)
        f64 = dtype == torch.float64
        runs = [(v, p) for v in MB.FWD_VARIANTS for p in (("HIGHEST",) if f64 else MB.PRECISIONS)]
        runs += [("cgvjp", "HIGHEST")] + [(v, "HIGHEST" if f64 else "DEFAULT") for v in MB.FWD_T_VARIANTS]
        runs += [("cgvjp_t", "HIGHEST")]
        for variant, prec in runs:
            bwd = variant.startswith("cgvjp")
            layout = "t" if variant in MB.FWD_T_VARIANTS or variant == "cgvjp_t" else "r"
            tf32 = prec == "DEFAULT" and variant in MB.MLP_VARIANTS
            counter = K.KERNELS[("mb_bwd" if bwd else "mb_fwd") + ("_t" if layout == "t" else "")]
            if bwd:
                kern = lambda: MB.chunk_bwd(plan, ops, G, layout)  # noqa: E731
                plains = [(lambda: MB.chunk_bwd_plain(plan, ops, layout), 1e-12 if f64 else 1e-4)]
            else:
                kern = lambda: (MB.chunk_fwd(plan, variant, ops, rows, G, prec),)  # noqa: E731
                plains = [(lambda: (MB.chunk_fwd_plain(plan, variant, ops, rows, G, tf32=tf32),), 1e-12 if f64 else 1e-4)]
                if tf32:
                    plains.append((lambda: (MB.chunk_fwd_plain(plan, variant, ops, rows, G),), 1e-2))
            before = counter.launches
            got = _tuple(kern())
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise RuntimeError(f"phase 8a: {variant} launch counter did not move")
            err = 0.0
            for plain, rel in plains:
                for a, b in zip(got, _tuple(plain())):
                    scale = float(b.abs().max())
                    diff = float((a - b).abs().max())
                    if not (bool(a.isfinite().all()) and diff <= rel * scale):
                        raise RuntimeError(f"phase 8a: {variant} {prec} {dtype} disagrees with plain: "
                                           f"max |diff| {diff:.3e}, max |ref| {scale:.3e} (bound {rel:g} max|ref|)")
                    if rel < 1e-2:
                        err = max(err, diff)
            if not all(torch.equal(a, b) for a, b in zip(got, _tuple(kern()))):
                raise RuntimeError(f"phase 8a: {variant} {prec} {dtype} differs on a repeat call")
            name = f"{variant} {prec}" + (" f64" if f64 else "")
            if bwd:
                shape = MB.bwd_launch_shape(plan, ops, G, layout)
                print(f"phase 8a {name} launch: {shape['tile']}-edge tiles, {shape['n_ranges']} step ranges, "
                      f"{shape['n_blocks']} blocks, {shape['smem']} bytes of shared memory a block, "
                      f"{shape['per_sm']} blocks an SM", flush=True)
            else:
                shape = MB.fwd_launch_shape(plan, variant, ops, rows, G, prec)
                print(f"phase 8a {name} launch: {shape['n_blocks']} blocks ({shape['n_ranges']} step ranges x column "
                      f"groups), {shape['smem']} bytes of shared memory a block; groups: {shape['groups']}", flush=True)
            if f64:
                print(f"phase 8a {name} G={G}: max_abs_err {err:.3e}", flush=True)
                continue
            ms = cuda_median_ms(kern, reps)
            plain_ms = cuda_median_ms(plains[0][0], reps)
            w_ops, w_mm, nbytes = mb_work(plan, variant, be, rows, G)
            bound, by = _mb_bound(w_ops, w_mm, nbytes, tf32=False)
            bound_tf32 = _mb_bound(w_ops, w_mm, nbytes, tf32=True)[0]
            if bwd:  # the plain version computes one step; a call at half the steps must take about half the time
                full_ms, half_ms = interleaved_median_ms([kern, lambda: MB.chunk_bwd(plan, ops, G // 2, layout)], reps)
                ratio = full_ms / half_ms
                plain = (f"plain (one step) {plain_ms:.3f} ms a chunk, kernel at G={G} / G={G // 2} in turns "
                         f"{full_ms:.3f} / {half_ms:.3f} ms (time ratio {ratio:.3f})")
                if not 1.7 <= ratio <= 2.3:
                    raise RuntimeError(f"phase 8a: {variant} at G={G} takes {ratio:.3f}x its time at G={G // 2}, "
                                       "outside [1.7, 2.3]: the steps' work is not all done")
            else:
                plain = f"plain {plain_ms:.3f} ms"
            print(
                f"phase 8a {name} ({smi}): max_abs_err {err:.3e}, kernel {ms:.3f} ms "
                f"({ms / G * 1e3:.2f} us/chunk), {plain}, bound {bound:.4f} ms ({by}, f32)"
                + (f", TF32 bound {bound_tf32:.4f} ms" if w_mm else ""),
                flush=True,
            )
            report[(variant, prec)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_tf32 if tf32 else bound, bound_by=by)
            if variant == "mlp":
                print(f"phase 8a mlp {prec} ({smi}): W2 product alone, not the same function: torch.mm "
                      f"[{G * be}, {ops['w2'].shape[0]}] x {list(ops['w2'].shape)} {_w2_mm_ms(ops, G, tf32, reps):.3f} ms "
                      f"({'TF32 allowed' if tf32 else 'f32'})", flush=True)
        del ops
    torch.cuda.empty_cache()

    def row(key, family):
        r = dict(report[key], library_ms=None)
        r["max_abs_err"] = max(v["max_abs_err"] for k, v in report.items() if k[0] in family)
        return r

    return {
        "mb_fwd": row(("full", "HIGHEST"), MB.FWD_VARIANTS),
        "mb_bwd": row(("cgvjp", "HIGHEST"), ("cgvjp",)),
        "mb_fwd_t": row(("full_t", "DEFAULT"), MB.FWD_T_VARIANTS),
        "mb_bwd_t": row(("cgvjp_t", "HIGHEST"), ("cgvjp_t",)),
    }


def phase8b_gather(smi: str, reps: int = 10, rows: int = 430080, dim: int = 288):
    """T5 on the 23k-atom edge stream against torch.index_select: at the
    tool's default (block_e, n_buf), which phase 8c launches and which also
    shapes the "local" index pattern (the report's time), and at the
    wrapper's own defaults."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.ops.kernels.row_gather import row_gather, row_gather_plain
    from nequip_tpu_torch.tools.gather_microbench import PATTERNS, make_idx, parse_args

    tool = parse_args([])
    block_e, n_buf = tool.block_e, tool.n_buf
    gen = torch.Generator(device="cuda").manual_seed(0)
    src32 = torch.randn(rows, dim, generator=gen, device="cuda")
    report = None
    for dtype in (torch.float32, torch.bfloat16):
        src = src32.to(dtype)
        for pattern in PATTERNS:
            idx = torch.as_tensor(make_idx(pattern, rows, rows, block_e, np.random.RandomState(0)), device="cuda")
            before = K.KERNELS["row_gather"].launches
            got = row_gather(src, idx)
            torch.cuda.synchronize()
            if K.KERNELS["row_gather"].launches != before + 1:
                raise RuntimeError("phase 8b: row_gather launch counter did not move")
            lib = torch.index_select(src, 0, idx)
            if not (torch.equal(got, lib) and torch.equal(row_gather(src, idx, block_e, n_buf), got)):
                raise RuntimeError(f"phase 8b: row_gather {pattern} {dtype} differs from index_select or itself")
            ms, ms_wrapper, lib_ms, plain_ms = interleaved_median_ms([
                lambda: row_gather(src, idx, block_e, n_buf),
                lambda: row_gather(src, idx),
                lambda: torch.index_select(src, 0, idx),
                lambda: row_gather_plain(src, idx),
            ], reps)
            nbytes = 2 * rows * dim * src.element_size() + 4 * rows
            bound = nbytes / HBM_BYTES_S * 1e3
            useful = rows * dim * src.element_size()
            print(
                f"phase 8b row_gather {pattern} {str(dtype).split('.')[-1]} [{rows}, {dim}] ({smi}): bitwise equal, "
                f"kernel (block_e {block_e}, n_buf {n_buf}) {ms:.4f} ms ({useful / ms / 1e6:.1f} GB/s useful; "
                f"wrapper's defaults: {ms_wrapper:.4f} ms), index_select {lib_ms:.4f} ms "
                f"({useful / lib_ms / 1e6:.1f} GB/s), plain src[idx] {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)",
                flush=True,
            )
            if report is None:  # f32, random, at the tool's defaults (the shape phase 8c launches)
                report = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                              library_ms=lib_ms)
    del src32, src, got, lib
    torch.cuda.empty_cache()
    return report


def phase8c_tools():
    """Both port tools' run() at their defaults; their kernels must launch."""
    import contextlib
    import io

    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.tools import gather_microbench, kernel_microbench

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for tool in (kernel_microbench, gather_microbench):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results = tool.run(tool.parse_args([]))
        lines = out.getvalue().splitlines()
        for ln in lines[1:]:
            print(f"phase 8c {tool.__name__.rsplit('.', 1)[-1]}: {ln}", flush=True)
        if any(not bool(r["out"].isfinite().all()) for r in results if r["out"].is_floating_point()):
            raise RuntimeError(f"phase 8c: {tool.__name__} gave non-finite output")
        del results
    torch.cuda.synchronize()
    launches = {k: K.KERNELS[k].launches for k in MICROBENCH_KERNELS}
    print(f"phase 8c launches {launches} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"phase 8c: kernel {name} was not launched by the tools")
    torch.cuda.empty_cache()
    return launches


# phase 9: the MD driver at 23k atoms, as bench.py's MD row drives the JAX one
MD_STEPS = 100
MD_MASS = 63.546  # amu, Cu
MD_SKIN = 0.5
# Host and block integration run the same kernels on the same float64 state;
# the Verlet forms differ in rounding (make_step against the split halves),
# and float32 forces carry such differences through the chaotic trajectory.
# After 110 steps from one start the gaps must stay below these (3.3e-8 A
# and 6.5e-7 of max |F| on an H100 80GB HBM3 at 700 W); a force call on a
# stale layout misses or adds whole pair terms.
MD_POS_TOL = 1e-5  # Angstrom
MD_FORCE_TOL = 1e-4  # of max |F|
# forces of a replayed block against a fresh neighbour list on the same
# positions: the same kernels on the same inputs, so float32 rounding at most
STALE_FORCE_TOL = 1e-6  # of max |F|
NVE_DRIFT_LIMIT = 1e-3  # eV per atom over the run (velocity Verlet, 2 fs)
MD_RUNS: dict = {}  # _md_run's numbers by phase and label ("9b", "16d.b", ...)


def _edge_rows(edge_index, shifts, mask=None) -> np.ndarray:
    """(dst, src, shift) rows of the (real) edges, sorted, to compare edge sets."""
    rows = np.concatenate([np.asarray(edge_index).T.astype(np.int64), np.rint(np.asarray(shifts)).astype(np.int64)],
                          axis=1)
    if mask is not None:
        rows = rows[np.asarray(mask)]
    return rows[np.lexsort(rows.T[::-1])]


def _md_frame(n_atoms: int) -> dict:
    f = fcc_frame(n_atoms)
    return {"pos": f["pos"], "cell": f["cell"], "pbc": f["pbc"], "atom_types": np.zeros(len(f["pos"]), dtype=np.int64)}


def phase9a_neighbor_list(smi: str, frame: dict, cutoff: float) -> dict:
    """The C++ cell list's build, and both backends at MD's cutoff (r_max +
    skin) on the 23k-atom frame; their edge sets must be equal.  Returns the
    C++ list's median ms and edge rows."""
    import tempfile

    from nequip_tpu_torch.data import _cpp_nl, neighbor_list

    _cpp_nl.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cpp_nl.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        _cpp_nl.build(Path(tmp))
        build_s = time.perf_counter() - t0
    ms, rows = {}, {}
    for backend, reps in (("cpp", 3), ("kdtree", 2)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ei, sh = neighbor_list(frame["pos"], cutoff, cell=frame["cell"], pbc=frame["pbc"], backend=backend)
            times.append(time.perf_counter() - t0)
        ms[backend] = 1e3 * float(np.median(times))
        rows[backend] = _edge_rows(ei, sh)
    equal = rows["cpp"].shape == rows["kdtree"].shape and bool((rows["cpp"] == rows["kdtree"]).all())
    print(f"phase 9a neighbour list ({smi}, host CPU): C++ cell list built by g++ in {build_s:.1f} s; "
          f"{len(frame['pos'])} atoms, cutoff {cutoff} A: cpp {ms['cpp']:.1f} ms (median of 3), "
          f"kdtree {ms['kdtree']:.1f} ms (median of 2), {len(rows['cpp'])} / {len(rows['kdtree'])} edges, "
          f"edge sets (dst, src, shift) equal: {equal}", flush=True)
    if not equal:
        raise RuntimeError("phase 9a: the cpp and kdtree neighbour lists differ")
    return {"ms": ms["cpp"], "rows": rows["cpp"]}


def _nl_work(pos: np.ndarray, cell: np.ndarray, dims, cell_cap: int, n_atoms: int, e_cap: int):
    """(operations, bytes) of one device_nl call: positions read once (and
    the cell and its inverse), the [E] stream (int64 dst and src, three
    float64 shifts, a mask byte) and the flag written once; ~11 float64
    operations (image add, difference, square, sum) a distance test, over
    the candidates this frame's buckets hold (27 neighbouring buckets, each
    up to cell_cap atoms)."""
    fw = (pos @ np.linalg.inv(cell)) % 1.0
    c3 = np.clip((fw * np.asarray(dims)).astype(int), 0, np.asarray(dims) - 1)
    counts = np.zeros(dims, dtype=np.int64)
    np.add.at(counts, tuple(c3.T), 1)
    capped = np.minimum(counts, cell_cap)
    around = sum(np.roll(capped, (i, j, k), axis=(0, 1, 2)) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))
    tests = int((counts * around).sum())
    return 11 * tests, 8 * (3 * n_atoms + 18) + e_cap * (16 + 24 + 1) + 4, tests


def phase9h_device_nl(smi: str, frame: dict, cutoff: float, cpp: dict) -> dict:
    """The device list (csrc/device_nl.cu) on phase 9's frame at r_max +
    skin: against its plain twin (slots and stream equal, equal flags),
    against the C++ list (the same edge set), bitwise equal on a repeat
    call, and its flag raised by a small bucket, per-atom or stream
    capacity, as the twin's.  Times: kernel, plain (CUDA events), C++
    (phase 9a, host clock), and the bound."""
    import torch

    from nequip_tpu_torch.data import round_up
    from nequip_tpu_torch.ops import device_nl as D

    pos_np, cell = np.asarray(frame["pos"], dtype=np.float64), np.asarray(frame["cell"], dtype=np.float64)
    n = len(pos_np)
    dims = D.suggest_grid_dims(cell, cutoff)
    cell_cap, k_max = D.size_capacities(pos_np, cell, dims, cpp["rows"][:, 0])
    e_cap = round_up(int(len(cpp["rows"]) * 1.1), 256)  # the MD driver's first-build capacity
    pos = torch.as_tensor(pos_np, dtype=torch.float64, device="cuda")
    grid = D.cell_grid(cell, cutoff, dims, torch.float64, "cuda")

    def run(fn, caps=(cell_cap, k_max), stream_cap=e_cap):
        out = (torch.empty(2, stream_cap, dtype=torch.int64, device="cuda"),
               torch.empty(stream_cap, 3, dtype=torch.float64, device="cuda"),
               torch.empty(stream_cap, dtype=torch.bool, device="cuda"))
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        slots = fn(pos, grid, *caps, flag, out=out, pad_index=n - 1)
        torch.cuda.synchronize()
        return tuple(slots) + out + (flag,)

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    got, again, ref = run(D.device_nl), run(D.device_nl), run(D.device_nl_plain)
    if not equal(got, ref):
        raise RuntimeError("phase 9h: the device list differs from its plain twin")
    if not equal(got, again):
        raise RuntimeError("phase 9h: two runs of the device list differ")
    ei, sh, mask, flag = got[3:]
    rows = _edge_rows(ei[:, mask].cpu().numpy(), sh[mask].cpu().numpy())
    if int(flag.item()) or rows.shape != cpp["rows"].shape or not (rows == cpp["rows"]).all():
        raise RuntimeError(f"phase 9h: the device list's {len(rows)} edges are not the C++ list's "
                           f"{len(cpp['rows'])} (overflow {int(flag.item())})")
    flags = {}
    for label, caps, stream_cap in (("cell_cap 2", (2, k_max), e_cap), ("k_max 8", (cell_cap, 8), e_cap),
                                    ("stream E/2", (cell_cap, k_max), e_cap // 2)):
        small, small_ref = run(D.device_nl, caps, stream_cap), run(D.device_nl_plain, caps, stream_cap)
        flags[label] = int(small[-1].item())
        if flags[label] != 1 or not equal(small, small_ref):
            raise RuntimeError(f"phase 9h: {label}: overflow flag {flags[label]} (want 1) or kernel and twin differ")

    out = (torch.empty(2, e_cap, dtype=torch.int64, device="cuda"),
           torch.empty(e_cap, 3, dtype=torch.float64, device="cuda"), torch.empty(e_cap, dtype=torch.bool, device="cuda"))
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = cuda_median_ms(lambda: D.device_nl(pos, grid, cell_cap, k_max, flag, out=out, pad_index=n - 1))
    plain_ms = cuda_median_ms(lambda: D.device_nl_plain(pos, grid, cell_cap, k_max, flag, out=out, pad_index=n - 1),
                              reps=3, warmup=1)
    ops, nbytes, tests = _nl_work(pos_np, cell, dims, cell_cap, n, e_cap)
    t_ops, t_bytes = ops / F64_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    bound, bound_by = max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")
    print(f"phase 9h device list ({smi}, f64): {n} atoms, cutoff {cutoff} A, grid {dims}, cell_cap {cell_cap}, "
          f"k_max {k_max}, stream {e_cap} slots: {len(rows)} edges, equal to the C++ list's and to the plain twin's "
          f"(slots, stream, flag), bitwise equal on a repeat call; overflow flags {flags}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms (CUDA events), C++ list {cpp['ms']:.1f} ms (host, phase 9a); bound {bound:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB, {tests} distance tests)", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def _md_run(label: str, smi: str, model, frame: dict, v0, integration: str, nl_backend: str = "host",
            steps: int = MD_STEPS, phase: str = "9", route: tuple = SERVING_KERNELS) -> dict:
    """A warm-up block, then ``steps`` timed steps from where it ended; the
    launches are counted from the driver's construction on and must be
    ``route``'s kernels (K1's serving kernels by default).  The result is
    also kept in MD_RUNS under phase + label (phase 16 prints phase 9's
    beside its own)."""
    import torch

    from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    n = len(frame["pos"])
    masses = np.full(n, MD_MASS)
    K.reset_launch_counts()
    driver = MDDriver(model, dict(frame), VelocityVerlet(dt_fs=2.0), masses=masses, skin=MD_SKIN,
                      steps_per_block=10, integration=integration, nl_backend=nl_backend)
    t0 = time.perf_counter()
    warm = driver.run(driver.steps_per_block, velocities=v0)
    warm_s = time.perf_counter() - t0
    dev = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    ke = lambda v: float(0.5 * np.sum(masses[:, None] * v**2))  # noqa: E731
    e0 = driver._potential_energy(dev(warm["positions"])) + ke(warm["velocities"])
    builds0, captures0 = len(driver.rebuild_timings), driver.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    capture_s0 = driver.capture_s
    t0 = time.perf_counter()
    out = driver.run(steps, velocities=warm["velocities"])
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in K.KERNELS.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    clock = driver.step_clock
    per_step = [1e3 * (tb - ta) / (sb - sa) for (sa, ta), (sb, tb) in zip(clock, clock[1:])]
    rebuilds = driver.rebuild_timings[builds0:]
    e1 = driver._potential_energy(dev(out["positions"])) + ke(out["velocities"])

    pos, forces = dev(out["positions"]), dev(out["forces"])
    half_a, half_b = driver.integrator.make_half_steps(driver.masses)
    state = (pos, dev(out["velocities"]), forces, torch.zeros((), dtype=torch.float64, device="cuda"))
    model_ms = cuda_median_ms(lambda: driver.forces(pos))
    integ_ms = cuda_median_ms(lambda: driver._disp2(half_b(*half_a(state), forces)[0]))
    med = float(np.median(per_step))
    if nl_backend == "device":
        rebuild_ms = float(np.mean([r["device_nl_ms"] for r in rebuilds])) if rebuilds else 0.0
        rebuild_text = (f"{len(rebuilds)} device rebuilds (list and layout; graph replays): {rebuild_ms:.3f} ms a "
                        f"rebuild (CUDA events), each followed by a force refresh")
    else:
        rebuild_ms = 1e3 * float(np.mean([r["neighbor_list_s"] + r["relayout_s"] for r in rebuilds])) if rebuilds else 0.0
        rebuild_text = (f"{len(rebuilds)} rebuilds: neighbour list "
                        f"{1e3 * np.mean([r['neighbor_list_s'] for r in rebuilds]) if rebuilds else 0:.1f} ms, "
                        f"pad + transfer + re-layout "
                        f"{1e3 * np.mean([r['relayout_s'] for r in rebuilds]) if rebuilds else 0:.1f} ms a rebuild")
    line = (f"phase {phase}{label} MD integration={integration} nl_backend={nl_backend} ({smi}): {n} atoms, warm-up block "
            f"{warm_s:.2f} s; {steps} steps in {wall_s:.3f} s ({1e3 * wall_s / steps:.2f} ms a step, "
            f"{n * steps / wall_s:.0f} atom-steps/s); step median {med:.2f} ms ({n / med * 1e3:.0f} atom-steps/s), "
            f"min {min(per_step):.2f}, max {max(per_step):.2f} ms (host clock per "
            f"{'step' if integration == 'host' else 'block / 10'}); model {model_ms:.2f} ms "
            f"({100 * model_ms / med:.0f}% of the median step), integrator {integ_ms:.3f} ms (CUDA events, "
            f"median of 10); {rebuild_text}; peak {peak / 2**30:.3f} GiB; edge capacity {driver._cap[1]}")
    if integration == "block":
        program = driver._block_program()
        replay_ms = cuda_median_ms(program, reps=5, warmup=1) / driver.steps_per_block
        line += (f"; captures {driver.captures} ({driver.captures - captures0} in the timed run), capture "
                 f"{driver.capture_s:.2f} s with its warm-up step, graph replay {replay_ms:.2f} ms a step "
                 f"(CUDA events, median of 5 blocks)")
    print(line, flush=True)
    print(f"phase {phase}{label} launches from the driver's construction on (counted in Python: eager calls"
          f"{', and each capture; replays add none' if integration == 'block' else ''}): {launches}", flush=True)
    if not (np.isfinite(out["positions"]).all() and np.isfinite(out["forces"]).all() and math.isfinite(e1)):
        raise RuntimeError(f"phase {phase}{label}: non-finite MD state")
    path_kernels = route + (("device_nl",) if nl_backend == "device" else ())
    for name in path_kernels:
        if not launches.get(name):
            raise RuntimeError(f"phase {phase}{label}: kernel {name} was not launched on the MD path")
    if any(k not in path_kernels for k in launches):
        raise RuntimeError(f"phase {phase}{label}: MD launched a kernel off its path: {launches}")
    result = {"out": out, "drift": abs(e1 - e0) / n, "e0": e0, "e1": e1, "launches": launches, "median_ms": med,
              "mean_ms": 1e3 * wall_s / steps, "atom_steps_s": n * steps / wall_s, "rebuilds": len(rebuilds),
              "rebuild_ms": rebuild_ms, "capture_s": driver.capture_s - capture_s0}
    MD_RUNS[phase + label] = {k: v for k, v in result.items() if k != "out"}
    return result


def phase9_md(smi: str) -> dict:
    """MD at 23k atoms: (a) neighbour lists, (h) the device list, (b) host
    and (c) block integration, (i) block integration with the device list
    against (c), (d) host against block, (e) a replayed block on refilled
    layouts against fresh neighbour lists, (g) the force call against the
    plain conv, (f) NVE drift; the launches in (b), (c) and (i).  Returns
    the device list's kernel report (launches from (i))."""
    import torch

    from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet, maxwell_boltzmann_velocities
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels.tp_scatter import LAYOUT_KEY

    frame = _md_frame(23000)
    n = len(frame["pos"])
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    cutoff = float(model.r_max) + MD_SKIN
    nl_report = phase9h_device_nl(smi, frame, cutoff, phase9a_neighbor_list(smi, frame, cutoff))
    v0 = maxwell_boltzmann_velocities(np.full(n, MD_MASS), 300.0, seed=1)
    runs = {integration: _md_run(label, smi, model, frame, v0, integration)
            for label, integration in (("b", "host"), ("c", "block"))}
    torch.cuda.empty_cache()
    nl_report["launches"] = phase9i_device_md(smi, model, frame, v0, runs["block"])
    phase9j_k4_device_md(smi, frame, v0)

    host, block = runs["host"]["out"], runs["block"]["out"]
    pos_gap = float(np.abs(host["positions"] - block["positions"]).max())
    f_scale = float(np.abs(host["forces"]).max())
    f_gap = float(np.abs(host["forces"] - block["forces"]).max())
    print(f"phase 9d host vs block after {MD_STEPS + 10} steps from one start: positions max gap {pos_gap:.3e} A "
          f"(limit {MD_POS_TOL:.0e}), forces max gap {f_gap:.3e} (max |F| {f_scale:.3e}, limit "
          f"{MD_FORCE_TOL:.0e} of it)", flush=True)
    if not (pos_gap <= MD_POS_TOL and f_gap <= MD_FORCE_TOL * f_scale):
        raise RuntimeError("phase 9d: host and block integration disagree")

    # (e) skin 1e-6: every block rebuilds, and the graph replays on layouts refilled in place
    masses = np.full(n, MD_MASS)
    driver = MDDriver(model, dict(frame), VelocityVerlet(dt_fs=2.0), masses=masses, skin=1e-6,
                      steps_per_block=10, integration="block")
    src0 = driver._batch[LAYOUT_KEY].edge_src.cpu().numpy().copy()
    out = driver.run(50, velocities=v0)
    rebuilds = len(driver.rebuild_timings) - 1
    lay = driver._batch[LAYOUT_KEY]
    moved_slots = int((lay.edge_src.cpu().numpy() != src0).sum())

    def fresh_forces(nl_pos, at):
        d = MDDriver(model, {**frame, "pos": nl_pos}, VelocityVerlet(dt_fs=2.0), masses=masses, skin=1e-6,
                     integration="host")
        return d.forces(torch.as_tensor(at, dtype=torch.float64, device="cuda")).cpu().numpy()

    scale = float(np.abs(out["forces"]).max())
    gap_last = float(np.abs(fresh_forces(out["positions"], out["positions"]) - out["forces"]).max())
    nl_pos = driver._nl_pos.copy()
    driver._block_program()()  # one more block, replayed on the last refilled layout
    replayed = driver._state[2].cpu().numpy()
    gap_replay = float(np.abs(fresh_forces(nl_pos, driver._state[0].cpu().numpy()) - replayed).max())
    print(f"phase 9e stale edges (skin 1e-6, block): {rebuilds} rebuilds in 50 steps, {driver.captures} capture, "
          f"{driver.replays} replays; kernel-order sources changed at {moved_slots} of {len(src0)} slots since the "
          f"capture; last forces vs a fresh list at the final positions: max gap {gap_last:.3e}; a further block "
          f"replayed on the refilled layout vs a fresh list from the same build positions: max gap "
          f"{gap_replay:.3e} (max |F| {scale:.3e}, limit {STALE_FORCE_TOL:.0e} of it)", flush=True)
    if rebuilds != 5 or driver.captures != 1 or moved_slots == 0:
        raise RuntimeError("phase 9e: expected 5 rebuilds, one capture and a changed layout")
    if not (gap_last <= STALE_FORCE_TOL * scale and gap_replay <= STALE_FORCE_TOL * scale):
        raise RuntimeError("phase 9e: a replayed block ran on stale edges")

    # (g) the force call at the MD graph's shapes against the plain conv (tp_impl="torch")
    ref_model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="torch", **FLAGSHIP)
    ref_model.load_state_dict(model.state_dict())
    at = torch.as_tensor(host["positions"], dtype=torch.float64, device="cuda")
    pair = [MDDriver(m, {**frame, "pos": host["positions"]}, VelocityVerlet(dt_fs=2.0), masses=masses, skin=MD_SKIN,
                     integration="host") for m in (model, ref_model)]
    (e_got, f_got), (e_ref, f_ref) = ((d._potential_energy(at), d.forces(at).cpu().numpy()) for d in pair)
    n_edges = int(pair[0]._batch["edge_mask"].sum())
    del pair
    e_rel = abs(e_got - e_ref) / abs(e_ref)
    f_err, f_max = float(np.abs(f_got - f_ref).max()), float(np.abs(f_ref).max())
    print(f"phase 9g fused vs torch on the MD graph (f32, card, {n_edges} edges at cutoff "
          f"{float(model.r_max) + MD_SKIN} A): energy rel err {e_rel:.3e}, forces max err {f_err:.3e} "
          f"(max |F| {f_max:.3e})", flush=True)
    if not (e_rel <= 1e-5 and f_err <= 1e-4 * f_max):
        raise RuntimeError("phase 9g: fused and torch force calls disagree on the MD graph")

    drift = runs["host"]["drift"]
    print(f"phase 9f NVE drift (host run, {MD_STEPS} steps of 2 fs): |dE_total| per atom {drift:.3e} eV "
          f"(E {runs['host']['e0']:.6f} -> {runs['host']['e1']:.6f} eV; limit {NVE_DRIFT_LIMIT:.0e}); "
          f"block run {runs['block']['drift']:.3e} eV", flush=True)
    if not drift <= NVE_DRIFT_LIMIT:
        raise RuntimeError("phase 9f: NVE energy drift beyond the limit")
    torch.cuda.empty_cache()
    return nl_report


def phase9i_device_md(smi: str, model, frame: dict, v0, host_nl: dict) -> int:
    """MDDriver(nl_backend="device", integration="block") from phase 9's
    start and velocities, held against the host-list block run (9c) at 9d's
    gates, with at least one rebuild; returns device_nl's launches."""
    import torch

    dev = _md_run("i", smi, model, frame, v0, "block", nl_backend="device")
    torch.cuda.empty_cache()
    got, want = dev["out"], host_nl["out"]
    pos_gap = float(np.abs(got["positions"] - want["positions"]).max())
    f_scale = float(np.abs(want["forces"]).max())
    f_gap = float(np.abs(got["forces"] - want["forces"]).max())
    print(f"phase 9i device list vs host list, block integration, after {MD_STEPS + 10} steps from one start: "
          f"positions max gap {pos_gap:.3e} A (limit {MD_POS_TOL:.0e}), forces max gap {f_gap:.3e} (max |F| "
          f"{f_scale:.3e}, limit {MD_FORCE_TOL:.0e} of it); {dev['rebuilds']} device rebuilds "
          f"{dev['rebuild_ms']:.3f} ms each, capture {dev['capture_s']:.2f} s in the timed run; step median / mean "
          f"{dev['median_ms']:.2f} / {dev['mean_ms']:.2f} ms, {dev['atom_steps_s']:.0f} atom-steps/s (host list: "
          f"{host_nl['median_ms']:.2f} / {host_nl['mean_ms']:.2f} ms, {host_nl['atom_steps_s']:.0f} atom-steps/s; "
          f"{host_nl['rebuilds']} rebuilds {host_nl['rebuild_ms']:.1f} ms each) ({smi})", flush=True)
    if not (pos_gap <= MD_POS_TOL and f_gap <= MD_FORCE_TOL * f_scale):
        raise RuntimeError("phase 9i: the device-list and host-list MD runs disagree")
    if dev["rebuilds"] < 1:
        raise RuntimeError("phase 9i: no device rebuild in the timed run at skin 0.5")
    return dev["launches"]["device_nl"]


K4_MD_STEPS = 50  # 9j's timed steps (phase 9i's 100 rebuilt 5 times on this frame)


def phase9j_k4_device_md(smi: str, frame: dict, v0) -> None:
    """The flagship's widths with a depth-2 radial MLP (K4's route, phase
    14c's model): MDDriver(nl_backend="device", integration="block") from
    phase 9's start against the host-list block run of the same model, at
    9d's gates, with at least one device rebuild; both runs launch K4, K5's
    inference variant and K3 only (and the device list)."""
    import torch

    from nequip_tpu_torch.model import NequIPGNNModel

    t_phase = time.perf_counter()
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", radial_mlp_depth=2, **FLAGSHIP)
    if set(_routes(model)) != {"fused_tp"}:
        raise RuntimeError("phase 9j: the depth-2 layers did not take K4's route")
    host_nl = _md_run("j.host", smi, model, frame, v0, "block", steps=K4_MD_STEPS, route=K4_ROUTE)
    torch.cuda.empty_cache()
    dev = _md_run("j", smi, model, frame, v0, "block", nl_backend="device", steps=K4_MD_STEPS, route=K4_ROUTE)
    torch.cuda.empty_cache()
    got, want = dev["out"], host_nl["out"]
    pos_gap = float(np.abs(got["positions"] - want["positions"]).max())
    f_scale = float(np.abs(want["forces"]).max())
    f_gap = float(np.abs(got["forces"] - want["forces"]).max())
    print(f"phase 9j K4's route (depth-2 radial MLP): device list vs host list, block integration, after "
          f"{K4_MD_STEPS + 10} steps from one start: positions max gap {pos_gap:.3e} A (limit {MD_POS_TOL:.0e}), forces "
          f"max gap {f_gap:.3e} (max |F| {f_scale:.3e}, limit {MD_FORCE_TOL:.0e} of it); {dev['rebuilds']} device "
          f"rebuilds {dev['rebuild_ms']:.3f} ms each; step median / mean {dev['median_ms']:.2f} / "
          f"{dev['mean_ms']:.2f} ms (host list: {host_nl['median_ms']:.2f} / {host_nl['mean_ms']:.2f} ms); launches "
          f"{dev['launches']} ({smi}); phase 9j {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (pos_gap <= MD_POS_TOL and f_gap <= MD_FORCE_TOL * f_scale):
        raise RuntimeError("phase 9j: the device-list and host-list MD runs on K4's route disagree")
    if dev["rebuilds"] < 1:
        raise RuntimeError("phase 9j: no device rebuild in the timed run at skin 0.5")


CLI_DIR = ROOT / "chiprun_out" / "chip_smoke_cli"
CLI_TRAIN_KERNELS = TRAINING_KERNELS + ("conv_bwd",)  # 10a: rr training, K2's inference variant in val and test
CLI_FR_KERNELS = ("tri_fwd_acc", "jvp_fwd", "jvp_bwd")  # 10c
CLI_RESUME_TOL = 1e-5  # of max |p|
ACCURACY_GATE = 0.15  # val forces MAE / label force RMS (tests/integration/test_train.py)


def _cli_config(supercell: int) -> dict:
    """The flagship in an EMATrainModule on LJ-labelled fcc frames, with the
    dataset statistics resolved into the model (phase 10a)."""
    t = "nequip_tpu_torch."
    model = {k: v for k, v in FLAGSHIP.items()
             if k not in ("avg_num_neighbors", "per_type_energy_shifts", "per_type_energy_scales")}
    return {
        "run": ["train", "val", "test"],
        "data": {
            "_target_": t + "data.NequIPDataModule",
            "seed": 0,
            "split_dataset": {
                "dataset": {
                    "_target_": t + "data.dataset.LJTestDataset", "supercell": [supercell] * 3, "num_frames": 4,
                    "seed": 0,
                    "transforms": [
                        {"_target_": t + "data.transforms.ChemicalSpeciesToAtomTypeMapper", "chemical_symbols": ["Cu"]},
                        {"_target_": t + "data.transforms.NeighborListTransform", "r_max": FLAGSHIP["r_max"]},
                    ],
                },
                "train": 2, "val": 1, "test": 1,
            },
            "train_dataloader": {"batch_size": 1},
            "val_dataloader": {"batch_size": 1},
            "test_dataloader": {"batch_size": 1},
            "stats_manager": {"_target_": t + "data.CommonDataStatisticsManager", "type_names": ["Cu"]},
        },
        "trainer": {
            "_target_": t + "train.Trainer",
            "max_epochs": 3,
            "monitor": "val0_epoch/weighted_sum",
            "log_every_n_steps": 100,
            "callbacks": [
                {"_target_": t + "train.callbacks.LossCoefficientMonitor"},
                {"_target_": t + "train.callbacks.TrainingStatsMonitor"},
                {"_target_": t + "train.callbacks.SoftAdapt", "beta": 1.1, "interval": "epoch", "frequency": 1},
            ],
        },
        "training_module": {
            "_target_": t + "train.EMATrainModule",
            "ema_decay": 0.99,
            "model": {
                "_target_": t + "model.NequIPGNNModel", "seed": 0, "model_dtype": "float32", "tp_impl": "fused",
                **model,
                "avg_num_neighbors": "${training_data_stats:num_neighbors_mean}",
                "per_type_energy_shifts": "${training_data_stats:per_atom_energy_mean}",
                "per_type_energy_scales": "${training_data_stats:per_type_forces_rms}",
            },
            "loss": {"_target_": t + "train.EnergyForceLoss", "per_atom_energy": True,
                     "coeffs": {"total_energy": 1.0, "forces": 1.0}},
            "val_metrics": {"_target_": t + "train.EnergyForceMetrics"},
            "optimizer": {"_target_": "optax.adam", "learning_rate": 1e-3},
            "gradient_clip_val": 100.0,
            "lr_scheduler": {"scheduler": {"_target_": t + "train.StepLR", "step_size": 1, "gamma": 0.5},
                             "interval": "epoch", "frequency": 1},
        },
    }


def _run_cli(name: str, args) -> object:
    """``main(["-cn", name, "-cp", CLI_DIR, *args])`` as a user runs
    nequip-torch-train; returns the trainer its run_config ran."""
    from nequip_tpu_torch.scripts import train as cli

    trainers = []
    run_config = cli.run_config
    cli.run_config = lambda *a, **kw: trainers.append(run_config(*a, **kw))
    try:
        cli.main(["-cn", name, "-cp", str(CLI_DIR), *args])
    finally:
        cli.run_config = run_config
    return trainers[0]


def _max_rel_gap(got: dict, want: dict):
    """(largest per-tensor max |got - want| / max |want|, all bitwise equal)."""
    import torch

    if set(got) != set(want):
        raise RuntimeError(f"tensor names differ: {sorted(set(got) ^ set(want))}")
    gap = max(float((got[k].double() - want[k].double()).abs().max()) / max(float(want[k].abs().max()), 1e-300)
              for k in want)
    return gap, all(torch.equal(got[k], want[k]) for k in want)


def phase10_cli(smi: str, rr: dict, supercell: int = 18, cli_args=()) -> dict:
    """The training CLI on the card: 10a the flagship run, 10b resume, 10c
    fr over edge slices, 10d the LJ accuracy gate."""
    import os

    import torch
    import yaml

    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    CLI_DIR.mkdir(parents=True, exist_ok=True)
    (CLI_DIR / "flagship_lj.yaml").write_text(yaml.safe_dump(_cli_config(supercell)))
    dirs = {k: CLI_DIR / k for k in ("a", "b", "c", "d")}

    # 10a
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = _run_cli("flagship_lj", [*cli_args, f"++trainer.ckpt_dir={dirs['a']}"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = np.asarray(trainer.step_seconds[1:]) * 1e3
    print(
        f"phase 10a CLI train/val/test ({smi}): {trainer.global_step} steps, main() {run_s:.1f} s, first step "
        f"{trainer.step_seconds[0] * 1e3:.1f} ms, later steps median {np.median(steps):.1f} ms "
        f"(min {steps.min():.1f}, max {steps.max():.1f}), max_memory_allocated {peak / 2**30:.3f} GiB; "
        f"phase 6 rr: median {rr['median_ms']:.1f} ms, {rr['peak_gib']:.3f} GiB",
        flush=True,
    )
    rows = trainer.metrics_rows
    if len(rows) != 5 or trainer.global_step != 6:
        raise RuntimeError(f"phase 10a: expected 3 epochs of 2 steps, then a val and a test row; got {len(rows)} rows")
    for row in rows[:3]:
        coeffs = {k.split("/", 1)[1]: round(v, 6) for k, v in row.items() if k.startswith("loss_coeffs/")}
        print(f"phase 10a epoch {row['epoch']}: train loss {row['train_loss_epoch/weighted_sum']:.6e}, "
              f"val loss {row['val0_epoch/weighted_sum']:.6e}, lr_scale {row['lr_scale']}, loss coefficients "
              f"logged at the previous epoch's end {coeffs or 'none'}", flush=True)
        if not all(math.isfinite(row[k]) for k in ("train_loss_epoch/weighted_sum", "val0_epoch/weighted_sum")):
            raise RuntimeError("phase 10a: non-finite training or validation loss")
    test = {k: v for k, v in rows[-1].items() if k.startswith("test0_epoch/")}
    print(f"phase 10a final loss coefficients {trainer.current_loss_coeffs()}; test (best.ckpt) "
          + ", ".join(f"{k.split('/')[1]} {v:.4e}" for k, v in sorted(test.items())), flush=True)
    if not test or not all(math.isfinite(v) for v in test.values()):
        raise RuntimeError("phase 10a: missing or non-finite test metrics")
    for name in ("last.ckpt", "best.ckpt", "metrics.csv"):
        if not (dirs["a"] / name).exists():
            raise RuntimeError(f"phase 10a: {name} was not written")
    if trainer.loaded_ckpt_path != str(dirs["a"] / "best.ckpt"):
        raise RuntimeError(f"phase 10a: the test run read {trainer.loaded_ckpt_path}, not best.ckpt")
    payload = load_checkpoint(str(dirs["a"] / "last.ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(dirs["a"] / "timed.ckpt"), trainer.module.state_dict(), payload["config"], payload["meta"])
    write_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 10a last.ckpt write: {write_ms:.1f} ms (state to the host and torch.save), "
          f"{os.path.getsize(dirs['a'] / 'last.ckpt') / 2**20:.3f} MiB", flush=True)
    print(f"phase 10a launches {launches}", flush=True)
    for name in CLI_TRAIN_KERNELS:
        if launches[name] == 0:
            raise RuntimeError(f"phase 10a: kernel {name} was not launched on the CLI's path")
    straight = payload["state"]
    del trainer
    torch.cuda.empty_cache()

    # 10b
    t0 = time.perf_counter()
    _run_cli("flagship_lj", [*cli_args, f"++trainer.ckpt_dir={dirs['b']}", "++trainer.max_epochs=2"])
    resumed = _run_cli("flagship_lj", [*cli_args, f"++trainer.ckpt_dir={dirs['b']}", "++trainer.max_epochs=3",
                                       f"++ckpt_path={dirs['b'] / 'last.ckpt'}"])
    got = load_checkpoint(str(dirs["b"] / "last.ckpt"))["state"]
    gaps = {k: _max_rel_gap(got[k], straight[k]) for k in ("params", "ema_params")}
    print(f"phase 10b resume (2 epochs, then main() with ++ckpt_path to 3; {time.perf_counter() - t0:.1f} s): "
          f"params max gap / max|p| {gaps['params'][0]:.3e} (bitwise equal: {gaps['params'][1]}), EMA params "
          f"{gaps['ema_params'][0]:.3e} (bitwise equal: {gaps['ema_params'][1]}); tolerance {CLI_RESUME_TOL:.0e}",
          flush=True)
    if resumed.epoch != 3 or not all(g <= CLI_RESUME_TOL for g, _ in gaps.values()):
        raise RuntimeError("phase 10b: the resumed run differs from the straight run")
    del resumed
    torch.cuda.empty_cache()

    # 10c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    fr = _run_cli("flagship_lj", [*cli_args, f"++trainer.ckpt_dir={dirs['c']}", "++trainer.max_epochs=1",
                                  "++training_module.force_grad_mode=fr", f"++training_module.fr_edge_chunks={N_CHUNKS}"])
    torch.cuda.synchronize()
    launches_fr = {k: fn.launches for k, fn in K.KERNELS.items()}
    loss_fr, loss_rr = fr.metrics_rows[0]["train_loss_epoch/weighted_sum"], rows[0]["train_loss_epoch/weighted_sum"]
    rel = abs(loss_fr - loss_rr) / abs(loss_rr)
    print(f"phase 10c CLI fr over {N_CHUNKS} edge slices ({smi}): step times {[round(x * 1e3, 1) for x in fr.step_seconds]} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; epoch 0 train loss {loss_fr:.6e} "
          f"against 10a's {loss_rr:.6e} (rel {rel:.2e}, limit 1e-4); launches {launches_fr}", flush=True)
    for name in CLI_FR_KERNELS:
        if launches_fr[name] == 0:
            raise RuntimeError(f"phase 10c: kernel {name} was not launched on the CLI's fr path")
    if not rel <= 1e-4:
        raise RuntimeError("phase 10c: the fr run's first epoch differs from rr's")
    del fr
    torch.cuda.empty_cache()

    # 10d
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.utils.config import retarget

    cfg = retarget(yaml.safe_load((ROOT / "tests" / "integration" / "lj_config.yaml").read_text()))
    split = cfg["data"]["split_dataset"]
    split["dataset"]["num_frames"] = 32
    split.update(train=24, val=4, test=4)
    cfg["data"]["train_dataloader"]["batch_size"] = 4
    cfg["trainer"].update(max_epochs=40, ckpt_dir=str(dirs["d"]))
    cfg["training_module"]["model"].update(model_dtype="float32", tp_impl="fused")
    (CLI_DIR / "lj_accuracy_gate.yaml").write_text(yaml.safe_dump(cfg))
    t0 = time.perf_counter()
    gate = _run_cli("lj_accuracy_gate", list(cli_args))
    gate_s = time.perf_counter() - t0
    mae = float(gate.metrics_rows[-1]["val0_epoch/forces_mae"])
    forces = np.concatenate([np.asarray(f["forces"]) for f in LJTestDataset(num_frames=32, seed=123456).frames])
    rms = float(np.sqrt(np.mean(forces**2)))
    print(f"phase 10d accuracy gate ({smi}): {gate.epoch} epochs, {gate.global_step} steps in {gate_s:.1f} s; val forces "
          f"MAE {mae:.4e} eV/A over label force RMS {rms:.4e} = {mae / rms:.4f} (limit {ACCURACY_GATE})", flush=True)
    if not mae <= ACCURACY_GATE * rms:
        raise RuntimeError("phase 10d: the model does not fit the LJ labels")
    torch.cuda.empty_cache()
    return launches


# phase 11: deployment of phase 10a's checkpoint (its files are deleted after it)
DEPLOY_DIR = CLI_DIR / "deploy"
TRAINING_ONLY = tuple(k for k in TRAINING_KERNELS + FR_CHUNKED_KERNELS if k not in SERVING_KERNELS)
DEPLOY_REQUESTS = 12


def _serving_launches(calc, frame) -> dict:
    """The kernels one request of ``calc`` launched (K1, K2, K3 and the
    training kernels, which must stay at 0)."""
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    K.reset_launch_counts()
    calc.calculate(frame)
    return {k: K.KERNELS[k].launches for k in SERVING_KERNELS + TRAINING_ONLY}


def _deploy_gap(got: dict, want: dict) -> tuple:
    """(energy rel err, forces max err / max|F|, stress max err / max|stress|)."""
    return (abs(got["energy"] - want["energy"]) / abs(want["energy"]),
            float(np.abs(got["forces"] - want["forces"]).max()) / float(np.abs(want["forces"]).max()),
            float(np.abs(got["stress"] - want["stress"]).max()) / float(np.abs(want["stress"]).max()))


def phase11_deploy(smi: str, built) -> dict:
    """Deployment on the card: 11a the f64 golden flagship exported and
    loaded, 11b nequip-torch-package on phase 10a's best.ckpt, 11c
    nequip-torch-compile of it with a 2-rung ladder, 11d compiled against
    eager requests, 11e a frame on rung 1, 11f the standalone consumer on
    11c's artifact (K1's route; ``_consumer_check``)."""
    import contextlib
    import io
    import os

    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params, save_compiled_model
    from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
    from nequip_tpu_torch.scripts import compile as compile_cli
    from nequip_tpu_torch.scripts import package as package_cli

    DEPLOY_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()

    # 11a: the JAX golden through an exported program at the 23k-atom frame's capacities
    z = np.load(GOLDEN)
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(model, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    model = model.to("cuda").requires_grad_(False)
    golden = {"pos": z["pos"], "cell": z["cell"], "pbc": z["pbc"], "atomic_numbers": z["atomic_numbers"]}
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(golden)), 4.0)
    batch = relayout_edge_stream(to_tensors(pad_batch(batched_from_list([frame]), 23424, 420096, 2), "cuda"))
    path = DEPLOY_DIR / "golden_f64.nequip_tpu_torch.zip"
    t0 = time.perf_counter()
    save_compiled_model(str(path), model, [batch])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    calc = NequIPCalculator.from_compiled_model(str(path))
    load_s = time.perf_counter() - t0
    res = calc.calculate(golden)
    e_err = abs(res["energy"] - float(z["energy"])) / abs(float(z["energy"]))
    f_err = float(np.abs(res["forces"] - z["forces"]).max())
    s_err = float(np.abs(res["stress"] - z["stress"]).max())
    print(f"phase 11a golden through the exported program (f64, 23424 node / 420096 edge slots, {smi}): export "
          f"{export_s:.1f} s, {os.path.getsize(path) / 2**20:.2f} MiB, load {load_s:.1f} s; energy rel err "
          f"{e_err:.3e}, forces max err {f_err:.3e}, stress max err {s_err:.3e}", flush=True)
    if not (e_err <= 1e-10 and f_err <= 1e-8 and s_err <= 1e-8):
        raise RuntimeError("phase 11a: the exported program disagrees with the JAX golden")
    del model, calc, batch
    torch.cuda.empty_cache()

    # 11b: the package of phase 10a's best.ckpt; the package and the checkpoint serve alike
    ckpt = str(CLI_DIR / "a" / "best.ckpt")
    pkg = str(DEPLOY_DIR / "flagship_pkg.zip")
    t0 = time.perf_counter()
    package_cli.main(["build", ckpt, pkg])
    build_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        package_cli.main(["info", pkg])
    info = json.loads(out.getvalue())
    with contextlib.redirect_stdout(io.StringIO()) as out:
        package_cli.main(["list", pkg])
    members = [ln.split() for ln in out.getvalue().splitlines()]
    frame23 = fcc_frame(23000, seed=1)
    by_pkg = NequIPCalculator.from_saved_model(pkg)
    eager = NequIPCalculator.from_saved_model(ckpt)
    # index_add on the card sums in any order: deterministic algorithms for the
    # bitwise comparison (the kernels write whole outputs: no fill of torch.empty)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        from_pkg, from_ckpt = by_pkg.calculate(frame23), eager.calculate(frame23)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    same = all(np.array_equal(np.asarray(from_pkg[k]), np.asarray(from_ckpt[k])) for k in ("energy", "forces", "stress"))
    same_weights = all(torch.equal(a, b) for (_, a), (_, b) in zip(by_pkg.predictor.jax_named_tensors(),
                                                                   eager.predictor.jax_named_tensors()))
    del by_pkg
    print(f"phase 11b nequip-torch-package build ({smi}): {build_s:.1f} s, "
          f"{os.path.getsize(pkg) / 2**20:.2f} MiB; info: {info['model_config']['_target_']}, "
          f"{info['metadata']['model_dtype']}, r_max {info['metadata']['r_max']}; list: "
          + ", ".join(f"{name} {int(size) / 2**20:.2f} MiB" for size, name in members)
          + f"; weights bitwise equal: {same_weights}; package and checkpoint calculators on {len(frame23['pos'])} "
          f"atoms (deterministic algorithms) bitwise equal: {same}", flush=True)
    if not (same and same_weights):
        raise RuntimeError("phase 11b: the package and the checkpoint answer differently")

    # 11c: nequip-torch-compile with its self-check; one compiled request's launches against eager's
    art = str(DEPLOY_DIR / "flagship.nequip_tpu_torch.zip")
    t0 = time.perf_counter()
    compile_cli.main([ckpt, art, "--target", "ase", "--capacity-ladder", "2"])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = NequIPCalculator.from_compiled_model(art)
    load_s = time.perf_counter() - t0
    ladder = compiled.predictor.capacity_ladder
    compiled.calculate(frame23)  # warm-up
    launches = _serving_launches(compiled, frame23)
    eager_launches = _serving_launches(eager, frame23)
    print(f"phase 11c nequip-torch-compile --capacity-ladder 2 ({smi}): {compile_s:.1f} s with the self-check, "
          f"{os.path.getsize(art) / 2**20:.2f} MiB, load {load_s:.1f} s; ladder {ladder}; launches of one request: "
          f"compiled {launches}, eager {eager_launches}", flush=True)
    if launches != eager_launches or any(launches[k] for k in TRAINING_ONLY) or not all(
            launches[k] for k in SERVING_KERNELS):
        raise RuntimeError("phase 11c: the compiled request does not launch K1, K2 and K3 as eager does")

    # 11d: warm requests, compiled and eager in turns
    times = {"compiled": [], "eager": []}
    for _ in range(DEPLOY_REQUESTS):
        for name, c in (("compiled", compiled), ("eager", eager)):
            res = c.calculate(frame23)
            times[name].append((c.timings["prepare_s"], c.timings["model_s"], res))
    med = {name: [float(np.median([t[i] for t in ts])) * 1e3 for i in (0, 1)] for name, ts in times.items()}
    gap = _deploy_gap(times["compiled"][-1][2], times["eager"][-1][2])
    print(f"phase 11d {DEPLOY_REQUESTS} warm requests each, in turns, on {len(frame23['pos'])} atoms ({smi}), host "
          f"clock medians: compiled prepare {med['compiled'][0]:.1f} ms, model {med['compiled'][1]:.2f} ms; eager "
          f"prepare {med['eager'][0]:.1f} ms, model {med['eager'][1]:.2f} ms; compiled vs eager: energy rel "
          f"{gap[0]:.3e}, forces {gap[1]:.3e} of max|F|, stress {gap[2]:.3e} of max|stress|", flush=True)
    if not (gap[0] <= 1e-5 and gap[1] <= 1e-4 and gap[2] <= 1e-4):
        raise RuntimeError("phase 11d: the compiled and eager requests disagree")

    # 11e: a larger frame walks up to rung 1
    big = fcc_frame(27000, seed=2)
    n_big = len(big["pos"])
    e_big = compute_neighborlist_(from_dict(big), 4.0)["edge_index"].shape[1]
    rung = ladder.index(compiled.predictor.select_capacities(n_big, e_big))
    gap = _deploy_gap(compiled.calculate(big), eager.calculate(big))
    print(f"phase 11e {n_big} atoms, {e_big} edges: served from rung {rung} ({ladder[rung]}); compiled vs eager: "
          f"energy rel {gap[0]:.3e}, forces {gap[1]:.3e} of max|F|, stress {gap[2]:.3e} of max|stress|; "
          f"phase 11 {time.perf_counter() - t_phase:.1f} s", flush=True)
    if rung != 1 or not (gap[0] <= 1e-5 and gap[1] <= 1e-4 and gap[2] <= 1e-4):
        raise RuntimeError("phase 11e: the frame beyond rung 0 was not served from rung 1 within the gates")
    del compiled, eager
    torch.cuda.empty_cache()
    frame23 = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame23)), 4.0)
    _consumer_check(smi, built, "K1", K1_ROUTE, Path(art), frame23, f"nequip-torch-compile {compile_s:.1f} s")
    for f in list(CLI_DIR.glob("*/*.ckpt")) + list(DEPLOY_DIR.glob("*.zip")):  # configs and metrics.csv stay
        f.unlink()
    torch.cuda.empty_cache()
    return {"compile_s": compile_s, "load_s": load_s, "model_ms": med}


CONSUMER = ROOT / "nequip_tpu_torch" / "tools" / "standalone_artifact_consumer.py"
CONSUMER_REQUESTS = 2  # the first request, and one warm one
# runs the consumer with nequip_tpu_torch import-poisoned: the artifact must suffice
CONSUMER_BLOCKER = """
import sys, runpy

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "nequip_tpu_torch" or name.startswith("nequip_tpu_torch."):
            raise ImportError(name + " is blocked: the standalone consumer must not import the package")
        return None

sys.meta_path.insert(0, _Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _consumer_inputs(frame: dict) -> dict:
    """A frame with its neighbour list as the contract's real inputs."""
    n = len(frame["pos"])
    return {"pos": np.asarray(frame["pos"], np.float64), "edge_index": np.asarray(frame["edge_index"], np.int64),
            "edge_cell_shift": np.asarray(frame["edge_cell_shift"], np.float64),
            "cell": np.asarray(frame["cell"], np.float64).reshape(1, 3, 3),
            "atom_types": np.asarray(frame["atom_types"], np.int64).reshape(-1), "batch": np.zeros(n, np.int64),
            "num_atoms": np.full(1, n, np.int64)}


def phase11f_consumer(smi: str, built) -> None:
    """The standalone consumer (nequip_tpu_torch/tools/standalone_artifact_consumer.py)
    in a subprocess where importing nequip_tpu_torch raises, on the depth-2
    radial-MLP twin of the f32 flagship (K4's route: K4, K5, K3) compiled on
    the card at one rung holding the 23k-atom frame (``_consumer_check``;
    K1's route runs on phase 11c's artifact)."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data import to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.model import NequIPGNNModel, save_compiled_model
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    DEPLOY_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(fcc_frame(23000, seed=1))), 4.0)
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", radial_mlp_depth=2, **FLAGSHIP)
    n, e = len(frame["pos"]), frame["edge_index"].shape[1]
    batch = K.relayout_edge_stream(to_tensors(pad_batch(batched_from_list([frame]), round_up(n, 128),
                                                        round_up(e, 256), 2), "cuda"))
    art = DEPLOY_DIR / "consumer_K4.nequip_tpu_torch.zip"
    t0 = time.perf_counter()
    save_compiled_model(str(art), model.to("cuda"), [batch])
    export = f"export {time.perf_counter() - t0:.1f} s"
    del batch, model
    _consumer_check(smi, built, "K4", K4_ROUTE, art, frame, export)
    print(f"phase 11f K4 {time.perf_counter() - t_phase:.1f} s", flush=True)


def _consumer_check(smi: str, built, label: str, route: tuple, art: Path, frame: dict, made: str) -> None:
    """The consumer on the artifact ``art`` (compiled on the card, ``made``
    says how) and ``frame`` (with its neighbour list) with the package
    blocked: the artifact carries the ops library and names the route's
    ops; the consumer loads the library from the artifact alone, its
    nequip_torch schemas equal the package's, and its outputs equal
    load_compiled_model's at the rung it chose, bitwise (both sides with
    deterministic algorithms: PyTorch's index_add on the card sums in any
    order otherwise); the package's request launches the route's kernels."""
    import os
    import subprocess
    import zipfile

    import torch

    from nequip_tpu_torch.data import batched_from_list, pad_batch, to_tensors
    from nequip_tpu_torch.model import load_compiled_model
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    n, e = len(frame["pos"]), frame["edge_index"].shape[1]
    with zipfile.ZipFile(art) as zf:
        md = json.loads(zf.read("metadata.json"))
    want_ops = sorted(f"nequip_torch::{op}" for op in route[:2] + ("scatter_rows",))
    if md["custom_ops"] != want_ops or md.get("ops_library", {}).get("arch") != "sm_90a":
        raise RuntimeError(f"phase 11f {label}: the artifact names {md['custom_ops']} and "
                           f"{md.get('ops_library')}, not {want_ops} and an sm_90a library")
    inputs = DEPLOY_DIR / f"consumer_{label}_inputs.npz"
    np.savez(inputs, **_consumer_inputs(frame))
    out = DEPLOY_DIR / f"consumer_{label}_out.npz"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CONSUMER_BLOCKER, str(CONSUMER), str(art), str(inputs), str(out),
                           "--repeat", str(CONSUMER_REQUESTS), "--deterministic"],
                          capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    consumer_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"phase 11f {label}: the consumer failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    schemas = json.loads(next(ln for ln in lines if ln.startswith("nequip_torch schemas: ")).split(": ", 1)[1])
    package_schemas = {op: str(getattr(torch.ops.nequip_torch, op.split("::")[1]).default._schema)
                       for op in md["custom_ops"]}
    request_ms = [float(ln.split()[-1]) for ln in lines if ln.startswith("request ms ")]
    rung_line = next(ln for ln in lines if ln.startswith("rung "))
    got = dict(np.load(out))

    compiled = load_compiled_model(str(art))
    caps = compiled.select_capacities(n, e)
    rung = compiled.capacity_ladder.index(caps)
    padded = to_tensors(pad_batch(batched_from_list([frame]), caps["n_nodes"], caps["n_edges"], caps["n_frames"]),
                        "cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        K.reset_launch_counts()
        res = compiled(padded)
        launches = _launches()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    rows = {"total_energy": 1, "stress": 1, "virial": 1}
    want = {k: v[: rows.get(k, n)].cpu().numpy() for k, v in res.items()}
    differ = [k for k in want if not (k in got and got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]))]
    finite = all(np.isfinite(v).all() for v in got.values())
    print(f"phase 11f standalone consumer, {label} ({smi}): artifact {os.path.getsize(art) / 2**20:.2f} MiB "
          f"({made}; ops library {md['ops_library']['member']}, sha256 "
          f"{md['ops_library']['sha256'][:12]}..., built in phase 1 in {built.seconds:.1f} s with the kernels: "
          f"binding {built.binding_seconds:.1f} s beside nvcc, link {built.ops_link_seconds:.1f} s); consumer "
          f"process {consumer_s:.1f} s with the package blocked, {n} atoms, {e} edges, {rung_line.split(';')[0]}, "
          f"requests {', '.join(f'{t:.1f}' for t in request_ms)} ms (host clock, card synchronised: padding, "
          f"layout, program, read-back); ops {sorted(schemas)} with the package's schemas: "
          f"{schemas == package_schemas}; outputs bitwise load_compiled_model's at rung {rung}: {not differ} "
          f"({sorted(want)}); package launches {launches}", flush=True)
    if schemas != package_schemas:
        raise RuntimeError(f"phase 11f {label}: the library's schemas differ from the package's")
    if not rung_line.startswith(f"rung {rung} "):
        raise RuntimeError(f"phase 11f {label}: the consumer chose {rung_line!r}, the package rung {rung}")
    if differ or not finite:
        raise RuntimeError(f"phase 11f {label}: the consumer's outputs differ from load_compiled_model's: {differ}")
    _check_route(f"phase 11f {label} package", "fused" if route == K1_ROUTE else "fused_tp", launches)
    del compiled, res
    for f in DEPLOY_DIR.glob(f"consumer_{label}*"):
        f.unlink()
    torch.cuda.empty_cache()


PAIR_E_TOL = 1e-5  # relative (f32)
PAIR_F_TOL = 1e-4  # of max |F|


def _edge_force_sum(n_nodes: int, dst, src, edge_forces) -> np.ndarray:
    """The engine's sum: F_i = sum over pairs with center i of the edge
    force, minus the sum over pairs with neighbour i."""
    return np.stack([np.bincount(dst, edge_forces[:, k], n_nodes) - np.bincount(src, edge_forces[:, k], n_nodes)
                     for k in range(3)], axis=1)


def _ghost_domains(pos: np.ndarray, cell: np.ndarray, comm_cut: float):
    """Two x-slabs of the box, each with its ghosts: every periodic image of
    an atom inside the slab's box grown by comm_cut on every side (a
    superset of the images within comm_cut of a local atom).  Yields
    (node positions, owner atom of each node, n_local)."""
    import itertools

    frac = (pos @ np.linalg.inv(cell)) % 1.0
    wpos = frac @ cell
    lengths = np.diag(cell)
    for d in (0, 1):
        local = np.nonzero((frac[:, 0] >= 0.5) == bool(d))[0]
        lo = np.array([0.5 * d * lengths[0], 0.0, 0.0]) - comm_cut
        hi = np.array([0.5 * (d + 1) * lengths[0], lengths[1], lengths[2]]) + comm_cut
        nodes, owners = [wpos[local]], [local]
        for s in itertools.product((-1, 0, 1), repeat=3):
            img = wpos + np.asarray(s, dtype=np.float64) @ cell
            keep = np.all((img >= lo) & (img <= hi), axis=1)
            if s == (0, 0, 0):
                keep[local] = False
            nodes.append(img[keep])
            owners.append(np.nonzero(keep)[0])
        yield np.concatenate(nodes), np.concatenate(owners), len(local)


def phase12_pair_style(smi: str) -> None:
    """The MD-engine pair style on the card (flagship, f32, fused, random
    weights from seed 0) on the 23k-atom MD frame, with the C++ list's
    edges (r_max) as the engine's pairs: 12a total energy and edge forces
    summed onto atoms against the calculator; 12b two x-slab domains with
    ghosts out to num_layers * r_max reproduce the undivided energy and
    forces; 12c the pair_nequip program (save_compiled_model, loaded with
    load_compiled_model) against the eager wrapper."""
    import torch

    from nequip_tpu_torch.data import neighbor_list
    from nequip_tpu_torch.integrations import NequIPCalculator, NequIPPairStyleWrapper
    from nequip_tpu_torch.model import NequIPGNNModel, load_compiled_model, save_compiled_model
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    frame = _md_frame(23000)
    pos, cell, n = frame["pos"], frame["cell"], len(frame["pos"])
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP)
    r_max = float(model.r_max)
    calc = NequIPCalculator.from_model(model)
    want = calc.calculate({"pos": pos, "cell": cell, "pbc": frame["pbc"], "atomic_numbers": np.full(n, 29)})
    wrapper = NequIPPairStyleWrapper(model)
    ei, sh = neighbor_list(pos, r_max, cell=cell, pbc=frame["pbc"], backend="cpp")
    dst, src = ei[0].astype(np.int64), ei[1].astype(np.int64)
    rij = pos[src] + sh @ cell - pos[dst]
    types = np.zeros(n, dtype=np.int64)
    wrapper.compute(rij, dst, src, types, n)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = wrapper.compute(rij, dst, src, types, n)
    compute_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in K.KERNELS.items() if fn.launches}
    f_pair = _edge_force_sum(n, dst, src, res["edge_forces"])
    f_scale = float(np.abs(want["forces"]).max())
    e_rel = abs(res["total_energy"] - want["energy"]) / abs(want["energy"])
    f_err = float(np.abs(f_pair - want["forces"]).max())
    print(f"phase 12a pair style ({smi}, f32): {n} atoms, {len(dst)} pairs at r_max {r_max} A (C++ list); compute "
          f"{1e3 * compute_s:.1f} ms (host clock, warm); against the calculator: energy rel err {e_rel:.3e} (limit "
          f"{PAIR_E_TOL:.0e}), edge forces summed onto atoms max err {f_err:.3e} (max |F| {f_scale:.3e}, limit "
          f"{PAIR_F_TOL:.0e} of it); launches {launches}", flush=True)
    if not (e_rel <= PAIR_E_TOL and f_err <= PAIR_F_TOL * f_scale):
        raise RuntimeError("phase 12a: the pair style disagrees with the calculator")
    if any(not launches.get(k) for k in SERVING_KERNELS) or any(k not in SERVING_KERNELS for k in launches):
        raise RuntimeError(f"phase 12a: the pair style's force call is not K1, K2 (inference) and K3: {launches}")

    # 12b: an engine's spatial decomposition, two domains with ghosts
    e_sum, f_acc, sizes = 0.0, np.zeros((n, 3)), []
    comm_cut = FLAGSHIP["num_layers"] * r_max
    for nodes, owners, n_local in _ghost_domains(pos, cell, comm_cut):
        e2, _ = neighbor_list(nodes, r_max, cell=None, pbc=(False, False, False), backend="cpp")
        d_dst, d_src = e2[0].astype(np.int64), e2[1].astype(np.int64)
        part = wrapper.compute(nodes[d_src] - nodes[d_dst], d_dst, d_src, np.zeros(len(nodes), np.int64), n_local)
        e_sum += part["total_energy"]
        f_nodes = _edge_force_sum(len(nodes), d_dst, d_src, part["edge_forces"])
        f_acc += np.stack([np.bincount(owners, f_nodes[:, k], n) for k in range(3)], axis=1)
        sizes.append((n_local, len(nodes), len(d_dst)))
    split_e = abs(e_sum - res["total_energy"]) / abs(res["total_energy"])
    split_f = float(np.abs(f_acc - f_pair).max())
    print(f"phase 12b two domains with ghosts out to {comm_cut} A ((local, nodes, pairs): {sizes}): energy rel err "
          f"{split_e:.3e}, forces max err {split_f:.3e} against the undivided pair style (limits {PAIR_E_TOL:.0e}, "
          f"{PAIR_F_TOL:.0e} of max |F|)", flush=True)
    if not (split_e <= PAIR_E_TOL and split_f <= PAIR_F_TOL * f_scale):
        raise RuntimeError("phase 12b: the two-domain split does not reproduce the undivided pair style")

    # 12c: the pair_nequip program against the eager wrapper
    from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream

    DEPLOY_DIR.mkdir(parents=True, exist_ok=True)
    path = DEPLOY_DIR / "pair_nequip.nequip_tpu_torch.zip"
    batch = wrapper.padded_batch(rij, dst, src, types, n)
    t0 = time.perf_counter()
    save_compiled_model(str(path), wrapper.model, [relayout_edge_stream(batch)], target="pair_nequip")
    export_s = time.perf_counter() - t0
    out = load_compiled_model(str(path))(batch)
    ef = out["edge_forces"][: len(dst)].cpu().numpy()
    c_e = abs(float(out["total_energy"].reshape(-1)[0]) - res["total_energy"]) / abs(res["total_energy"])
    ef_scale = float(np.abs(res["edge_forces"]).max())
    c_f = float(np.abs(ef - res["edge_forces"]).max())
    print(f"phase 12c pair_nequip program ({smi}): export {export_s:.1f} s; against the eager wrapper: energy rel "
          f"err {c_e:.3e}, edge forces max err {c_f:.3e} (max |edge force| {ef_scale:.3e}; limits {PAIR_E_TOL:.0e}, "
          f"{PAIR_F_TOL:.0e} of the max)", flush=True)
    if not (c_e <= PAIR_E_TOL and c_f <= PAIR_F_TOL * ef_scale):
        raise RuntimeError("phase 12c: the pair_nequip program disagrees with the eager wrapper")
    del calc, wrapper
    torch.cuda.empty_cache()


# phase 13: training from data files, the bucket ladder, the tutorial config
FILES_DIR = ROOT / "chiprun_out" / "chip_smoke_files"
FILE_KERNELS = ("conv_fwd", "conv_bwd_train", "scatter_rows", "tri_fwd", "tri_bwd")  # 13b: K1, K2-train, K3, K4, K5
ZBL = {"_target_": "nequip_tpu_torch.nn.pair_potential.ZBL", "units": "metal", "chemical_species": ["Cu"]}
XYZ_TOL = 1e-10  # the extxyz writer's %.10f: Angstrom, eV/A, eV
XYZ_LOSS_REL = 1e-6
BUCKET_LOSS_REL = 1e-5  # f32


def _file_frames(supercell: int, num_frames: int, seed: int) -> list:
    from nequip_tpu_torch.data.dataset import LJTestDataset

    ds = LJTestDataset(supercell=(supercell,) * 3, num_frames=num_frames, seed=seed)
    return [ds.get_frame(i) for i in range(num_frames)]


def _file_transforms() -> list:
    t = "nequip_tpu_torch.data.transforms."
    return [{"_target_": t + "ChemicalSpeciesToAtomTypeMapper", "chemical_symbols": ["Cu"]},
            {"_target_": t + "NeighborListTransform", "r_max": FLAGSHIP["r_max"]}]


def _fit_one_epoch(dataset, n_buckets: int = 1, with_val: bool = True, shuffle: bool = True):
    """One epoch of Trainer.fit of the flagship with a ZBL prior (f32,
    fused, EnergyForceLoss, Adam) over ``dataset`` (a dataset or its
    ``_target_`` config), batch 1; returns (trainer, launches, peak bytes, loader)."""
    import torch

    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

    loader = {"batch_size": 1, "n_buckets": n_buckets, "shuffle": shuffle}
    if with_val:
        dm = NequIPDataModule(seed=0, split_dataset={"dataset": dataset, "train": 2, "val": 1},
                              train_dataloader=loader, val_dataloader={"batch_size": 1}, device="cuda")
    else:
        dm = NequIPDataModule(seed=0, train_dataset=dataset, train_dataloader=loader, device="cuda")
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", pair_potential=ZBL, **FLAGSHIP).to("cuda")
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), val_metrics=EnergyForceMetrics(),
                               optimizer={"_target_": "optax.adam", "learning_rate": 1e-3})
    trainer = Trainer(max_epochs=1, ckpt_dir=str(FILES_DIR / "ckpt"), save_last=False, save_best=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    trainer.fit(module, dm)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    train_loader = dm.train_dataloader()
    del module, model, dm
    torch.cuda.empty_cache()
    return trainer, launches, peak, train_loader


def phase13_files(smi: str, frames=None, rr=None) -> dict:
    """Training from files on the card: 13a extxyz, NPZ and shard files of
    phase 6's three 23k-atom LJ frames written and read back, 13b one epoch
    of the flagship with ZBL from each file against the frames in memory,
    13c the capacity-bucket ladder on a mixed-size dataset, 13d
    nequip-torch-train -cn tutorial and lj_accuracy, 13e nequip-torch-compile
    of the tutorial's best.ckpt against eager."""
    import os

    import torch

    from nequip_tpu_torch.data.dataset import InMemoryDataset, NPZDataset, ShardDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
    from nequip_tpu_torch.data.xyz import read_extxyz, write_extxyz

    FILES_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    if frames is None:
        frames = _file_frames(18, 3, seed=0)
    n_atoms = len(frames[0]["pos"])

    # 13a: three files of the same frames, the port's writers only
    paths = {"extxyz": FILES_DIR / "lj18.extxyz", "npz": FILES_DIR / "lj18.npz", "shard": FILES_DIR / "lj18.nqs"}
    write_extxyz(str(paths["extxyz"]), frames)
    stack = lambda k: np.stack([np.asarray(f[k]) for f in frames])  # noqa: E731
    np.savez(str(paths["npz"]), R=stack("pos"), E=stack("total_energy").reshape(-1), F=stack("forces"),
             z=np.asarray(frames[0]["atomic_numbers"]), cell=stack("cell"), pbc=stack("pbc"), stress=stack("stress"))
    ShardDataset.save_from_iterator(str(paths["shard"]), iter(frames))
    read, read_s = {}, {}
    for name, reader in (("extxyz", lambda p: read_extxyz(p)),
                         ("npz", lambda p: [NPZDataset(p).get_frame(i) for i in range(len(frames))]),
                         ("shard", lambda p: [ShardDataset(p).get_frame(i) for i in range(len(frames))])):
        t0 = time.perf_counter()
        read[name] = reader(str(paths[name]))
        read_s[name] = time.perf_counter() - t0
    xyz_err = max(float(np.abs(np.asarray(g[k], dtype=np.float64).reshape(-1) - np.asarray(f[k]).reshape(-1)).max())
                  for g, f in zip(read["extxyz"], frames) for k in ("pos", "forces", "total_energy", "cell"))
    npz_equal = all(np.array_equal(np.asarray(g[k]).reshape(-1), np.asarray(f[k]).reshape(-1))
                    for g, f in zip(read["npz"], frames)
                    for k in ("pos", "forces", "total_energy", "atomic_numbers", "cell", "pbc", "stress"))
    shard_equal = all(set(g) == set(f) and all(np.array_equal(g[k], f[k]) and g[k].dtype == np.asarray(f[k]).dtype
                                               for k in f) for g, f in zip(read["shard"], frames))
    print(f"phase 13a files of {len(frames)} LJ frames of {n_atoms} atoms (host clock): "
          + ", ".join(f"{n} {os.path.getsize(paths[n]) / 2**20:.1f} MiB read in {read_s[n]:.3f} s" for n in paths)
          + f"; extxyz read-back max err {xyz_err:.2e} (limit {XYZ_TOL:.0e}); NPZ bitwise equal {npz_equal}; "
          f"shard bitwise equal {shard_equal}", flush=True)
    if not (xyz_err <= XYZ_TOL and npz_equal and shard_equal):
        raise RuntimeError("phase 13a: a file does not read back the frames written")
    del read

    # 13b: one epoch from each file, with deterministic index_add so the runs compare bitwise
    ds = "nequip_tpu_torch.data.dataset."
    sources = {
        "memory": InMemoryDataset(frames, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                      NeighborListTransform(FLAGSHIP["r_max"])]),
        "npz": {"_target_": ds + "NPZDataset", "file_path": str(paths["npz"]), "transforms": _file_transforms()},
        "shard": {"_target_": ds + "ShardDataset", "file_path": str(paths["shard"]), "transforms": _file_transforms()},
        "extxyz": {"_target_": ds + "ASEDataset", "file_path": str(paths["extxyz"]), "transforms": _file_transforms()},
    }
    losses, steps_13b = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for name, src in sources.items():
            t0 = time.perf_counter()
            trainer, launches, peak, _ = _fit_one_epoch(src)
            row = trainer.metrics_rows[0]
            losses[name] = row["train_loss_epoch/weighted_sum"]
            steps_13b[name] = [x * 1e3 for x in trainer.step_seconds]
            print(f"phase 13b {name} ({smi}): fit {time.perf_counter() - t0:.1f} s, step times "
                  f"{[round(x, 1) for x in steps_13b[name]]} ms, max_memory_allocated {peak / 2**30:.3f} GiB, "
                  f"train loss {losses[name]!r}, val loss {row['val0_epoch/weighted_sum']:.6e}; launches "
                  + ", ".join(f"{k} {launches[k]}" for k in FILE_KERNELS + ("conv_bwd", "dw_reduce")), flush=True)
            if not all(launches[k] for k in FILE_KERNELS):
                raise RuntimeError(f"phase 13b: a kernel of {FILE_KERNELS} was not launched training from {name}")
            if not all(math.isfinite(row[k]) for k in ("train_loss_epoch/weighted_sum", "val0_epoch/weighted_sum")):
                raise RuntimeError(f"phase 13b: non-finite loss training from {name}")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    xyz_rel = abs(losses["extxyz"] - losses["memory"]) / abs(losses["memory"])
    print(f"phase 13b first-epoch train loss against memory: NPZ bitwise equal {losses['npz'] == losses['memory']}, "
          f"shard bitwise equal {losses['shard'] == losses['memory']}, extxyz rel {xyz_rel:.2e} "
          f"(limit {XYZ_LOSS_REL:.0e})", flush=True)
    if not (losses["npz"] == losses["memory"] and losses["shard"] == losses["memory"] and xyz_rel <= XYZ_LOSS_REL):
        raise RuntimeError("phase 13b: training from a file differs from training on the frames in memory")

    # 13c: the bucket ladder on 2 frames each of 14^3, 16^3 and 18^3 supercells, in order
    mixed = _file_frames(14, 2, seed=1) + _file_frames(16, 2, seed=2) + frames[:2]
    mixed_ds = InMemoryDataset(mixed, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                  NeighborListTransform(FLAGSHIP["r_max"])])
    needs = [(len(f["pos"]) + 1, mixed_ds[i]["edge_index"].shape[1]) for i, f in enumerate(mixed)]
    ladder = {}
    for n_buckets in (3, 1):
        trainer, launches, peak, loader = _fit_one_epoch(mixed_ds, n_buckets=n_buckets, with_val=False, shuffle=False)
        by_bucket = {}
        for need, ms in zip(needs, trainer.step_seconds):
            by_bucket.setdefault(loader._pick_bucket(*need)["n_nodes"], []).append(round(ms * 1e3, 1))
        ladder[n_buckets] = dict(loss=trainer.metrics_rows[0]["train_loss_epoch/weighted_sum"],
                                 waste=loader.padding_waste(), peak=peak,
                                 steps=[round(x * 1e3, 1) for x in trainer.step_seconds])
        print(f"phase 13c n_buckets={n_buckets} ({smi}): ladder "
              + ", ".join(f"({b['n_nodes']} nodes, {b['n_edges']} edges)" for b in loader.buckets)
              + f"; padding waste {loader.padding_waste():.4f}; step ms by bucket (nodes: steps) {by_bucket}; "
              f"max_memory_allocated {peak / 2**30:.3f} GiB; train loss {ladder[n_buckets]['loss']:.8e}; "
              f"launches {launches['conv_fwd']} K1, {launches['conv_bwd_train']} K2-train", flush=True)
        if n_buckets == 3 and len(loader.buckets) != 3:
            raise RuntimeError(f"phase 13c: expected a 3-bucket ladder, got {loader.buckets}")
    rel = abs(ladder[3]["loss"] - ladder[1]["loss"]) / abs(ladder[1]["loss"])
    print(f"phase 13c n_buckets 3 against 1: loss rel {rel:.2e} (limit {BUCKET_LOSS_REL:.0e}), padding waste "
          f"{ladder[3]['waste']:.4f} against {ladder[1]['waste']:.4f}, peak {ladder[3]['peak'] / 2**30:.3f} against "
          f"{ladder[1]['peak'] / 2**30:.3f} GiB; the 18^3 steps with ZBL {ladder[3]['steps'][-2:]} ms against "
          f"phase 6's rr median without it {rr['median_ms'] if rr else float('nan'):.1f} ms", flush=True)
    if not (rel <= BUCKET_LOSS_REL and ladder[3]["waste"] < ladder[1]["waste"]):
        raise RuntimeError("phase 13c: the bucketed epoch differs from the worst-case-padded one")

    # 13d: the tutorial config as shipped, and lj_accuracy for 2 epochs
    configs = str(ROOT / "nequip_tpu_torch" / "configs")
    from nequip_tpu_torch.scripts import train as cli

    runs = {}
    for name, extra in (("tutorial", []), ("lj_accuracy", ["++trainer.max_epochs=2"])):
        trainers = []
        run_config = cli.run_config
        cli.run_config = lambda *a, **kw: trainers.append(run_config(*a, **kw))
        t0 = time.perf_counter()
        try:
            cli.main(["-cn", name, "-cp", configs, f"++trainer.ckpt_dir={FILES_DIR / name}", *extra])
        finally:
            cli.run_config = run_config
        main_s = time.perf_counter() - t0
        trainer = trainers[0]
        test = {k.split("/")[1]: v for k, v in trainer.metrics_rows[-1].items() if k.startswith("test0_epoch/")}
        coeffs = trainer.current_loss_coeffs()
        values = [float(v) for row in trainer.metrics_rows for v in row.values() if isinstance(v, (int, float))]
        values += list(coeffs.values())
        print(f"phase 13d nequip-torch-train -cn {name} {' '.join(extra)} ({smi}): main() {main_s:.1f} s, "
              f"{trainer.epoch} epochs, {trainer.global_step} steps, step median "
              f"{np.median(trainer.step_seconds) * 1e3:.1f} ms; test (best.ckpt) "
              + ", ".join(f"{k} {v:.4e}" for k, v in sorted(test.items()))
              + f"; loss coefficients {coeffs}", flush=True)
        if not test or not all(math.isfinite(v) for v in values):
            raise RuntimeError(f"phase 13d: {name} has missing or non-finite metrics")
        runs[name] = main_s
        del trainer, trainers
        torch.cuda.empty_cache()

    # 13e: compile the tutorial's best.ckpt (ZBL through the export) and serve it against eager
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.scripts import compile as compile_cli

    ckpt = str(FILES_DIR / "tutorial" / "best.ckpt")
    art = str(FILES_DIR / "tutorial.nequip_tpu_torch.zip")
    t0 = time.perf_counter()
    compile_cli.main([ckpt, art, "--target", "ase", "--no-check"])  # checked against eager below
    compile_s = time.perf_counter() - t0
    frame = LJTestDataset(num_frames=1, seed=7).get_frame(0)
    frame = {k: frame[k] for k in ("pos", "cell", "pbc", "atomic_numbers")}
    compiled, eager = NequIPCalculator.from_compiled_model(art), NequIPCalculator.from_saved_model(ckpt)
    gap = _deploy_gap(compiled.calculate(frame), eager.calculate(frame))
    print(f"phase 13e nequip-torch-compile --no-check of the tutorial's best.ckpt (ZBL; {smi}): {compile_s:.1f} s, "
          f"{os.path.getsize(art) / 2**20:.2f} MiB; compiled vs eager on {len(frame['pos'])} atoms: energy "
          f"rel {gap[0]:.3e}, forces {gap[1]:.3e} of max|F|, stress {gap[2]:.3e} of max|stress|; phase 13 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (gap[0] <= 1e-5 and gap[1] <= 1e-4):
        raise RuntimeError("phase 13e: the compiled tutorial model disagrees with eager")
    del compiled, eager
    for f in list(FILES_DIR.glob("*/*.ckpt")) + list(FILES_DIR.glob("*.zip")) + [paths[n] for n in paths]:
        f.unlink()
    torch.cuda.empty_cache()
    return {"read_s": read_s, "steps_13b": steps_13b, "ladder": ladder, "main_s": runs, "compile_s": compile_s}


OPTIONS_GOLDEN = ROOT / "tests" / "data" / "torch_port_options_golden.npz"
OPTIONS_ROUTES = {"options": "fused", "depth2": "fused_tp", "preset_m": "fused"}  # K1's or K4's route
OPTIONS_DIR = ROOT / "chiprun_out" / "chip_smoke_options"
PRESET_M = dict(type_names=["Cu"], r_max=4.0, preset="M", avg_num_neighbors=18.0,
                per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5})
K1_ROUTE = ("conv_fwd", "conv_bwd", "scatter_rows")
K4_ROUTE = ("tri_fwd", "tri_bwd", "scatter_rows")


def _routes(model) -> list:
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock

    return [m.route for m in model.modules() if isinstance(m, InteractionBlock)]


def _check_route(label: str, route: str, launches: dict) -> None:
    """K1's route launches K1, K2 and K3 and no K4; K4's route K4, K5 and K3
    and no K1."""
    need, never = (K1_ROUTE, "tri_fwd") if route == "fused" else (K4_ROUTE, "conv_fwd")
    if not all(launches.get(k) for k in need) or launches.get(never):
        raise RuntimeError(f"{label}: route {route} launched {launches}")


def _launches() -> dict:
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    return {k: fn.launches for k, fn in K.KERNELS.items() if fn.launches}


def phase14a_options_golden(smi: str) -> None:
    """The options golden (three JAX-built models) in f64 through the kernels
    at phase 3's gates, each layer on the route its radial MLP gives it."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data import to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.model import load_jax_params
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.utils.config import instantiate, retarget

    if not OPTIONS_GOLDEN.exists():
        raise RuntimeError(f"phase 14a: golden file {OPTIONS_GOLDEN} is missing")
    z = np.load(OPTIONS_GOLDEN)
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(
        from_dict({k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "charge")})), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([frame]), 128, round_up(frame["edge_index"].shape[1], 256), 2),
                       "cuda")
    n = len(z["pos"])
    for name, route in OPTIONS_ROUTES.items():
        model = instantiate(dict(retarget(json.loads(str(z[f"{name}/config"]))), tp_impl="fused"), _recursive_=False)
        prefix = f"{name}/params/"
        load_jax_params(model, {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)})
        model = model.to("cuda").requires_grad_(False)
        K.reset_launch_counts()
        out = model(batch)
        launches = _launches()
        e_err = abs(float(out["total_energy"][0, 0]) - float(z[f"{name}/energy"])) / abs(float(z[f"{name}/energy"]))
        f_err = float(np.abs(out["forces"][:n].cpu().numpy() - z[f"{name}/forces"]).max())
        s_err = float(np.abs(out["stress"][0].cpu().numpy() - z[f"{name}/stress"]).max())
        print(f"phase 14a options golden {name} (f64, kernels, {smi}): routes {_routes(model)}, energy rel err "
              f"{e_err:.3e}, forces max err {f_err:.3e}, stress max err {s_err:.3e}; launches {launches}", flush=True)
        if set(_routes(model)) != {route}:
            raise RuntimeError(f"phase 14a: {name} layers took routes {_routes(model)}, not {route}")
        _check_route(f"phase 14a {name}", route, launches)
        if not (e_err <= 1e-10 and f_err <= 1e-8 and s_err <= 1e-8):
            raise RuntimeError(f"phase 14a: the port's {name} disagrees with the JAX golden")
    del model, out
    torch.cuda.empty_cache()


def _layer_inputs(model, batch) -> list:
    """Per interaction block: its plan, radial MLP and the conv's inputs
    (x, sh, emb, layout) in one forward of ``model`` on ``batch``."""
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels.tp_scatter import LAYOUT_KEY

    found, blocks = [], [m for m in model.modules() if isinstance(m, InteractionBlock)]
    for b in blocks:
        def conv(data, x, _b=b, _conv=b.conv):
            found.append((_b, x.detach(), data["edge_attrs"].detach(), data["edge_embedding"].detach(),
                          data[LAYOUT_KEY]))
            return _conv(data, x)
        b.conv = conv
    try:
        model(batch)
    finally:
        for b in blocks:
            del b.conv
    return found


def phase14b_preset_m(smi: str) -> dict:
    """PresetNequIPGNNModel("M") at full width on the 23k-atom frame, f32:
    serving against tp_impl="torch"; each layer's shapes and tiles, and its
    kernels held against their plain versions on the layer's inputs and
    timed; rr steps with remat_conv False, True and "save_tp" and one fr step
    over 4 slices with remat_conv True against False; then one rr and one fr
    step against tp_impl="torch" on a 4,000-atom frame."""
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import PresetNequIPGNNModel, jax_named_grads
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    model = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **PRESET_M)
    calc = NequIPCalculator.from_model(model, device="cuda")
    frame = fcc_frame(23000, seed=1)
    calc.calculate(frame)  # warm-up: the tile queries and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = calc.calculate(frame)
    serving, peak = _launches(), torch.cuda.max_memory_allocated()
    ref_model = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="torch", **PRESET_M)
    ref_model.load_state_dict(model.state_dict())
    ref = NequIPCalculator.from_model(ref_model, device="cuda").calculate(frame)
    gap = _deploy_gap(res, ref)
    print(f"phase 14b preset M serving, {len(frame['pos'])} atoms ({smi}): routes {_routes(model)}, model "
          f"{calc.timings['model_s'] * 1e3:.1f} ms, max_memory_allocated {peak / 2**30:.3f} GiB, launches {serving}; "
          f"fused vs torch: energy rel {gap[0]:.3e}, forces {gap[1]:.3e} of max|F|", flush=True)
    if set(_routes(model)) != {"fused"}:
        raise RuntimeError("phase 14b: preset M's layers did not all take K1's route")
    _check_route("phase 14b serving", "fused", serving)
    if any(serving.get(k) for k in ("conv_bwd_train", "dw_reduce", "tri_fwd", "tri_bwd")):
        raise RuntimeError("phase 14b: serving launched a training kernel")
    if not (gap[0] <= 1e-5 and gap[1] <= 1e-4):
        raise RuntimeError("phase 14b: preset M's fused and torch serving disagree")
    del ref_model, ref, calc
    torch.cuda.empty_cache()

    # each layer's shapes and tiles; its kernels against their plain versions
    # on the layer's inputs at phase 2's f32 gates, then timed (CUDA events)
    batch, n, e = graph(23000, "cuda", seed=1)
    g_rng = torch.Generator(device="cuda").manual_seed(0)
    layers = []
    with torch.no_grad():
        for i, (blk, x, sh, emb, layout) in enumerate(_layer_inputs(model.to("cuda"), batch)):
            plan, mlp = blk.tp_scatter.plan, blk.edge_mlp
            w1, w2 = (w.detach() for w in mlp.weights())
            a0, a1 = mlp.alphas
            N, E = x.shape[0], sh.shape[0]

            def t(*shape):
                return torch.randn(*shape, device="cuda", generator=g_rng)

            g, gt = t(N, plan.mid_dim), t(N, plan.mid_dim)
            W = mlp(emb).contiguous()
            # the fr operands on slice 1 of N_CHUNKS: tangents and accumulators
            sl = K.edge_slices(layout, N_CHUNKS)[1]
            lay_s, rows = sl.layout, slice(sl.start, sl.stop)
            tx, tsh, dW = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel)
            s_ops = (x, tx, sh[rows], tsh[rows], W[rows], dW[rows], lay_s)
            acc, tacc = t(N, plan.mid_dim), t(N, plan.mid_dim)
            mlp_args = (plan, x, sh, emb, w1, w2, a0, a1, layout)
            calls = {
                "K1": (lambda: K.conv_fwd(*mlp_args), lambda: K.conv_fwd_plain(*mlp_args)),
                "K2": (lambda: K.conv_bwd(*mlp_args, g), lambda: K.conv_bwd_plain(*mlp_args, g)),
                "K2-train": (lambda: K.conv_bwd_train(*mlp_args, g), lambda: K.conv_bwd_train_plain(*mlp_args, g)),
                "K4": (lambda: K.tri_fwd(plan, x, sh, W, layout), lambda: K.tri_fwd_plain(plan, x, sh, W, layout)),
                "K5": (lambda: K.tri_bwd(plan, x, sh, W, layout, g),
                       lambda: K.tri_bwd_plain(plan, x, sh, W, layout, g)),
                "K4-acc": (lambda: K.tri_fwd(plan, x, sh[rows], W[rows], lay_s, acc=acc.clone()),
                           lambda: K.tri_fwd_plain(plan, x, sh[rows], W[rows], lay_s, acc.clone())),
                "K6": (lambda: K.jvp_fwd(plan, *s_ops, acc=(acc.clone(), tacc.clone())),
                       lambda: K.jvp_fwd_plain(plan, *s_ops, (acc.clone(), tacc.clone()))),
                "K7": (lambda: K.jvp_bwd(plan, *s_ops, g, gt), lambda: K.jvp_bwd_plain(plan, *s_ops, g, gt)),
            }
            where = f"at preset M layer {i} float32"
            errs = {k: _check(k, _tuple(kern()), _tuple(plain()), 1e-4, 1e-5, where, phase="phase 14b")
                    for k, (kern, plain) in calls.items()}
            torch.cuda.empty_cache()
            ms = {k: cuda_median_ms(calls[k][0], reps=5, warmup=1) for k in ("K1", "K2", "K2-train", "K4", "K5")}
            tiles = {"K1": K.conv_fwd_tile(plan, w1.shape[0], w1.shape[1], torch.float32, "cuda"),
                     "K4": K.tri_fwd_tile(plan, "tri_fwd", torch.float32, "cuda"),
                     "K6": K.tri_fwd_tile(plan, "jvp_fwd", torch.float32, "cuda")}
            shape = dict(dim_in=plan.dim_in, mid_dim=plan.mid_dim, WN=plan.weight_numel, paths=len(plan.paths),
                         cg_terms=len(plan._tables["fwd_coef"]), mlp=f"{w1.shape[0]}->{w1.shape[1]}->{w2.shape[1]}")
            n_real = layout.n_real
            n_dst = int((layout.dst_ptr[1:] > layout.dst_ptr[:-1]).sum())
            n_src = int(torch.unique(layout.edge_src[:n_real]).numel())
            bound = {k: _bound_ms(*work(name, plan, n_real, n_dst, n_src, x.shape[0], w1.shape[1], w1.shape[0], 4))[0]
                     for k, name in (("K1", "conv_fwd"), ("K2", "conv_bwd"), ("K2-train", "conv_bwd_train"),
                                     ("K4", "tri_fwd"), ("K5", "tri_bwd"))}
            layers.append(dict(shape=shape, tiles=tiles, ms=ms, bound_ms=bound, max_abs_err=errs))
            print(f"phase 14b preset M layer {i} ({smi}): {shape}; edges per tile {tiles}; against plain (f32, max "
                  f"abs err) " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + "; f32 ms (bound) "
                  + ", ".join(f"{k} {v:.3f} ({bound[k]:.3f})" for k, v in ms.items()), flush=True)
            del W, g, gt, tx, tsh, dW, acc, tacc, s_ops, calls
            torch.cuda.empty_cache()

    # rr steps with remat_conv False, True, "save_tp"; then fr over 4 slices with and without remat
    lab = torch.Generator(device="cuda").manual_seed(1)
    batch = dict(batch, total_energy=torch.randn(2, 1, device="cuda", generator=lab, dtype=torch.float64),
                 forces=torch.randn(batch["pos"].shape, device="cuda", generator=lab, dtype=torch.float64))
    rr = {}
    remats = {"none": {}, "remat_conv=True": {"remat_conv": True}, "remat_conv='save_tp'": {"remat_conv": "save_tp"},
              "remat_force=True": {"remat_force": True}}
    for label, kw in remats.items():
        m = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **kw, **PRESET_M)
        module = NequIPTrainModule(m.to("cuda"), loss=EnergyForceLoss(type_names=["Cu"]),
                                   optimizer={"_target_": "optax.adam", "learning_rate": 1e-3})
        times, losses = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(3):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            loss, _, _ = module.compute_loss(batch)
            loss.backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
            if step == 0:
                grads, launches = jax_named_grads(m), _launches()
            m.zero_grad(set_to_none=True)
            del loss
        rr[label] = dict(ms=float(np.median(times)), peak=torch.cuda.max_memory_allocated() / 2**30, losses=losses,
                         grads=grads, launches=launches)
        print(f"phase 14b preset M rr step, {label} ({smi}): median {rr[label]['ms']:.1f} ms of "
              f"{[round(t, 1) for t in times]}, max_memory_allocated {rr[label]['peak']:.3f} GiB, losses "
              f"{losses}, launches a step {launches}", flush=True)
        del module, m
        torch.cuda.empty_cache()
    # remat_conv=True recomputes each layer's forward twice a rr step (in the
    # force backward and again in the loss backward); "save_tp" never reruns
    # the conv; remat_force is recorded only (nn/grad_output.py)
    wants = {"remat_conv=True": {"conv_fwd": 2 * 4}, "remat_conv='save_tp'": {}, "remat_force=True": {}}
    base = rr["none"]
    for label, want in wants.items():
        err = _grad_errors(rr[label]["grads"], base["grads"])
        keys = set(rr[label]["launches"]) | set(base["launches"]) | set(want)
        extra = {k: rr[label]["launches"].get(k, 0) - base["launches"].get(k, 0) for k in keys}
        want = {k: want.get(k, 0) for k in keys}
        loss_rel = abs(rr[label]["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        print(f"phase 14b {label} against none: grads max err / max|grad| {err:.3e}, loss rel {loss_rel:.3e}, peak "
              f"{rr[label]['peak']:.3f} against {base['peak']:.3f} GiB, step {rr[label]['ms']:.1f} against "
              f"{base['ms']:.1f} ms, extra launches {extra} (expected {want})", flush=True)
        if not (err <= 1e-4 and loss_rel <= 1e-5):
            raise RuntimeError(f"phase 14b: {label} changed the loss or the gradients")
        if extra != want:
            raise RuntimeError(f"phase 14b: {label} launched {extra} more kernels, not {want}")
    fr = {}
    for remat in (False, True):
        m = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", remat_conv=remat, **PRESET_M)
        module = NequIPTrainModule(m.to("cuda"), loss=EnergyForceLoss(type_names=["Cu"]),
                                   optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                                   force_grad_mode="fr", fr_edge_chunks=N_CHUNKS)
        module.compute_grads_fr(batch)  # warm-up
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, _ = module.compute_grads_fr(batch)
        torch.cuda.synchronize()
        fr[remat] = dict(ms=(time.perf_counter() - t0) * 1e3, peak=torch.cuda.max_memory_allocated() / 2**30,
                         loss=float(loss), grads=jax_named_grads(m), launches=_launches())
        print(f"phase 14b preset M fr step over {N_CHUNKS} slices, remat_conv={remat!r} ({smi}): "
              f"{fr[remat]['ms']:.1f} ms, max_memory_allocated {fr[remat]['peak']:.3f} GiB, loss "
              f"{fr[remat]['loss']:.6e}, launches {fr[remat]['launches']}", flush=True)
        del module, m, loss
        torch.cuda.empty_cache()
    err = _grad_errors(fr[True]["grads"], fr[False]["grads"])
    fr_rr = _grad_errors(fr[False]["grads"], rr["none"]["grads"])
    print(f"phase 14b fr remat against none: grads max err / max|grad| {err:.3e}; fr against rr (no remat) "
          f"{fr_rr:.3e}", flush=True)
    if not (err <= 1e-4 and fr_rr <= 1e-4):
        raise RuntimeError("phase 14b: preset M's fr gradients disagree (remat, or against rr)")
    for k in ("jvp_fwd", "jvp_bwd", "tri_fwd_acc"):
        if not fr[True]["launches"].get(k):
            raise RuntimeError(f"phase 14b: the fr step with remat did not launch {k}")
    del batch
    torch.cuda.empty_cache()
    _preset_m_against_torch(smi)
    return {"layers": layers, "rr": {str(k): {kk: v[kk] for kk in ("ms", "peak")} for k, v in rr.items()},
            "fr": {str(k): {kk: v[kk] for kk in ("ms", "peak")} for k, v in fr.items()}}


def _preset_m_against_torch(smi: str) -> None:
    """One rr step and one fr step (4 slices) of preset M on the kernels
    against the same weights at tp_impl="torch", on a 4,000-atom frame at
    full width (smaller than phase 4's, to keep the plain conv's double
    backward in memory): losses within 1e-5 rel, gradients within 1e-4 of
    max."""
    import torch

    from nequip_tpu_torch.model import PresetNequIPGNNModel, jax_named_grads
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    batch, n, e = graph(4000, "cuda", seed=2)
    lab = torch.Generator(device="cuda").manual_seed(2)
    batch = dict(batch, total_energy=torch.randn(2, 1, device="cuda", generator=lab, dtype=torch.float64),
                 forces=torch.randn(batch["pos"].shape, device="cuda", generator=lab, dtype=torch.float64))
    state = None
    for mode in ("rr", "fr"):
        runs = {}
        for impl in ("fused", "torch"):
            m = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl=impl, **PRESET_M).to("cuda")
            if state is None:
                state = m.state_dict()
            m.load_state_dict(state)
            module = NequIPTrainModule(m, loss=EnergyForceLoss(type_names=["Cu"]),
                                       optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                                       force_grad_mode=mode,
                                       fr_edge_chunks=N_CHUNKS if mode == "fr" and impl == "fused" else 0)
            if mode == "rr":
                loss, _, _ = module.compute_loss(batch)
                loss.backward()
            else:
                loss, _, _ = module.compute_grads_fr(batch)
            torch.cuda.synchronize()
            runs[impl] = (float(loss.detach()), jax_named_grads(m))
            del module, m, loss
            torch.cuda.empty_cache()
        err = _grad_errors(runs["fused"][1], runs["torch"][1])
        loss_rel = abs(runs["fused"][0] - runs["torch"][0]) / abs(runs["torch"][0])
        print(f"phase 14b preset M {mode} step on {n} atoms, {e} edges, kernels against tp_impl='torch' ({smi}): "
              f"loss rel {loss_rel:.3e}, grads max err / max|grad| {err:.3e}", flush=True)
        if not (loss_rel <= 1e-5 and err <= 1e-4):
            raise RuntimeError(f"phase 14b: preset M's {mode} step on the kernels disagrees with tp_impl='torch'")


def phase14c_depth2(smi: str) -> None:
    """The flagship's widths with a depth-2 radial MLP at tp_impl="fused":
    K4's route (K4, K5, K3 and no K1) serving against tp_impl="torch", and its
    package compiled through the registered ops against eager."""
    import os

    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.scripts import compile as compile_cli
    from nequip_tpu_torch.scripts import package as package_cli

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", radial_mlp_depth=2, **FLAGSHIP)
    eager = NequIPCalculator.from_model(model, device="cuda")
    frame = fcc_frame(23000, seed=1)
    eager.calculate(frame)  # warm-up
    K.reset_launch_counts()
    res = eager.calculate(frame)
    launches = _launches()
    ref_model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="torch", radial_mlp_depth=2, **FLAGSHIP)
    ref_model.load_state_dict(model.state_dict())
    gap = _deploy_gap(res, NequIPCalculator.from_model(ref_model, device="cuda").calculate(frame))
    print(f"phase 14c depth-2 radial MLP at tp_impl='fused' ({smi}): routes {_routes(model)}, model "
          f"{eager.timings['model_s'] * 1e3:.1f} ms, launches {launches}; against torch: energy rel {gap[0]:.3e}, "
          f"forces {gap[1]:.3e} of max|F|", flush=True)
    if set(_routes(model)) != {"fused_tp"}:
        raise RuntimeError("phase 14c: the depth-2 layers did not take K4's route")
    _check_route("phase 14c", "fused_tp", launches)
    if not (gap[0] <= 1e-5 and gap[1] <= 1e-4):
        raise RuntimeError("phase 14c: the depth-2 model disagrees with tp_impl='torch'")
    del ref_model

    OPTIONS_DIR.mkdir(parents=True, exist_ok=True)
    nl = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    example = pad_batch(batched_from_list([nl]), round_up(len(frame["pos"]), 128),
                        round_up(nl["edge_index"].shape[1], 256), 2)
    pkg, art = str(OPTIONS_DIR / "depth2_pkg.zip"), str(OPTIONS_DIR / "depth2.nequip_tpu_torch.zip")
    package_cli.package_model(model, pkg, example, "cuda", snapshot=False)
    t0 = time.perf_counter()
    compile_cli.main([pkg, art, "--target", "ase", "--no-check"])  # checked against eager below
    compile_s = time.perf_counter() - t0
    compiled = NequIPCalculator.from_compiled_model(art)
    compiled.calculate(frame)  # warm-up
    K.reset_launch_counts()
    got = compiled.calculate(frame)
    c_launches = _launches()
    gap = _deploy_gap(got, eager.calculate(frame))
    print(f"phase 14c nequip-torch-compile of the depth-2 package ({smi}): {compile_s:.1f} s, "
          f"{os.path.getsize(art) / 2**20:.2f} MiB; compiled model {compiled.timings['model_s'] * 1e3:.1f} ms, "
          f"launches {c_launches}; compiled vs eager: energy rel {gap[0]:.3e}, forces {gap[1]:.3e} of max|F|, "
          f"stress {gap[2]:.3e} of max|stress|", flush=True)
    _check_route("phase 14c compiled", "fused_tp", c_launches)
    if not (gap[0] <= 1e-5 and gap[1] <= 1e-4):
        raise RuntimeError("phase 14c: the compiled depth-2 program disagrees with eager")
    del compiled, eager, model
    for f in OPTIONS_DIR.glob("*.zip"):
        f.unlink()
    torch.cuda.empty_cache()


def phase14_options(smi: str) -> dict:
    """Phase 14: the model builder's options (14a), preset M at full width
    (14b) and the depth-2 radial MLP on K4's route (14c)."""
    t0 = time.perf_counter()
    phase14a_options_golden(smi)
    out = phase14b_preset_m(smi)
    phase14c_depth2(smi)
    print(f"phase 14 {time.perf_counter() - t0:.1f} s", flush=True)
    return out


OPTIM_GOLDEN = ROOT / "tests" / "data" / "torch_port_optim_golden.npz"
OPTIM_GOLDEN_TOL = 1e-8  # of max |p| per tensor (f64)
MUON_GOLDEN_TOL = 1e-5  # Muon's Newton-Schulz runs in float32 on both sides
OPTIM_GOLDEN_STEPS = 3
# 15a: every case of the golden, and ConFIG with lsqr=True from EMA-ConFIG's steps (the EMA leaves the weights alone)
OPTIM_GOLDEN_RUNS = (("config_pinv", None), ("ema_config_lsqr", None), ("ema_config_lsqr", "ConFIGTrainModule"),
                     ("muon_adam", None), ("schedule_free", None), ("adam_eps_root", None),
                     ("adam_warmup_cosine", None), ("lion_warmup_cosine", None), ("adafactor_factored", None),
                     ("lamb_mask", None), ("polyak_sgd", None), ("reduce_on_plateau", None))
MODULES_TOL = 1e-4  # 15c: of max |g|, f32


def optim_golden_case(z, name: str, device: str, module_name=None):
    """Three steps of one case of tests/data/torch_port_optim_golden.npz
    through the port's kernels (``tp_impl="fused"``): the model's tensors
    after them, and the evaluation model's when it is another (EMA,
    schedule-free), by JAX dotted path."""
    from nequip_tpu_torch import train as port_train
    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data import to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.model import load_jax_params
    from nequip_tpu_torch.utils.config import instantiate, retarget

    case = json.loads(str(z["cases"]))[name]
    kwargs = dict(case["kwargs"])
    if module_name is not None:
        kwargs.pop("ema_decay", None)
    model = instantiate(dict(retarget(json.loads(str(z["config"]))), tp_impl="fused"), _recursive_=False)
    load_jax_params(model, {k[len("init/"):]: z[k] for k in z.files if k.startswith("init/")})
    module = getattr(port_train, module_name or case["module"])(
        model, loss=port_train.EnergyForceLoss(type_names=["Cu"]), optimizer=retarget(case["optimizer"]),
        device=device, **kwargs)
    frame = {k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "total_energy", "forces")}
    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([data]), 128, round_up(data["edge_index"].shape[1], 256), 2),
                       device)
    coeffs = module.loss.coeff_vector()
    for _ in range(OPTIM_GOLDEN_STEPS):
        module.training_step(batch, coeffs)
    host = lambda m: {k: t.detach().cpu().numpy() for k, t in m.jax_named_tensors()}  # noqa: E731
    evaluation = module.evaluation_model()
    return host(module.model), None if evaluation is module.model else host(evaluation)


def optim_golden_errors(z, name: str, params: dict, evaluation) -> tuple:
    """Largest per-tensor max |diff| / max |golden| of the weights and of the
    evaluation weights (0 without them) against the golden's."""
    def err(got, prefix):
        want = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
        if set(got) != set(want):
            raise RuntimeError(f"{name}: tensors {sorted(set(got) ^ set(want))} are not in both")
        return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-300) for k in want)

    return err(params, f"{name}/params/"), 0.0 if evaluation is None else err(evaluation, f"{name}/eval/")


def phase15a_golden(smi: str) -> None:
    """The optimizer golden's cases in f64 through the kernels."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    if not OPTIM_GOLDEN.exists():
        raise RuntimeError(f"phase 15a: golden file {OPTIM_GOLDEN} is missing")
    z = np.load(OPTIM_GOLDEN)
    for name, module_name in OPTIM_GOLDEN_RUNS:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        params, evaluation = optim_golden_case(z, name, "cuda", module_name)
        torch.cuda.synchronize()
        p_err, e_err = optim_golden_errors(z, name, params, evaluation)
        tol = MUON_GOLDEN_TOL if name == "muon_adam" else OPTIM_GOLDEN_TOL
        label = name if module_name is None else f"{name} as {module_name}"
        print(f"phase 15a optimizer golden {label} (f64, kernels, {smi}): {OPTIM_GOLDEN_STEPS} steps in "
              f"{time.perf_counter() - t0:.2f} s, weights max err / max|p| {p_err:.3e}, evaluation weights "
              f"{e_err:.3e} (gate {tol:g}); launches {_launches()}", flush=True)
        if not all(K.KERNELS[k].launches for k in TRAINING_KERNELS):
            raise RuntimeError(f"phase 15a: {label} did not launch every rr training kernel")
        if not (p_err <= tol and e_err <= tol):
            raise RuntimeError(f"phase 15a: the port's {label} disagrees with the JAX golden")
    torch.cuda.empty_cache()


def _config_direction_inputs(module, batch):
    import torch

    A_raw, _, _ = module.component_grads(batch)
    b = torch.tensor([module.loss.coeffs[module.loss.entries[i]["name"]] for i in module._component_index],
                     dtype=A_raw.dtype, device=A_raw.device)
    return A_raw, b


def phase15c_second_pass(smi: str, dm) -> None:
    """ConFIG's k gradients from one graph against k separate passes, and
    its final gradient through the kernels against tp_impl="torch", on
    phase 6's first batch at full width, f32."""
    import torch

    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.train import ConFIGTrainModule, EnergyForceLoss
    from nequip_tpu_torch.train.config_module import config_direction

    first = next(iter(DataLoader(dm.datasets["train"][0], batch_size=1, shuffle=True, seed=dm.seed, device="cuda")))
    modules = {}
    for impl in ("fused", "torch"):
        model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=impl, **FLAGSHIP).to("cuda")
        modules[impl] = ConFIGTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), lsqr=True)
    fused = modules["fused"]
    names = [fused.loss.entries[i]["name"] for i in fused._component_index]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A_one, b = _config_direction_inputs(fused, first)
    torch.cuda.synchronize()
    one_ms, one_peak = (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2**30
    params = [p for _, p in fused.named_trainable()]
    pass_err = 0.0
    for i, name in enumerate(names):
        out = fused.model(fused._prepare(first))
        _, values = fused.loss.values(fused.loss.batch_state(out, first))
        row = torch.cat([g.reshape(-1) for g in torch.autograd.grad(values[name], params)])
        pass_err = max(pass_err, float((A_one[i] - row).abs().max()) / float(row.abs().max()))
        del out, values, row
    flat = config_direction(A_one, b)
    A_torch, _ = _config_direction_inputs(modules["torch"], first)
    flat_torch = config_direction(A_torch, b)
    final_err = float((flat - flat_torch).abs().max()) / float(flat_torch.abs().max())
    print(f"phase 15c ConFIG second pass ({smi}, f32, {len(names)} components {names}): one graph with retain_graph "
          f"{one_ms:.1f} ms, max_memory_allocated {one_peak:.3f} GiB; against separate passes max err / max|g| "
          f"{pass_err:.3e}; final gradient fused vs torch {final_err:.3e} (gate {MODULES_TOL:g})", flush=True)
    if not (pass_err <= MODULES_TOL and final_err <= MODULES_TOL):
        raise RuntimeError("phase 15c: ConFIG's second pass or its fused gradient disagrees")
    del modules, fused, A_one, A_torch
    torch.cuda.empty_cache()


def phase15b_fit(smi: str, dm, rr: dict) -> dict:
    """Trainer.fit of the flagship at full width (f32, fused) with
    EMA-ConFIG, Muon + Adam and schedule-free, then Muon + Adam under fr
    over N_CHUNKS edge slices, then optax's Lion with a schedule as its
    rate and the plateau scale (which reads each step's loss) on optax
    chains; step times, peaks, launches and losses."""
    import torch

    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch import train as port_train

    adam = {"_target_": "optax.adam", "learning_rate": 1e-3}
    muon = {"_target_": "nequip_tpu_torch.train.muon_adam", "muon_lr": 0.02, "adam_lr": 1e-3}
    lion = {"_target_": "optax.lion", "learning_rate": {
        "_target_": "optax.warmup_cosine_decay_schedule", "init_value": 1e-4, "peak_value": 1e-3, "warmup_steps": 1,
        "decay_steps": 4}}
    plateau = {"_target_": "optax.contrib.reduce_on_plateau", "factor": 0.5, "patience": 1, "rtol": 0.9}
    runs = (("ema_config", "EMAConFIGTrainModule", adam, dict(lsqr=True)),
            ("muon_adam", "NequIPTrainModule", muon, {}),
            ("schedule_free", "ScheduleFreeTrainModule", adam, dict(warmup_steps=2)),
            ("muon_adam_fr", "NequIPTrainModule", muon, dict(force_grad_mode="fr", fr_edge_chunks=N_CHUNKS)),
            ("lion_schedule", "NequIPTrainModule", lion, {}),
            # the bare plateau scale times a constant -1e-3 schedule: SGD whose rate halves on a plateau
            ("reduce_on_plateau", "NequIPTrainModule", plateau,
             dict(lr_scheduler={"_target_": "optax.constant_schedule", "value": -1e-3})))
    out = {}
    for label, cls, optimizer, kwargs in runs:
        model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP).to("cuda")
        module = getattr(port_train, cls)(model, loss=port_train.EnergyForceLoss(type_names=["Cu"]),
                                          val_metrics=port_train.EnergyForceMetrics(), optimizer=optimizer, **kwargs)
        trainer = port_train.Trainer(max_epochs=2, ckpt_dir=str(ROOT / "chiprun_out" / f"chip_smoke_{label}"),
                                     save_last=False, save_best=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        trainer.fit(module, dm)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in K.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = np.asarray(trainer.step_seconds[1:]) * 1e3
        print(f"phase 15b {label} ({cls}, {smi}): first step {trainer.step_seconds[0] * 1e3:.1f} ms, later steps "
              f"median {np.median(steps):.1f} ms (min {steps.min():.1f}, max {steps.max():.1f}), "
              f"max_memory_allocated {peak:.3f} GiB; Adam rr (phase 6): median {rr['median_ms']:.1f} ms, "
              f"{rr['peak_gib']:.3f} GiB", flush=True)
        for row in trainer.metrics_rows:
            print(f"phase 15b {label} epoch {row['epoch']}: train loss {row['train_loss_epoch/weighted_sum']:.6e}, "
                  f"val loss {row['val0_epoch/weighted_sum']:.6e}", flush=True)
        print(f"phase 15b {label} launches {launches}", flush=True)
        if label == "reduce_on_plateau":
            plateau_state = module.optimizer.chain_states[0]["states"][0]
            print(f"phase 15b {label}: scale after {trainer.global_step} steps {float(plateau_state['scale']):g}, "
                  f"best loss {float(plateau_state['best_value']):.6e}", flush=True)
        for name in FR_CHUNKED_KERNELS if label.endswith("_fr") else TRAINING_KERNELS:
            if launches[name] == 0:
                raise RuntimeError(f"phase 15b: kernel {name} was not launched by {label}")
        _check_fit(f"phase 15b {label}", trainer, 2)
        out[label] = dict(median_ms=float(np.median(steps)), peak_gib=peak, launches=launches)
        del module, model, trainer
        torch.cuda.empty_cache()
    return out


def phase15_train_modules(smi: str, dm, rr: dict) -> dict:
    """Phase 15: ConFIG, Muon, schedule-free and the other optimizers and
    schedules against the JAX goldens (15a), at full width (15b) and
    ConFIG's second pass (15c)."""
    t0 = time.perf_counter()
    phase15a_golden(smi)
    out = phase15b_fit(smi, dm, rr)
    phase15c_second_pass(smi, dm)
    print(f"phase 15 {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# phase 16: the bfloat16 fast mode (enable_bf16_fast_mode) through every conv kernel in bf16
BF16_FLOP_S = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet): the bf16 kernels' operation bound
BF16_KERNELS = ("conv_fwd", "conv_bwd", "conv_bwd_train", "dw_reduce", "scatter_rows", "tri_fwd", "tri_fwd_acc",
                "tri_bwd", "jvp_fwd", "jvp_bwd")
BF16_TRILINEAR = ("tri_fwd", "tri_fwd_acc", "tri_bwd", "jvp_fwd", "jvp_bwd")  # 16a's second half
BF16_TRAINING = ("conv_bwd_train", "dw_reduce")  # 16a's third part; launched by 16g's rr fit on "fused"
BF16_FR_KERNELS = ("tri_fwd_acc", "tri_bwd", "jvp_fwd", "jvp_bwd", "scatter_rows")  # 16g: fr over edge slices
# a bf16 training step against the f64 training golden (loss rel; each tensor's max err / max|grad|): JAX's own
# bf16 step (XLA, CPU) on that golden measures loss 2.2e-4, gradients 4.2e-2 (tests/test_torch_port_bf16_tri.py)
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-3, 0.1
BF16_PLAIN_REPS = 3  # the plain twins of K4-K7 at 23k atoms take tens of ms a call
BF16_DEPTH2_MD_STEPS = 20
# a bf16 kernel and its plain twin round at the same points and differ only by
# the order of their float32 sums: an output (or a rounded w or h inside)
# may land one bf16 ulp apart; two ulps of max|out|
BF16_KERNEL_TOL = 8e-3
BF16_E_TOL, BF16_F_TOL = 1e-3, 2e-2  # against the f64 golden: JAX's gate (tests/integration/test_deploy.py)
# a bf16 request against the f32 request on the same frame: a sanity bound (16b is the accuracy gate)
BF16_SERVE_F_TOL = 5e-2
BF16_MD_STEPS = 50
BF16_DIR = CLI_DIR.parent / "chip_smoke_bf16"  # beside the CLI runs' outputs


def _bf16_model(tp_impl: str = "fused", **kw):
    """The flagship (seed 0, f32 weights; ``kw`` on top of FLAGSHIP) through
    enable_bf16_fast_mode."""
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.model.modify_utils import modify

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=tp_impl, **dict(FLAGSHIP, **kw))
    return modify(model, [{"modifier": "enable_bf16_fast_mode"}])


def _bf16_check(label: str, got, ref, li: int) -> tuple:
    """(largest |got - ref| / max|ref|, largest |got - ref|) over the
    outputs of a bf16 kernel against its twin: each output bf16 (or
    float32: accumulators, the weight gradients) as the twin's; raises
    beyond BF16_KERNEL_TOL of max|ref| or on a non-finite value."""
    import torch

    err = abs_err = 0.0
    for out_i, (a, b) in enumerate(zip(got, ref)):
        if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32) or not bool(a.float().isfinite().all()):
            raise RuntimeError(f"phase 16a: {label} output {out_i} layer {li} is not finite bf16 (or float32)")
        diff, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        if diff > BF16_KERNEL_TOL * scale:
            raise RuntimeError(f"phase 16a: {label} output {out_i} layer {li} disagrees with plain: max |diff| "
                               f"{diff:.3e}, max |ref| {scale:.3e} (limit {BF16_KERNEL_TOL:.0e} of it)")
        err, abs_err = max(err, diff / scale), max(abs_err, diff)
    return err, abs_err


def phase16a_kernels(n_atoms: int, reps: int) -> dict:
    """K1, K2 (inference) and K3 in bf16 against their plain versions at
    the flagship's three layer shapes on the 23k-atom graph, each bitwise
    equal on a repeat call, with kernel, plain and bound ms (index_add_ in
    bf16 and the f32 kernel on the same values beside K3, whose outputs
    must be bitwise its edge-order reference, as on a misaligned view:
    _k3_misaligned); then K4-K7 (_bf16_trilinear), K2's training variant
    and the dW reduction (_bf16_training); returns the report rows, summed
    over the layers."""
    import torch

    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    dev = torch.device("cuda")
    data, n, e = graph(n_atoms, dev)
    layout = data[K.LAYOUT_KEY]
    N, E, n_real = data["pos"].shape[0], data["edge_index"].shape[1], layout.n_real
    n_src = int(torch.unique(layout.edge_src[:n_real]).numel())
    n_dst = int((layout.dst_ptr[1:] > layout.dst_ptr[:-1]).sum())
    blocks = [m for m in _bf16_model().modules() if isinstance(m, InteractionBlock)]
    rng = np.random.RandomState(16)
    report = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0,
                  "library_ms": None} for k in BF16_KERNELS}
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        a0, a1 = blk.edge_mlp.alphas
        n_emb, hidden = blk.edge_mlp.w0.shape

        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=dev)

        x, sh, emb = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb)
        w1, w2, g = t(n_emb, hidden), t(hidden, plan.weight_numel), t(N, plan.mid_dim)
        dx_edge = K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g)[0]
        dx32 = dx_edge.float()
        src_idx = layout.edge_src[:n_real].long()
        buf = torch.zeros(N, plan.dim_in, dtype=torch.bfloat16, device=dev)
        calls = {
            "conv_fwd": (lambda: K.conv_fwd(plan, x, sh, emb, w1, w2, a0, a1, layout),
                         lambda: K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout)),
            "conv_bwd": (lambda: K.conv_bwd(plan, x, sh, emb, w1, w2, a0, a1, layout, g),
                         lambda: K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g)),
            "scatter_rows": (lambda: K.scatter_rows(dx_edge, layout.src_perm, layout.src_ptr),
                             lambda: K.scatter_rows_plain(dx_edge, layout.src_perm, layout.src_ptr)),
        }
        for name, (kern, plain) in calls.items():
            counter = K.KERNELS[name]
            before = counter.launches
            got = _tuple(kern())
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise RuntimeError(f"phase 16a: {name} bf16 launch counter did not move")
            err, abs_err = _bf16_check(name, got, _tuple(plain()), li)
            if not all(torch.equal(a, b) for a, b in zip(got, _tuple(kern()))):
                raise RuntimeError(f"phase 16a: {name} bf16 differs on a repeat call")
            f32_ms = lib_ms = None
            if name == "scatter_rows":
                _k3_edge_order(f"layer {li}", got[0], dx_edge, layout.src_perm, layout.src_ptr)
                kern32 = lambda: K.scatter_rows(dx32, layout.src_perm, layout.src_ptr)  # noqa: E731
                ms, f32_ms = interleaved_median_ms([kern, kern32], reps, rounds=1)
                ten_ms, ten32_ms = _ten_back_to_back((kern, kern32), reps)
                lib_ms = cuda_median_ms(lambda: buf.index_add_(0, src_idx, dx_edge[:n_real]), reps)
            else:
                ms = cuda_median_ms(kern, reps)
            plain_ms = cuda_median_ms(plain, reps)
            ops, nbytes = work(name, plan, n_real, n_dst, n_src, N, hidden, n_emb, 2)
            t_ops, t_bytes = ops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            print(f"phase 16a {name} bf16 layer {li}: max err {err:.3e} of max|out| (limit {BF16_KERNEL_TOL:.0e}), "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                  f"({'operations' if t_ops > t_bytes else 'bytes'})"
                  + ("" if lib_ms is None else
                     f", index_add_ bf16 {lib_ms:.3f} ms, f32 kernel {f32_ms:.3f} ms (same call); ten back to "
                     f"back, per call: kernel {ten_ms:.4f} ms, f32 kernel {ten32_ms:.4f} ms; geometry "
                     f"{K.scatter_rows_geometry(plan.dim_in, dx_edge.data_ptr() % 16 == 0)}"), flush=True)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bound_ms"] += bound
            r["ops"] += ops
            r["bytes"] += nbytes
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
                r["f32_ms"] = r.get("f32_ms", 0.0) + f32_ms
        del x, sh, emb, w1, w2, g, dx_edge, dx32, buf, calls
        torch.cuda.empty_cache()
    _k3_misaligned(layout, E, rng, reps)
    _bf16_trilinear(layout, N, E, n_real, n_src, n_dst, blocks, rng, reps, report)
    _bf16_training(layout, N, E, n_real, n_src, n_dst, blocks, rng, reps, report)
    for name, r in report.items():
        r["bound_by"] = "operations" if r.pop("ops") / BF16_FLOP_S > r.pop("bytes") / HBM_BYTES_S else "bytes"
        print(f"phase 16a {name} bf16, sum of 3 layers: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
              + ("" if r.get("f32_ms") is None else f", f32 kernel {r.pop('f32_ms'):.3f} ms")
              + ("" if r["library_ms"] is None else
                 f", {'torch.mm bf16' if name == 'dw_reduce' else 'index_add_'} {r['library_ms']:.3f} ms"),
              flush=True)
    return report


def _k3_edge_order(label: str, got, values, perm, ptr) -> None:
    """K3 bf16's output must be bitwise its edge-order float32 reference
    (tp_scatter.scatter_rows_edge_order: the same additions in the same
    order, rounded once)."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    want = K.scatter_rows_edge_order(values, perm, ptr)
    if got.dtype != want.dtype or not torch.equal(got, want):
        diff = float((got.float() - want.float()).abs().max())
        raise RuntimeError(f"phase 16a: scatter_rows bf16 {label} is not bitwise its edge-order reference "
                           f"(max |diff| {diff:.3e})")


def _k3_misaligned(layout, E: int, rng, reps: int) -> None:
    """K3 bf16 on a values view 2 bytes off 16-byte alignment with D = 36
    (D % 8 != 0), on the 23k stream: the kernel's 2-byte load path, bitwise
    its edge-order reference and its repeat call, the counter moving."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    d = 36
    flat = torch.as_tensor(rng.standard_normal(E * d + 1), dtype=torch.bfloat16, device="cuda")
    v = flat[1:].view(E, d)
    geom = K.scatter_rows_geometry(d, v.data_ptr() % 16 == 0)
    if v.data_ptr() % 16 != 2 or geom.vec != 1:
        raise RuntimeError(f"phase 16a: the misaligned K3 case does not take 2-byte loads: {geom}")
    before = K.KERNELS["scatter_rows"].launches
    got = K.scatter_rows(v, layout.src_perm, layout.src_ptr)
    torch.cuda.synchronize()
    if K.KERNELS["scatter_rows"].launches != before + 1:
        raise RuntimeError("phase 16a: scatter_rows bf16 (misaligned) launch counter did not move")
    _k3_edge_order(f"D {d} at a 2-byte offset", got, v, layout.src_perm, layout.src_ptr)
    if not torch.equal(got, K.scatter_rows(v, layout.src_perm, layout.src_ptr)):
        raise RuntimeError("phase 16a: scatter_rows bf16 (misaligned) differs on a repeat call")
    ms = cuda_median_ms(lambda: K.scatter_rows(v, layout.src_perm, layout.src_ptr), reps)
    print(f"phase 16a scatter_rows bf16, D {d} at a 2-byte offset: bitwise its edge-order reference and its repeat "
          f"call, geometry {geom}, kernel {ms:.3f} ms", flush=True)


def _bf16_training(layout, N: int, E: int, n_real: int, n_src: int, n_dst: int, blocks, rng, reps: int,
                   report: dict) -> None:
    """16a's third part: K2's training variant (with its two dW reductions,
    as phase 2 times it) and the dW reduction alone at both shapes (dW2 = h
    (x) dW_e, dW1 = emb (x) dh_pre) at the flagship's three layer shapes on
    the 23k-atom stream, in bf16 against their twins (K2-train at
    BF16_KERNEL_TOL of max|out|, with dx, dsh and demb bitwise K2's
    inference variant's; the dW reduction at phase 2's f32 gate), each
    bitwise equal on a repeat call; the kernel's and the f32 kernel's
    CUDA-event medians on the same values in one call, the twin's
    (BF16_PLAIN_REPS), torch.mm on the same bf16 operands beside the dW
    reduction (also ten calls back to back, as phase 2 times it), and the
    bound at 2 B a bf16 value and 4 B a float32 one; added to ``report``.
    Then the dW2 reduction at preset M's layer-1 shape (_bf16_dw_preset_m)."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    dev = torch.device("cuda")
    # per shape, over the layers: bf16 kernel, f32 kernel, plain, bound, torch.mm bf16, and ten back to back:
    # bf16 kernel, f32 kernel, torch.mm bf16
    dw_sums = {}
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        a0, a1 = blk.edge_mlp.alphas
        n_emb, hidden = blk.edge_mlp.w0.shape

        def t(*shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=dev)

        x, sh, emb, w1, w2, g = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb), t(n_emb, hidden),
                                 t(hidden, plan.weight_numel), t(N, plan.mid_dim))
        h_e, dw_e, dh_pre = t(n_real, hidden), t(n_real, plan.weight_numel), t(n_real, hidden)
        args16 = (plan, x, sh, emb, w1, w2, a0, a1, layout, g)
        args32 = tuple(v.float() if isinstance(v, torch.Tensor) else v for v in args16)
        emb32, h32, dw32, dh32 = (v.float() for v in (emb, h_e, dw_e, dh_pre))
        calls = {
            "conv_bwd_train": ((lambda: K.conv_bwd_train(*args16)), (lambda: K.conv_bwd_train_plain(*args16)),
                               (lambda: K.conv_bwd_train(*args32)), None),
            "dw_reduce dW2": ((lambda: K.dw_reduce(h_e, dw_e, a1, n_real)),
                              (lambda: K.dw_reduce_plain(h_e, dw_e, a1, n_real)),
                              (lambda: K.dw_reduce(h32, dw32, a1, n_real)), (lambda: torch.mm(h_e.t(), dw_e))),
            "dw_reduce dW1": ((lambda: K.dw_reduce(emb, dh_pre, a0, n_real)),
                              (lambda: K.dw_reduce_plain(emb, dh_pre, a0, n_real)),
                              (lambda: K.dw_reduce(emb32, dh32, a0, n_real)),
                              (lambda: torch.mm(emb[:n_real].t(), dh_pre))),
        }
        for label, (kern, plain, kern32, library) in calls.items():
            name = label.split()[0]
            counter = K.KERNELS[name]
            before = counter.launches
            got = _tuple(kern())
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise RuntimeError(f"phase 16a: {label} bf16 launch counter did not move")
            ref = _tuple(plain())
            if name == "dw_reduce":
                abs_err = _check(label, got, ref, 1e-4, 1e-5, f"layer {li} bf16", phase="phase 16a")
            else:
                abs_err = _bf16_check(label, got, ref, li)[1]
                if not all(torch.equal(a, b) for a, b in zip(got[:3], K.conv_bwd(*args16))):
                    raise RuntimeError(f"phase 16a: conv_bwd_train's dx, dsh, demb in bf16 are not conv_bwd's, "
                                       f"layer {li}")
            if not all(torch.equal(a, b) for a, b in zip(got, _tuple(kern()))):
                raise RuntimeError(f"phase 16a: {label} bf16 differs on a repeat call")
            del got, ref
            ms, f32_ms = interleaved_median_ms([kern, kern32], reps, rounds=1)
            plain_ms = cuda_median_ms(plain, BF16_PLAIN_REPS, warmup=1)
            lib_ms = None if library is None else cuda_median_ms(library, reps)
            burst = ""
            if name == "dw_reduce":
                P, Q = (n_emb, hidden) if label.endswith("dW1") else (hidden, plan.weight_numel)
                ops, nbytes = _dw_bf16_work(n_real, P, Q)
                ten = _ten_back_to_back((kern, kern32, library), reps)
                burst = (f"; 10 back to back, per call: kernel {ten[0]:.3f} ms, f32 kernel {ten[1]:.3f} ms, "
                         f"torch.mm bf16 {ten[2]:.3f} ms")
            else:
                ops, nbytes = work(name, plan, n_real, n_dst, n_src, N, hidden, n_emb, 2)
            t_ops, t_bytes = ops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            print(f"phase 16a {label} bf16 layer {li}: max abs err {abs_err:.3e}, kernel {ms:.3f} ms, f32 kernel "
                  f"{f32_ms:.3f} ms (same call), plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                  f"({'operations' if t_ops > t_bytes else 'bytes'})"
                  + ("" if lib_ms is None else f", torch.mm bf16 {lib_ms:.3f} ms") + burst, flush=True)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["ms"] += ms
            r["f32_ms"] = (r.get("f32_ms") or 0.0) + f32_ms
            r["plain_ms"] += plain_ms
            r["bound_ms"] += bound
            r["ops"] += ops
            r["bytes"] += nbytes
            if lib_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
                dw_sums.setdefault(label, np.zeros(8))[:] += (ms, f32_ms, plain_ms, bound, lib_ms, *ten)
        del x, sh, emb, w1, w2, g, h_e, dw_e, dh_pre, args16, args32, emb32, h32, dw32, dh32, calls
        torch.cuda.empty_cache()
    dw_sums["both shapes"] = sum(dw_sums.values())
    for label, (ms, f32_ms, plain_ms, bound, lib_ms, ms10, f32_10, lib10) in dw_sums.items():
        print(f"phase 16a {label} bf16, sum of 3 layers: kernel {ms:.3f} ms, f32 kernel {f32_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.3f} ms, torch.mm bf16 {lib_ms:.3f} ms; 10 back to back, per call: "
              f"kernel {ms10:.3f} ms, f32 kernel {f32_10:.3f} ms, torch.mm bf16 {lib10:.3f} ms", flush=True)
    if not dw_sums["both shapes"][0] < dw_sums["both shapes"][1]:
        raise RuntimeError("phase 16a: the bf16 dW reduction is not faster than the f32 kernel on the same values")
    _bf16_dw_preset_m(layout, n_real, rng, reps)


def _dw_bf16_work(n: int, P: int, Q: int):
    """(operations, bytes) of one bf16 dw_reduce call: bf16 a [n, P] and
    b [n, Q] read once, the float32 out [P, Q] written once."""
    return dw_work(n, P, Q, 2)[0], 2 * n * (P + Q) + 4 * P * Q


def _ten_back_to_back(fns, reps: int) -> list:
    """Each function's CUDA-event median of ten calls back to back, per
    call: the host's cost per call hides behind the card's work."""
    return [cuda_median_ms(lambda f=f: [f() for _ in range(10)], reps) / 10 for f in fns]


def _bf16_dw_preset_m(layout, n_real: int, rng, reps: int) -> None:
    """16a's dW2 reduction at preset M's layer-1 shape (hidden x 768 WN,
    the widest the port's presets train) on the 23k-atom stream's edges:
    within phase 2's f32 gate of the twin, bitwise on a repeat, one launch;
    the kernel beside the f32 kernel and torch.mm in bf16 (single calls and
    ten back to back) and the bound."""
    import torch

    from nequip_tpu_torch.model import PresetNequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    model = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **PRESET_M)
    blk = [m for m in model.modules() if isinstance(m, InteractionBlock)][1]
    P, Q, a1 = blk.edge_mlp.w0.shape[1], blk.tp_scatter.plan.weight_numel, blk.edge_mlp.alphas[1]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    h_e, dw_e = (torch.randn(n_real, q, generator=gen, device="cuda").bfloat16() for q in (P, Q))
    h32, dw32 = h_e.float(), dw_e.float()
    kern, kern32, library = ((lambda: K.dw_reduce(h_e, dw_e, a1, n_real)),
                             (lambda: K.dw_reduce(h32, dw32, a1, n_real)), (lambda: torch.mm(h_e.t(), dw_e)))
    before = K.KERNELS["dw_reduce"].launches
    got = kern()
    torch.cuda.synchronize()
    if K.KERNELS["dw_reduce"].launches != before + 1:
        raise RuntimeError("phase 16a: dw_reduce preset M bf16 launch counter did not move")
    abs_err = _check("dw_reduce preset M dW2", (got,), (K.dw_reduce_plain(h_e, dw_e, a1, n_real),), 1e-4, 1e-5,
                     "layer 1 bf16", phase="phase 16a")
    if not torch.equal(got, kern()):
        raise RuntimeError("phase 16a: dw_reduce preset M dW2 bf16 differs on a repeat call")
    ms, f32_ms = interleaved_median_ms([kern, kern32], reps, rounds=1)
    lib_ms = cuda_median_ms(library, reps)
    ten = _ten_back_to_back((kern, kern32, library), reps)
    ops, nbytes = _dw_bf16_work(n_real, P, Q)
    t_ops, t_bytes = ops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    print(f"phase 16a dw_reduce dW2 bf16, preset M layer 1 ({P} x {Q}, {n_real} edges): max abs err {abs_err:.3e}, "
          f"kernel {ms:.3f} ms, f32 kernel {f32_ms:.3f} ms (same call), bound {max(t_ops, t_bytes):.3f} ms "
          f"({'operations' if t_ops > t_bytes else 'bytes'}), torch.mm bf16 "
          f"{lib_ms:.3f} ms; 10 back to back, per call: kernel {ten[0]:.3f} ms, f32 kernel {ten[1]:.3f} ms, "
          f"torch.mm bf16 {ten[2]:.3f} ms", flush=True)
    del model, h_e, dw_e, h32, dw32, got
    torch.cuda.empty_cache()


def _bf16_trilinear(layout, N: int, E: int, n_real: int, n_src: int, n_dst: int, blocks, rng, reps: int,
                    report: dict) -> None:
    """16a's second half: K4 and K5 on the whole 23k-atom stream, K4-acc,
    K6 and K7 on one of N_CHUNKS slices (phase 2's cut, a boundary inside a
    destination's segment), in bf16 against their twins at BF16_KERNEL_TOL
    of max|out| (the accumulating forms once each, on fresh float32
    accumulators; K5 once more on the slice, untimed), bitwise equal on a
    repeat call; the kernel's and the f32
    kernel's CUDA-event medians on the same values in one call, the twin's
    (BF16_PLAIN_REPS), and the bound at 2 B a value (K4-acc's accumulator
    4 B); added to ``report``."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    dev = torch.device("cuda")
    bounds = [0] + [s * n_real // N_CHUNKS + 7 for s in range(1, N_CHUNKS)] + [n_real]
    sl = K.edge_slices(layout, N_CHUNKS, bounds)[1]
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    n_touched_s = int((lay_s.dst_ptr[1:] > lay_s.dst_ptr[:-1]).sum())
    n_src_s = int(torch.unique(lay_s.edge_src).numel())
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        n_emb, hidden = blk.edge_mlp.w0.shape

        def t(*shape, dtype=torch.bfloat16):
            return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

        ops16 = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim),
                 t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim))
        acc = (t(N, plan.mid_dim, dtype=torch.float32), t(N, plan.mid_dim, dtype=torch.float32))

        def calls(ops, acc_t):
            x, sh, w, g, tx, tsh, dw, gt = ops
            s_ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s)
            return {
                "tri_fwd": (lambda: K.tri_fwd(plan, x, sh, w, layout), lambda: K.tri_fwd_plain(plan, x, sh, w, layout)),
                "tri_bwd": (lambda: K.tri_bwd(plan, x, sh, w, layout, g),
                            lambda: K.tri_bwd_plain(plan, x, sh, w, layout, g)),
                "tri_fwd_acc": (lambda: K.tri_fwd(plan, x, sh[rows], w[rows], lay_s, acc=acc_t),
                                lambda: K.tri_fwd_plain(plan, x, sh[rows], w[rows], lay_s, acc_t)),
                "jvp_fwd": (lambda: K.jvp_fwd(plan, *s_ops), lambda: K.jvp_fwd_plain(plan, *s_ops)),
                "jvp_bwd": (lambda: K.jvp_bwd(plan, *s_ops, g, gt), lambda: K.jvp_bwd_plain(plan, *s_ops, g, gt)),
                # checked once, not timed: the accumulating forms on fresh accumulators
                "tri_fwd_acc check": (lambda: K.tri_fwd(plan, x, sh[rows], w[rows], lay_s, acc=acc[0].clone()),
                                      lambda: K.tri_fwd_plain(plan, x, sh[rows], w[rows], lay_s, acc[0].clone())),
                "jvp_fwd_acc check": (lambda: K.jvp_fwd(plan, *s_ops, acc=tuple(a.clone() for a in acc)),
                                      lambda: K.jvp_fwd_plain(plan, *s_ops, tuple(a.clone() for a in acc))),
                # K5 on the slice too: its bf16 tiles staged at y's 2-byte phase (sh[rows] of an fr slice)
                "tri_bwd slice check": (lambda: K.tri_bwd(plan, x, sh[rows], w[rows], lay_s, g),
                                        lambda: K.tri_bwd_plain(plan, x, sh[rows], w[rows], lay_s, g)),
            }

        c16 = calls(ops16, acc[0].clone())  # the timed K4-acc calls keep adding onto their accumulator
        c32 = calls(tuple(o.float() for o in ops16), acc[0].clone())
        for name in BF16_TRILINEAR:
            counter = K.KERNELS[name]
            checked = [c16[f"{name} check"]] if name == "tri_fwd_acc" else [c16[name]]
            extra = {"jvp_fwd": "jvp_fwd_acc check", "tri_bwd": "tri_bwd slice check"}.get(name)
            if extra is not None:
                checked.append(c16[extra])
            err = abs_err = 0.0
            for run, ref_run in checked:
                before = counter.launches
                got = _tuple(run())
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise RuntimeError(f"phase 16a: {name} bf16 launch counter did not move")
                e, a_e = _bf16_check(name, got, _tuple(ref_run()), li)
                err, abs_err = max(err, e), max(abs_err, a_e)
                if not all(torch.equal(a, b) for a, b in zip(got, _tuple(run()))):
                    raise RuntimeError(f"phase 16a: {name} bf16 differs on a repeat call")
            kern, plain = c16[name]
            ms, f32_ms = interleaved_median_ms([kern, c32[name][0]], reps, rounds=1)
            plain_ms = cuda_median_ms(plain, BF16_PLAIN_REPS, warmup=1)
            sliced = name in ("tri_fwd_acc", "jvp_fwd", "jvp_bwd")
            ops, nbytes = work(name, plan, lay_s.n_real if sliced else n_real, n_touched_s if sliced else n_dst,
                               n_src_s if sliced else n_src, N, hidden, n_emb, 2)
            if name == "tri_fwd_acc":  # its accumulator is float32: 4 B read and written a value
                nbytes += 2 * n_touched_s * plan.mid_dim * 2
            t_ops, t_bytes = ops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
            bound = max(t_ops, t_bytes)
            print(f"phase 16a {name} bf16 layer {li}{' (one of 4 slices)' if sliced else ''}: max err {err:.3e} of "
                  f"max|out| (limit {BF16_KERNEL_TOL:.0e}), kernel {ms:.3f} ms, f32 kernel {f32_ms:.3f} ms (same "
                  f"call), plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
                  f"({'operations' if t_ops > t_bytes else 'bytes'})", flush=True)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["ms"] += ms
            r["f32_ms"] = (r.get("f32_ms") or 0.0) + f32_ms
            r["plain_ms"] += plain_ms
            r["bound_ms"] += bound
            r["ops"] += ops
            r["bytes"] += nbytes
        del ops16, acc, c16, c32
        torch.cuda.empty_cache()


def _golden_gap(res: dict, z) -> tuple:
    """(energy rel err, forces max err / max|F|) against the f64 golden."""
    return (abs(res["energy"] - float(z["energy"])) / abs(float(z["energy"])),
            float(np.abs(res["forces"] - z["forces"]).max()) / float(np.abs(z["forces"]).max()))


def phase16b_golden() -> None:
    """Phase 3's golden through the bf16 kernels: the JAX f64 parameters in
    a bf16 flagship (float32 parameters, enable_bf16_fast_mode), against the
    f64 golden at JAX's bf16 gate."""
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    z = np.load(GOLDEN)
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(model, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    model = modify(model, [{"modifier": "enable_bf16_fast_mode"}])
    K.reset_launch_counts()
    res = NequIPCalculator.from_model(model, device="cuda").calculate(
        {"pos": z["pos"], "cell": z["cell"], "pbc": z["pbc"], "atomic_numbers": z["atomic_numbers"]})
    launches = {k: K.KERNELS[k].launches for k in K1_ROUTE}
    e_err, f_err = _golden_gap(res, z)
    print(f"phase 16b golden in bf16 through the kernels (launches {launches}): energy rel err {e_err:.3e} "
          f"(limit {BF16_E_TOL:.0e}), forces max err {f_err:.3e} of max|F| (limit {BF16_F_TOL:.0e})", flush=True)
    if not all(launches.values()):
        raise RuntimeError("phase 16b: the bf16 golden did not run K1, K2 and K3")
    if not (e_err <= BF16_E_TOL and f_err <= BF16_F_TOL):
        raise RuntimeError("phase 16b: the bf16 port disagrees with the f64 golden beyond JAX's bf16 gate")
    del model
    torch.cuda.empty_cache()


def phase16c_serve(smi: str, n_atoms: int, n_requests: int = 3) -> dict:
    """Three bf16 calculator requests at 23k atoms (tp_impl="fused") beside
    three f32 requests on the same frames: launches (K1, K2, K3 only), the
    bf16 serving peak, finiteness and translation invariance, forces within
    the sanity bound of the f32 request's, model times; returns the bf16
    requests' launches."""
    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    frames = [fcc_frame(n_atoms, seed=s, jitter=0.05) for s in range(1, n_requests + 1)]
    f32 = NequIPCalculator.from_model(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                                      device="cuda")
    ref = []
    for frame in frames:
        ref.append((f32.calculate(frame), f32.timings["model_s"] * 1e3))
    del f32
    torch.cuda.empty_cache()
    calc = NequIPCalculator.from_model(_bf16_model(), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    results = []
    for frame in frames:
        results.append((calc.calculate(frame), calc.timings["model_s"] * 1e3))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, ((res, ms), (want, ref_ms)) in enumerate(zip(results, ref)):
        F, n = res["forces"], len(res["forces"])
        f_scale = float(np.abs(want["forces"]).max())
        f_gap = float(np.abs(F - want["forces"]).max())
        net = float(np.abs(F.sum(axis=0)).max())
        print(f"phase 16c request {i} ({smi}): {n} atoms, model {ms:.1f} ms in bf16, {ref_ms:.1f} ms in f32 "
              f"(phase 4's f32 requests above); E {res['energy']:.6f} (f32 {want['energy']:.6f}); forces against "
              f"f32 {f_gap / f_scale:.3e} of max|F| (limit {BF16_SERVE_F_TOL:.0e}); net force {net:.3e}", flush=True)
        if not (math.isfinite(res["energy"]) and np.isfinite(F).all()):
            raise RuntimeError(f"phase 16c: request {i} returned non-finite values")
        if net > 1e-3 * float(np.abs(F).max()) * math.sqrt(n):
            raise RuntimeError(f"phase 16c: request {i} net force {net:.3e} breaks translation invariance")
        if f_gap > BF16_SERVE_F_TOL * f_scale:
            raise RuntimeError(f"phase 16c: request {i} forces are far from the f32 request's")
    bf16_ms = [ms for _, ms in results]
    f32_ms = [ms for _, ms in ref]
    print(f"phase 16c launches {launches}, max_memory_allocated (bf16 serving peak) {peak / 2**30:.3f} GiB, limit "
          f"{SERVING_PEAK_LIMIT / 2**30:.3f} GiB; model ms bf16 {', '.join(f'{m:.1f}' for m in bf16_ms)} "
          f"(requests 1-2 median {np.median(bf16_ms[1:]):.1f}), f32 {', '.join(f'{m:.1f}' for m in f32_ms)} "
          f"(median {np.median(f32_ms[1:]):.1f}) ({smi})", flush=True)
    if n_atoms == 23000 and peak > SERVING_PEAK_LIMIT:
        raise RuntimeError("phase 16c: the bf16 serving peak exceeds phase 4's limit")
    if not all(launches[k] for k in K1_ROUTE) or any(launches[k] for k in launches if k not in K1_ROUTE):
        raise RuntimeError(f"phase 16c: bf16 serving must launch K1, K2 and K3 and nothing else: {launches}")
    del calc
    torch.cuda.empty_cache()
    return launches


def phase16d_md(smi: str) -> None:
    """MD of the bf16 flagship at 23k atoms, host, block and device-list
    block integration from one start (phase 9's settings, BF16_MD_STEPS
    timed steps): host and block within phase 9d's limits, the step times
    beside phase 9's f32 runs, the NVE drift (reported, not gated)."""
    import torch

    from nequip_tpu_torch.integrations import maxwell_boltzmann_velocities

    frame = _md_frame(23000)
    n = len(frame["pos"])
    model = _bf16_model()
    v0 = maxwell_boltzmann_velocities(np.full(n, MD_MASS), 300.0, seed=1)
    runs = {}
    for label, integration, backend in (("b", "host", "host"), ("c", "block", "host"), ("i", "block", "device")):
        runs[label] = _md_run(label, smi, model, frame, v0, integration, nl_backend=backend, steps=BF16_MD_STEPS,
                              phase="16d.")
        torch.cuda.empty_cache()
    host, block = runs["b"]["out"], runs["c"]["out"]
    pos_gap = float(np.abs(host["positions"] - block["positions"]).max())
    f_scale = float(np.abs(host["forces"]).max())
    f_gap = float(np.abs(host["forces"] - block["forces"]).max())
    dev_pos_gap = float(np.abs(runs["i"]["out"]["positions"] - block["positions"]).max())
    dev_f_gap = float(np.abs(runs["i"]["out"]["forces"] - block["forces"]).max())
    print(f"phase 16d host vs block (bf16) after {BF16_MD_STEPS + 10} steps from one start: positions max gap "
          f"{pos_gap:.3e} A (limit {MD_POS_TOL:.0e}), forces max gap {f_gap:.3e} (max |F| {f_scale:.3e}, limit "
          f"{MD_FORCE_TOL:.0e} of it); device list vs host list (block): positions {dev_pos_gap:.3e} A, forces "
          f"{dev_f_gap:.3e}", flush=True)
    for label, what in (("b", "host"), ("c", "block"), ("i", "block, device list")):
        r, f = runs[label], MD_RUNS.get("9" + label)
        beside = (f"f32 (phase 9{label}): median {f['median_ms']:.2f} ms, mean {f['mean_ms']:.2f} ms, "
                  f"{f['atom_steps_s']:.0f} atom-steps/s" if f else "f32: phase 9 not run")
        print(f"phase 16d {what} bf16 ({smi}): step median {r['median_ms']:.2f} ms, mean {r['mean_ms']:.2f} ms, "
              f"{r['atom_steps_s']:.0f} atom-steps/s; {beside}; NVE drift |dE_total| per atom {r['drift']:.3e} eV "
              f"over {BF16_MD_STEPS} steps (E {r['e0']:.6f} -> {r['e1']:.6f} eV; reported, not gated)", flush=True)
    if not (pos_gap <= MD_POS_TOL and f_gap <= MD_FORCE_TOL * f_scale):
        raise RuntimeError("phase 16d: bf16 host and block integration disagree")
    if not (dev_pos_gap <= MD_POS_TOL and dev_f_gap <= MD_FORCE_TOL * f_scale):
        raise RuntimeError("phase 16d: bf16 device-list and host-list MD runs disagree")
    del model
    torch.cuda.empty_cache()


def phase16e_compile(smi: str, label: str = "16e", route: tuple = K1_ROUTE, **model_kw) -> None:
    """nequip-torch-compile --modifiers enable_bf16_fast_mode --no-check of
    a checkpoint of the flagship (f32 weights, ``model_kw`` on top, a
    32-atom LJ data config; rung 0 at the 23k-atom frame's capacities),
    loaded with from_compiled_model and held against the eager bf16 model
    on the 23k frame, its request launching ``route``'s kernels alone; the
    self-check is refused for bf16 as in JAX (no tolerance)."""
    import os

    import torch

    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.model.saved_models import ModelFromCheckpoint
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.scripts import compile as compile_cli
    from nequip_tpu_torch.train.checkpoint import save_checkpoint

    BF16_DIR.mkdir(parents=True, exist_ok=True)
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **dict(FLAGSHIP, **model_kw))
    ckpt, art = str(BF16_DIR / "flagship.ckpt"), str(BF16_DIR / "flagship_bf16.nequip_tpu_torch.zip")
    save_checkpoint(ckpt, {"params": {k: v.detach().cpu() for k, v in model.jax_named_tensors()}},
                    {"training_module": {"model": model.model_config}, "data": _cli_config(2)["data"]})
    caps = ["--num-nodes", "23424", "--num-edges", "420096"]
    try:
        compile_cli.main([ckpt, art, "--modifiers", "enable_bf16_fast_mode", *caps])
        raise RuntimeError(f"phase {label}: the compile self-check did not refuse bf16")
    except KeyError as e:
        refusal = str(e)
    t0 = time.perf_counter()
    compile_cli.main([ckpt, art, "--modifiers", "enable_bf16_fast_mode", "--no-check", *caps])
    compile_s = time.perf_counter() - t0
    compiled = NequIPCalculator.from_compiled_model(art)
    eager = NequIPCalculator.from_model(modify(ModelFromCheckpoint(ckpt), [{"modifier": "enable_bf16_fast_mode"}]),
                                        device="cuda")
    frame = fcc_frame(23000, seed=1)
    compiled.calculate(frame)  # warm-up
    K.reset_launch_counts()
    got = compiled.calculate(frame)
    launches = {k: fn.launches for k, fn in K.KERNELS.items() if fn.launches}
    want = eager.calculate(frame)
    e_rel = abs(got["energy"] - want["energy"]) / abs(want["energy"])
    f_err = float(np.abs(got["forces"] - want["forces"]).max()) / float(np.abs(want["forces"]).max())
    print(f"phase {label} nequip-torch-compile --modifiers enable_bf16_fast_mode --no-check {model_kw or ''}({smi}): "
          f"{compile_s:.1f} s, {os.path.getsize(art) / 2**20:.2f} MiB, metadata model_dtype "
          f"{compiled.predictor.metadata.get('model_dtype')}; with the self-check: KeyError {refusal}; compiled vs "
          f"eager bf16 on {len(frame['pos'])} atoms: energy rel {e_rel:.3e} (limit {BF16_E_TOL:.0e}), forces "
          f"{f_err:.3e} of max|F| (limit {BF16_F_TOL:.0e}); compiled request launches {launches}", flush=True)
    if set(launches) != set(route):
        raise RuntimeError(f"phase {label}: the compiled bf16 request does not launch {route} alone")
    if not (e_rel <= BF16_E_TOL and f_err <= BF16_F_TOL):
        raise RuntimeError(f"phase {label}: the compiled bf16 model disagrees with eager bf16")
    del compiled, eager
    for f in BF16_DIR.glob("*"):
        if f.is_file():  # the artifacts; a folder is 16g's, from an earlier run in this checkout
            f.unlink()
    torch.cuda.empty_cache()


def _requests(calc, frames) -> tuple:
    """(results, model ms) of a calculator's requests on ``frames``, and
    the peak allocated over them (GiB), from a reset before the first."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = [(calc.calculate(frame), calc.timings["model_s"] * 1e3) for frame in frames]
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def phase16f_depth2(smi: str, n_atoms: int = 23000, n_requests: int = 3) -> dict:
    """The flagship with a depth-2 radial MLP in bf16 (K4's route: K4, K5,
    K3): three requests at 23k atoms beside the f32 model's on the same
    frames (model ms and peak, forces within the sanity bound), the options
    golden's depth-2 model in bf16 against its f64 golden at JAX's bf16
    gate, its compile under --no-check (16e's check), and a short host MD
    run; returns the bf16 requests' launches."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data import to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.integrations import NequIPCalculator, maxwell_boltzmann_velocities
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.utils.config import instantiate, retarget

    frames = [fcc_frame(n_atoms, seed=s, jitter=0.05) for s in range(1, n_requests + 1)]
    f32 = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", radial_mlp_depth=2, **FLAGSHIP)
    ref, ref_peak = _requests(NequIPCalculator.from_model(f32, device="cuda"), frames)
    torch.cuda.empty_cache()
    model = _bf16_model(radial_mlp_depth=2)
    if set(_routes(model)) != {"fused_tp"}:
        raise RuntimeError("phase 16f: the depth-2 layers did not take K4's route")
    calc = NequIPCalculator.from_model(model, device="cuda")
    K.reset_launch_counts()
    results, peak = _requests(calc, frames)
    launches = {k: fn.launches for k, fn in K.KERNELS.items()}
    for i, ((res, ms), (want, ref_ms)) in enumerate(zip(results, ref)):
        f_scale = float(np.abs(want["forces"]).max())
        f_gap = float(np.abs(res["forces"] - want["forces"]).max())
        print(f"phase 16f request {i} depth-2 ({smi}): {len(res['forces'])} atoms, model {ms:.1f} ms in bf16, "
              f"{ref_ms:.1f} ms in f32; E {res['energy']:.6f} (f32 {want['energy']:.6f}); forces against f32 "
              f"{f_gap / f_scale:.3e} of max|F| (limit {BF16_SERVE_F_TOL:.0e})", flush=True)
        if not (math.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()):
            raise RuntimeError(f"phase 16f: request {i} returned non-finite values")
        if f_gap > BF16_SERVE_F_TOL * f_scale:
            raise RuntimeError(f"phase 16f: request {i} forces are far from the f32 request's")
    bf16_ms, f32_ms = [ms for _, ms in results], [ms for _, ms in ref]
    print(f"phase 16f depth-2 launches {launches}; model ms bf16 {', '.join(f'{m:.1f}' for m in bf16_ms)} "
          f"(requests 1-2 median {np.median(bf16_ms[1:]):.1f}), f32 {', '.join(f'{m:.1f}' for m in f32_ms)} "
          f"(median {np.median(f32_ms[1:]):.1f}); max_memory_allocated over the requests bf16 {peak:.3f} GiB, "
          f"f32 {ref_peak:.3f} GiB ({smi})", flush=True)
    if not all(launches[k] for k in K4_ROUTE) or any(launches[k] for k in launches if k not in K4_ROUTE):
        raise RuntimeError(f"phase 16f: bf16 depth-2 serving must launch K4, K5 and K3 and nothing else: {launches}")
    del calc, f32, ref, results
    torch.cuda.empty_cache()

    z = np.load(OPTIONS_GOLDEN)
    name = "depth2"
    golden = instantiate(dict(retarget(json.loads(str(z[f"{name}/config"]))), tp_impl="fused"), _recursive_=False)
    load_jax_params(golden, {k[len(f"{name}/params/"):]: z[k] for k in z.files if k.startswith(f"{name}/params/")})
    golden = modify(golden, [{"modifier": "enable_bf16_fast_mode"}]).to("cuda").requires_grad_(False)
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(
        from_dict({k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "charge")})), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([frame]), 128, round_up(frame["edge_index"].shape[1], 256), 2),
                       "cuda")
    K.reset_launch_counts()
    out = golden(batch)
    g_launches = _launches()
    n = len(z["pos"])
    e_err = abs(float(out["total_energy"][0, 0]) - float(z[f"{name}/energy"])) / abs(float(z[f"{name}/energy"]))
    f_ref = z[f"{name}/forces"]
    f_err = float(np.abs(out["forces"][:n].cpu().numpy() - f_ref).max()) / float(np.abs(f_ref).max())
    print(f"phase 16f options golden depth2 in bf16 through the kernels ({smi}): energy rel err {e_err:.3e} (limit "
          f"{BF16_E_TOL:.0e}), forces max err {f_err:.3e} of max|F| (limit {BF16_F_TOL:.0e}); launches {g_launches}",
          flush=True)
    _check_route("phase 16f golden", "fused_tp", g_launches)
    if not (e_err <= BF16_E_TOL and f_err <= BF16_F_TOL):
        raise RuntimeError("phase 16f: the bf16 depth-2 model disagrees with the f64 golden beyond JAX's bf16 gate")
    del golden, out
    torch.cuda.empty_cache()

    phase16e_compile(smi, label="16f", route=K4_ROUTE, radial_mlp_depth=2)
    md_frame = _md_frame(23000)
    v0 = maxwell_boltzmann_velocities(np.full(len(md_frame["pos"]), MD_MASS), 300.0, seed=1)
    _md_run("f", smi, model, md_frame, v0, "host", steps=BF16_DEPTH2_MD_STEPS, phase="16", route=K4_ROUTE)
    del model
    torch.cuda.empty_cache()
    return launches


BF16_FR_UNSLICED = TRAINING_KERNELS + ("conv_bwd",)  # fr on "fused" without slices: pass 1 serves, pass 2 trains


def _bf16_golden_steps(smi: str) -> None:
    """16g's gate: the bf16 flagship from the f64 training golden's
    parameters (float32) takes one rr step on fused_tp, one fr step over
    N_CHUNKS edge slices with remat_conv="save_tp" on fused, and one rr and
    one unsliced fr step on fused (K2's training variant and the dW
    reduction); its loss and gradients against the f64 golden within
    BF16_LOSS_TOL and BF16_GRAD_TOL (JAX's own bf16 step meets them), its
    gradients float32."""
    import torch

    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up
    from nequip_tpu_torch.data import to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
    from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads, load_jax_params
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    z, params = np.load(TRAIN_GOLDEN), np.load(GOLDEN)
    flat = {k[len("params/"):]: params[k] for k in params.files if k.startswith("params/")}
    frame = {k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "total_energy", "forces")}
    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([data]), 128, round_up(data["edge_index"].shape[1], 256), 2),
                       "cuda")
    want = {k[len("grads/"):]: z[k] for k in z.files if k.startswith("grads/")}
    steps = {("fused_tp", "rr", 0): ({}, K4_ROUTE), ("fused", "fr", N_CHUNKS): ({"remat_conv": "save_tp"}, BF16_FR_KERNELS),
             ("fused", "rr", 0): ({}, TRAINING_KERNELS), ("fused", "fr", 0): ({}, BF16_FR_UNSLICED)}
    for (tp_impl, mode, n_chunks), (kw, path) in steps.items():
        model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl=tp_impl, **dict(FLAGSHIP, **kw))
        load_jax_params(model, flat)
        model = modify(model, [{"modifier": "enable_bf16_fast_mode"}]).to("cuda")
        module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode,
                                   fr_edge_chunks=n_chunks)
        K.reset_launch_counts()
        if mode == "rr":
            loss, _, _ = module.compute_loss(batch)
            loss.backward()
        else:
            loss, _, _ = module.compute_grads_fr(batch)
        torch.cuda.synchronize()
        launches = _launches()
        dtypes = {p.grad.dtype for p in model.parameters() if p.grad is not None}
        loss_err = abs(float(loss.detach()) - float(z["loss"])) / abs(float(z["loss"]))
        grad_err = _grad_errors(jax_named_grads(model), want)
        print(f"phase 16g training golden in bf16 ({mode} on {tp_impl}, fr_edge_chunks {n_chunks}{', save_tp' if kw else ''}, "
              f"{smi}): loss rel err {loss_err:.3e} (limit {BF16_LOSS_TOL:.0e}), grads max err / max|grad| "
              f"{grad_err:.3e} (limit {BF16_GRAD_TOL:.0e}), grad dtypes {sorted(map(str, dtypes))}, launches {launches}",
              flush=True)
        if set(launches) != set(path):
            raise RuntimeError(f"phase 16g: the bf16 {mode} step launched {launches}, not {path}")
        if dtypes != {torch.float32}:
            raise RuntimeError(f"phase 16g: the bf16 {mode} step's gradients are {dtypes}, not float32")
        if not (loss_err <= BF16_LOSS_TOL and grad_err <= BF16_GRAD_TOL):
            raise RuntimeError(f"phase 16g: the bf16 {mode} step disagrees with the f64 training golden")
        del model, module, loss
        torch.cuda.empty_cache()


def phase16g_train(smi: str, dm=None, epochs: int = 2, preset_m_f32=None) -> dict:
    """bf16 training at 23k atoms: Trainer.fit (phase 6's LJ frames, 2
    steps and a validation an epoch) in fr over N_CHUNKS edge slices with
    remat_conv="save_tp" on the fused route (JAX's bf16 fr training row),
    in rr on fused_tp and in rr on fused, each beside the same fit in f32
    (later steps' median and peak); the bf16 fits launch the sliced fr
    kernels, K4's route, or K1's training path (K1, K2's training variant,
    the dW reduction, K3, K4 and K5; only this fit launches the latter
    two); then the gradient gate (_bf16_golden_steps) and preset-M rr steps
    in bf16 (_bf16_preset_m, beside ``preset_m_f32``, phase 14b's f32 rr
    step).  Returns the bf16 fits' launches by "mode route"."""
    import torch

    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, EnergyForceMetrics, NequIPTrainModule, Trainer

    dm = lj_datamodule("phase 16g") if dm is None else dm
    out = {}
    fits = (("fr", "fused", N_CHUNKS, {"remat_conv": "save_tp"}), ("rr", "fused_tp", 0, {}), ("rr", "fused", 0, {}))
    for mode, tp_impl, n_chunks, kw in fits:
        rows = {}
        for dtype in ("float32", "bfloat16"):
            model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=tp_impl, **dict(FLAGSHIP, **kw))
            if dtype == "bfloat16":
                model = modify(model, [{"modifier": "enable_bf16_fast_mode"}])
            module = NequIPTrainModule(model.to("cuda"), loss=EnergyForceLoss(type_names=["Cu"]),
                                       val_metrics=EnergyForceMetrics(),
                                       optimizer={"_target_": "optax.adam", "learning_rate": 1e-3},
                                       force_grad_mode=mode, fr_edge_chunks=n_chunks)
            trainer = Trainer(max_epochs=epochs, ckpt_dir=str(BF16_DIR / "train"), save_last=False, save_best=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            trainer.fit(module, dm)
            torch.cuda.synchronize()
            launches = _launches()
            steps = np.asarray(trainer.step_seconds[1:]) * 1e3
            rows[dtype] = dict(median_ms=float(np.median(steps)), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                               first_ms=trainer.step_seconds[0] * 1e3, launches=launches,
                               losses=[row["train_loss_epoch/weighted_sum"] for row in trainer.metrics_rows])
            _check_fit(f"phase 16g {mode} {dtype}", trainer, epochs)
            if {p.dtype for p in model.parameters()} != {torch.float32}:
                raise RuntimeError(f"phase 16g: the {dtype} model's parameters are not float32")
            del model, module, trainer
            torch.cuda.empty_cache()
        b, f = rows["bfloat16"], rows["float32"]
        print(f"phase 16g train {mode} on {tp_impl}{f' over {n_chunks} edge slices, save_tp' if n_chunks else ''} "
              f"({smi}): bf16 later steps median {b['median_ms']:.1f} ms (first {b['first_ms']:.1f}), "
              f"max_memory_allocated {b['peak_gib']:.3f} GiB; f32 median {f['median_ms']:.1f} ms (first "
              f"{f['first_ms']:.1f}), {f['peak_gib']:.3f} GiB; epoch train losses bf16 "
              f"{', '.join(f'{x:.6e}' for x in b['losses'])}, f32 {', '.join(f'{x:.6e}' for x in f['losses'])}; "
              f"bf16 launches {b['launches']}", flush=True)
        need = BF16_FR_KERNELS if mode == "fr" else K4_ROUTE if tp_impl == "fused_tp" else TRAINING_KERNELS
        trains_k2 = any(k in b["launches"] for k in BF16_TRAINING)
        if not all(b["launches"].get(k) for k in need) or trains_k2 != (need == TRAINING_KERNELS):
            raise RuntimeError(f"phase 16g: the bf16 {mode} fit on {tp_impl} launched {b['launches']}")
        out[f"{mode} {tp_impl}"] = b["launches"]
    _bf16_golden_steps(smi)
    _bf16_preset_m(smi, preset_m_f32)
    return out


def _bf16_preset_m(smi: str, f32=None, steps: int = 3) -> None:
    """Preset M at full width in bf16 on the 23k-atom frame (phase 14b's
    batch and labels): rr steps on "fused", whose layers (480 / 2368 / 768
    WN) run the wide K2-train tiles; the median of ``steps`` steps and the
    peak, beside ``f32`` (phase 14b's f32 rr step in this run: "ms",
    "peak"); finite float32 gradients, and K2's training variant and the
    dW reduction launched."""
    import torch

    from nequip_tpu_torch.model import PresetNequIPGNNModel
    from nequip_tpu_torch.model.modify_utils import modify
    from nequip_tpu_torch.ops.kernels import tp_scatter as K
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    batch, n, e = graph(23000, "cuda", seed=1)
    lab = torch.Generator(device="cuda").manual_seed(1)
    batch = dict(batch, total_energy=torch.randn(2, 1, device="cuda", generator=lab, dtype=torch.float64),
                 forces=torch.randn(batch["pos"].shape, device="cuda", generator=lab, dtype=torch.float64))
    m = modify(PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **PRESET_M),
               [{"modifier": "enable_bf16_fast_mode"}])
    module = NequIPTrainModule(m.to("cuda"), loss=EnergyForceLoss(type_names=["Cu"]),
                               optimizer={"_target_": "optax.adam", "learning_rate": 1e-3})
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(steps):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, _ = module.compute_loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        if step == 0:
            launches = _launches()
            grads = [p.grad for p in m.parameters() if p.grad is not None]
            if not grads or any(g.dtype != torch.float32 or not bool(g.isfinite().all()) for g in grads):
                raise RuntimeError("phase 16g: preset M's bf16 rr gradients are not finite float32")
            del grads
        m.zero_grad(set_to_none=True)
        del loss
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 16g preset M rr step in bf16 on fused, {n} atoms ({smi}): routes {_routes(m)}, median "
          f"{float(np.median(times)):.1f} ms of {[round(t, 1) for t in times]}, max_memory_allocated {peak:.3f} GiB; "
          + ("phase 14b's f32 rr step not run" if f32 is None else
             f"phase 14b's f32 rr step {f32['ms']:.1f} ms, {f32['peak']:.3f} GiB")
          + f"; losses {losses}, launches a step {launches}", flush=True)
    if set(_routes(m)) != {"fused"} or not all(launches.get(k) for k in TRAINING_KERNELS):
        raise RuntimeError(f"phase 16g: preset M's bf16 rr step launched {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError("phase 16g: preset M's bf16 rr losses are not finite")
    del module, m, batch
    torch.cuda.empty_cache()


def phase16_bf16(smi: str, n_atoms: int = 23000, dm=None, preset_m_f32=None) -> tuple:
    """Phase 16: the bf16 fast mode (16a kernels, 16b golden, 16c serving,
    16d MD, 16e compile, 16f the depth-2 flagship on K4's route, 16g
    training), with cuBLAS's bf16 products summed in float32 (as JAX sums
    them) for the phase; ``dm`` phase 6's data (built anew when None).
    Returns (the bf16 kernels' report rows, their launches on the main
    paths: 16c's requests for K1, K2 and K3, 16f's requests and 16g's fits
    for K4-K7, K2's training variant and the dW reduction)."""
    import torch

    t0 = time.perf_counter()
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        report = phase16a_kernels(n_atoms, reps=10)
        phase16b_golden()
        launches = dict(phase16c_serve(smi, n_atoms))
        phase16d_md(smi)
        phase16e_compile(smi)
        t1 = time.perf_counter()
        depth2 = phase16f_depth2(smi, n_atoms)
        fits = phase16g_train(smi, dm, preset_m_f32=preset_m_f32)
        for name in BF16_TRILINEAR + BF16_TRAINING:
            launches[name] = depth2.get(name, 0) + sum(f.get(name, 0) for f in fits.values())
        print(f"phase 16f-16g {time.perf_counter() - t1:.1f} s", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old
    print(f"phase 16 {time.perf_counter() - t0:.1f} s", flush=True)
    return report, launches

# --- phase 17: parallel execution, ranks sharing the one card over gloo -------------
PARALLEL_DIR = ROOT / "chiprun_out" / "chip_smoke_parallel"
SHARED_CARD = "ranks sharing one H100, gloo"  # no parallel speed: gloo copies every collective through the host
FR_UNCHUNKED_KERNELS = ("conv_fwd", "conv_bwd", "conv_bwd_train", "dw_reduce", "scatter_rows", "tri_fwd", "tri_bwd")
SGD = {"_target_": "optax.sgd", "learning_rate": 1e-3}  # updates linear in the gradients: comparable in f32
PARALLEL_TOL = 1e-4  # f32: loss relative, gradients and parameters of each tensor's max


def _rank_main(fn, rank: int, world_size: int, workdir: str, threads: int, pg_timeout_s: float) -> None:
    """A spawned rank: ``threads`` torch threads, the default group on
    ``cuda:0`` over gloo (by name: NCCL refuses two ranks on one card),
    ``fn(rank)``, its result or its traceback pickled for the parent."""
    import datetime
    import pickle
    import traceback

    import torch

    from nequip_tpu_torch.parallel.distributed import destroy_distributed, init_distributed

    torch.set_num_threads(threads)
    try:
        init_distributed(backend="gloo", device="cuda:0", init_method=f"file://{workdir}/store", rank=rank,
                         world_size=world_size, timeout=datetime.timedelta(seconds=pg_timeout_s))
        result = ("ok", fn(rank))
    except BaseException:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    finally:
        destroy_distributed()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, threads: int, deadline_s: float, pg_timeout_s: float) -> list:
    """``[fn(rank) for rank in range(world_size)]``, each rank a spawned
    process meeting the others in a ``FileStore`` under PARALLEL_DIR with
    ``threads`` torch threads; a rank's exception, or a rank still running
    at ``deadline_s`` (then killed), raises here."""
    import multiprocessing
    import pickle

    work = PARALLEL_DIR / f"pg_{fn.__name__}_{world_size}"
    work.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, str(work), threads, pg_timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still ran after {deadline_s} s")
    results = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)  # written by the rank above
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results


def _rank_start() -> float:
    """A rank's set-up: TF32 off (as phase 0), and the kernel library phase 1
    built (its build seconds: 0 when nothing was compiled again)."""
    import torch

    from nequip_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = build.build()
    build.load_library()
    return built.seconds


def _rank_timed(fn):
    """``(fn(), {ms: host clock synced, peak_gib, launches})`` of one call,
    with the launch counts set to 0 just before it."""
    import torch

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": {k: f.launches for k, f in K.KERNELS.items() if f.launches}}


def _param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, t in model.jax_named_tensors():
        h.update(k.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _grads_np(model) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in model.jax_named_tensors() if getattr(p, "grad", None)
            is not None}


def _single_device_rr(model, frame: dict, e_ref: float, f_ref: np.ndarray, device):
    """The loss and gradients of ``loss_and_grad`` on one device, as the
    ordinary rr step computes them (the model's own force output)."""
    import torch

    batch = graph_of(frame, device)
    n = len(frame["pos"])
    out = model(batch)
    de = (out["total_energy"][0, 0] - e_ref) / n
    fe = out["forces"][:n] - torch.as_tensor(f_ref, dtype=out["forces"].dtype, device=out["forces"].device)
    loss = de**2 + (fe * fe).sum() / (3.0 * n)
    names, params = zip(*[(k, p) for k, p in model.jax_named_tensors()
                          if isinstance(p, torch.nn.Parameter) and p.requires_grad])
    grads = torch.autograd.grad(loss, params)
    return float(loss), {k: g.cpu().numpy() for k, g in zip(names, grads)}


def graph_of(frame: dict, device):
    """A padded, kernel-ordered one-frame batch of ``frame`` (with atom types)."""
    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, round_up, to_tensors
    from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream

    data = compute_neighborlist_(from_dict(dict(frame)), 4.0)
    b = batched_from_list([data])
    padded = pad_batch(b, round_up(b["pos"].shape[0], 128), round_up(b["edge_index"].shape[1], 256), 2)
    return relayout_edge_stream(to_tensors(padded, device))


def _lj(supercell: int, num_frames: int) -> list:
    from nequip_tpu_torch.data.dataset import LJTestDataset

    ds = LJTestDataset(supercell=(supercell,) * 3, num_frames=num_frames, seed=0)
    return [dict(f, atom_types=np.zeros(len(f["pos"]), dtype=np.int64)) for f in ds.frames]


def _rank_17abc(rank: int) -> dict:
    """Phase 17 (a)-(c) on one of two ranks: sharded serving, sharded rr and
    fr training, and Trainer(devices=2)."""
    import torch

    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
    from nequip_tpu_torch.integrations import NequIPCalculator
    from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
    from nequip_tpu_torch.parallel import ShardedGraphEvaluator, disable_MeshGhostExchange
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule, Trainer
    from nequip_tpu_torch.train.callbacks.base import Callback

    dev = torch.device("cuda:0")
    out = {"built_s": _rank_start()}

    # (a) serving: phase 4's model and first frame, and phase 3's f64 golden
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP).to(dev)
    frame = dict(fcc_frame(23000, seed=1), atom_types=np.zeros(23328, dtype=np.int64))
    ev = ShardedGraphEvaluator(model, device=dev)
    ev.evaluate(frame)  # the first request: partition, layout
    (energy, forces), out["serve"] = _rank_timed(lambda: ev.evaluate(frame))
    out["serve"]["caps"] = dict(ev.caps)
    if rank == 0:
        ref = NequIPCalculator.from_model(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                                          device=dev).calculate(fcc_frame(23000, seed=1))
        out["serve"]["e_rel"] = abs(energy - ref["energy"]) / abs(ref["energy"])
        out["serve"]["f_err"] = float(np.abs(forces - ref["forces"]).max() / np.abs(ref["forces"]).max())
    z = np.load(GOLDEN)
    golden = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl="fused", **FLAGSHIP)
    load_jax_params(golden, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")})
    gframe = {"pos": z["pos"], "cell": z["cell"], "pbc": z["pbc"], "atom_types": np.zeros(len(z["pos"]), np.int64)}
    gev = ShardedGraphEvaluator(golden.to(dev), device=dev)
    (energy, forces), out["golden"] = _rank_timed(lambda: gev.evaluate(gframe))
    out["golden"].update(caps=dict(gev.caps), e_rel=abs(energy - float(z["energy"])) / abs(float(z["energy"])),
                         f_err=float(np.abs(forces - z["forces"]).max()))
    del golden, gev, ev, model
    torch.cuda.empty_cache()

    # (b) loss_and_grad on phase 6's first LJ frame, rr and fr over N_CHUNKS slices
    lj = _lj(18, 1)[0]
    e_ref = float(np.asarray(lj["total_energy"]).reshape(-1)[0])
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP).to(dev)
    for mode, chunks in (("rr", 0), ("fr", N_CHUNKS)):
        ev = ShardedGraphEvaluator(model, force_grad_mode=mode, fr_edge_chunks=chunks, device=dev)
        ev.loss_and_grad(lj, e_ref, lj["forces"])  # the first step: partition, layout
        (loss, grads), out[mode] = _rank_timed(lambda: ev.loss_and_grad(lj, e_ref, lj["forces"]))
        out[mode].update(caps=dict(ev.caps), loss=loss, grads={k: g.cpu().numpy() for k, g in grads.items()})
    if rank == 0:
        disable_MeshGhostExchange(model)
        out["ref_loss"], out["ref_grads"] = _single_device_rr(model, lj, e_ref, lj["forces"], dev)
    del model, ev
    torch.cuda.empty_cache()

    # (c) Trainer(devices=2): one epoch of batch 1 over phase 6's three frames (the tail a masked filler)
    class Steps(Callback):
        def __init__(self):
            self.rows = []

        def on_train_batch_end(self, trainer, module, logs, step):
            self.rows.append({"loss": logs["train_loss_step/weighted_sum"], "digest": _param_digest(module.model),
                              "grads": _grads_np(module.model)})

    ds = LJTestDataset(supercell=(18,) * 3, num_frames=3, seed=0,
                       transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
    dm = NequIPDataModule(seed=0, train_dataset=ds, train_dataloader={"batch_size": 1, "shuffle": False}, device=dev)
    module = NequIPTrainModule(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                               loss=EnergyForceLoss(type_names=["Cu"]), optimizer=SGD, device=dev)
    steps = Steps()
    trainer = Trainer(max_epochs=1, devices=2, callbacks=[steps], ckpt_dir=str(PARALLEL_DIR / "dp"),
                      save_last=False, save_best=False)
    _, out["dp"] = _rank_timed(lambda: trainer.fit(module, dm))
    out["dp"].update(fit_ms=out["dp"]["ms"], ms=trainer.step_seconds[-1] * 1e3,
                     step_ms=[t * 1e3 for t in trainer.step_seconds], steps=steps.rows,
                     params={k: t.detach().cpu().numpy() for k, t in module.model.jax_named_tensors()},
                     epoch=trainer.metrics_rows[-1])
    return out


def _rank_17d(rank: int) -> dict:
    """Phase 17 (d) on one of four ranks: SpatialTrainModule on a (2, 2)
    mesh, one rr step and one unsliced fr step from the same weights."""
    import torch

    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.parallel import SpatialFrameLoader, SpatialTrainModule, make_2d_mesh
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule

    dev = torch.device("cuda:0")
    out = {"built_s": _rank_start()}
    mesh = make_2d_mesh(2, 2)
    ds = LJTestDataset(supercell=(12,) * 3, num_frames=2, seed=0,
                       transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
    batch = next(iter(SpatialFrameLoader(ds, mesh, 4.0, device=dev)))
    out["coords"] = dict(mesh.coords)
    out["caps"] = {"L": batch["arrays"]["local_pos"].shape[0], "G": batch["arrays"]["ghost_mask"].shape[0],
                   "E": batch["arrays"]["edge_mask"].shape[0]}
    def step(mode: str) -> dict:
        module = SpatialTrainModule(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                                    loss=EnergyForceLoss(type_names=["Cu"]), optimizer=SGD, force_grad_mode=mode,
                                    mesh=mesh, device=dev)
        logs, rep = _rank_timed(lambda: module.training_step(batch))
        rep.update(loss=float(logs["train_loss_step/weighted_sum"]), grads=_grads_np(module.model),
                   digest=_param_digest(module.model))
        return rep

    step("rr")  # the process's first step, not timed
    out["rr"], out["fr"] = step("rr"), step("fr")
    if rank == 0:
        ref = NequIPTrainModule(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                                loss=EnergyForceLoss(type_names=["Cu"]), optimizer=SGD, device=dev)
        logs = ref.training_step(next(iter(DataLoader(ds, batch_size=2, device=dev))))
        out["ref_loss"], out["ref_grads"] = float(logs["train_loss_step/weighted_sum"]), _grads_np(ref.model)
    return out


def _rel_gap(got: dict, want: dict) -> float:
    """Largest per-tensor max |diff| / max |want|."""
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30) for k in want)


def _rank_line(label: str, rank: int, n: int, r: dict) -> str:
    caps = r.get("caps")
    ghost = "" if caps is None else (f"caps L {caps['L']}, G {caps['G']}, E {caps['E']} (G/L "
                                     f"{caps['G'] / caps['L']:.3f}), ")
    return (f"phase 17{label} rank {rank}: {ghost}step {r['ms']:.1f} ms ({n} {SHARED_CARD}), max_memory_allocated "
            f"{r['peak_gib']:.3f} GiB, launches {r['launches']}")


def _need(label: str, rank: int, launches: dict, kernels) -> None:
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise RuntimeError(f"phase 17{label}: rank {rank} did not launch {missing} ({launches})")


def phase17_parallel(smi: str) -> dict:
    """Phase 17: the parallel paths as ranks on the one card over gloo (by
    name: NCCL refuses two ranks on one card), each rank a process of its
    own that reports its caps, step time, peak memory and launches: (a)
    sharded serving of the f32 flagship on 23k atoms against the
    single-device request and of the f64 golden frame against the golden;
    (b) sharded loss_and_grad, rr and fr over N_CHUNKS slices, on phase
    6's LJ frame against the single-device rr step; (c) Trainer(devices=2)
    against the single-device trainer at batch 2 (this process), the
    replicated parameters the same bytes on both ranks after each step;
    (d) SpatialTrainModule on a (2, 2) mesh of four ranks, one rr and one
    fr step (after an untimed rr step), against the single-device step.
    Returns each kernel's launches summed over the ranks' main paths."""
    import shutil

    import torch

    from nequip_tpu_torch.data import NequIPDataModule
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule, Trainer
    from nequip_tpu_torch.train.callbacks.base import Callback

    gather = "all_gather_single" if hasattr(torch.distributed, "all_gather_single") else "all_gather_into_tensor"
    print(f"phase 17 collectives on gloo's CUDA tensors: the ghost gather by torch.distributed.{gather}, its "
          f"transpose by all_reduce (torch {torch.__version__})", flush=True)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    totals: dict = {}

    def tally(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    two = run_ranks(_rank_17abc, 2, threads=4, deadline_s=420, pg_timeout_s=300)
    t1 = time.perf_counter()
    for rank, r in enumerate(two):
        if r["built_s"] != 0.0:
            raise RuntimeError(f"phase 17: rank {rank} compiled the kernels again ({r['built_s']:.1f} s)")
        for label, key, kernels in (("a", "serve", SERVING_KERNELS), ("a", "golden", SERVING_KERNELS),
                                    ("b", "rr", TRAINING_KERNELS), ("b", "fr", FR_CHUNKED_KERNELS),
                                    ("c", "dp", TRAINING_KERNELS)):
            print(_rank_line(f"{label} {key}", rank, 2, r[key]) + (
                f"; fit {r[key]['fit_ms']:.1f} ms, steps {[round(t, 1) for t in r[key]['step_ms']]} ms"
                if key == "dp" else ""), flush=True)
            _need(label, rank, r[key]["launches"], kernels)
            tally(r[key]["launches"])
        if any(k not in SERVING_KERNELS for k in r["serve"]["launches"]):
            raise RuntimeError(f"phase 17a: sharded serving launched a training kernel: {r['serve']['launches']}")
        if not (r["golden"]["e_rel"] <= 1e-10 and r["golden"]["f_err"] <= 1e-8):
            raise RuntimeError(f"phase 17a: rank {rank}'s sharded f64 golden: E rel {r['golden']['e_rel']:.3e}, "
                               f"F max err {r['golden']['f_err']:.3e}")
    a, g = two[0]["serve"], two[0]["golden"]
    print(f"phase 17a sharded serving vs the single-device request (f32, 23,328 atoms): E rel {a['e_rel']:.3e}, "
          f"F max err / max|F| {a['f_err']:.3e}; f64 golden over 2 ranks: E rel {g['e_rel']:.3e}, F max err "
          f"{g['f_err']:.3e}", flush=True)
    if not (a["e_rel"] <= 1e-5 and a["f_err"] <= 1e-4):
        raise RuntimeError("phase 17a: sharded serving disagrees with the single-device request")
    for mode in ("rr", "fr"):
        gaps = [(abs(r[mode]["loss"] - two[0]["ref_loss"]) / abs(two[0]["ref_loss"]),
                 _rel_gap(r[mode]["grads"], two[0]["ref_grads"])) for r in two]
        print(f"phase 17b sharded {mode}{f' over {N_CHUNKS} slices' if mode == 'fr' else ''} vs the single-device rr "
              f"step (f32): loss {two[0][mode]['loss']:.6e} (single {two[0]['ref_loss']:.6e}), per rank (loss rel, "
              f"grads max err / max|grad|) {[(f'{x:.2e}', f'{y:.2e}') for x, y in gaps]}", flush=True)
        if not all(x <= PARALLEL_TOL and y <= PARALLEL_TOL for x, y in gaps):
            raise RuntimeError(f"phase 17b: sharded {mode} training disagrees with the single-device rr step")

    # (c) the single-device trainer at batch 2 over the same frames, here
    class Steps(Callback):
        def __init__(self):
            self.rows = []

        def on_train_batch_end(self, trainer, module, logs, step):
            self.rows.append({"loss": logs["train_loss_step/weighted_sum"], "grads": _grads_np(module.model)})

    ds = LJTestDataset(supercell=(18,) * 3, num_frames=3, seed=0,
                       transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]), NeighborListTransform(4.0)])
    module = NequIPTrainModule(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **FLAGSHIP),
                               loss=EnergyForceLoss(type_names=["Cu"]), optimizer=SGD, device="cuda")
    steps = Steps()
    Trainer(max_epochs=1, callbacks=[steps], ckpt_dir=str(PARALLEL_DIR / "single"), save_last=False,
            save_best=False).fit(module, NequIPDataModule(
                seed=0, train_dataset=ds, train_dataloader={"batch_size": 2, "shuffle": False}, device="cuda"))
    single = {k: t.detach().cpu().numpy() for k, t in module.model.jax_named_tensors()}
    del module, ds
    torch.cuda.empty_cache()
    dp = [r["dp"] for r in two]
    if len(steps.rows) != 2 or any(len(d["steps"]) != 2 for d in dp):
        raise RuntimeError(f"phase 17c: {[len(d['steps']) for d in dp]} data-parallel steps, {len(steps.rows)} "
                           "single-device steps; 2 each expected")
    for i, want in enumerate(steps.rows):
        if len({d["steps"][i]["digest"] for d in dp}) != 1:
            raise RuntimeError(f"phase 17c: the ranks' parameters differ after step {i}")
        loss_rel = max(abs(d["steps"][i]["loss"] - want["loss"]) / abs(want["loss"]) for d in dp)
        grad_gap = max(_rel_gap(d["steps"][i]["grads"], want["grads"]) for d in dp)
        print(f"phase 17c step {i}: Trainer(devices=2) vs the single-device trainer at batch 2 (f32, SGD): loss "
              f"{dp[0]['steps'][i]['loss']:.6e} rel {loss_rel:.2e}, grads max err / max|grad| {grad_gap:.2e}; "
              f"parameters the same bytes on both ranks; step {dp[0]['step_ms'][i]:.1f} ms ({2} {SHARED_CARD})",
              flush=True)
        if not (loss_rel <= PARALLEL_TOL and grad_gap <= PARALLEL_TOL):
            raise RuntimeError(f"phase 17c: step {i} disagrees with the single-device trainer")
    p_gap = _rel_gap(dp[0]["params"], single)
    print(f"phase 17c parameters after the epoch vs single device: max err / max|p| {p_gap:.2e}", flush=True)
    if not p_gap <= PARALLEL_TOL:
        raise RuntimeError("phase 17c: the data-parallel parameters disagree with the single-device trainer's")
    t2 = time.perf_counter()

    four = run_ranks(_rank_17d, 4, threads=2, deadline_s=300, pg_timeout_s=240)
    for rank, r in enumerate(four):
        for mode, kernels in (("rr", TRAINING_KERNELS), ("fr", FR_UNCHUNKED_KERNELS)):
            print(_rank_line(f"d {mode} {tuple(r['coords'].values())}", rank, 4, dict(r[mode], caps=r["caps"])),
                  flush=True)
            _need("d", rank, r[mode]["launches"], kernels)
            tally(r[mode]["launches"])
    ref = four[0]
    for mode in ("rr", "fr"):
        if len({r[mode]["digest"] for r in four}) != 1:
            raise RuntimeError(f"phase 17d: the four ranks' parameters differ after the {mode} step")
        loss_rel = max(abs(r[mode]["loss"] - ref["ref_loss"]) / abs(ref["ref_loss"]) for r in four)
        gap = max(_rel_gap(r[mode]["grads"], ref["ref_grads"]) for r in four)
        print(f"phase 17d 2-D {mode} step vs the single-device rr step on the same 2 frames of 6,912 atoms (f32): "
              f"loss {ref[mode]['loss']:.6e} rel {loss_rel:.2e}, grads max err / max|grad| {gap:.2e}", flush=True)
        if not (loss_rel <= PARALLEL_TOL and gap <= PARALLEL_TOL):
            raise RuntimeError(f"phase 17d: the 2-D {mode} step disagrees with the single-device step")
    print(f"phase 17 {time.perf_counter() - t0:.1f} s ((a)-(c) ranks {t1 - t0:.1f} s, (c)'s reference "
          f"{t2 - t1:.1f} s, (d) {time.perf_counter() - t2:.1f} s; {smi})", flush=True)
    return totals


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    smi = phase0_device()
    t0 = time.perf_counter()
    built = phase1_build()
    report = phase2_kernels(n_atoms=23000, reps=10)
    phase3_golden()
    phase4_serve(n_atoms=23000)
    phase5_train_golden()
    rr_launches, dm, rr = phase6_train(smi)
    fr_launches = phase7_train_fr(smi, dm, rr)
    lj_frames = dm.datasets["train"][0].dataset.frames  # phase 6's three LJ frames, for phase 13
    report.update(phase8a_microbench(smi))
    report["row_gather"] = phase8b_gather(smi)
    mb_launches = phase8c_tools()
    report["device_nl"] = phase9_md(smi)
    phase10_cli(smi, rr)
    phase11_deploy(smi, built)
    phase11f_consumer(smi, built)
    phase12_pair_style(smi)
    phase13_files(smi, lj_frames, rr)
    del lj_frames
    options = phase14_options(smi)
    phase15_train_modules(smi, dm, rr)
    bf16_report, bf16_launches = phase16_bf16(smi, dm=dm, preset_m_f32=options["rr"]["none"])
    del dm
    parallel_launches = phase17_parallel(smi)
    print(f"phase 17 launches over the ranks' main paths {parallel_launches}", flush=True)

    from nequip_tpu_torch.ops.kernels.build import KERNEL_SOURCES

    def launches(name):
        if name == "device_nl":
            return report[name]["launches"]
        if name in MICROBENCH_KERNELS:
            return mb_launches[name]
        return (rr_launches if name in RR_REPORTED else fr_launches)[name]

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches(name),
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            "library_ms": report[name]["library_ms"],
        }
        for name in REPLACES
    ] + [
        {
            "name": f"{name}_bf16",
            "route": "cuda",
            "source": KERNEL_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": bf16_launches[name],
            **{k: bf16_report[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
        }
        for name in BF16_KERNELS
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError(f"a kernel was not launched on its path: {[k['name'] for k in kernels if not k['launches']]}")
    print(f"total {time.perf_counter() - t0:.1f} s after phase 0", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
