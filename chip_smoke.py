"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Builds the CUDA kernels of ``nbody_streams_tpu_torch`` from the sources in
this checkout, checks each against its plain torch version on the card,
drives ``run_simulation(method='direct', architecture='gpu')`` on the bench
case (N = 65,536 Plummer, spline softening h = 0.05, float32 + Kahan,
dt = 2e-5), times it, and drives the measurement path (probe, bench,
roofline, speed of light, tile sweep, bench suite), the external fields,
dynamical friction, the SCF tier, the samplers, the reference's drop-in
names with the one-card tree tier, stream generation (particle spray,
restricted N-body), unbinding, the command line, the ring over virtual
shards, the scale drivers (the 2M flagship, the 1M and 2M gates) and the
tensor-core forms of the direct kernels (kernels M and F).
Phases:

  (a) card name and power limit; kernel build time; each force kernel's
      registers, spills and issue slots a pair from its SASS (the base
      pass's loop holds no rsqrt range check)
  (b) kernels vs plain versions on the card, each plain version at the
      kernel's source-stream split count S; S, grid and share of the
      FLOP bound of the base and band passes; kernel vs the fp64 oracle
  (c) Kahan compensation beats plain fp32 on an adversarial sum (S = 1)
  (d) run_simulation on the bench case, 300 steps: |dE/E| < 1e-4, the last
      snapshot (the restart file where h5py is absent) reads back, and the
      path ran through both kernels
  (e) impl='cuda' vs impl='torch' over 10 KDK steps at N = 16,384
  (f) ms/step and Gint/s of the bench case, best of 3 windows of 100 steps
      (``bench.measure``, |dE/E| < 1e-4 over the windows)
  (g) the roofline kernels vs their plain versions, the moment tile's
      speed of light (tile_sol_moment_kernel, kernel M's step loop) among
      them at the base pass's shape within MOMENT_TOL of its plain version
      (the moments before the finalisation); then, with their launch
      counts zeroed, the measurement path: the FMA probe, the bench's
      capacity probe, the FMA and rsqrt rates and tile_sol and
      tile_sol_moment at the base pass's shape and at full occupancy, each
      <= 1.05 x the card's peak (SM count x max clock; tile_sol_moment's
      pairs against the MUFU peak and its TF32 FLOPs against the tensor
      cores' dense peak); the base and band passes as fractions of the
      speed of light; the base pass at full occupancy (16 copies of its
      targets at the same S, the same work per block); kernel M at its
      own shape as a fraction of tile_sol_moment at both shapes, and at
      full occupancy, beside the base pass's fractions of tile_sol
  (h) the tile sweep at N = 65,536 (every geometry within 2e-6 * max of
      the default's accelerations), bench_suite sections 1-3 (errors vs
      the fp64 oracle <= 3e-6), and the single-pass kernel's plain time
  (i) the external-potential path: four fields (MWPotential22,
      McMillan17_streams, the MW+LMC evolving field, the FIRE-like BFE)
      on the card in float32 against float64 on the CPU at 65,536 points
      (MW+LMC at three times, one a table node), each force under
      torch.cuda.set_sync_debug_mode('error'); their ms and launches per
      force evaluation; run_simulation of the bench case's Plummer on an
      orbit in McMillan17_streams (300 steps, |dE/E| < 1e-4 with the
      field's energy) and in the MW+LMC field from t = -1 (100 steps, the
      centre of mass on the fp64 orbit of one point); the KDK ms/step with
      and without the MW+LMC field; and fit_cylspline_from_particles
      through the two-set potential kernel (vs its plain version, 2e-6)
  (j) dynamical friction: the DF tutorial's satellite (Plummer N = 65,536,
      M = 5e9, a = 0.5 at +40 kpc, +120 km/s) in its NFW host (the bare
      class, on the CPU) through run_simulation, 750 steps of 2e-3 with
      DF off, on (shrinking sphere) and on (bound_phi): both DF runs end
      closer in; the friction term at step 100 of the bound_phi loop,
      float32 on the card vs float64 on the CPU within DF_TOL and with no
      host sync; its launches; the base and band launches a step of each
      path; the KDK ms/step of each
  (k) the SCF tier at N = 1M: float32 vs float64 on the card within
      SCF_TOL with TF32 off and on; ms and launches a force, ms a KDK
      step (benchmarks.scf speed); the accuracy ladder at N = 65,536
      against docs/runs/scf_ladder.txt (5%) and the single-pass Plummer
      kernel there vs its plain version; 200 steps of
      run_simulation(method='scf') with |dE/E| < 1e-4; scf_groups on a
      two-centre case; sample_quasispherical (65,536, then 0.25 t_dyn on
      the card, median radius within 8%), sample_disk (1M in
      McMillan17), make_king_potential on the card vs the CPU
  (l) the potential forms of the direct kernels: two-set (nt != ns, nt
      not a multiple of 64) for every law, mask off and on, at S = 1 and
      the wrapper's S, vs their plain versions; the self-masked potential
      with a quarter of the particles at h = 0 (single pass, every law;
      sorted two-pass) vs the fp64 oracle; times by CUDA events of the
      fit's two-set kernel (20,000 x 65,536), the self spline potential
      at the DF satellite (single pass), the sorted path's potential base
      and band passes and rows 1 and 3 at the bench case; slots a pair and
      registers of those forms from the SASS
  (m) the drop-in surface, the tree tier, stream generation and
      unbinding: get_gpu_info / cuda_alive; compute_nbody_forces_gpu vs
      DirectGravity on the bench case; tree_gravity_gpu there (eps = 0.05)
      vs the fp64 oracle (3e-6), warning once; run_nbody_gpu_tree 100
      steps (|dE/E| < 1e-4); run_simulation(method='tree') equal to
      method='direct' over 100 steps; a profile_dir trace naming the
      kernels; the spray of examples/stream_in_mw.py (MWPotential22,
      King W0 = 4, 4,000 particles, float32) on the window SPRAY_WINDOW
      vs float64 on the CPU within SPRAY_TOL, then timed (rewind and
      forward ensemble apart, cut in depth to SPRAY_RUN) with the
      launches, device ms and busy share of an RK4 step and a DP5(4)
      substep (profiler); run_restricted_nbody at 10,000 particles (bound
      mass non-increasing above the refit's 10-particle threshold); and
      iterative_unbinding in both call forms at N = 2^20 with a seeded
      tenth kicked past escape: ms an iteration by CUDA events, row 2's
      potential form against its bound, and the final masks against the
      criterion in fp64 at a sample of 32,768 particles
  (n) the user's command-line workflow: nbody-torch-run in-process
      (cli.main) at N = 100,000 for 1,000 steps of 2e-5 with restarts,
      then --continue for 200 more: the restart file reads back at step
      1,200, |dE/E| < 1e-4 from host float64 energies, the base and band
      kernels ran; at that shape, the start and the final state's force
      and self-masked potential through DirectGravity and both branches
      of the sorted path against the float64 sum at CLI_SAMPLE targets,
      and the single, base and band passes against their plain
      versions; the final state rendered at 512^2 on the card against
      the CPU with the same smoothing lengths (RENDER_TOL), the frame's
      mass within MASS_TOL of its float64 value, the splat's ms (CUDA
      events), launches and busy share (profiler); the native host
      library: its build time, knn_radius at N = 2^20 equal to cKDTree
      (KNN_TOL) with both times, the host CPU and thread count,
      morton_argsort a permutation, and a render at 2^20 through 'auto'
      (the native kNN) with the same checks; the port's
      examples/plummer_stability.py at its own size (runpy, |dE/E| <
      1e-4, finite profile drift); cli.bench_main([]) prints the bench
      JSON line
  (o) the multi-device ring over virtual shards of the card
      (devices=['cuda:0'] * D) on the slab-sorted bench case: (o.1) the
      ring at D = 1, 2, 4, 8, force and potential, within 2e-6 * max of
      the one-card sorted path (rows 1 + 3) and within 3e-6 of the fp64
      sum at RING_SAMPLE targets, every tile a kernel launch; (o.2) row
      2's ring forms (spline and Newtonian force, potential with and
      without the self mask) at the D = 4 tile shape against their plain
      versions, timed by CUDA events, with their bounds; (o.3) the far
      tiles at D = 4 and 8 equal to the count the slabs' x-intervals
      give, and none on shuffled input; (o.4) run_simulation(method=
      'tree', devices=['cuda:0'] * 4) at N = 65,537 (3 ghost rows), 100
      steps: |dE/E| < 1e-4 from host float64 energies, the final state
      within 1e-5 * max|x| of method='direct', the displacement within
      1e-3 and the velocity change within 1e-4 of their max; then the
      ring at the run's shape (n_local = 16,385, 3 ghost rows of h = 0)
      at the start and final ghost-padded states within 2e-6 of the
      one-card path and 3e-6 of fp64, and the last shard's force and
      self-masked potential tiles against their plain versions; (o.5)
      the strong-scaling table of benchmarks.ring_scaling beside the
      one-card time
  (p) the scale drivers (benchmarks.flagship2m, benchmarks.northstar) at
      full width, cut in depth: (p.1) the flagship at N = 2,097,153 (three
      species in the MW+LMC field with friction): build_ics' host seconds,
      the field at every initial point in float32 against float64 on the
      CPU at 65,536 of them (FIELD_TOL), the self-gravity force and
      self-masked potential of the start and final states against the
      float64 sum at 4,096 targets (3e-6), the sorted path's kernels at
      that N timed by CUDA events, flagship2m.run stopped at step 3 and
      resumed to step 6 (restart files at steps 3 and 6, the summary
      counting 6 steps over 2 attempts, the CoM radius falling, every state
      finite), one KDK step's ms, kernels, device ms and busy share, and
      the final state's stars rendered at 384^2 on the card against the
      CPU; (p.2) northstar's argsort at 2M; (p.3) gate2m at N = 2,097,152
      for 3 of its 100 steps and (p.4) gate1m at N = 1,048,576 for 20 of
      its 1,000, each with |dE/E| < 1e-4 from its float64 bracket
  (q) the tensor-core forms of the direct kernels (csrc/moment.cu): (q.1)
      kernel M (folded, unfolded) and kernel F (acc, pot) as the sorted
      base pass at the bench case, centred, against their plain versions
      (MOMENT_TOL, FAST_TOL), timed by CUDA events beside rows 1 and 3
      timed in the same call, with their bounds (the tensor pipe added);
      (q.2) M's two-set form at the ring's D = 4 far tile against its
      plain version, timed beside row 2's Newtonian tile; (q.3) the sorted path with M, M unfolded and F
      against the float64 sum at RING_SAMPLE targets (3e-6; F
      FAST_FP64_TOL); (q.4) F's guarantees on the fast tier test's
      clustered data at N = 65,536 (finite, max < 0.5, median < 5e-3 acc
      and < 1e-3 pot); (q.5) 3 x 100 KDK steps of the bench case with
      tile_config {'mxu': True} and with precision='float32_fast' (ms/step,
      |dE/E| < 1e-4); (q.6) gate1m with target_drift=1e-8 for
      GATE1M_STEPS steps, on the VPU form (it launches no kernel M), its
      final state's force against the float64 sum at P_SAMPLE targets
      (3e-6) through that solver and through kernel M unfolded
      (tile_config {'mxu': True}), and M at that shape against its plain
      version on the last two target tiles (MOMENT_TOL); (q.7) the ring
      with mxu=True over RING_RUN_D virtual shards at (120, -80, 40)
      within 2e-6 of one card.  The default paths of phases (d)-(p)
      launch neither M nor F.

Every phase raises on failure.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card, and
the one before that a JSON object of the kernels: for the force kernels
the launches of each run path of phases (d), (i), (j), (k), (m), (n), (o),
(p) and (q) under ``launches_by_path``, counted by kernel form (the base pass, the single
pass, the band pass) where the wrapper launches it, and in phase (g)'s
measurement path for the roofline kernels; max error and times from
(b)/(g)/(k)/(l) (tile_sol and tile_sol_moment at full occupancy, the
shape where each bounds its pass; tile_sol_moment's entry carries kernel
M's fractions of it), each kernel's bound (the largest of its FP32 operations
over the card's FP32 peak, its rsqrts over its MUFU rate and its bytes
over the memory rate; ``bound_pipe`` says which, ``fp32_share`` is the
share of the FP32 bound alone), slots a pair from the SASS where read
and, for the force kernels, S.
Exits nonzero, and prints no result, without a CUDA device.
"""
import argparse
import copy
import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_BENCH = 65536
DT = 2e-5
H = 0.05
SOURCE = "nbody_streams_tpu_torch/csrc/direct.cu"
MOMENT_SOURCE = "nbody_streams_tpu_torch/csrc/moment.cu"
ROOFLINE_SOURCE = "nbody_streams_tpu_torch/csrc/roofline.cu"
# the chains (K links per pass, passes) for the kernel-vs-plain checks: the
# probe's K, where the chains sit at their fixed point, and a K below it,
# where every link and every pass moves the output
CHAIN_CHECKS = ((256, 40), (16, 2))
# tile_sol reps for the kernel-vs-plain check and for the rates
SOL_CHECK_REPS, SOL_REPS = 16, 1024
# copies of the bench case's targets for the base pass at full occupancy
OCC_COPIES = 16
# the card's peaks for the bounds: H100 SXM at 700 W (NVIDIA's data
# sheet: FP32 outside the tensor cores, HBM3); the rsqrt chain's MUFU peak
# is the card's own (SM count x 16 x max clock, probe.card_peaks)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# dense TF32 on the tensor cores (NVIDIA's data sheet, H100 SXM); a
# 3xTF32 product issues two mma passes (csrc/direct_math.cuh)
PEAK_TF32 = 495e12
# FP32 operations a pair, the rsqrt counted as one.  Newtonian force with
# Kahan: 3 subtracts, 6 for r^2 + eps2, 1 rsqrt, 3 multiplies (inv^3 and
# G m), 6 for the three multiply-adds into the sum (direct_math.cuh).
# Spline: the same 19, the pair min of 1/h, and 23 in force_pre<SPLINE>
# (r, newton, h^-3, q, q^2, 5 inner, 9 outer, 2 compares, 2 selects)
# Plummer: the Newtonian 19, the pair max of h^2 and its add into r^2
PAIR_FLOPS = {"newtonian": 19, "spline": 43, "plummer": 21}
# The potential forms.  Newtonian: 3 subtracts, 6 for r^2 + eps2, 1 rsqrt,
# the multiply by G m and the add into the sum (one FFMA); Plummer: the
# same and the pair max of h^2 and its add; spline: the Newtonian 12, the
# pair min of 1/h and 25 in pot_pre<SPLINE> (r, q, q^2, 7 inner, 11 outer,
# 2 compares, 2 selects)
POT_FLOPS = {"newtonian": 12, "plummer": 14, "spline": 38}
G = 4.300917270069976e-06
# the satellite's orbit in the static field (examples/stream_nbody.py) and
# its Sgr-like present-day phase in the MW+LMC field
# (examples/mw_lmc_stream.py), started at t = -1 (a table node)
ORBIT_MW = np.array([14.0, 0.0, 6.0, 30.0, 150.0, -10.0])
ORBIT_LMC = np.array([17.5, 2.5, -6.5, 237.9, -24.3, 209.0])
# card float32 vs CPU float64, max |err| / max |fp64| over the 65,536
# points of benchmarks.fields.field_points: force, potential.  Four times the JAX package's
# own float32-vs-float64 error at the first 2,048 of the same points
# (tests/test_torch_fields.py::test_field_fp32_error_within_chip_tolerance
# measures it, pins each limit to 4-5 times it, and holds the port's CPU
# float32 to the same limits).  The JAX package's float32 CylSpline loses
# ~1e-4 of the FIRE BFE's force near its centre to cancellation in its
# Hermite sums; the port's corner-relative sums lose less
FIELD_TOL = {"MWPotential22": (3.9e-6, 7.8e-7),
             "McMillan17_streams": (3.0e-6, 9.5e-7),
             "MW+LMC": (2.9e-6, 1.2e-6),
             "FIRE BFE": (4.8e-4, 5.5e-6)}
# card float32 vs CPU float64 of the friction vector a_df, |da| / |a|, at a
# bound_phi update: four times the JAX package's own float32 error at the
# same kind of state (tests/test_torch_friction.py::
# test_df_fp32_error_within_chip_tolerance measures it and pins this)
DF_TOL = 3.5e-6
# SCFGravity(nmax=8, lmax=4, a=1) float32 vs float64, max |err| / max |fp64|
# of the accelerations and the potential: four times the JAX package's own
# float32 error on the 65,536-particle Plummer sphere (seed 7;
# tests/test_torch_scf.py::test_scf_fp32_error_within_chip_tolerance);
# TF32 in the contractions would read ~1e-3
SCF_TOL = (3.1e-6, 2.8e-6)
# phase (j): the DF tutorial's satellite (examples/dynamical_friction_
# tutorial.py) at the bench case's N, in its NFW host, 750 steps of 2e-3
DF_DT, DF_STEPS = 2e-3, 750
DF_RUNS = {"df_off": {},
           "df_shrinking_sphere": dict(df_M_sat=5e9, df_sigma_method="jeans",
                                       df_update_interval=10),
           "df_bound_phi": dict(df_M_sat=5e9, df_sigma_method="jeans",
                                df_update_interval=10,
                                df_com_method="bound_phi")}
# phase (k): the SCF tier at the size of the JAX package's scf_bench speed
# and drift runs; the ladder's record (an accuracy record of the same
# truncated field on the same sample, not a time) and its tolerance
N_SCF = 1_048_576
SCF_DRIFT_STEPS = 200
LADDER_RECORD = "docs/runs/scf_ladder.txt"
LADDER_TOL = 0.05
# phase (m): the spray of examples/stream_in_mw.py at its full size (a
# Pal 5-like King cluster in MWPotential22), and the window of its first
# SPRAY_WINDOW output nodes and forward steps where the card's float32 is
# held against the port's float64 on the CPU
MW22 = "nbody_streams_tpu_torch/data/potentials/MWPotential22.ini"
SPRAY_CASE = dict(initmass=2e4,
                  sat_cen_present=np.array([8.3, 0.2, 16.9, -52.0, -96.0,
                                            -8.0]),
                  scaleradius=0.02, num_particles=4000, prog_pot_kind="King",
                  W0=4.0, time_total=2.0, time_end=0.0, n_steps=2000)
SPRAY_WINDOW = 200
# card float32 vs CPU float64 on that window, max |err| / max |fp64| of
# positions and velocities: the rewound orbit over the window's nodes and
# the released stream at the window's end over its particles.  Four times
# the JAX package's own float32-vs-float64 error on the same window at 400
# particles (tests/test_torch_fast_sims.py::test_spray_fp32_error_within_
# chip_tolerance measures it and pins each limit to 4-5 times it)
SPRAY_TOL = {"rewind": (9.9e-6, 1.5e-5), "stream": (2.6e-5, 6.5e-5)}


def spray_window(**kw):
    """SPRAY_CASE cut to its first SPRAY_WINDOW output nodes and forward
    steps (the same step), every step saved: the spray's ``prog_xv`` is
    then the rewound orbit at each node and ``part_xv[:, -1]`` the stream
    at the window's end."""
    case = dict(SPRAY_CASE, **kw)
    case.update(time_total=SPRAY_WINDOW * case["time_total"]
                / case["n_steps"], n_steps=SPRAY_WINDOW,
                save_rate=SPRAY_WINDOW)
    return case


# phase (m): the spray and restricted N-body runs at full width, cut in
# depth from the example's 2.0 time units (kpc / (km/s)) at its step of
# 1e-3: their eager torch took ~93 (spray) and ~120 (restricted) ms a step
# on an NVIDIA H100 80GB HBM3 at 700 W (~29 us a launch), so the full
# 2,000 steps would hold the phase ~7 minutes.  The spray runs an eighth
# of them (250 steps) so that the whole script, phase (n) included, stays
# near 400 s; restricted N-body a quarter.  Unbinding at N = 2^20
SPRAY_RUN = dict(SPRAY_CASE, time_total=0.25, n_steps=250)
RESTRICTED_N = 10_000
RESTRICTED_TIME, RESTRICTED_STEPS = 0.5, 500
N_UNBIND = 1_048_576
# phase (n): the command-line workflow.  The README quick start's N and
# softening with the bench case's step: at the quick start's dt = 1e-3 a
# Plummer sphere with h = 0.05 drifts to |dE/E| ~ 2e-2 in 1,000 steps, past
# the 1e-4 contract.  1,000 steps, then 200 more from the restart file
CLI_ARGS = ["--n", "100000", "--softening", "0.05", "--dt", "2e-5",
            "--architecture", "gpu", "--no-snapshots", "--restart-interval",
            "250", "--debug-energy"]
CLI_T_END, CLI_T_CONTINUE = 0.02, 0.024
# the direct kernels at the CLI's shape (cli_kernel_checks): each kernel
# against its plain version on the same operands within 2e-6 * max (phase
# (b)'s Kahan tolerance), and the force and the self-masked potential
# against the float64 sum over the same float32 positions at a seeded
# sample of CLI_SAMPLE targets within 3e-6 * max (phase (b)'s
# kernel-vs-oracle tolerance)
CLI_SAMPLE = 4096
# the render of a state on the card against the same call on the CPU with
# the same smoothing lengths, max |card - cpu| / max |cpu| over the image:
# float32 sums in another order (atomic adds on the card, in order on the
# CPU).  The port and the JAX package, two orders on the CPU, differ by
# ~3e-7 at N = 4,096 (tests/test_torch_viz.py); this allows ~30 times that
RENDER_TOL = 1e-5
RENDER_NPIX = 512
# the mass inside the frame against its float64 value (frame_mass)
MASS_TOL = 1e-5
# the native kNN against cKDTree: both compute the same float64 distances
KNN_TOL = 1e-12
PLUMMER_EXAMPLE = "nbody_streams_tpu_torch/examples/plummer_stability.py"
# phase (o), the ring over virtual shards of the card: the shard counts,
# the fp64 oracle's targets, the tile shape of row 2's ring forms (D = 4 at
# the bench case), the run (3 ghost rows at D = 4) and its depth
RING_DS = (1, 2, 4, 8)
RING_SAMPLE = 4096
RING_TILE_D = 4
RING_RUN_N = 65_537
RING_RUN_D = 4
RING_RUN_STEPS = 100
# (p) the scale drivers at full width, cut in depth (PERF.md section 4):
# the flagship 3 steps, then a resumed 3, of its 200; gate2m 2 of its 100
# steps; gate1m 4 of its 1,000
FLAGSHIP_STEPS = 6
FLAGSHIP_STOP = 3
GATE2M_STEPS = 2
GATE1M_STEPS = 4
P_SAMPLE = 4096        # float64 targets of the flagship's force checks
P_FIELD_SAMPLE = 65536  # float64 CPU points of its field check
P_RENDER_NPIX = 384
# (q), the tensor-core forms (csrc/moment.cu).  Kernel vs plain version:
# kernel M 2e-6 of max with Kahan (as rows 1-3); kernel F
# by its measured bound (the cross term's products summed in another
# order, amplified as (|x| / r)^2 in r^2; PERF.md §6)
MOMENT_TOL = 2e-6
FAST_TOL = {"acc": 2e-5, "pot": 3e-6}
FAST_FP64_TOL = 2e-5
#: the base pass's forms: (mode, fold_mass, fast)
MOMENT_FORMS = {"fold": ("acc", True, False), "unfold": ("acc", False, False),
                "fast": ("acc", True, True), "fast_pot": ("pot", True, True)}
MOMENT_KERNELS = {"fold": "kernel M", "unfold": "kernel M, unfolded",
                  "fast": "kernel F", "fast_pot": "kernel F, potential"}
# FP32 operations a pair (an FMA counted as two): the Newtonian factor
# (dx, r^2, the cube: 11; F's expanded r^2 takes 7 where dx and r^2 take
# 9), the subtraction of the factor's TF32 split (1; its rounding is two
# integer operations, off the FP32 pipe), its add into the step's moments
# (1) and, unfolded, G m (1); and TF32 tensor FLOPs a pair: 2 passes of
# m16n8k8 (2 x 16 x 8 x 8) over 16 x 8 pairs (3xTF32 in two passes,
# csrc/direct_math.cuh), F twice that for its cross term
MOMENT_FLOPS = {"fold": 13, "unfold": 14, "fast": 11, "fast_pot": 9}
TENSOR_FLOPS = {"fold": 32, "unfold": 32, "fast": 64, "fast_pot": 64}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel_err(a, b):
    """max |a - b| / max |b| (and the absolute max)."""
    d = (a.double() - b.double()).abs().max().item()
    return d / b.double().abs().max().item(), d


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, by events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, rsqrts, mufu_per_s, tensor_flops=0):
    """The least time the card could take for a kernel's work: the largest
    of its FP32 operations over PEAK_FP32, its rsqrts over the card's MUFU
    rate, its TF32 tensor-core FLOPs over PEAK_TF32 and its bytes over
    PEAK_BYTES.  A dict of ``bound_ms``, ``bound_by`` ('operations' or
    'bytes'), ``bound_pipe`` (which of 'fp32', 'mufu', 'tensor' and
    'bytes' sets it) and ``fp32_bound_ms``, the FP32 time alone."""
    times = {"fp32": flops / PEAK_FP32, "mufu": rsqrts / mufu_per_s,
             "tensor": tensor_flops / PEAK_TF32,
             "bytes": nbytes / PEAK_BYTES}
    pipe = max(times, key=times.get)
    return {"bound_ms": times[pipe] * 1e3,
            "bound_by": "bytes" if pipe == "bytes" else "operations",
            "bound_pipe": pipe, "fp32_bound_ms": times["fp32"] * 1e3}


@functools.cache
def mufu_rate(dev):
    """The card's MUFU rsqrt results a second (probe.card_peaks)."""
    from nbody_streams_tpu_torch.ops import probe

    return probe.card_peaks(dev)["mufu_per_s"]


def describe(b, ms):
    """A kernel's bound (``bound``) and its shares, for the log."""
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_pipe']}), "
            f"{b['bound_ms'] / ms:.4f} of bound, {b['fp32_bound_ms'] / ms:.4f}"
            f" of the FP32 bound {b['fp32_bound_ms']:.4f} ms")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def plummer_case(n, seed):
    from nbody_streams_tpu_torch import make_plummer_sphere

    xv, m = make_plummer_sphere(n, M_total=1e9, a=1.0, seed=seed)
    return xv, m


def sorted_operands(xv, gm, h, dev, wide=False, order=None):
    """The sorted path's operands for per-particle G m ``gm`` and
    softenings ``h``, as ``cuda_direct._self_sorted`` builds them: targets
    and sources (spline) in ``order`` (by default the slab order of xv's
    positions), the band's start rows, its width nb, the source rows and
    the widest band window (the two-pass branch runs where it is <= nb).
    ``wide`` widens nb to that window where it is wider, so that the two
    passes sum the exact force at any state."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.as_tensor(xv[:, :3], **f32)
    if order is None:
        order = cd.slab_sort_key(pos)
    ps = pos[order]
    gs = torch.as_tensor(gm, **f32)[order]
    hs = torch.as_tensor(h, **f32)[order]
    hinv = cd._soft_pre("spline", hs)
    first, max_width, rows = cd.band_window(ps[:, 0], hs.max())
    nb = cd.band_rows(rows)
    if wide:
        nb = max(nb, int(max_width))
    start = first.clamp(0, rows - nb).to(torch.int32).contiguous()
    return (cd._targets(ps, hinv), cd._sources(ps, gs, hinv, cd.TN), start,
            nb, rows, int(max_width))


def phase_a(log_dir):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"(a) nvidia-smi: {smi}")
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    from nbody_streams_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"(a) kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")
    if log_dir:
        shutil.copy(lib_path.parent / "build.log", log_dir)
    from nbody_streams_tpu_torch.benchmarks import sass

    prof = sass.library_profile()
    for label, r in prof.items():
        loop = ""
        if "slots_per_pair" in r:
            loop = (f", inner loop {r['slots_per_pair']:.3f} issue slots a "
                    f"pair ({r['pairs_per_trip']} pairs a trip): "
                    + ", ".join(f"{op} {n:g}"
                                for op, n in r["per_pair"].items()))
        log(f"(a) {label}: {r['registers']} registers, {r['spill_bytes']} "
            f"spill bytes{loop}")
    base = prof["direct_tile_kernel<NEWTONIAN,ACC,Kahan,skip> (base pass)"]
    check(base["per_pair"].get("FSETP", 0) == 0
          and base["per_pair"]["MUFU.RSQ"] == 1,
          f"base pass loop keeps an rsqrt range check: {base['per_pair']}")
    return smi, name


def phase_b(dev):
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.pairwise import (
        compute_forces_direct, compute_potential_direct)

    rng = np.random.default_rng(5)
    # direct_tile_kernel, single pass: 5 laws x acc/pot x Kahan on/off at a
    # ragged N.  Tolerance: 2e-6 * max with Kahan, 1e-5 * max without
    # (fp32 sums in another order; rsqrt <= 2 ulp on both sides)
    n = 3000
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), dtype=torch.float32,
                       device=dev)
    gm = torch.tensor(rng.uniform(0.5, 2.0, n) * 0.43, dtype=torch.float32,
                      device=dev)
    soft = torch.tensor(rng.uniform(0.05, 0.3, n), dtype=torch.float32,
                        device=dev)
    worst = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in ("newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline"):
        pre = cd._soft_pre(kind, soft)
        tgt, src = cd._targets(pos, pre), cd._sources(pos, gm, pre, cd.TN)
        splits = cd.split_count("direct", n, src.shape[1], sms)
        for mode in ("acc", "pot"):
            for kahan in (True, False):
                args = (tgt, src, kind, mode, kahan, 1e-15, mode == "pot")
                got = cd._direct_tile(*args)
                want = cd._direct_tile_reference(*args, splits=splits)
                rel, _ = rel_err(got, want)
                tol = 2e-6 if kahan else 1e-5
                check(torch.isfinite(got).all().item(), f"{kind} {mode}")
                check(rel < tol, f"direct {kind} {mode} kahan={kahan}: "
                      f"{rel:.2e} >= {tol}")
                worst = max(worst, rel / tol)
    log(f"(b) direct_tile_kernel single pass, 20 variants at N={n}, "
        f"S={splits}: worst error {worst:.2f} of its tolerance")

    # skip_band base pass + band pass at the bench case's shapes
    xv, m = plummer_case(N_BENCH, 2)
    tgt, src, start, nb, rows, max_width = sorted_operands(
        xv, G * m, np.full(len(m), H), dev)
    check(max_width <= nb, f"bench case window {max_width} > {nb}")
    ns = src.shape[1]
    mufu = mufu_rate(dev)
    stats = {}
    for name, kind, pairs, fn, ref in (
            ("direct", "newtonian", N_BENCH * (ns - nb * cd.TN),
             lambda s=None: cd._direct_tile(
                 tgt, src, "newtonian", "acc", True, 1e-15, False, nb, start,
                 splits=s),
             lambda s: cd._direct_tile_reference(
                 tgt, src, "newtonian", "acc", True, 1e-15, False, nb,
                 start, splits=s)),
            ("band", "spline", N_BENCH * nb * cd.TN,
             lambda s=None: cd._band(tgt, src, start, "acc", True, 1e-15,
                                     False, cd.TM, cd.TN, nb, splits=s),
             lambda s: cd._band_reference(tgt, src, start, "acc", True,
                                          1e-15, False, cd.TM, cd.TN, nb,
                                          s))):
        splits = cd.split_count(name, N_BENCH, ns, sms, nb, cd.TN)
        check(splits > 1, f"{name} at N={N_BENCH} is not split")
        got, want = fn(), ref(splits)
        check(torch.equal(got, fn(splits)),
              f"{name}: the wrapper's S is not split_count's {splits}")
        rel, absolute = rel_err(got, want)
        check(rel < 2e-6, f"{name} at N={N_BENCH}: {rel:.2e} >= 2e-6")
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(lambda: ref(splits), 3)
        b = bound(pairs * PAIR_FLOPS[kind], nbytes(tgt, src, start, got),
                  pairs, mufu)
        stats[name] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                           plain_ms=plain_ms, splits=splits, **b)
        log(f"(b) {name} kernel at N={N_BENCH} (nb={nb} of {rows} rows), "
            f"S={splits}, grid {N_BENCH // cd.BLOCK} x {splits} = "
            f"{N_BENCH // cd.BLOCK * splits} blocks: rel err {rel:.2e} "
            f"(tol 2e-6), {ms:.3f} ms vs plain {plain_ms:.3f} ms; "
            f"{pairs / (ms * 1e-3):.6e} pairs/s; {describe(b, ms)}")
    single = cd.split_count("direct", N_BENCH, ns, sms)
    for mode in ("acc", "pot"):
        # the single-pass spline (the fallback branch) at the same shapes
        ms = cuda_ms(lambda: cd._direct_tile(
            tgt, src, "spline", mode, True, 1e-15, mode == "pot"), 5)
        flops = (PAIR_FLOPS if mode == "acc" else POT_FLOPS)["spline"]
        b = bound(N_BENCH * ns * flops, 0, N_BENCH * ns, mufu)
        log(f"(b) single-pass spline {mode} at N={N_BENCH}, S={single}: "
            f"{ms:.3f} ms, {describe(b, ms)}")
    stats["operands"] = (tgt, src, start, nb)

    # kernels vs the fp64 oracle at N = 16,384 (sorted two-pass path).
    # Tolerance 3e-6 * max, the JAX package's kernel-vs-oracle tolerance
    n = 16384
    xv, m = plummer_case(n, 4)
    p = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    mt = torch.tensor(m, dtype=torch.float32, device=dev)
    ht = torch.full((n,), H, dtype=torch.float32, device=dev)
    before = dict(cd.BRANCHES)
    acc = cd.cuda_accel(p, mt, ht, G, "spline", True)
    phi = cd.cuda_potential(p, mt, ht, G, "spline", True)
    check(cd.BRANCHES["two_pass"] == before["two_pass"] + 2,
          "N=16384 did not take the two-pass branch")
    acc64 = compute_forces_direct(p.double(), mt.double(), ht.double(), G=G,
                                  precision="float64")
    phi64 = compute_potential_direct(p.double(), mt.double(), ht.double(),
                                     G=G, precision="float64")
    for what, got, want in (("acc", acc, acc64), ("pot", phi, phi64)):
        rel, _ = rel_err(got, want)
        check(rel < 3e-6, f"{what} vs fp64 at N={n}: {rel:.2e} >= 3e-6")
        log(f"(b) cuda_{'accel' if what == 'acc' else 'potential'} vs fp64 "
            f"oracle at N={n}: rel err {rel:.2e} (tol 3e-6)")
    return stats


def phase_c(dev):
    """One heavy near source first, then 65,535 light far ones, each below
    half an ulp of the running sum: plain fp32 drops them all."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    n = N_BENCH
    rng = np.random.default_rng(9)
    xs = np.empty((n, 3))
    xs[0] = (1.0, 0.0, 0.0)
    xs[1:] = (100.0, 0.0, 0.0) + rng.normal(0, 1.0, (n - 1, 3))
    gm = np.full(n, 5e-6)
    gm[0] = 1.0
    xs32 = xs.astype(np.float32).astype(np.float64)
    gm32 = gm.astype(np.float32).astype(np.float64)
    r = np.linalg.norm(xs32, axis=1)
    exact = (gm32 / r**3 * xs32[:, 0]).sum()
    zero = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    tgt = cd._targets(zero, torch.zeros(1, device=dev))
    src = cd._sources(torch.tensor(xs, dtype=torch.float32, device=dev),
                      torch.tensor(gm, dtype=torch.float32, device=dev),
                      torch.zeros(n, device=dev), cd.TN)
    errs = {}
    for kahan in (True, False):
        # one stream: splits would cut the light sources into partial sums
        # that plain fp32 no longer drops
        a = cd._direct_tile(tgt, src, "newtonian", "acc", kahan, 1e-15,
                            splits=1)
        errs[kahan] = abs(a[0, 0].item() - exact) / abs(exact)
    log(f"(c) Kahan check: rel err {errs[True]:.2e} compensated vs "
        f"{errs[False]:.2e} plain (fp64 sum {exact:.9e})")
    check(errs[True] * 10 < errs[False],
          "compensated sum is not 10x better than plain fp32")


def phase_d(dev):
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch import nbody_io
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    xv, m = plummer_case(N_BENCH, 2)
    species = [nst.Species.dark(N=N_BENCH, mass=float(m[0]), softening=H)]
    solver = nst.DirectGravity(m, np.full(N_BENCH, H), device=dev)

    def energy(xv_):
        pos = torch.tensor(xv_[:, :3], dtype=torch.float32, device=dev)
        phi = solver.potential(pos).double().cpu().numpy()
        return 0.5 * (m * (xv_[:, 3:] ** 2).sum(1)).sum() + \
            0.5 * (m * phi).sum()

    e0 = energy(xv)
    steps = 300
    # snapshots need h5py; without it the run writes only its restart file
    snaps = nbody_io.H5PY_AVAILABLE
    if not snaps:
        log("(d) h5py is not installed: snapshots off, the restart file "
            "is read back instead")
    with tempfile.TemporaryDirectory() as out_dir:
        for key in cd.LAUNCHES:
            cd.LAUNCHES[key] = 0
        for key in cd.BRANCHES:
            cd.BRANCHES[key] = 0
        t0 = time.perf_counter()
        res = nst.run_simulation(
            xv, species, 0.0, steps * DT, DT, architecture="gpu",
            method="direct", output_dir=out_dir, save_snapshots=snaps,
            snapshots=4, debug_energy=True, verbose=True)
        wall = time.perf_counter() - t0
        launches, branches = dict(cd.LAUNCHES), dict(cd.BRANCHES)
        final = res["dark"]
        if snaps:
            reader = nst.ParticleReader(f"{out_dir}/snapshot*.h5")
            saved = reader.read_snapshot(
                int(reader.Snapshots[-1])).dark["posvel"]
        else:
            saved, _, saved_step = nbody_io._load_restart(out_dir)[:3]
            check(saved_step == steps, f"restart at step {saved_step}")
        check(np.array_equal(saved, final),
              "saved state differs from the returned state")
    check(final.shape == (N_BENCH, 6) and np.isfinite(final).all(),
          "final state not finite / wrong shape")
    de = abs((energy(final) - e0) / e0)
    log(f"(d) run_simulation: {steps} steps in {wall:.2f} s, |dE/E| = "
        f"{de:.3e} (limit 1e-4), launches {launches}, branches {branches}")
    check(de < 1e-4, f"|dE/E| = {de:.3e} >= 1e-4")
    check(launches["base"] > 0 and launches["band"] > 0,
          f"main path missed a kernel: {launches}")
    check(branches["two_pass"] > 0, f"two-pass branch never ran: {branches}")
    return launches


def phase_e(dev):
    from nbody_streams_tpu_torch.integrate import (
        init_state, make_accel_fn, make_kdk_step, run_chunk)
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    n = 16384
    xv, m = plummer_case(n, 3)
    finals = {}
    for impl in ("cuda", "torch"):
        solver = DirectGravity(m, np.full(n, H), impl=impl, device=dev)
        accel_fn = make_accel_fn(solver, solver.mass)
        step_fn = make_kdk_step(accel_fn, DT, 0.0)
        state = init_state(xv[:, :3], xv[:, 3:], accel_fn, solver.mass, 0.0,
                           device=dev)
        finals[impl] = run_chunk(step_fn, state, 10)
    for field in ("pos", "vel"):
        a = getattr(finals["cuda"], field)
        b = getattr(finals["torch"], field)
        rel, _ = rel_err(a, b)
        check(rel < 1e-6, f"cuda vs torch {field}: {rel:.2e} >= 1e-6")
        log(f"(e) impl='cuda' vs 'torch', 10 steps at N={n}: {field} rel "
            f"err {rel:.2e} (tol 1e-6)")


def phase_f(dev, smi, name):
    from nbody_streams_tpu_torch import bench

    r = bench.measure(dev, windows=3, steps=100)
    log(f"(f) N={N_BENCH} {r['ms_per_step']:.3f} ms/step (windows "
        f"{', '.join(f'{w:.3f}' for w in r['windows_ms'])} ms), "
        f"{r['gint_per_s']:.2f} Gint/s, |dE/E| = {r['de']:.2e} over "
        f"{r['steps']} steps, on {name} ({smi})")
    log(json.dumps({
        "metric": bench.METRIC, "value": round(r["gint_per_s"], 2),
        "unit": "Gint/s",
        "vs_baseline": round(r["gint_per_s"] / bench.BASELINE_GINT, 3),
        "card": smi}))
    return r


def phase_g(dev, base):
    """Roofline kernels vs plain, then the measurement path."""
    from nbody_streams_tpu_torch import bench
    from nbody_streams_tpu_torch.benchmarks import tile_sweep
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops import probe
    from nbody_streams_tpu_torch.ops import roofline as rl

    t0 = time.perf_counter()
    stats = {}
    # chains: tolerance 1e-5 * max (one FFMA on the card, two roundings in
    # torch; rsqrt within 2 ulp on both sides; the recurrences contract).
    # The kernels line takes the worst error of the checks and the times
    # of the first (the probe's K)
    x = probe.probe_tile(dev)
    for name in ("fma_chain", "rsqrt_chain"):
        fn = getattr(rl, name)
        ref = getattr(rl, f"_{name}_reference")
        for K, passes in CHAIN_CHECKS:
            got, want = fn(x, K, passes), ref(x, K, passes)
            check(torch.isfinite(got).all().item(), f"{name} not finite")
            rel, absolute = rel_err(got, want)
            check(rel < 1e-5, f"{name} K={K}: {rel:.2e} >= 1e-5")
            if name not in stats:
                links = x.numel() * K * passes
                # fma: 2 FP32 ops a link; rsqrt: one MUFU rsqrt and an
                # add a link
                flops, rsqrts = ((2 * links, 0) if name == "fma_chain"
                                 else (links, links))
                stats[name] = dict(
                    max_abs_err=absolute, rel=rel,
                    ms=cuda_ms(lambda: fn(x, K, passes), 10),
                    plain_ms=cuda_ms(lambda: ref(x, K, passes), 1),
                    **bound(flops, 2 * nbytes(x), rsqrts, mufu_rate(dev)))
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             absolute)
            log(f"(g) {name}_kernel on (512, 512), K={K}, {passes} passes: "
                f"rel err {rel:.2e}, abs {absolute:.3e} (tol 1e-5 rel)")
        log(f"(g) {name}_kernel at K={CHAIN_CHECKS[0][0]}, "
            f"{CHAIN_CHECKS[0][1]} passes: {stats[name]['ms']:.3f} ms vs "
            f"plain {stats[name]['plain_ms']:.3f} ms")
    # tile_sol at the base pass's shape on the bench operands: 2e-6 * max
    # (the Kahan tolerance of direct_tile_kernel)
    tgt, src, _, nb = base["operands"]
    blocks = tgt.shape[1] // 64
    for kind in ("newtonian", "spline"):
        def sol(kind=kind):
            return rl.tile_sol(tgt, src, kind, blocks, SOL_CHECK_REPS)

        def plain(kind=kind):
            return rl._tile_sol_reference(tgt, src, kind, blocks,
                                          SOL_CHECK_REPS)

        got, want = sol(), plain()
        rel, absolute = rel_err(got, want)
        check(torch.isfinite(got).all().item(), f"tile_sol {kind}")
        check(rel < 2e-6, f"tile_sol {kind}: {rel:.2e} >= 2e-6")
        ms, plain_ms = cuda_ms(sol, 10), cuda_ms(plain, 1)
        if kind == "newtonian":
            stats["tile_sol"] = dict(max_abs_err=absolute, rel=rel)
        log(f"(g) tile_sol_kernel<{kind}> at {blocks} blocks, "
            f"{SOL_CHECK_REPS} reps: rel err {rel:.2e} (tol 2e-6), "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    # the moment tile (7m) at the same shape, on random targets and
    # sources apart (the bench operands hold each block's own particles,
    # whose self pairs the moment form would sum as ~1/eps2^1.5, as the
    # TPU's moment form would): its moments before the finalisation
    # within MOMENT_TOL of its plain version, no cancellation to excuse
    mom_t, mom_s = tile_sweep.sol_operands("newtonian", tgt.shape[1],
                                           64 * 64, dev)

    def sol_moment():
        return rl.tile_sol(mom_t, mom_s, "newtonian", blocks, SOL_CHECK_REPS,
                           mxu=True)

    got = sol_moment()
    rel, absolute = rel_err(got, rl._tile_sol_moment_reference(
        mom_t, mom_s, "newtonian", blocks, SOL_CHECK_REPS))
    check(torch.isfinite(got).all().item() and rel < MOMENT_TOL,
          f"tile_sol_moment: {rel:.2e} >= {MOMENT_TOL}")
    stats["tile_sol_moment"] = dict(max_abs_err=absolute, rel=rel)
    log(f"(g) tile_sol_moment_kernel at {blocks} blocks, {SOL_CHECK_REPS} "
        f"reps: rel err {rel:.2e} (tol {MOMENT_TOL:g}), "
        f"{cuda_ms(sol_moment, 10):.3f} ms")

    # the measurement path, its launch counts zeroed just before
    for key in rl.LAUNCHES:
        rl.LAUNCHES[key] = 0
    tops = probe.delivered_tops(device=dev)
    torch_tops, cuda_tops = bench._capacity_probe(device=dev)
    roof = tile_sweep.roofline(dev)
    # "base": the launch shape of the pass it bounds, N / 64 x S blocks
    grids = {"newtonian": blocks * base["direct"]["splits"],
             "spline": blocks * base["band"]["splits"]}
    sols = {(kind, shape): tile_sweep.sol(
                kind, grids[kind] if shape == "base" else None, SOL_REPS, dev)
            for kind in ("newtonian", "spline") for shape in ("base", "full")}
    # the moment tile at kernel M's base-pass shape (its S is row 1's)
    sols.update({("moment", shape): tile_sweep.sol(
        "newtonian", grids["newtonian"] if shape == "base" else None,
        SOL_REPS, dev, mxu=True) for shape in ("base", "full")})
    launches = dict(rl.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"measurement path missed a kernel: {launches}")

    peaks = probe.card_peaks(dev)
    fp32, mufu = peaks["fp32_ops_per_s"], peaks["mufu_per_s"]
    log(f"(g) card peaks from {peaks['sms']} SMs at {peaks['max_sm_mhz']:.0f} "
        f"MHz max: FP32 {fp32 / 1e12:.2f} TFLOP/s, MUFU "
        f"{mufu / 1e12:.3f} T/s")
    readings = [("delivered_tops fma", tops * 1e12, fp32),
                ("capacity probe fma_chain_kernel", cuda_tops * 1e12, fp32),
                ("roofline fma", roof["fma"]["g_ops_per_s"] * 1e9, fp32),
                ("roofline rsqrt", roof["rsqrt"]["g_lanes_per_s"] * 1e9,
                 mufu)]
    readings += [(f"tile_sol {kind} {shape} ({r['blocks']} blocks) pairs",
                  r["g_pairs_per_s"] * 1e9, mufu)
                 for (kind, shape), r in sols.items()]
    readings += [(f"tile_sol_moment {shape} ({sols[('moment', shape)]['blocks']}"
                  " blocks) TF32 FLOPs", sols[("moment", shape)]["g_pairs_per_s"]
                  * 1e9 * TENSOR_FLOPS["fold"], PEAK_TF32)
                 for shape in ("base", "full")]
    for what, rate, peak in readings:
        check(np.isfinite(rate) and 0 < rate <= 1.05 * peak,
              f"{what}: {rate:.4e}/s is not within (0, 1.05 x peak "
              f"{peak:.4e}]")
        log(f"(g) {what}: {rate:.6e}/s = {rate / peak:.4f} of peak")
    log(f"(g) capacity probe: plain torch chain {torch_tops:.5f} Top/s, "
        f"fma_chain_kernel {cuda_tops:.4f} Top/s")
    # the kernels line's tile_sol: newtonian at full occupancy, the shape
    # where it bounds the base pass, with its plain version and its bound
    # at that shape (the error is the check's above)
    full = sols[("newtonian", "full")]
    sol_t, sol_s = tile_sweep.sol_operands("newtonian", full["blocks"] * 64,
                                           64 * 64, dev)
    pairs = full["blocks"] * 64 * 64 * SOL_REPS
    plain_ms = cuda_ms(lambda: rl._tile_sol_reference(
        sol_t, sol_s, "newtonian", full["blocks"], SOL_REPS), 1)
    b = bound(pairs * PAIR_FLOPS["newtonian"],
              nbytes(sol_t, sol_s) + full["blocks"] * 64 * 3 * 4, pairs,
              mufu)
    stats["tile_sol"].update(ms=full["ms"], plain_ms=plain_ms,
                             blocks=full["blocks"], reps=SOL_REPS, **b)
    log(f"(g) tile_sol_kernel<newtonian> at full occupancy "
        f"({full['blocks']} blocks, {SOL_REPS} reps): {full['ms']:.3f} ms "
        f"vs plain {plain_ms:.3f} ms; {describe(b, full['ms'])}")
    # and 7m's, at its own full occupancy (kernel M's terms a pair: the
    # FP32 operations, one rsqrt, the tensor FLOPs)
    full = sols[("moment", "full")]
    sol_t, sol_s = tile_sweep.sol_operands("newtonian", full["blocks"] * 64,
                                           64 * 64, dev)
    pairs = full["blocks"] * 64 * 64 * SOL_REPS
    plain_ms = cuda_ms(lambda: rl._tile_sol_moment_reference(
        sol_t, sol_s, "newtonian", full["blocks"], SOL_REPS), 1)
    b = bound(pairs * MOMENT_FLOPS["fold"],
              nbytes(sol_t, sol_s) + full["blocks"] * 64 * 4 * 4, pairs,
              mufu, pairs * TENSOR_FLOPS["fold"])
    stats["tile_sol_moment"].update(ms=full["ms"], plain_ms=plain_ms,
                                    blocks=full["blocks"], reps=SOL_REPS,
                                    **b)
    log(f"(g) tile_sol_moment_kernel at full occupancy ({full['blocks']} "
        f"blocks, {SOL_REPS} reps): {full['ms']:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; {describe(b, full['ms'])}")

    # base and band passes (phase b) as fractions of the speed of light
    nt, ns = tgt.shape[1], src.shape[1]
    base_pairs = nt * (ns - nb * cd.TN) / (base["direct"]["ms"] * 1e-3)
    # the base pass itself at full occupancy: OCC_COPIES copies of the
    # targets (and of their band windows) against the same sources at the
    # same S, the same work per block in OCC_COPIES times the blocks
    start = base["operands"][2]
    tgt_n, start_n = tgt.repeat(1, OCC_COPIES), start.repeat(OCC_COPIES)
    splits = base["direct"]["splits"]

    def base_pass(t, s):
        return cd._direct_tile(t, src, "newtonian", "acc", True, 1e-15, False,
                               nb, s, splits=splits)

    check(torch.equal(base_pass(tgt_n, start_n)[:nt], base_pass(tgt, start)),
          "base pass over copied targets differs from the base pass")
    own_ms = cuda_ms(lambda: base_pass(tgt, start), 20)
    full_ms = cuda_ms(lambda: base_pass(tgt_n, start_n), 5)
    own_pairs = nt * (ns - nb * cd.TN) / (own_ms * 1e-3)
    full_pairs = OCC_COPIES * nt * (ns - nb * cd.TN) / (full_ms * 1e-3)
    log(f"(g) base pass occupancy at S={splits}: {nt // cd.BLOCK * splits} "
        f"blocks {own_ms:.3f} ms, {own_pairs:.6e} pairs/s; "
        f"{OCC_COPIES * nt // cd.BLOCK * splits} blocks {full_ms:.3f} ms, "
        f"{full_pairs:.6e} pairs/s; own shape / full = "
        f"{own_pairs / full_pairs:.4f}")
    band_pairs = nt * nb * cd.TN / (base["band"]["ms"] * 1e-3)
    for shape in ("base", "full"):
        sn = sols[("newtonian", shape)]["g_pairs_per_s"] * 1e9
        ss = sols[("spline", shape)]["g_pairs_per_s"] * 1e9
        log(f"(g) speed of light at the {shape} shape: base pass "
            f"{base_pairs:.6e} pairs/s = {base_pairs / sn:.4f} of "
            f"tile_sol newtonian; band pass {band_pairs:.6e} pairs/s = "
            f"{band_pairs / ss:.4f} of tile_sol spline")
    sn = sols[("newtonian", "full")]["g_pairs_per_s"] * 1e9
    log(f"(g) base pass at full occupancy: {full_pairs / sn:.4f} of "
        "tile_sol newtonian at full occupancy")
    # kernel M (row 1m, folded) as a fraction of 7m, beside row 1's of
    # row 7: at its own shape against both of 7m's, and at full occupancy
    # (the same OCC_COPIES copies) against 7m's full occupancy
    def moment_pass(t, s):
        return cd._moment_tile(t, src, "newtonian", "acc", True, 1e-15, True,
                               False, nb=nb, start=s, splits=splits)

    m_own = cuda_ms(lambda: moment_pass(tgt, start), 20)
    m_full = cuda_ms(lambda: moment_pass(tgt_n, start_n), 5)
    m_pairs = nt * (ns - nb * cd.TN) / (m_own * 1e-3)
    m_full_pairs = OCC_COPIES * nt * (ns - nb * cd.TN) / (m_full * 1e-3)
    stats["m_vs_sol"] = {}
    for shape in ("base", "full"):
        sm = sols[("moment", shape)]["g_pairs_per_s"] * 1e9
        sn = sols[("newtonian", shape)]["g_pairs_per_s"] * 1e9
        stats["m_vs_sol"][shape] = dict(m=m_pairs / sm, row1=own_pairs / sn)
        log(f"(g) kernel M at its own shape ({m_own:.4f} ms, "
            f"{m_pairs:.6e} pairs/s) = {m_pairs / sm:.4f} of tile_sol_moment"
            f" at the {shape} shape ({sm:.6e} pairs/s); row 1 = "
            f"{own_pairs / sn:.4f} of tile_sol newtonian there")
    sm = sols[("moment", "full")]["g_pairs_per_s"] * 1e9
    stats["m_vs_sol"]["occupancy"] = m_full_pairs / sm
    log(f"(g) kernel M at full occupancy ({OCC_COPIES} copies, "
        f"{m_full:.3f} ms): {m_full_pairs / sm:.4f} of tile_sol_moment at "
        f"full occupancy (row 1: {full_pairs / sn:.4f} of tile_sol "
        "newtonian)")
    log(f"(g) wall {time.perf_counter() - t0:.1f} s")
    return stats, launches


def phase_h(dev, base):
    from nbody_streams_tpu_torch import bench_suite
    from nbody_streams_tpu_torch.benchmarks import tile_sweep
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    t0 = time.perf_counter()
    res = tile_sweep.sweep(N_BENCH, 10, tile_sweep.GEOMS_64K, dev)
    ref = res[(512, 512)]["acc"]
    for (tm, tn), r in res.items():
        rel, _ = rel_err(r["acc"], ref)
        check(rel < 2e-6, f"sweep {tm}/{tn}: {rel:.2e} >= 2e-6 of 512/512")
        log(f"(h) sweep tm={tm} tn={tn}: {r['ms_per_eval']:.3f} ms/eval, "
            f"{r['gint_per_s']:.2f} Gint/s ({r['branch']}), rel err vs "
            f"512/512 {rel:.2e} (tol 2e-6)")
    out = bench_suite.main(["-N", str(N_BENCH), "--reps", "3",
                            "--sections", "1,2,3"])
    for precision, row in out["section3"].items():
        check(row["max_rel_err"] <= 3e-6,
              f"bench_suite {precision}: {row['max_rel_err']:.2e} > 3e-6")
    # row 2 of the kernel table: the single-pass kernel's plain version
    tgt, src = base["operands"][:2]
    plain_ms = cuda_ms(lambda: cd._direct_tile_reference(
        tgt, src, "spline", "acc", True, 1e-15), 1)
    log(f"(h) single-pass spline acc plain version at N={N_BENCH}: "
        f"{plain_ms:.3f} ms")
    log(f"(h) wall {time.perf_counter() - t0:.1f} s")


def kdk_ms(dev, pot=None, orbit=None, t0=0.0, steps=2):
    """Best ms/step of 2 windows of 20 KDK steps of the bench case
    (``bench.measure``) with ``pot`` (or none) as the external field; then
    the card's device ms a step from ``steps`` more steps under
    torch.profiler, split into the two-pass kernels (with their combines)
    and the rest (the field and the sorted path's host side)."""
    from nbody_streams_tpu_torch import bench

    r = bench.measure(dev, windows=2, steps=20, external_potential=pot,
                      orbit=orbit, t0=t0, profile_steps=steps)
    device, seen = {"gravity": 0.0, "rest": 0.0}, 0
    for e in r["profile"].events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            seen += "direct_tile" in e.name or "band_kernel" in e.name
            key = ("gravity" if any(k in e.name for k in (
                "direct_tile", "band_kernel", "combine_kernel")) else "rest")
            device[key] += e.device_time / (steps * 1e3)
    # every step runs the base and the band pass once; the profiler can
    # drop a window's kernel records: then the device split is not measured
    return r["ms_per_step"], (device if seen == 2 * steps else None)


def phase_i(dev, bench_ms):
    """The external-potential path on the card."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch.benchmarks.fields import (
        T_LMC, field_builders, field_points, profile_call)
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.potentials import fit

    t_phase = time.perf_counter()
    builders = field_builders()
    fields, stats = {}, {}
    x32 = field_points(N_BENCH)
    xg = torch.tensor(x32, device=dev)
    xc = torch.tensor(x32.astype(np.float64))
    for name, (build, times) in builders.items():
        t0 = time.perf_counter()
        pot64 = build()
        build_s = time.perf_counter() - t0
        gpu = copy.deepcopy(pot64).to(dev, torch.float32)
        fields[name] = (pot64, gpu)
        tol_f, tol_p = FIELD_TOL[name]
        worst = (0.0, 0.0)
        for t in times:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                f = gpu.force(xg, t)
                phi = gpu.potential(xg, t)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(f.is_cuda and f.dtype == torch.float32
                  and f.shape == (N_BENCH, 3), f"{name}: force {f.dtype}")
            check(torch.isfinite(f).all().item()
                  and torch.isfinite(phi).all().item(),
                  f"{name}: not finite at t={t}")
            ef, _ = rel_err(f.cpu(), pot64.force(xc, t))
            ep, _ = rel_err(phi.cpu(), pot64.potential(xc, t))
            log(f"(i) {name} t={t}: float32 card vs float64 CPU at "
                f"{N_BENCH} points: force {ef:.3e} (tol {tol_f:g}), "
                f"potential {ep:.3e} (tol {tol_p:g}); no host sync in "
                "force")
            check(ef < tol_f and ep < tol_p,
                  f"{name} t={t}: {ef:.3e} / {ep:.3e} over tolerance")
            worst = (max(worst[0], ef), max(worst[1], ep))
        t = times[0]
        rec = profile_call(lambda: gpu.force(xg, t), 5)
        ms_pot = cuda_ms(lambda: gpu.potential(xg, t), 5)
        stats[name] = dict(**rec, ms_potential=ms_pot, build_s=build_s,
                           err=worst)
        log(f"(i) {name}: built in {build_s:.2f} s; force "
            f"{rec['wall_median_ms']:.4f} ms (median of 5; least "
            f"{rec['wall_min_ms']:.4f}), potential {ms_pot:.4f} ms at "
            f"N={N_BENCH}; per force {rec['launches']} CUDA kernel "
            f"launches, {rec['device_ms']:.4f} ms of device time, busy "
            f"share {rec['busy_share']:.3f} (torch.profiler)")

    # TF32 cannot enter: CylSpline's bicubic contraction is elementwise
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pot64, gpu = fields["FIRE BFE"]
        ef, _ = rel_err(gpu.force(xg, 0.0).cpu(), pot64.force(xc, 0.0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(ef < FIELD_TOL["FIRE BFE"][0], f"FIRE BFE with TF32 on: {ef:.3e}")
    log(f"(i) FIRE BFE with allow_tf32=True: force {ef:.3e} (tol "
        f"{FIELD_TOL['FIRE BFE'][0]:g})")

    # a loader's default is the card: numpy positions are evaluated there
    pot = nst.potentials.load_mw_lmc_potential()[0]
    check(all(b.is_cuda for b in pot.buffers())
          and pot.force(x32[:8], T_LMC).is_cuda,
          "load_mw_lmc_potential() did not build on the card")
    log("(i) load_mw_lmc_potential() built on the card; numpy positions "
        "evaluated there")

    xv, m = plummer_case(N_BENCH, 2)
    species = [nst.Species.dark(N=N_BENCH, mass=float(m[0]), softening=H)]
    solver = nst.DirectGravity(m, np.full(N_BENCH, H), device=dev)
    launches = {}

    def run(xv0, pot, t0, steps, out_dir, path):
        for key in cd.LAUNCHES:
            cd.LAUNCHES[key] = 0
        for key in cd.BRANCHES:
            cd.BRANCHES[key] = 0
        t = time.perf_counter()
        res = nst.run_simulation(
            xv0, species, t0, t0 + steps * DT, DT, architecture="gpu",
            method="direct", external_potential=pot, output_dir=out_dir,
            save_snapshots=False, verbose=False)["dark"]
        wall = time.perf_counter() - t
        launches[path] = dict(cd.LAUNCHES)
        check(cd.LAUNCHES["base"] == steps + 1
              and cd.LAUNCHES["band"] == steps + 1
              and cd.LAUNCHES["single"] == 0,
              f"{path}: not every force call ran both two-pass kernels: "
              f"{cd.LAUNCHES}, {cd.BRANCHES}")
        check(res.shape == (N_BENCH, 6) and np.isfinite(res).all(),
              f"{path}: final state")
        return res, wall

    def energy(xv_, pot64, t):
        pos = torch.tensor(xv_[:, :3], dtype=torch.float32, device=dev)
        self_phi = solver.potential(pos).double().cpu().numpy()
        ext = pot64.potential(torch.tensor(xv_[:, :3]), t).numpy()
        return (0.5 * (m * (xv_[:, 3:] ** 2).sum(1)).sum()
                + 0.5 * (m * self_phi).sum() + (m * ext).sum())

    # static field: energy with the field's term
    pot64 = fields["McMillan17_streams"][0]
    xv0 = xv + ORBIT_MW
    steps = 300
    with tempfile.TemporaryDirectory() as out_dir:
        res, wall = run(xv0, pot64, 0.0, steps, out_dir, "mcmillan17")
    e0, e1 = energy(xv0, pot64, 0.0), energy(res, pot64, steps * DT)
    de = abs((e1 - e0) / e0)
    log(f"(i) run_simulation in McMillan17_streams: {steps} steps in "
        f"{wall:.2f} s, |dE/E| = {de:.3e} (limit 1e-4, E with the field's "
        f"energy), launches {launches['mcmillan17']}")
    check(de < 1e-4, f"McMillan17 |dE/E| = {de:.3e} >= 1e-4")

    # time-dependent field: the centre of mass on the fp64 orbit of a point
    pot64 = fields["MW+LMC"][0]
    xv0 = xv + ORBIT_LMC
    steps = 100
    with tempfile.TemporaryDirectory() as out_dir:
        res, wall = run(xv0, pot64, T_LMC, steps, out_dir, "mw_lmc")
    point = torch.tensor(xv0.mean(0)[None, :])
    acc = pot64.force(point[:, :3], T_LMC)
    for k in range(steps):
        point[:, 3:] += 0.5 * DT * acc
        point[:, :3] += DT * point[:, 3:]
        acc = pot64.force(point[:, :3], T_LMC + (k + 1) * DT)
        point[:, 3:] += 0.5 * DT * acc
    point = point[0].numpy()
    dx = np.abs(res[:, :3].mean(0) - point[:3]).max()
    dv = np.abs(res[:, 3:].mean(0) - point[3:]).max()
    log(f"(i) run_simulation in MW+LMC from t={T_LMC}: {steps} steps in "
        f"{wall:.2f} s; centre of mass vs the fp64 point orbit: "
        f"{dx:.3e} kpc (tol 1e-3), {dv:.3e} km/s; moved "
        f"{np.abs(point[:3] - xv0[:, :3].mean(0)).max():.4f} kpc; "
        f"launches {launches['mw_lmc']}")
    check(dx < 1e-3, f"MW+LMC centre of mass {dx:.3e} kpc off its orbit")

    # the KDK step with and without the field (the bench case's loop)
    plain_ms, plain_dev = kdk_ms(dev)
    field_ms, field_dev = kdk_ms(dev, fields["MW+LMC"][1], ORBIT_LMC, T_LMC)
    share = (field_ms - plain_ms) / field_ms

    def split(device, ms):
        if device is None:
            return "not measured (the profiler lost kernel records)"
        return (f"two-pass kernels {device['gravity']:.3f}, the rest "
                f"{device['rest']:.3f}, the card busy "
                f"{sum(device.values()) / ms:.3f} of the step")

    log(f"(i) KDK step at N={N_BENCH}: {plain_ms:.3f} ms/step without a "
        f"field, {field_ms:.3f} ms/step in the MW+LMC field (phase f's "
        f"bench case: {bench_ms:.3f}); the field's share of the step "
        f"{share:.3f} (its force alone "
        f"{stats['MW+LMC']['wall_median_ms']:.3f} ms); device ms a step "
        f"without the field: {split(plain_dev, plain_ms)}; in the field: "
        f"{split(field_dev, field_ms)}")
    stats["kdk"] = dict(plain_ms=plain_ms, field_ms=field_ms, share=share,
                        plain_device=plain_dev, field_device=field_dev)

    # the fit's kernel: the two-set potential kernel on the probe grid
    pos = res[:, :3] - res[:, :3].mean(0)
    for key in cd.LAUNCHES:
        cd.LAUNCHES[key] = 0
    t = time.perf_counter()
    coefs = fit.fit_cylspline_from_particles(pos, m, softening=H,
                                             device=dev)
    fit_s = time.perf_counter() - t
    fit_launches = cd.LAUNCHES["single"]
    check(fit_launches > 0, "the fit launched no kernel")
    fitted = nst.potentials.CylSplinePotential(coefs)
    check(np.isfinite(fitted.potential(np.array([[1.0, 0.5, 0.2]]))).all(),
          "fitted CylSpline not finite")
    _, _, _, probes = fit.cylspline_grid(pos)
    kind = "plummer"
    pre_t = cd._soft_pre(kind, torch.zeros(len(probes), device=dev))
    tgt = cd._targets(torch.tensor(probes, dtype=torch.float32, device=dev),
                      pre_t)
    src = cd._sources(
        torch.tensor(pos, dtype=torch.float32, device=dev),
        torch.tensor(m * 4.300917270069976e-06, dtype=torch.float32,
                     device=dev),
        cd._soft_pre(kind, torch.full((N_BENCH,), H, device=dev)), cd.TN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cd.split_count("direct", tgt.shape[1], src.shape[1], sms)

    def kernel():
        return cd._direct_tile(tgt, src, kind, "pot", True, 1e-15)

    def plain():
        return cd._direct_tile_reference(tgt, src, kind, "pot", True, 1e-15,
                                         splits=splits)

    got, want = kernel(), plain()
    rel, absolute = rel_err(got, want)
    check(rel < 2e-6, f"fit kernel vs plain: {rel:.2e} >= 2e-6")
    ms, plain_ms = cuda_ms(kernel, 10), cuda_ms(plain, 1)
    pairs = tgt.shape[1] * N_BENCH
    b = bound(pairs * POT_FLOPS[kind], nbytes(tgt, src, got), pairs,
              mufu_rate(dev))
    stats["fit"] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                        plain_ms=plain_ms, splits=splits, s=fit_s,
                        launches=fit_launches, **b)
    log(f"(i) fit_cylspline_from_particles: {fit_s:.2f} s, "
        f"{tgt.shape[1]} probes x {N_BENCH} sources, {fit_launches} "
        f"launch(es) of the two-set kernel; two-set potential kernel ({kind}, Kahan, "
        f"S={splits}) vs plain: rel err {rel:.2e} (tol 2e-6), {ms:.3f} ms "
        f"vs plain {plain_ms:.3f} ms; {POT_FLOPS[kind]} FP32 ops a pair, "
        f"{describe(b, ms)}")
    log(f"(i) wall {time.perf_counter() - t_phase:.1f} s")
    return stats, launches


def df_case():
    """The DF tutorial's satellite: Plummer N = 65,536, M = 5e9, a = 0.5,
    at +40 kpc in x and +120 km/s in v_y (seed 4)."""
    from nbody_streams_tpu_torch import make_plummer_sphere

    xv, m = make_plummer_sphere(N_BENCH, M_total=5e9, a=0.5, seed=4)
    xv[:, 0] += 40.0
    xv[:, 4] += 120.0
    return xv, m


def profile_launches(fn):
    """(CUDA kernels launched, their device ms) of one call under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


def df_friction(host, kw):
    """The friction of a DF_RUNS entry, built as run_simulation builds
    it (before the run moves its own copy to the card)."""
    from nbody_streams_tpu_torch.friction import make_df_force_extra

    return make_df_force_extra(
        host, M_sat=kw["df_M_sat"], t_start=0.0, t_end=DF_STEPS * DF_DT,
        **{k.removeprefix("df_"): v for k, v in kw.items()
           if k != "df_M_sat"})


def phase_j(dev):
    """Dynamical friction on the card, through run_simulation."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch import bench
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
    from nbody_streams_tpu_torch.potentials import NFWPotential

    t_phase = time.perf_counter()
    # the bare class, as the example writes it: built on the CPU in
    # float64, so the run moves its own copies (field and friction)
    host = NFWPotential(mass=1e12, scaleRadius=20.0)
    xv, m = df_case()
    species = [nst.Species.dark(N=N_BENCH, mass=float(m[0]), softening=H)]
    launches, radius, stats = {}, {}, {}
    for path, kw in DF_RUNS.items():
        for key in cd.LAUNCHES:
            cd.LAUNCHES[key] = 0
        for key in cd.BRANCHES:
            cd.BRANCHES[key] = 0
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            res = nst.run_simulation(
                xv, species, 0.0, DF_STEPS * DF_DT, DF_DT,
                architecture="gpu", external_potential=host,
                dynamical_friction=bool(kw), output_dir=out_dir,
                save_snapshots=False, verbose=False, **kw)["dark"]
            wall = time.perf_counter() - t0
        launches[path] = dict(cd.LAUNCHES)
        branches = dict(cd.BRANCHES)
        check(res.shape == (N_BENCH, 6) and np.isfinite(res).all(),
              f"{path}: final state")
        radius[path] = float(np.linalg.norm(res[:, :3].mean(0)))
        per_step = {k: v / DF_STEPS for k, v in launches[path].items()}
        stats[path] = dict(wall_ms_per_step=1e3 * wall / DF_STEPS,
                           launches_per_step=per_step, branches=branches)
        log(f"(j) run_simulation {path}: {DF_STEPS} steps in {wall:.2f} s "
            f"({1e3 * wall / DF_STEPS:.3f} ms/step wall), final centre "
            f"of mass at {radius[path]:.4f} kpc (from 40); launches a "
            f"step: base pass {per_step['base']:.4f}, band pass "
            f"{per_step['band']:.4f}, single pass {per_step['single']:.4f} "
            f"(branches {branches})")
    check(all(b.device.type == "cpu" for b in host.buffers()),
          "the caller's field was moved")
    for path in ("df_shrinking_sphere", "df_bound_phi"):
        check(radius[path] < radius["df_off"],
              f"{path}: {radius[path]:.4f} kpc is not inside the DF-off "
              f"run's {radius['df_off']:.4f} kpc")

    # the KDK loop of each run (bench.measure: the DF case, the host field
    # and the friction moved as run_nbody moves them), best of 3 windows
    # of 20 steps after 100 warm-up steps
    loops = {}
    for path, kw in DF_RUNS.items():
        loops[path] = bench.measure(
            dev, windows=3, steps=20, case=(xv, m), external_potential=host,
            force_extra=df_friction(host, kw) if kw else None, dt=DF_DT,
            warmup=100)
        stats[path]["kdk_ms"] = loops[path]["ms_per_step"]
        log(f"(j) KDK step {path}: {stats[path]['kdk_ms']:.3f} ms/step "
            "(best of 3 x 20)")

    # the friction term at step 100 of the bound_phi loop, on that loop's
    # state and friction: float32 on the card against float64 on the CPU
    loop = loops["df_bound_phi"]
    state, solver, fx = loop["warm"], loop["solver"], loop["force_extra"]
    check(state.step == 100, f"the warm state is at step {state.step}")
    t = 100 * DF_DT
    phi = solver.potential(state.pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc32, st32 = fx(state.extra_state, state.pos, state.vel,
                         solver.mass, t, phi=phi, step=100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    phi64 = DirectGravity(m, np.full(N_BENCH, H), precision="float64",
                          device=dev).potential(state.pos.double()).cpu()
    fx64 = df_friction(host, DF_RUNS["df_bound_phi"]).to("cpu",
                                                         torch.float64)
    extra64 = {k: (v.cpu().double() if isinstance(v, torch.Tensor)
                   and v.is_floating_point() else
                   v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in state.extra_state.items()}
    acc64, st64 = fx64(extra64, state.pos.double().cpu(),
                       state.vel.double().cpu(), torch.tensor(m), t,
                       phi=phi64, step=100)
    a32, a64 = st32["a_df"].double().cpu(), st64["a_df"]
    err = float((a32 - a64).norm() / a64.norm())
    flips = int((st32["bound"].cpu() != st64["bound"]).sum())
    check(acc32.is_cuda and acc32.dtype == torch.float32
          and torch.isfinite(acc32).all().item(), "friction term on the card")
    log(f"(j) friction at step 100 of df_bound_phi: a_df float32 card "
        f"{a32.numpy()} vs float64 CPU {a64.numpy()}: |da|/|a| {err:.3e} "
        f"(tol {DF_TOL:g}); bound {int(st64['bound'].sum())} of {N_BENCH}, "
        f"{flips} differ; M_bound {float(st32['m_bound']):.6e} vs "
        f"{float(st64['m_bound']):.6e}; no host sync in __call__")
    check(err < DF_TOL, f"friction float32 error {err:.3e} >= {DF_TOL}")
    check(flips <= N_BENCH // 10000, f"{flips} bound flags differ")

    # launches the friction term adds: a full update (step 100) and a
    # predictor step (step 101), and per step at update_interval 10
    friction = {}
    for label, step in (("update", 100), ("predictor", 101)):
        friction[label] = profile_launches(lambda s=step: fx(
            state.extra_state, state.pos, state.vel, solver.mass, t,
            phi=phi, step=s))
    per_step = (friction["update"][0] + 9 * friction["predictor"][0]) / 10
    log(f"(j) the friction term's launches: {friction['update'][0]} a full "
        f"update ({friction['update'][1]:.4f} device ms), "
        f"{friction['predictor'][0]} a predictor step "
        f"({friction['predictor'][1]:.4f} device ms): {per_step:.1f} a "
        f"step at update_interval 10")
    stats["friction_launches"] = dict(update=friction["update"][0],
                                      predictor=friction["predictor"][0],
                                      per_step=per_step)

    log(f"(j) wall {time.perf_counter() - t_phase:.1f} s")
    return stats, launches


def ladder_record():
    """{(nmax, lmax): (median, p99)} from docs/runs/scf_ladder.txt."""
    out = {}
    text = (Path(__file__).resolve().parent / LADDER_RECORD).read_text()
    for line in text.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            out[(r["nmax"], r["lmax"])] = (r["median_rel_err"],
                                           r["p99_rel_err"])
    return out


def hernquist_sample(rng, n, a, m_tot, center):
    u = rng.uniform(0, 1, n)
    s = np.clip(np.sqrt(u) / (1 - np.sqrt(u)), 0, 50)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return a * s[:, None] * d + np.asarray(center), np.full(n, m_tot / n)


def phase_k(dev):
    """The SCF tier and the samplers on the card."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch.benchmarks import scf as scf_bench
    from nbody_streams_tpu_torch.fast_sims import king
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops import scf as ts
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    t_phase = time.perf_counter()
    stats, launches = {}, {}
    # float32 vs float64 at N = 1M, TF32 off and switched on globally
    xv, m = plummer_case(N_SCF, 7)
    s64 = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, precision="float64",
                        device=dev)
    p64 = torch.tensor(xv[:, :3], device=dev)
    want = (s64.accel(p64), s64.potential(p64))
    s32 = ts.SCFGravity(m, nmax=8, lmax=4, a=1.0, device=dev)
    p32 = p64.float()
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = (s32.accel(p32), s32.potential(p32))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        errs = [rel_err(g, w)[0] for g, w in zip(got, want)]
        log(f"(k) SCFGravity(8, 4) float32 vs float64 on the card at "
            f"N={N_SCF}, allow_tf32={tf32}: accel {errs[0]:.3e}, potential "
            f"{errs[1]:.3e} (tol {SCF_TOL[0]:g}, {SCF_TOL[1]:g})")
        check(errs[0] < SCF_TOL[0] and errs[1] < SCF_TOL[1],
              f"SCF float32 error with allow_tf32={tf32}: {errs}")
        stats[f"fp32_err_tf32_{tf32}"] = errs
    # what the guard keeps out: the two contractions with TF32 allowed and
    # no guard (the coefficients, then the potential from them)
    R, B = ts._basis_rows(p32, 1.0, 8, 4, s32.labels, s32._harm)
    mR = (s32.mass[:, None] * R).T
    A = s32._coefs(p32)
    tight = (torch.matmul(mR, B), ts._phi_of(p32, A, 1.0, s32.G, 8, 4,
                                             s32.labels, s32._harm))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loose = (torch.matmul(mR, B), ts._phi_of(p32, A, 1.0, s32.G, 8, 4,
                                                 s32.labels, s32._harm))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    unguarded = [rel_err(lo, ti)[0] for lo, ti in zip(loose, tight)]
    log(f"(k) without the guard, TF32 allowed: the coefficient "
        f"contraction {unguarded[0]:.3e} and the potential "
        f"{unguarded[1]:.3e} of max off IEEE fp32")
    stats["tf32_unguarded"] = unguarded
    del R, B, mR, A, loose, tight, want, p64, s64

    # ms per force, launches and device ms per force, ms per KDK step
    rec = scf_bench.run_speed(ns=(N_SCF,), device=dev)[0]
    stats["speed"] = rec
    log(f"(k) SCF speed at N={N_SCF}, (8, 4): {rec['ms_per_force_eval']:.3f} "
        f"ms a force (least {rec['ms_per_force_eval_min']:.3f}), "
        f"{rec['launches_per_force']} CUDA launches and "
        f"{rec['device_ms_per_force']:.3f} device ms a force, busy share "
        f"{rec['busy_share']:.3f}; {rec['ms_per_kdk_step']:.3f} ms a KDK "
        f"step; peak {rec['peak_gb']:.2f} GB")

    # the ladder against the direct Plummer-law sum (single-pass kernel)
    for key in cd.LAUNCHES:
        cd.LAUNCHES[key] = 0
    rows = scf_bench.run_ladder(device=dev)
    launches["scf_ladder"] = dict(cd.LAUNCHES)
    check(cd.LAUNCHES == {**dict.fromkeys(cd.LAUNCHES, 0), "single": 1},
          f"the ladder's reference did not take the single pass once: "
          f"{cd.LAUNCHES}")
    record = ladder_record()
    for r in rows:
        want_med, want_p99 = record[(r["nmax"], r["lmax"])]
        d_med = abs(r["median_rel_err"] / want_med - 1)
        d_p99 = abs(r["p99_rel_err"] / want_p99 - 1)
        log(f"(k) ladder ({r['nmax']}, {r['lmax']}): median "
            f"{r['median_rel_err']:.5f} (record {want_med:.5f}, "
            f"{d_med:.3f} off), p99 {r['p99_rel_err']:.5f} (record "
            f"{want_p99:.5f}, {d_p99:.3f} off); tol {LADDER_TOL}")
        check(d_med < LADDER_TOL and d_p99 < LADDER_TOL,
              f"ladder ({r['nmax']}, {r['lmax']}) off its record")
    stats["ladder"] = rows

    # row 2 at the ladder's shape: the Plummer force, kernel vs plain
    x, mm = scf_bench.ladder_case()
    kind = "plummer"
    pos = torch.tensor(x, dtype=torch.float32, device=dev)
    pre = cd._soft_pre(kind, torch.full((len(x),), 1e-4, device=dev))
    tgt = cd._targets(pos, pre)
    src = cd._sources(pos, torch.tensor(mm * 4.300917270069976e-06,
                                        dtype=torch.float32, device=dev),
                      pre, cd.TN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cd.split_count("direct", tgt.shape[1], src.shape[1], sms)

    def kernel():
        return cd._direct_tile(tgt, src, kind, "acc", True, 1e-15)

    def plain():
        return cd._direct_tile_reference(tgt, src, kind, "acc", True, 1e-15,
                                         splits=splits)

    got, ref = kernel(), plain()
    rel, absolute = rel_err(got, ref)
    check(rel < 2e-6, f"single-pass Plummer kernel vs plain: {rel:.2e}")
    ms, plain_ms = cuda_ms(kernel, 10), cuda_ms(plain, 1)
    pairs = tgt.shape[1] * len(x)
    b = bound(pairs * PAIR_FLOPS[kind], nbytes(tgt, src, got), pairs,
              mufu_rate(dev))
    stats["row2"] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                         plain_ms=plain_ms, splits=splits, **b)
    log(f"(k) direct_tile_kernel<PLUMMER,ACC,Kahan> single pass at "
        f"N={len(x)} (the ladder's reference), S={splits}: rel err "
        f"{rel:.2e} (tol 2e-6), {ms:.3f} ms vs plain {plain_ms:.3f} ms; "
        f"{PAIR_FLOPS[kind]} FP32 ops a pair, {describe(b, ms)}")

    # energy drift through run_simulation(method='scf')
    rec = scf_bench.run_drift(n=N_SCF, steps=SCF_DRIFT_STEPS, device=dev,
                              verbose=False)
    stats["drift"] = rec
    log(f"(k) run_simulation(method='scf') at N={N_SCF}: "
        f"{SCF_DRIFT_STEPS} steps of 2e-5, |dE/E| = {rec['value']:.3e} "
        f"(limit 1e-4) in the truncated Hamiltonian, "
        f"{rec['ms_per_step']:.3f} ms/step wall, Q {rec['Q0']:.4f} -> "
        f"{rec['Q1']:.4f}")
    check(rec["finite"] and rec["value"] < 1e-4,
          f"SCF drift {rec['value']:.3e}")

    # scf_groups on the two-centre case, the satellite a tenth of the host
    rng = np.random.default_rng(11)
    n_mw, n_sat = N_BENCH, 6554
    p1, m1 = hernquist_sample(rng, n_mw, 1.0, 1e9, (0, 0, 0))
    p2, m2 = hernquist_sample(rng, n_sat, 0.3, 1e8, (8.0, 0, 0))
    pos2, m12 = np.vstack([p1, p2]), np.concatenate([m1, m2])
    pt = torch.tensor(pos2, dtype=torch.float32, device=dev)
    ref = DirectGravity(m12, np.full(len(m12), 1e-6), kernel="plummer",
                        device=dev).accel(pt).double().cpu().numpy()
    sat = slice(n_mw, None)

    def med(acc):
        acc = acc.double().cpu().numpy()[sat]
        return float(np.median(np.linalg.norm(acc - ref[sat], axis=1)
                               / np.linalg.norm(ref[sat], axis=1)))

    single = med(ts.SCFGravity(m12, nmax=8, lmax=4, a=1.0,
                               device=dev).accel(pt))
    groups = {"mw": {"a": 1.0}, "sat": {"a": 0.3, "center": "com"}}
    comp = med(ts.CompositeSCFGravity(
        m12, groups=[(slice(0, n_mw), groups["mw"]), (sat, groups["sat"])],
        nmax=8, lmax=4, device=dev).accel(pt))
    log(f"(k) two centres at {n_mw} + {n_sat}: median force error on the "
        f"satellite {single:.4f} single-centre, {comp:.4f} with one "
        "expansion a group")
    check(comp < single, "the composite is not better on the satellite")
    xv2 = np.hstack([pos2, np.zeros_like(pos2)])
    species = [nst.Species(name="mw", N=n_mw, mass=m1, softening=0.05),
               nst.Species(name="sat", N=n_sat, mass=m2, softening=0.05)]
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = nst.run_simulation(xv2, species, 0.0, 10 * 1e-4, 1e-4,
                                 architecture="gpu", method="scf",
                                 scf_nmax=8, scf_lmax=4, scf_groups=groups,
                                 output_dir=out_dir, save_snapshots=False,
                                 verbose=False)
        wall = time.perf_counter() - t0
    check(all(np.isfinite(v).all() for v in res.values()), "scf_groups run")
    stats["composite"] = dict(single=single, composite=comp)
    log(f"(k) run_simulation(method='scf', scf_groups=...): 10 steps in "
        f"{wall:.2f} s")

    # the samplers
    G = nst.G_DEFAULT
    M, a = 1e9, 1.0
    plummer = nst.potentials.make_potential(type="Plummer", mass=M,
                                            scaleRadius=a)
    check(all(b.is_cuda for b in plummer.buffers()), "Plummer not on card")

    def dens(pts):
        r2 = (np.asarray(pts) ** 2).sum(1)
        return 3 * M / (4 * np.pi * a**3) * (1 + r2 / a**2) ** -2.5

    t0 = time.perf_counter()
    xq, mq = nst.sample_quasispherical(dens, plummer, N_BENCH, seed=13,
                                       r_grid=np.geomspace(1e-3, 1e3, 200))
    qs_s = time.perf_counter() - t0
    sp = nst.Species(name="star", N=N_BENCH, mass=float(mq[0]),
                     softening=0.05)
    t_dyn = np.sqrt(a**3 / (G * M))
    for key in cd.LAUNCHES:
        cd.LAUNCHES[key] = 0
    with tempfile.TemporaryDirectory() as out_dir:
        out = nst.run_simulation(xq, [sp], 0.0, 0.25 * t_dyn,
                                 dt=0.005 * t_dyn, architecture="gpu",
                                 save_snapshots=False, verbose=False,
                                 output_dir=out_dir)["star"]
    launches["quasispherical_run"] = dict(cd.LAUNCHES)
    r0 = np.median(np.linalg.norm(xq[:, :3], axis=1))
    r1 = np.median(np.linalg.norm(out[:, :3], axis=1))
    log(f"(k) sample_quasispherical: {N_BENCH} Plummer tracers in "
        f"{qs_s:.2f} s; 0.25 t_dyn through run_simulation on the card: "
        f"median radius {r0:.4f} -> {r1:.4f} ({abs(r1 / r0 - 1):.4f} off, "
        f"tol 0.08); launches {launches['quasispherical_run']}")
    check(abs(r1 / r0 - 1) < 0.08, "the sampled Plummer left equilibrium")

    ini = (Path(nst.__file__).resolve().parent / "data" / "potentials"
           / "McMillan17.ini")
    mw = nst.potentials.load_potential_ini(ini)
    sd, rd, hz = 8.95679e+08, 2.49955, 0.3       # its thin disk
    t0 = time.perf_counter()
    xd, md = nst.sample_disk(N_SCF, mw, surfaceDensity=sd, scaleRadius=rd,
                             scaleHeight=hz, seed=3)
    disk_s = time.perf_counter() - t0
    m_an = 2 * np.pi * sd * rd**2
    z_std = xd[:, 2].std()
    log(f"(k) sample_disk: {N_SCF} thin-disk particles in McMillan17 (on "
        f"the card) in {disk_s:.2f} s; mass {md.sum():.5e} (exponential "
        f"disk {m_an:.5e}), z std {z_std:.4f} (hz sqrt 2 = "
        f"{hz * np.sqrt(2):.4f})")
    check(np.isfinite(xd).all() and abs(md.sum() / m_an - 1) < 0.01
          and abs(z_std / (hz * np.sqrt(2)) - 1) < 0.03, "sample_disk")

    t0 = time.perf_counter()
    kp = king.make_king_potential(mass=1e5, r_core=0.01, W0=7.0)
    king_s = time.perf_counter() - t0
    kc = king.KingModel(7.0, 1e5, 0.01).potential()
    check(all(b.is_cuda for b in kp.buffers()), "King potential not on card")
    xk = np.random.default_rng(0).normal(0, 0.05, (N_BENCH, 3))
    ef, _ = rel_err(kp.force(xk).cpu(), kc.force(xk))
    ep, _ = rel_err(kp.potential(xk).cpu(), kc.potential(xk))
    log(f"(k) make_king_potential(W0=7) built in {king_s:.2f} s on the "
        f"card; float64 card vs CPU at {N_BENCH} points: force {ef:.3e}, "
        f"potential {ep:.3e} (tol 1e-10)")
    check(ef < 1e-10 and ep < 1e-10, "King card vs CPU")
    stats["samplers_s"] = dict(quasispherical=qs_s, disk=disk_s, king=king_s)
    log(f"(k) wall {time.perf_counter() - t_phase:.1f} s")
    return stats, launches


def zero_launches():
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    for key in cd.LAUNCHES:
        cd.LAUNCHES[key] = 0
    for key in cd.BRANCHES:
        cd.BRANCHES[key] = 0


def read_launches():
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    return dict(cd.LAUNCHES)


def direct64_at(pos, gm, soft, idx, dev, kind="plummer", mode="pot",
                chunk=(2048, 65536)):
    """The float64 sum at ``pos[idx]`` over every particle of (pos, G m,
    soft), the self pair left out (``ops.pairwise``'s tiles, in chunks of
    targets x sources): the potential (len(idx),) for ``mode='pot'``, the
    acceleration (len(idx), 3) for ``'acc'``."""
    from nbody_streams_tpu_torch.ops.pairwise import accel_tile, potential_tile

    tile = accel_tile if mode == "acc" else potential_tile
    f64 = dict(dtype=torch.float64, device=dev)
    p = torch.as_tensor(pos, **f64)
    g = torch.as_tensor(gm, **f64)
    h = torch.as_tensor(soft, **f64).expand(len(pos)).contiguous()
    ids = torch.arange(len(pos), device=dev)
    idx = torch.as_tensor(idx, device=dev)
    out = []
    for t0 in range(0, len(idx), chunk[0]):
        ti = idx[t0:t0 + chunk[0]]
        acc = 0.0
        for s0 in range(0, len(pos), chunk[1]):
            sl = slice(s0, s0 + chunk[1])
            acc = acc + tile(kind, p[ti], h[ti], ti, p[sl], g[sl], h[sl],
                             ids[sl])
        out.append(acc)
    return torch.cat(out).cpu().numpy()


def m_tree(dev):
    """(m) 1: device info, the fields aliases and the tree tier."""
    import warnings

    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch import tree
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
    from nbody_streams_tpu_torch.ops.pairwise import (
        compute_forces_direct, compute_potential_direct)

    info = nst.get_gpu_info()
    check(info["platform"] == "gpu"
          and info["device_kind"] == torch.cuda.get_device_name(0)
          and 0 < info["bytes_in_use"] < info["bytes_limit"],
          f"get_gpu_info: {info}")
    check(nst.cuda_alive() is True, "cuda_alive() is not True")
    log(f"(m) get_gpu_info: {info['device_kind']}, "
        f"{info['bytes_in_use'] / 2**30:.2f} of "
        f"{info['bytes_limit'] / 2**30:.2f} GiB in use, "
        f"{info['n_devices']} device(s); cuda_alive True")

    xv, m = plummer_case(N_BENCH, 2)
    pos = xv[:, :3]
    # the reference's compute_nbody_forces_gpu (the plain sum on the card)
    # against the kernels' DirectGravity on the bench case
    alias = nst.compute_nbody_forces_gpu(pos, m, H, G=G)
    kern = DirectGravity(m, np.full(N_BENCH, H), G=G, device=dev).accel(
        torch.tensor(pos, dtype=torch.float32, device=dev))
    rel, _ = rel_err(alias, kern)
    check(alias.is_cuda and rel < 3e-6,
          f"compute_nbody_forces_gpu vs DirectGravity: {rel:.2e} >= 3e-6")
    log(f"(m) compute_nbody_forces_gpu vs DirectGravity at N={N_BENCH} "
        f"(spline, h={H}): rel err {rel:.2e} (tol 3e-6)")

    # tree_gravity_gpu on the bench Plummer at eps = 0.05, twice (one
    # warning), then run_nbody_gpu_tree: the tree tier's path
    p64 = torch.tensor(pos, dtype=torch.float64, device=dev)
    m64 = torch.tensor(m, dtype=torch.float64, device=dev)
    h64 = torch.full((N_BENCH,), H, dtype=torch.float64, device=dev)
    tree._warned = False
    zero_launches()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        acc, phi = nst.tree_gravity_gpu(pos, m, eps=H, G=G, theta=0.5)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        acc2, _ = nst.tree_gravity_gpu(pos, m, eps=H, G=G, theta=0.7,
                                       nleaf=16)
        steps = 100
        with tempfile.TemporaryDirectory() as out_dir:
            solver = DirectGravity(m, np.full(N_BENCH, H), G=G,
                                   kernel="plummer", device=dev)

            def energy(xv_):
                p = torch.tensor(xv_[:, :3], dtype=torch.float32, device=dev)
                phi_ = solver.potential(p).double().cpu().numpy()
                return (0.5 * (m * (xv_[:, 3:] ** 2).sum(1)).sum()
                        + 0.5 * (m * phi_).sum())

            t0 = time.perf_counter()
            fin = nst.run_nbody_gpu_tree(
                xv, m, 0.0, steps * DT, DT, softening=H, G=G, theta=0.6,
                output_dir=out_dir, save_snapshots=False, verbose=False)
            wall = time.perf_counter() - t0
    tree_launches = read_launches()
    hits = [w for w in rec if "tree tier is exact" in str(w.message)]
    check(len(hits) == 1, f"the tree tier warned {len(hits)} times")
    check(np.array_equal(acc, acc2), "tree_gravity_gpu is not repeatable")
    acc64 = compute_forces_direct(p64, m64, h64, G=G, kernel="plummer",
                                  precision="float64").cpu().numpy()
    pot64 = compute_potential_direct(p64, m64, h64, G=G, kernel="plummer",
                                     precision="float64").cpu().numpy()
    errs = [np.abs(a - b).max() / np.abs(b).max()
            for a, b in ((acc, acc64), (phi, pot64))]
    check(acc.dtype == np.float32 and acc.shape == (N_BENCH, 3)
          and phi.shape == (N_BENCH,) and max(errs) < 3e-6,
          f"tree_gravity_gpu vs fp64: {errs} (tol 3e-6)")
    de = abs((energy(fin) - energy(xv)) / energy(xv))
    check(np.isfinite(fin).all() and de < 1e-4,
          f"run_nbody_gpu_tree |dE/E| = {de:.3e}")
    check(tree_launches["single"] > 0, f"tree tier: {tree_launches}")
    log(f"(m) tree_gravity_gpu at N={N_BENCH}, eps={H}: acc / phi rel err "
        f"vs fp64 {errs[0]:.2e} / {errs[1]:.2e} (tol 3e-6), first call "
        f"{ms:.2f} ms wall (solver build included), warned once; "
        f"run_nbody_gpu_tree {steps} steps in {wall:.2f} s, |dE/E| = "
        f"{de:.3e} (limit 1e-4); launches {tree_launches}")

    # run_simulation(method='tree') on the bench case: the direct path
    species = [nst.Species.dark(N=N_BENCH, mass=float(m[0]), softening=H)]
    finals, launches = {}, {}
    for method in ("tree", "direct"):
        zero_launches()
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            finals[method] = nst.run_simulation(
                xv, species, 0.0, steps * DT, DT, architecture="gpu",
                method=method, output_dir=out_dir, save_snapshots=False,
                verbose=False)["dark"]
            wall = time.perf_counter() - t0
        launches[method] = read_launches()
        log(f"(m) run_simulation(method={method!r}): {steps} steps in "
            f"{wall:.2f} s, launches {launches[method]}")
    check(np.array_equal(finals["tree"], finals["direct"]),
          "method='tree' differs from method='direct'")
    check(launches["tree"]["base"] > 0 and launches["tree"]["band"] > 0,
          f"method='tree' missed a kernel: {launches['tree']}")

    # profile_dir: the trace names the base pass's kernel
    with tempfile.TemporaryDirectory() as prof_dir:
        nst.run_nbody(xv, m, 0.0, 5 * DT, DT, softening=H, G=G,
                      architecture="gpu", save_snapshots=False,
                      verbose=False, output_dir=prof_dir,
                      profile_dir=f"{prof_dir}/trace")
        traces = list(Path(prof_dir, "trace").glob("*.json"))
        check(len(traces) == 1, f"profile_dir wrote {traces}")
        text = traces[0].read_text()
    check("direct_tile_kernel" in text and "band_kernel" in text,
          "the profile_dir trace names no direct_tile_kernel / band_kernel")
    log(f"(m) profile_dir: {len(text) / 1e6:.1f} MB trace names "
        "direct_tile_kernel and band_kernel")
    return {"tree_gravity": tree_launches, "tree": launches["tree"]}


def m_spray(dev):
    """(m) 2: the particle spray of examples/stream_in_mw.py on the card."""
    from nbody_streams_tpu_torch.fast_sims import KingModel, orbits, spray
    from nbody_streams_tpu_torch.potentials import load_potential_ini

    mw = load_potential_ini(MW22)
    check(next(mw.buffers()).is_cuda, "the loader did not build on the card")
    # the card float32 against the port's float64 on the CPU, on the window
    case = spray_window()
    got = spray.create_particle_spray_stream(mw, **case,
                                             dtype=torch.float32)
    want = spray.create_particle_spray_stream(
        load_potential_ini(MW22, device="cpu"), **case,
        dtype=torch.float64, device="cpu")
    errs = {}
    for key, a, b in (("rewind", got["prog_xv"], want["prog_xv"]),
                      ("stream", got["part_xv"][:, -1],
                       want["part_xv"][:, -1])):
        check(np.isfinite(a).all(), f"spray window {key}: not finite")
        errs[key] = [np.abs(a[:, sl] - b[:, sl]).max()
                     / np.abs(b[:, sl]).max()
                     for sl in (slice(0, 3), slice(3, 6))]
        for err, tol, what in zip(errs[key], SPRAY_TOL[key], ("pos", "vel")):
            check(err <= tol, f"spray window {key} {what}: {err:.3e} > "
                  f"{tol:.1e}")
    log(f"(m) spray window ({SPRAY_WINDOW} nodes, "
        f"{case['num_particles']} particles) float32 card vs float64 CPU: "
        f"rewind pos / vel {errs['rewind'][0]:.2e} / "
        f"{errs['rewind'][1]:.2e}, stream {errs['stream'][0]:.2e} / "
        f"{errs['stream'][1]:.2e} (SPRAY_TOL {SPRAY_TOL})")

    # the full example, its rewind and forward ensemble timed apart
    timed, calls = {}, {}

    def timer(name, fn):
        def run(*args, **kw):
            calls[name] = (args, kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timed[name] = time.perf_counter() - t0
            return out
        return run

    saved = (spray.integrate_orbit_adaptive, spray.integrate_orbits_released)
    spray.integrate_orbit_adaptive = timer("rewind", saved[0])
    spray.integrate_orbits_released = timer("forward", saved[1])
    try:
        t0 = time.perf_counter()
        res = spray.create_particle_spray_stream(mw, **SPRAY_RUN,
                                                 dtype=torch.float32)
        wall = time.perf_counter() - t0
    finally:
        spray.integrate_orbit_adaptive, spray.integrate_orbits_released = \
            saved
    part = res["part_xv"]
    extent = np.ptp(part[:, :3], axis=0)
    # the stream has left the cluster: longer than five tidal radii of
    # the King model, and shorter than the orbit
    r_t = KingModel(SPRAY_RUN["W0"], SPRAY_RUN["initmass"],
                    SPRAY_RUN["scaleradius"], G=G).r_tidal
    check(part.shape == (SPRAY_RUN["num_particles"], 6)
          and np.isfinite(part).all(), "spray: stream not finite")
    check(5 * r_t < extent.max() < 100.0,
          f"spray: stream extent {extent} kpc (tidal radius {r_t:.3f})")
    n_steps = SPRAY_RUN["n_steps"]

    # launches and device time per RK4 step and per DP5(4) substep
    # (profiler), and the card's busy share (device ms over wall ms)
    args, kw = calls["forward"]
    pot, ics, t_rel, t_start, t_end = args[:5]
    dt = (t_end - t_start) / n_steps
    k = 10

    def rk4():
        orbits.integrate_orbits_released(pot, ics, t_rel, t_start,
                                         t_start + k * dt, k, **kw)

    rk4()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk4()
    torch.cuda.synchronize()
    rk4_ms = 1e3 * (time.perf_counter() - t0) / k
    n_rk4, dev_rk4 = profile_launches(rk4)
    args, kw = calls["rewind"]
    substeps = [0]
    step = orbits._dp45_step

    def counted(*a, **k_):
        substeps[0] += 1
        return step(*a, **k_)

    pot_r, sat, t_hi, t_lo = args[:4]
    h_out = (t_lo - t_hi) / kw["n_out"]
    dp_kw = dict(kw, n_out=k)

    def dp5():
        orbits.integrate_orbit_adaptive(pot_r, sat, t_hi, t_hi + k * h_out,
                                        **dp_kw)

    orbits._dp45_step = counted
    try:
        dp5()
        torch.cuda.synchronize()
        substeps[0] = 0
        t0 = time.perf_counter()
        dp5()
        torch.cuda.synchronize()
        dp_wall = 1e3 * (time.perf_counter() - t0)
        n_sub = substeps[0]
        n_dp5, dev_dp5 = profile_launches(dp5)
    finally:
        orbits._dp45_step = step
    # a force on the spray's ensemble: MWPotential22 + the moving King,
    # and MWPotential22 alone
    x = torch.tensor(ics[:, :3], dtype=torch.float32, device=dev)
    n_force, dev_force = profile_launches(lambda: pot.force(x, t_start))
    mw32 = orbits.field_on(mw, dev, torch.float32)
    n_mw, dev_mw = profile_launches(lambda: mw32.force(x, t_start))
    log(f"(m) spray (stream_in_mw.py, {SPRAY_RUN['num_particles']} "
        f"particles, {n_steps} steps, float32): {wall:.2f} s wall; rewind "
        f"{timed['rewind']:.2f} s, forward ensemble {timed['forward']:.2f} "
        f"s; stream extent {np.round(extent, 2)} kpc")
    log(f"(m) spray RK4 step ({len(ics)} particles): {rk4_ms:.3f} ms wall, "
        f"{n_rk4 / k:.1f} launches, {dev_rk4 / k:.3f} device ms, busy "
        f"{dev_rk4 / k / rk4_ms:.3f}; a force {n_force} launches, "
        f"{dev_force:.3f} device ms (MWPotential22 alone {n_mw}, "
        f"{dev_mw:.3f})")
    log(f"(m) spray DP5(4) substep (1 orbit): {dp_wall / n_sub:.3f} ms "
        f"wall, {n_dp5 / n_sub:.1f} launches, busy {dev_dp5 / dp_wall:.3f}; "
        f"{n_sub / k:.2f} substeps an output node")


def m_restricted(dev):
    """(m) 3: restricted N-body of the spray's cluster on the card."""
    from nbody_streams_tpu_torch.fast_sims import run_restricted_nbody
    from nbody_streams_tpu_torch.potentials import load_potential_ini

    mw = load_potential_ini(MW22)
    kw = {k: SPRAY_CASE[k] for k in ("initmass", "sat_cen_present",
                                     "scaleradius", "prog_pot_kind", "W0",
                                     "time_end")}
    t0 = time.perf_counter()
    res = run_restricted_nbody(mw, num_particles=RESTRICTED_N,
                               time_total=RESTRICTED_TIME,
                               n_steps=RESTRICTED_STEPS,
                               dtype=torch.float32, **kw)
    wall = time.perf_counter() - t0
    bm = res["bound_mass"]
    check(res["part_xv"].shape[1] == RESTRICTED_N
          and np.isfinite(res["part_xv"]).all(), "restricted: not finite")
    # non-increasing while the refit runs: below its threshold (10 bound
    # particles, restricted.py) the potential is no longer refit and the
    # count of a dissolved cluster's last stars may tick up
    floor = 10 * kw["initmass"] / RESTRICTED_N
    rises = np.flatnonzero(np.diff(bm) > 0)
    check(bm[-1] < kw["initmass"] and (bm[rises + 1] <= floor).all(),
          f"restricted: bound mass rises above the refit threshold "
          f"{floor:.4g}: {bm}")
    n_chunks = RESTRICTED_STEPS // 10
    log(f"(m) run_restricted_nbody ({RESTRICTED_N} particles, "
        f"{RESTRICTED_STEPS} steps over {RESTRICTED_TIME} time units in "
        f"{n_chunks} chunks, float32): "
        f"{wall:.2f} s ({1e3 * wall / n_chunks:.1f} ms a chunk); bound "
        f"mass {bm[0]:.4g} -> {bm[-1]:.4g} of {kw['initmass']:.4g} over "
        f"{len(bm)} saves, {len(rises)} rises, all at or below "
        f"{floor:.4g}")


def m_unbinding(dev):
    """(m) 4: iterative unbinding, both call forms, at N = 1,048,576."""
    from nbody_streams_tpu_torch.utils import iterative_unbinding
    from nbody_streams_tpu_torch.utils import main as umain

    n = N_UNBIND
    xv, m = plummer_case(n, 8)
    rng = np.random.default_rng(8)
    kicked = rng.choice(n, n // 10, replace=False)
    r = np.linalg.norm(xv[kicked, :3], axis=1)
    v_esc = np.sqrt(2 * G * m.sum() / np.sqrt(r ** 2 + 1.0))
    u = rng.normal(size=(len(kicked), 3))
    xv[kicked, 3:] = 1.5 * v_esc[:, None] * u / np.linalg.norm(
        u, axis=1, keepdims=True)
    pos, vel = xv[:, :3], xv[:, 3:]

    # each potential: its wall time (solver build, host copies and the
    # float64 read-back included), its sources and its output; and, by CUDA
    # events around DirectGravity.potential alone, the kernel's time
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    calls, kernel_ms = [], []
    direct, potential = umain._direct_potential, DirectGravity.potential

    def timed_potential(self, x):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = potential(self, x)
        end.record()
        torch.cuda.synchronize()
        kernel_ms.append((len(x), start.elapsed_time(end)))
        return out

    def timed(pos_s, mass_s, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = direct(pos_s, mass_s, *args)
        calls.append({"n": len(pos_s), "wall_ms": 1e3 * (
            time.perf_counter() - t0), "phi": out, "pos": pos_s,
            "mass": mass_s})
        return out

    mufu = mufu_rate(dev)
    zero_launches()
    umain._direct_potential = timed
    DirectGravity.potential = timed_potential
    try:
        t0 = time.perf_counter()
        native, info = iterative_unbinding(pos, vel, m, softening=H, G=G)
        native_s = time.perf_counter() - t0
        native_calls = list(calls)
        calls.clear()
        t0 = time.perf_counter()
        (ref,), cp, cv = iterative_unbinding(
            pos, vel, m, potential_compute_method="direct", softening=H,
            G=G, verbose=False, return_history=False)
        ref_s = time.perf_counter() - t0
        ref_calls = list(calls)
    finally:
        umain._direct_potential = direct
        DirectGravity.potential = potential
    launches = read_launches()
    n_calls = len(native_calls) + len(ref_calls)
    check(launches["single"] == n_calls and len(kernel_ms) == n_calls,
          f"unbinding launches {launches}, {len(kernel_ms)} timed, for "
          f"{n_calls} potentials")
    for form, mask in (("native", native), ("reference", ref.astype(bool))):
        check(not mask[kicked].any(), f"{form}: a kicked particle is bound")
        rest = np.setdiff1d(np.arange(n), kicked)
        check(mask[rest].mean() > 0.8,
              f"{form}: {mask[rest].mean():.3f} of the rest bound")

    # each form's last potential against the float64 sum over the same
    # sources (the positions and masses that call was given) at a seeded
    # sample of 32,768 targets: max |err| / max |fp64| within 3e-6, the
    # tree tier's tolerance.  The final masks against the same criterion
    # in float64: they may differ only where |E| is within that bound.
    # native: it converged, so its last call's sources are the final bound
    # set; reference: its final mask is E < 0 under its last potential
    check(info["removed_per_iter"][-1] == 0
          and native_calls[-1]["n"] == native.sum(),
          f"native unbinding did not converge: {info}")
    last = native_calls[-1]
    rows = np.sort(rng.choice(last["n"], min(last["n"], 32768),
                              replace=False))
    sb = np.flatnonzero(native)[rows]
    v0 = (vel[native] * m[native, None]).sum(0) / m[native].sum()
    kin = 0.5 * ((vel[sb] - v0) ** 2).sum(1)
    checks = {"native": (last, rows, kin, native[sb])}
    last = ref_calls[-1]
    sample = np.sort(rng.choice(n, min(n, 32768), replace=False))
    kin = 0.5 * ((vel[sample] - cv) ** 2).sum(1)
    checks["reference"] = (last, sample, kin, ref[sample].astype(bool))
    for form, (call, idx, kin, got_mask) in checks.items():
        p32 = call["phi"][idx]
        p64 = direct64_at(call["pos"], G * np.asarray(call["mass"]), H,
                          idx, dev)
        tol = 3e-6 * np.abs(p64).max()
        err = np.abs(p32 - p64).max()
        check(np.isfinite(p32).all() and err <= tol,
              f"{form}: potential vs fp64 at N={call['n']}: max |err| "
              f"{err:.3e} > 3e-6 * max |fp64| = {tol:.3e}")
        e64 = p64 + kin
        differ = (e64 < 0) != got_mask
        check((np.abs(e64[differ]) <= tol).all(),
              f"{form}: {int(differ.sum())} of the sample disagree with "
              f"the fp64 criterion beyond {tol:.3e} of E = 0")
        log(f"(m) unbinding {form}: last potential at {len(idx)} sampled "
            f"particles vs fp64 over its {call['n']} sources, rel err "
            f"{err / np.abs(p64).max():.2e} (tol 3e-6); mask vs the fp64 "
            f"criterion: {int(differ.sum())} differ, all within {tol:.3e} "
            f"of E = 0")

    # row 2's potential form at the first iteration's shape, against its
    # bound (N^2 pairs: 14 FP32 operations and one rsqrt a pair)
    ms = min(t for nn, t in kernel_ms if nn == n)
    pairs = float(n) * n
    b = bound(pairs * POT_FLOPS["plummer"], 16 * n * 2, pairs, mufu)
    log(f"(m) iterative_unbinding at N={n} (a seeded tenth kicked to 1.5 "
        f"v_esc): native {info['iterations']} iterations in "
        f"{native_s:.2f} s, bound {native.mean():.4f}; reference form "
        f"{len(ref_calls)} potentials in {ref_s:.2f} s, bound "
        f"{ref.mean():.4f}; a potential's wall ms (solver build, copies "
        f"and read-back included) "
        + ", ".join(f"{c['wall_ms']:.1f}" for c in native_calls + ref_calls)
        + "; DirectGravity.potential ms (CUDA events) "
        + ", ".join(f"{t:.1f}" for _, t in kernel_ms)
        + f"; launches {launches}")
    log(f"(m) row 2 potential form (Plummer, self-masked) at N={n}: "
        f"{ms:.2f} ms, {describe(b, ms)}")
    return {"unbinding": launches}


def phase_m(dev):
    """The drop-in surface, the tree tier, stream generation and
    unbinding on the card; the launches of its run paths."""
    times = [time.perf_counter()]
    launches = m_tree(dev)
    times.append(time.perf_counter())
    m_spray(dev)
    times.append(time.perf_counter())
    m_restricted(dev)
    times.append(time.perf_counter())
    launches.update(m_unbinding(dev))
    times.append(time.perf_counter())
    log("(m) wall " + ", ".join(
        f"{k} {b - a:.1f} s" for k, a, b in zip(
            ("tree", "spray", "restricted", "unbinding"), times, times[1:]))
        + f", total {times[-1] - times[0]:.1f} s")
    return launches

def host_energy(xv, m, dev):
    """KE + PE summed in float64 on the host, the potential from the
    card's direct kernels (spline, h = H), as in phase (d)."""
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    solver = DirectGravity(m, np.full(len(m), H), device=dev)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    phi = solver.potential(pos).double().cpu().numpy()
    return 0.5 * (m * (xv[:, 3:] ** 2).sum(1)).sum() + 0.5 * (m * phi).sum()


def splat_args(pos2, m, h, extent, npix, dev, dtype=torch.float32):
    """The arguments of ``viz.sph._splat`` for (N, 2) projected positions,
    as ``render_surface_density`` builds them."""
    x0, x1, y0, y1 = extent

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return (t(pos2[:, 0]), t(pos2[:, 1]), t(m), t(h), t(x0), t(y0),
            t((x1 - x0) / npix), t((y1 - y0) / npix), npix, npix, 9)


def frame_mass(pos2, m, h, extent, npix):
    """The mass the splat must deposit inside the frame, in float64 on the
    CPU: all of it for the particles whose 9 x 9 stencil lies inside the
    frame with a pixel to spare, and the plain splat in float64 of the
    rest (those a frame edge cuts)."""
    from nbody_streams_tpu_torch.viz.sph import _splat

    x0, x1, y0, y1 = extent
    ix = np.floor((pos2[:, 0] - x0) / ((x1 - x0) / npix))
    iy = np.floor((pos2[:, 1] - y0) / ((y1 - y0) / npix))
    inner = ((ix >= 5) & (ix < npix - 5) & (iy >= 5) & (iy < npix - 5))
    edge = _splat(*splat_args(pos2[~inner], m[~inner], h[~inner], extent,
                              npix, "cpu", torch.float64))
    return float(m[inner].sum() + edge.sum())


def render_checks(dev, pos, m, tag, npix=RENDER_NPIX, phase="n",
                  extent=None):
    """Render ``pos`` at npix^2 (over ``extent``, the renderer's own frame
    by default) through ``auto`` on the card and
    on the CPU with the same smoothing lengths: the images agree within
    RENDER_TOL, the card's image holds the frame's mass within MASS_TOL;
    the splat's CUDA-event ms, launches and busy share (profiler), the
    whole call's wall ms, and whether two splats agree bitwise."""
    from nbody_streams_tpu_torch.viz import sph

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, extent = sph.render_surface_density(pos, m, npix=npix,
                                             extent=extent)
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    h = sph.get_smoothing_lengths(pos[:, :2])
    knn_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, ext_cpu = sph.render_surface_density(pos, m, npix=npix,
                                              extent=extent, smoothing=h,
                                              arch="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    check(ext_cpu == extent and img.shape == (npix, npix)
          and np.isfinite(img).all(), f"{tag}: render shape / extent")
    err = np.abs(img - ref).max() / np.abs(ref).max()
    area = (extent[1] - extent[0]) * (extent[3] - extent[2]) \
        / npix ** 2
    want = frame_mass(pos[:, :2], m, h, extent, npix)
    mass_err = abs(img.sum() * area - want) / want
    args = splat_args(pos[:, :2], m, h, extent, npix, dev)
    ms = cuda_ms(lambda: sph._splat(*args), 5)
    n_launch, dev_ms = profile_launches(lambda: sph._splat(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = sph._splat(*args)
    torch.cuda.synchronize()
    splat_wall = (time.perf_counter() - t0) * 1e3
    bitwise = torch.equal(a, sph._splat(*args))
    log(f"({phase}) render {tag}: N={len(m)} at {npix}^2, card vs CPU "
        f"{err:.3e} (tol {RENDER_TOL:.0e}); frame mass {want:.6e}, "
        f"|image - frame| / frame {mass_err:.3e} (tol {MASS_TOL:.0e}); "
        f"render wall {wall_ms:.1f} ms (kNN alone {knn_ms:.1f} ms, the "
        f"CPU render {cpu_ms:.1f} ms); splat {ms:.3f} ms (CUDA events), "
        f"{n_launch} launches, {dev_ms:.3f} device ms, busy share "
        f"{dev_ms / splat_wall:.3f}; two card splats bitwise equal: "
        f"{bitwise}")
    check(err <= RENDER_TOL, f"{tag}: card vs CPU {err:.3e}")
    check(mass_err <= MASS_TOL, f"{tag}: frame mass {mass_err:.3e}")
    return {"wall_ms": wall_ms, "splat_ms": ms, "launches": n_launch,
            "device_ms": dev_ms, "busy": dev_ms / splat_wall, "err": err,
            "mass_err": mass_err, "bitwise": bitwise}


def cli_kernel_checks(dev, states, m):
    """(n) the direct kernels at the CLI's shape: the spline at h = H with
    Kahan, as the CLI's solver runs them.  For each (tag, xv) of
    ``states``: the force and the self-masked potential through
    DirectGravity on the card, on whichever branch of the sorted path the
    state takes, against the float64 sum at a seeded sample of CLI_SAMPLE
    targets.  At the last state, both branches on the sorted operands (the
    band widened to the state's window where the path's is too narrow):
    each kernel against its plain version, and each branch's sum against
    the same float64 sample."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    n = len(m)
    idx = np.sort(np.random.default_rng(11).choice(n, CLI_SAMPLE,
                                                   replace=False))
    rows_of = torch.as_tensor(idx, device=dev)
    solver = DirectGravity(m, H, device=dev)
    eps2 = solver.eps2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"fp64": 0.0, "plain": 0.0}
    taken = {}

    def vs64(what, got, want):
        rel = np.abs(got - want).max() / np.abs(want).max()
        check(np.isfinite(got).all() and rel <= 3e-6,
              f"{what} vs fp64 at N={n}: {rel:.2e} > 3e-6")
        worst["fp64"] = max(worst["fp64"], rel)

    def vs_plain(what, got, want):
        rel, _ = rel_err(got, want)
        check(torch.isfinite(got).all().item() and rel <= 2e-6,
              f"{what} vs plain at N={n}: {rel:.2e} > 2e-6")
        worst["plain"] = max(worst["plain"], rel)

    for tag, xv in states:
        pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
        want = {mode: direct64_at(pos, G * m, H, idx, dev, "spline", mode,
                                  chunk=(1024, 32768))
                for mode in ("acc", "pot")}
        before = dict(cd.BRANCHES)
        for mode, fn in (("acc", solver.accel), ("pot", solver.potential)):
            vs64(f"{tag}: DirectGravity {mode}",
                 fn(pos)[rows_of].cpu().numpy(), want[mode])
        taken[tag] = [k for k in ("two_pass", "single_pass")
                      if cd.BRANCHES[k] > before[k]]
        check(len(taken[tag]) == 1,
              f"{tag}: DirectGravity took branches {taken[tag]}")

    # the last state's sorted operands
    order = cd.slab_sort_key(pos)
    tgt, src, start, nb, rows, width = sorted_operands(
        xv, G * m, np.full(n, H), dev, wide=True, order=order)
    ns = src.shape[1]

    def unsorted(out_s):
        out = torch.empty_like(out_s)
        out[order] = out_s
        return out[rows_of].cpu().numpy()

    for mode in ("acc", "pot"):
        mask = mode == "pot"
        args = (tgt, src, "spline", mode, True, eps2, mask)
        single = cd._direct_tile(*args)
        vs_plain(f"single pass {mode}", single, cd._direct_tile_reference(
            *args, splits=cd.split_count("direct", n, ns, sms)))
        args = (tgt, src, "newtonian", mode, True, eps2, mask, nb, start)
        base = cd._direct_tile(*args)
        vs_plain(f"base pass {mode}", base, cd._direct_tile_reference(
            *args, splits=cd.split_count("direct", n, ns, sms, nb, cd.TN)))
        args = (tgt, src, start, mode, True, eps2, mask, cd.TM, cd.TN, nb)
        band = cd._band(*args)
        vs_plain(f"band pass {mode}", band, cd._band_reference(
            *args, cd.split_count("band", n, ns, sms, nb, cd.TN)))
        vs64(f"{tag}: single pass {mode}", unsorted(single), want[mode])
        vs64(f"{tag}: two passes {mode}", unsorted(base + band), want[mode])
    log(f"(n) direct kernels at the CLI's shape N={n} (spline, h={H}, "
        f"Kahan): DirectGravity force and self-masked potential vs the "
        f"fp64 sum at {CLI_SAMPLE} sampled targets, branch taken "
        f"{taken}; at {states[-1][0]} the single pass and the two passes "
        f"(nb={nb} of {rows} rows, widest window {width}) vs fp64 and each "
        f"kernel vs its plain version: worst rel err {worst['fp64']:.2e} "
        f"vs fp64 (tol 3e-6), {worst['plain']:.2e} vs plain (tol 2e-6)")
    return taken


def n_cli(dev):
    """(n) a/b: nbody-torch-run on the card, continued from its restart
    file, and a render of its final state."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch import cli, nbody_io
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    n = int(CLI_ARGS[CLI_ARGS.index("--n") + 1])
    xv0, m = nst.make_plummer_sphere(n, M_total=1e9, a=1.0, seed=42069)
    e0 = host_energy(xv0, m, dev)
    with tempfile.TemporaryDirectory() as out:
        zero_launches()
        t0 = time.perf_counter()
        rc = cli.main(CLI_ARGS + ["--t-end", str(CLI_T_END),
                                  "--output-dir", out])
        t1 = time.perf_counter()
        rc2 = cli.main(CLI_ARGS + ["--t-end", str(CLI_T_CONTINUE),
                                   "--output-dir", out, "--continue"])
        t2 = time.perf_counter()
        launches = read_launches()
        branches = dict(cd.BRANCHES)
        check(rc == 0 and rc2 == 0, f"nbody-torch-run rc {rc}, {rc2}")
        xv, t_end, step = nbody_io._load_restart(out)[:3]
    steps = int(round(CLI_T_CONTINUE / 2e-5))
    check(step == steps and abs(t_end - CLI_T_CONTINUE) < 1e-12,
          f"restart at step {step}, t {t_end}")
    check(xv.shape == (n, 6) and np.isfinite(xv).all(),
          "CLI state not finite / wrong shape")
    de = abs((host_energy(xv, m, dev) - e0) / e0)
    log(f"(n) nbody-torch-run N={n}: 1000 steps in {t1 - t0:.2f} s, then "
        f"--continue to step {step} in {t2 - t1:.2f} s (restart reads "
        f"back); |dE/E| {de:.3e} (limit 1e-4) from host float64 energies; "
        f"launches {launches}, branches of the sorted path {branches}")
    check(de < 1e-4, f"CLI |dE/E| = {de:.3e}")
    check(launches["base"] > 0 and launches["band"] > 0,
          f"the CLI run missed a kernel: {launches}")
    cli_kernel_checks(dev, [("t = 0", xv0), (f"t = {t_end:g}", xv)], m)
    render = render_checks(dev, xv[:, :3], m, "CLI final state")
    return {"cli": launches}, branches, render


def host_cpu():
    """The host CPU's model: /proc/cpuinfo's "model name", else
    "unknown"."""
    for ln in Path("/proc/cpuinfo").read_text().splitlines():
        if ln.startswith("model name") and ":" in ln:
            return ln.split(":", 1)[1].strip()
    return "unknown"


def n_native(dev):
    """(n) c: the native host library on the card machine: its build, kNN
    at N = 2^20 against cKDTree, the Morton sort, and a render at 2^20
    through 'auto' (the native kNN)."""
    import os

    from nbody_streams_tpu_torch import native

    cpu = host_cpu()
    t0 = time.perf_counter()
    check(native.build(verbose=True), "the native host library did not "
          "build")
    build_s = time.perf_counter() - t0
    xv, m = plummer_case(N_UNBIND, 8)
    pos = xv[:, :3]
    t0 = time.perf_counter()
    h_nat = native.knn_radius(pos, 32)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_ck = native.knn_radius_ckdtree(pos, 32)
    ck_s = time.perf_counter() - t0
    knn_err = float(np.max(np.abs(h_nat - h_ck) / h_ck))
    t0 = time.perf_counter()
    order = native.morton_argsort(pos)
    morton_s = time.perf_counter() - t0
    log(f"(n) native host library: built in {build_s:.2f} s on {cpu}, "
        f"{os.cpu_count()} threads (os.cpu_count); N={N_UNBIND} k=32: "
        f"knn_radius {nat_s:.3f} s, cKDTree {ck_s:.3f} s, max rel diff "
        f"{knn_err:.1e} (tol {KNN_TOL:.0e}); morton_argsort {morton_s:.3f} "
        "s")
    check(knn_err <= KNN_TOL, f"native kNN vs cKDTree {knn_err:.3e}")
    check(np.array_equal(np.sort(order), np.arange(N_UNBIND)),
          "morton_argsort is not a permutation")
    render = render_checks(dev, pos, m, "N = 2^20 (native kNN)")
    return {"build_s": build_s, "knn_s": nat_s, "ckdtree_s": ck_s,
            "cpu": cpu, "render": render}


def n_example(dev):
    """(n) d: examples/plummer_stability.py of the port at its own size,
    in-process."""
    import os
    import runpy

    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    path = Path(PLUMMER_EXAMPLE).resolve()
    argv, cwd = sys.argv, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        sys.argv = [str(path)]
        try:
            zero_launches()
            t0 = time.perf_counter()
            g = runpy.run_path(str(path), run_name="__main__")
            wall = time.perf_counter() - t0
            launches = read_launches()
            branches = dict(cd.BRANCHES)
        finally:
            sys.argv = argv
            os.chdir(cwd)
    e0 = host_energy(g["xv"], g["masses"], dev)
    de = abs((host_energy(g["xv1"], g["masses"], dev) - e0) / e0)
    log(f"(n) {PLUMMER_EXAMPLE}: N={g['N']} {g['STEPS']} steps of "
        f"{g['DT']} in {wall:.2f} s, |dE/E| {de:.3e} (limit 1e-4), "
        f"density-profile drift {g['drift']:.4f}, launches {launches}, "
        f"branches of the sorted path {branches}")
    check(de < 1e-4, f"example |dE/E| = {de:.3e}")
    check(np.isfinite(g["drift"]), "example's profile drift not finite")
    check(launches["base"] + launches["single"] > 0,
          f"the example ran no direct kernel: {launches}")
    return {"plummer_example": launches}, branches


def phase_n(dev):
    """The user's command-line workflow on the card: nbody-torch-run and
    its continuation, renders, the native library, the headline example
    and the bench console entry; the launches of its run paths."""
    import contextlib
    import io

    from nbody_streams_tpu_torch import cli

    times = [time.perf_counter()]
    launches, cli_branches, render = n_cli(dev)
    times.append(time.perf_counter())
    nat = n_native(dev)
    times.append(time.perf_counter())
    example, example_branches = n_example(dev)
    launches.update(example)
    times.append(time.perf_counter())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.bench_main([])
    line = buf.getvalue().strip().splitlines()[-1]
    rec = json.loads(line)
    check(rc == 0 and rec["unit"] == "Gint/s" and rec["value"] > 0,
          f"nbody-torch-bench: {line}")
    log("(n) nbody-torch-bench printed:")
    print(line, flush=True)
    times.append(time.perf_counter())
    log("(n) wall " + ", ".join(
        f"{k} {b - a:.1f} s" for k, a, b in zip(
            ("cli+render", "native+render", "example", "bench"), times,
            times[1:])) + f", total {times[-1] - times[0]:.1f} s")
    return launches, {"render_cli": render, "native": nat, "branches": {
        "cli": cli_branches, "plummer_example": example_branches}}


def ring_far_count(x, d, h):
    """The far tiles an acceleration of the ring over ``d`` shards takes:
    the (target, source) shard pairs whose x-intervals lie farther apart
    than h, from the slabs of ``x`` padded with zeros as the ring pads
    them, in float32 as the ring compares (on the host)."""
    nl = -(-len(x) // d)
    x = np.concatenate([np.float32(x), np.zeros(nl * d - len(x),
                                                np.float32)]).reshape(d, nl)
    lo, hi = x.min(1), x.max(1)
    gap = np.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None])
    return int((gap > np.float32(h)).sum())


def o_forms(dev, pos, m):
    """(o.2) row 2's two-set forms as the ring calls them, one tile each at
    the D = RING_TILE_D tile shape of the sorted bench case: targets of
    shard 1 against its own block (the spline near tile; the potential with
    the self mask, as on ring step 0), against shard 2's (the potential
    without it) and against shard 3's (the far Newtonian tile)."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    nl = len(m) // RING_TILE_D
    gm = torch.tensor(m * G, dtype=torch.float32, device=dev)
    pre = cd._soft_pre("spline", torch.full((len(m),), H,
                                            dtype=torch.float32, device=dev))

    def block(k):
        sl = slice(k * nl, (k + 1) * nl)
        return cd._sources(pos[sl], gm[sl], pre[sl], cd.BLOCK)

    tgt = cd._targets(pos[nl:2 * nl], pre[nl:2 * nl])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mufu = mufu_rate(dev)
    stats = {}
    for label, law, mode, k, mask in (
            ("spline acc (near)", "spline", "acc", 1, False),
            ("newtonian acc (far)", "newtonian", "acc", 3, False),
            ("spline pot, self mask (r = 0)", "spline", "pot", 1, True),
            ("spline pot (r > 0)", "spline", "pot", 2, False)):
        src = block(k)
        args = (tgt, src, law, mode, True, 1e-15, mask)
        splits = cd.split_count("direct", nl, src.shape[1], sms)
        got = cd._direct_tile(*args)
        want = cd._direct_tile_reference(*args, splits=splits)
        rel, absolute = rel_err(got, want)
        check(torch.isfinite(got).all().item() and rel < 2e-6,
              f"(o.2) {label}: {rel:.2e} >= 2e-6 of its plain version")
        ms = cuda_ms(lambda: cd._direct_tile(*args), 20)
        plain_ms = cuda_ms(lambda: cd._direct_tile_reference(
            *args, splits=splits), 2)
        pairs = nl * src.shape[1]
        flops = (PAIR_FLOPS if mode == "acc" else POT_FLOPS)[law]
        b = bound(pairs * flops, nbytes(tgt, src, got), pairs, mufu)
        stats[label] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                            plain_ms=plain_ms, splits=splits,
                            shape=[nl, src.shape[1]], **b)
        log(f"(o.2) {label} at {nl} x {src.shape[1]}, S={splits}: rel err "
            f"{rel:.2e} (tol 2e-6), {ms:.4f} ms vs plain {plain_ms:.2f} ms;"
            f" {describe(b, ms)}")
    return stats


def o_run_forces(dev, card, xr, mr, final):
    """(o.4) the ring run's forces at its own shape: the ring over its
    RING_RUN_D shards (n_local = 16,385, sources padded to whole tiles)
    at the run's start and final states, ghost-padded as run_nbody pads
    them (ghost rows frozen at the last particle's start), against the
    one-card path and the fp64 sum at RING_SAMPLE targets; and the last
    shard's tiles, which hold the ghosts (h = 0), against their plain
    versions."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    n = RING_RUN_N
    h = np.full(n, H)
    ring = DirectGravity(mr, h, G=G, impl="sharded",
                         devices=[card] * RING_RUN_D)
    one = DirectGravity(mr, h, G=G, impl="cuda", device=dev)
    sd = ring._sharded
    pad = sd.npad - n
    check(pad == 3 and sd.use_kernels, f"(o.4) ring: {pad} ghost rows")
    idx = np.sort(np.random.default_rng(1).choice(n, RING_SAMPLE,
                                                  replace=False))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    for label, x in (("start", xr[:, :3]), ("final", final[:, :3])):
        real = torch.tensor(x, dtype=torch.float32, device=dev)
        # the rows the ring runs: the real ones and the ghosts it pads
        # them with, the last row repeated
        padded = torch.cat([real, real[-1:].expand(pad, 3)])
        for mode, k in (("accel", "acc"), ("potential", "pot")):
            got = getattr(ring, mode)(real)
            check(got.shape[0] == n and torch.isfinite(got).all()
                  .item(), f"(o.4) {label} {mode}: {tuple(got.shape)}")
            rel, _ = rel_err(got, getattr(one, mode)(real))
            want64 = direct64_at(x, mr * G, H, idx, dev, "spline", k)
            rel64 = (np.abs(got.double().cpu().numpy()[idx] - want64)
                     .max() / np.abs(want64).max())
            check(rel < 2e-6 and rel64 < 3e-6,
                  f"(o.4) ring {label} {mode}: {rel:.2e} vs one card (tol "
                  f"2e-6), {rel64:.2e} vs fp64 (tol 3e-6)")
            errs[f"{label}_{mode}"] = (rel, rel64)
        nl, last = sd.n_local, RING_RUN_D - 1
        tgt, src = sd._pack(last, padded[last * nl:(last + 1) * nl])
        splits = cd.split_count("direct", nl, src.shape[1], sms)
        for mode, mask in (("acc", False), ("pot", True)):
            args = (tgt, src, "spline", mode, ring.kahan, ring.eps2, mask)
            got = cd._direct_tile(*args)
            rel, _ = rel_err(got, cd._direct_tile_reference(
                *args, splits=splits))
            check(torch.isfinite(got).all().item() and rel < 2e-6,
                  f"(o.4) {label} last shard's {mode} tile ({nl} x "
                  f"{src.shape[1]}, S={splits}): {rel:.2e} >= 2e-6 of its "
                  "plain version")
            errs[f"{label}_tile_{mode}"] = (rel, None)
    log(f"(o.4) the ring at the run's shape ({RING_RUN_D} x {sd.n_local} "
        f"rows, {pad} ghosts), start and final states, vs one card / fp64 "
        f"at {RING_SAMPLE} targets (tol 2e-6 / 3e-6): " + ", ".join(
            f"{k} {a:.2e}" + ("" if b is None else f" / {b:.2e}")
            for k, (a, b) in errs.items())
        + "; the last shard's tiles vs their plain versions (tol 2e-6)")
    return errs


def phase_o(dev):
    """The multi-device ring over virtual shards of the card; the
    launches of its two run paths and its numbers."""
    import nbody_streams_tpu_torch as nst
    from nbody_streams_tpu_torch.benchmarks import ring_scaling
    from nbody_streams_tpu_torch.ops.cuda_direct import uses_spatial_sort
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
    from nbody_streams_tpu_torch.parallel import sharded as sh

    t_phase = time.perf_counter()
    card = f"cuda:{torch.cuda.current_device()}"
    xv0, m0 = plummer_case(N_BENCH, 2)
    xv, m = sh.slab_sort_for_sharding(xv0, m0)
    h = np.full(N_BENCH, H)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)

    # (o.1) the ring against the one-card sorted path and the fp64 sum
    one = DirectGravity(m, h, G=G, impl="cuda", device=dev)
    check(uses_spatial_sort(one.kernel, one.n),
          "the one-card reference is not sorted")
    modes = {"accel": "acc", "potential": "pot"}
    ref = {mode: getattr(one, mode)(pos) for mode in modes}
    idx = np.sort(np.random.default_rng(0).choice(N_BENCH, RING_SAMPLE,
                                                  replace=False))
    ref64 = {mode: direct64_at(xv[:, :3], m * G, H, idx, dev, "spline", k)
             for mode, k in modes.items()}
    errs = {}
    zero_launches()
    for d in RING_DS:
        ring = DirectGravity(m, h, G=G, impl="sharded", devices=[card] * d)
        check(ring._sharded.use_kernels and ring.impl == "sharded",
              f"the ring at D={d} is not on the kernel route")
        before = read_launches()["single"]
        for mode in modes:
            got = getattr(ring, mode)(pos)
            check(got.is_cuda and got.shape == ref[mode].shape
                  and torch.isfinite(got).all().item(),
                  f"(o.1) D={d} {mode}: {got.device} {tuple(got.shape)}")
            rel, _ = rel_err(got, ref[mode])
            rel64 = (np.abs(got.double().cpu().numpy()[idx] - ref64[mode])
                     .max() / np.abs(ref64[mode]).max())
            check(rel < 2e-6 and rel64 < 3e-6,
                  f"(o.1) D={d} {mode}: {rel:.2e} vs one card (tol 2e-6), "
                  f"{rel64:.2e} vs fp64 (tol 3e-6)")
            errs[f"D{d}_{mode}"] = (rel, rel64)
        check(read_launches()["single"] - before == 2 * d * d,
              f"(o.1) D={d}: {read_launches()['single'] - before} kernel "
              f"launches for 2 x {d * d} tiles")
    ring_launches = read_launches()
    check(ring_launches["base"] == ring_launches["band"] == 0,
          f"the ring launched a sorted-path kernel: {ring_launches}")
    log("(o.1) the ring over [cuda] * D vs the one-card sorted path / fp64 "
        f"at {RING_SAMPLE} targets: " + ", ".join(
            f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items())
        + f" (tol 2e-6 / 3e-6); launches {ring_launches}")

    # (o.2) row 2's forms at the ring's tile shape
    forms = o_forms(dev, pos, m)

    # (o.3) far tiles: sorted at D = 4 and 8 against the slab geometry,
    # shuffled none
    far = {}
    pos0 = torch.tensor(xv0[:, :3], dtype=torch.float32, device=dev)
    for label, d, p, x in (("sorted", 4, pos, xv[:, 0]),
                           ("sorted", 8, pos, xv[:, 0]),
                           ("shuffled", 8, pos0, xv0[:, 0])):
        ring = DirectGravity(m if label == "sorted" else m0, h, G=G,
                             impl="sharded", devices=[card] * d)
        before = sh.TILES["newtonian"]
        ring.accel(p)
        got = sh.TILES["newtonian"] - before
        want = ring_far_count(x, d, H)
        check(got == want and (got > 0) == (label == "sorted"),
              f"(o.3) {label} D={d}: {got} far tiles, the slabs give {want}")
        far[f"{label}_D{d}"] = got
        log(f"(o.3) {label} input, D={d}: {got} of {d * d} tiles far "
            f"(slab geometry {want}; non-neighbours "
            f"{d * d - d - 2 * (d - 1) if d > 2 else 0})")

    # (o.4) method='tree' over four virtual shards, 3 ghost rows
    xr, mr = plummer_case(RING_RUN_N, 2)
    xr, mr = sh.slab_sort_for_sharding(xr, mr)
    species = [nst.Species.dark(N=RING_RUN_N, mass=float(mr[0]),
                                softening=H)]
    finals, walls = {}, {}
    for method in ("tree", "direct"):
        kw = dict(devices=[card] * RING_RUN_D) if method == "tree" else {}
        zero_launches()
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            finals[method] = nst.run_simulation(
                xr, species, 0.0, RING_RUN_STEPS * DT, DT,
                architecture="gpu", method=method, output_dir=out_dir,
                save_snapshots=False, verbose=False, **kw)["dark"]
            walls[method] = time.perf_counter() - t0
        if method == "tree":
            run_launches = read_launches()
    tiles = (RING_RUN_STEPS + 1) * RING_RUN_D ** 2
    check(run_launches["single"] == tiles and run_launches["base"] == 0,
          f"(o.4) the ring run launched {run_launches}, not {tiles} tiles")
    tree = finals["tree"]
    check(tree.shape == (RING_RUN_N, 6) and np.isfinite(tree).all(),
          f"(o.4) ring run: {tree.shape}")
    e0, e1 = host_energy(xr, mr, dev), host_energy(tree, mr, dev)
    de = abs((e1 - e0) / e0)
    direct = finals["direct"]
    dx = (np.abs(tree[:, :3] - direct[:, :3]).max()
          / np.abs(direct[:, :3]).max())
    # the motion over the run, tree against direct: the displacement
    # (float32 positions: one unit in the last place at max|x| ~ 240 is
    # ~1e-4 of the largest displacement) and the velocity change, which
    # the force alone makes
    step = {k: (np.abs((tree - xr)[:, sl] - (direct - xr)[:, sl]).max()
                / np.abs((direct - xr)[:, sl]).max())
            for k, sl in (("dx", slice(0, 3)), ("dv", slice(3, 6)))}
    check(de < 1e-4 and dx < 1e-5 and step["dx"] < 1e-3
          and step["dv"] < 1e-4,
          f"(o.4) ring run |dE/E| {de:.3e} (limit 1e-4), vs direct "
          f"{dx:.2e} of max|x| (tol 1e-5), displacement {step['dx']:.2e} "
          f"(tol 1e-3), velocity change {step['dv']:.2e} (tol 1e-4)")
    log(f"(o.4) run_simulation(method='tree', devices=[cuda] * "
        f"{RING_RUN_D}) at N={RING_RUN_N} (3 ghost rows), "
        f"{RING_RUN_STEPS} steps: {walls['tree']:.2f} s (direct "
        f"{walls['direct']:.2f} s), |dE/E| {de:.3e}, vs direct {dx:.2e} of "
        f"max|x|, displacement {step['dx']:.2e}, velocity change "
        f"{step['dv']:.2e} of their max; launches {run_launches}")
    run_errs = o_run_forces(dev, card, xr, mr, tree)

    # (o.5) the strong-scaling table beside the one-card sorted path, and
    # for each the CUDA kernels of an evaluation and their device ms
    # (profiler, over three evaluations; on virtual shards kernels of
    # several streams overlap, so device ms over wall ms may pass 1)
    def per_eval(solver, reps=3):
        n_k, dev_ms = profile_launches(
            lambda: [solver.accel(pos) for _ in range(reps)])
        return n_k / reps, dev_ms / reps

    one_ms = ring_scaling.best_ms(lambda: one.accel(pos), dev)
    n_k, dev_ms = per_eval(one)
    log(f"(o.5) one card, the sorted path (rows 1 + 3): {one_ms:.3f} "
        f"ms/eval, {n_k:.1f} CUDA kernels, {dev_ms:.3f} device ms")
    rows = ring_scaling.strong(N_BENCH, dev)
    for row in rows:
        ring = DirectGravity(m, h, G=G, impl="sharded",
                             devices=[card] * row["D"])
        ring.accel(pos)
        row["cuda_kernels"], row["device_ms"] = per_eval(ring)
        seen = (f"{row['device_ms']:.3f} device ms of {row['ms']:.3f} wall "
                f"ms ({row['device_ms'] / row['ms']:.3f})"
                if row["cuda_kernels"] else "not measured (the profiler "
                "recorded no kernel)")
        log(f"(o.5) D={row['D']}: {row['cuda_kernels']:.1f} CUDA kernels an "
            f"evaluation, {seen}")
    log(f"(o) wall {time.perf_counter() - t_phase:.1f} s")
    return ({"ring": ring_launches, "ring_run": run_launches},
            {"forms": forms, "far": far, "errs": errs, "de": de, "dx": dx,
             "motion": step, "run_errs": run_errs, "one_ms": one_ms,
             "strong": rows})


def event_ms(fn):
    """``fn()`` and its ms by CUDA events, one call with no warm-up."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def p_sorted_rows(dev, xv, gm, soft, eps2):
    """The base and band passes (rows 1 and 3) the sorted path runs at the
    flagship's N on the freshly sorted ``xv``, each timed by CUDA events
    (one call: the kernels ran in the checks before) with its bound; None
    where the widest band window does not fit the band."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    tgt, src, start, nb, rows, width = sorted_operands(xv, gm, soft, dev)
    n, ns = tgt.shape[1], src.shape[1]
    if width > nb:
        log(f"(p.1) the fresh order's band window {width} exceeds the band "
            f"nb={nb}: rows 1 and 3 are not timed")
        return None
    forms = {
        "base": ("newtonian", n * (ns - nb * cd.TN), lambda: cd._direct_tile(
            tgt, src, "newtonian", "acc", True, eps2, False, nb, start)),
        "band": ("spline", n * nb * cd.TN, lambda: cd._band(
            tgt, src, start, "acc", True, eps2, False, cd.TM, cd.TN, nb))}
    out = {}
    for key, (law, pairs, fn) in forms.items():
        _, ms = event_ms(fn)
        b = bound(pairs * PAIR_FLOPS[law], nbytes(tgt, src) + n * 12, pairs,
                  mufu_rate(dev))
        out[key] = dict(ms=ms, pairs=pairs, shape=[n, ns], **b)
        log(f"(p.1) {key} pass at the flagship's N={n} (band window {width} "
            f"of nb={nb} rows of {rows}): {ms:.2f} ms (CUDA events), "
            f"{pairs / (ms * 1e-3):.4e} pairs/s; {describe(b, ms)}")
    return out


def p_single_pass(dev, xv, gm, soft, idx, want, eps2):
    """(p.1) row 2, the single pass the flagship's steps take, at its
    shape: the final state's operands in the slab order of the state one
    drift (DT) earlier, as a step sorts them.  The force and the
    self-masked potential, each one call timed by CUDA events, against
    the float64 sum ``want`` at the ``idx`` targets (3e-6 of max) and, on
    the last two target blocks (the last holds one row), against the plain
    version at the kernel's split count S (2e-6 of max)."""
    from nbody_streams_tpu_torch.benchmarks import flagship2m as fl
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    n = len(gm)
    order = cd.slab_sort_key(torch.tensor(
        xv[:, :3] - fl.DT * xv[:, 3:], dtype=torch.float32, device=dev))
    tgt, src, _, nb, rows, width = sorted_operands(xv, gm, soft, dev,
                                                   order=order)
    ns = src.shape[1]
    splits = cd.split_count(
        "direct", n, ns,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    # the plain version's self mask pairs target row i with source column
    # i: the slice's sources start at its first target
    t0 = (-(-n // cd.TM) - 2) * cd.TM
    tgt_tail = tgt[:, t0:].contiguous()
    src_tail = torch.roll(src, -t0, dims=1).contiguous()
    rows_of = torch.as_tensor(idx, device=dev)
    out = {"nb": nb, "rows": rows, "width": width, "splits": splits}
    for mode in ("acc", "pot"):
        args = ("spline", mode, True, eps2, mode == "pot")
        got, ms = event_ms(lambda: cd._direct_tile(tgt, src, *args))
        full = torch.empty_like(got)
        full[order] = got
        sample = full[rows_of].cpu().numpy()
        rel64 = np.abs(sample - want[mode]).max() / np.abs(want[mode]).max()
        t_plain = time.perf_counter()
        plain = cd._direct_tile_reference(tgt_tail, src_tail, *args,
                                          splits=splits)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t_plain
        rel, err = rel_err(got[t0:], plain)
        flops = (PAIR_FLOPS if mode == "acc" else POT_FLOPS)["spline"]
        b = bound(n * ns * flops, nbytes(tgt, src, got), n * ns,
                  mufu_rate(dev))
        log(f"(p.1) single pass (row 2) {mode} at the flagship's final "
            f"state N={n}, sources {ns}, S={splits}, in the order one drift "
            f"old (its band window {width} of nb={nb} rows of {rows}): "
            f"{ms:.1f} ms (CUDA events), {n * ns / (ms * 1e-3):.4e} "
            f"pairs/s; {describe(b, ms)}; vs the float64 sum at "
            f"{len(idx)} targets {rel64:.3e} (tol 3e-6); vs plain on "
            f"targets {t0:,}..{n - 1:,} {rel:.3e} (tol 2e-6; the plain "
            f"version {t_plain:.1f} s wall)")
        check(np.isfinite(sample).all() and rel64 <= 3e-6,
              f"(p.1) single pass {mode} vs fp64: {rel64:.2e}")
        check(torch.isfinite(got).all().item() and rel <= 2e-6,
              f"(p.1) single pass {mode} vs plain: {rel:.2e}")
        out[mode] = dict(ms=ms, pairs=n * ns, shape=[n, ns], rel64=rel64,
                         rel=rel, max_abs_err=err, **b)
    return out


def p_gravity(dev, solver, pos, m, soft, idx, tag, phase="p.1"):
    """The self-gravity force and self-masked potential of ``pos``
    through a run's DirectGravity against the float64 sum at the ``idx``
    targets (3e-6 of max); the branch each call took, and the float64
    sums."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    rows = torch.as_tensor(idx, device=dev)
    out, want = {}, {}
    for mode, fn in (("acc", solver.accel), ("pot", solver.potential)):
        want[mode] = direct64_at(pos, G * m, soft, idx, dev, "spline", mode,
                                 chunk=(1024, 131072))
        before = dict(cd.BRANCHES)
        got = fn(pos)[rows].cpu().numpy()
        taken = [k for k in ("two_pass", "single_pass")
                 if cd.BRANCHES[k] > before[k]]
        rel = np.abs(got - want[mode]).max() / np.abs(want[mode]).max()
        log(f"({phase}) {tag}: DirectGravity {mode} vs the float64 sum at "
            f"{len(idx)} targets: rel err {rel:.3e} (tol 3e-6), branch "
            f"{taken}")
        check(np.isfinite(got).all() and rel <= 3e-6 and len(taken) == 1,
              f"({phase}) {tag} {mode}: {rel:.2e} vs fp64, branches {taken}")
        out[mode] = {"rel": rel, "branch": taken[0]}
    return out, want


def p_field(dev, xv, t):
    """(p.1) the MW+LMC field's force and potential at every initial point
    on the card in float32 (its ms and the memory it adds) against float64
    on the CPU at P_FIELD_SAMPLE of them, within FIELD_TOL."""
    from nbody_streams_tpu_torch.potentials.mwlmc import load_mw_lmc_potential

    pot64, _ = load_mw_lmc_potential(device="cpu")
    gpu = copy.deepcopy(pot64).to(dev, torch.float32)
    x32 = xv[:, :3].astype(np.float32)
    x = torch.tensor(x32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    f = gpu.force(x, t)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    phi = gpu.potential(x, t)
    check(torch.isfinite(f).all().item() and torch.isfinite(phi).all().item(),
          "(p.1) the field is not finite at the flagship's points")
    idx = np.sort(np.random.default_rng(13).choice(len(xv), P_FIELD_SAMPLE,
                                                   replace=False))
    xc = torch.tensor(x32[idx].astype(np.float64))
    rows = torch.as_tensor(idx, device=dev)
    ef, _ = rel_err(f[rows].cpu(), pot64.force(xc, t))
    ep, _ = rel_err(phi[rows].cpu(), pot64.potential(xc, t))
    tol_f, tol_p = FIELD_TOL["MW+LMC"]
    log(f"(p.1) MW+LMC field at the flagship's {len(xv):,} initial points "
        f"(t={t:g}): force {ms:.1f} ms wall, {peak:.2f} GiB of device "
        f"memory above its inputs; float32 card vs float64 CPU at "
        f"{P_FIELD_SAMPLE} of them: force {ef:.3e} (tol {tol_f:g}), "
        f"potential {ep:.3e} (tol {tol_p:g})")
    check(ef < tol_f and ep < tol_p,
          f"(p.1) MW+LMC at the flagship: {ef:.3e} / {ep:.3e}")
    return {"ms": ms, "peak_gib": peak, "err": (ef, ep)}, pot64


def p_flagship(dev, snaps):
    """(p.1) the flagship at full width through its driver, 3 steps then a
    resumed 3, with its checks; returns its launches, branches and
    numbers."""
    from nbody_streams_tpu_torch import bench, nbody_io
    from nbody_streams_tpu_torch.benchmarks import flagship2m as fl
    from nbody_streams_tpu_torch.friction import make_df_force_extra
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    n = fl.N_TOTAL
    t_start = -FLAGSHIP_STEPS * fl.DT
    t0 = time.perf_counter()
    xv0, species = fl.build_ics(n, device=dev)
    ic_s = time.perf_counter() - t0
    m = np.concatenate([np.broadcast_to(sp.mass, sp.N) for sp in species])
    soft = np.concatenate([np.full(sp.N, sp.softening) for sp in species])
    log(f"(p.1) build_ics at N={n:,}: {ic_s:.2f} s on the host")
    check(xv0.shape == (n, 6) and np.isfinite(xv0).all(), "(p.1) ICs")
    field, pot64 = p_field(dev, xv0, t_start)

    # the run's solver (spline, float32 + Kahan, the CUDA kernels) on the
    # start state against float64 at P_SAMPLE targets, the BH among them
    solver = DirectGravity(m, soft, impl="cuda", device=dev)
    idx = np.sort(np.append(np.random.default_rng(17).choice(
        n - 1, P_SAMPLE - 1, replace=False), n - 1))
    pos0 = torch.tensor(xv0[:, :3], dtype=torch.float32, device=dev)
    grav = {"start": p_gravity(dev, solver, pos0, m, soft, idx,
                               "t_start")[0]}
    rows = p_sorted_rows(dev, xv0, G * m, soft, solver.eps2) or {}

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "flagship"
        zero_launches()
        fl.run(n, FLAGSHIP_STEPS, device=dev, out=out, save_snapshots=snaps,
               _stop_step=FLAGSHIP_STOP)
        first = nbody_io._load_restart(out)
        res = fl.run(n, FLAGSHIP_STEPS, device=dev, out=out,
                     save_snapshots=snaps)
        launches, branches = read_launches(), dict(cd.BRANCHES)
        restart = nbody_io._load_restart(out)
        summ = fl.summary(out)
    check(first[2] == FLAGSHIP_STOP and first[8] is not None,
          f"(p.1) the first attempt's restart is at step {first[2]}")
    xv1 = restart[0]
    check(restart[2] == FLAGSHIP_STEPS and np.array_equal(
        xv1, np.concatenate([res[sp.name] for sp in species])),
        f"(p.1) the restart file reads back at step {restart[2]}")
    check(xv1.shape == (n, 6) and np.isfinite(xv1).all(),
          "(p.1) the final state is not finite")
    check(summ["steps"] == FLAGSHIP_STEPS and summ["attempts"] == 2,
          f"(p.1) the summary counts {summ}")
    check(launches["base"] + launches["single"] > 0,
          f"(p.1) the flagship ran no direct kernel: {launches}")
    radius = [np.linalg.norm(np.average(x[:, :3], axis=0, weights=m))
              for x in (xv0, xv1)]
    check(radius[1] < radius[0], f"(p.1) the CoM radius {radius}")
    ms_step = 1e3 * summ["wall_s"] / summ["steps"]
    log(f"(p.1) flagship N={n:,}: {summ['steps']} steps over "
        f"{summ['attempts']} attempts (stopped at step {first[2]}, resumed "
        f"to {restart[2]}) in {summ['wall_s']:.1f} s: {ms_step:.1f} ms a "
        f"step with its start, energies and I/O, "
        f"{n * n / ms_step / 1e6:.1f} Gint/s; CoM radius {radius[0]:.4f} -> "
        f"{radius[1]:.4f} kpc; launches {launches}, branches {branches}")
    pos1 = torch.tensor(xv1[:, :3], dtype=torch.float32, device=dev)
    grav["final"], want = p_gravity(dev, solver, pos1, m, soft, idx,
                                    "t = 0")
    # row 2 as the steps run it, on the final state's operands in the
    # order one drift old
    single = p_single_pass(dev, xv1, G * m, soft, idx, want, solver.eps2)
    rows["single"] = single["acc"]

    # one KDK step as the run takes it (bench.measure builds the step as
    # run_nbody does): its ms, and its CUDA kernels and device ms
    # (profiler), from the start state
    fx = make_df_force_extra(pot64, M_sat=fl.M_DARK + fl.M_STAR + fl.M_BH,
                             t_start=t_start, t_end=0.0,
                             coulomb_mode="variable", update_interval=10)
    torch.cuda.reset_peak_memory_stats(dev)
    kdk = bench.measure(dev, windows=1, steps=1, case=(xv0, m),
                        solver=solver, external_potential=pot64,
                        force_extra=fx, dt=fl.DT, t0=t_start, warmup=0,
                        profile_steps=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cuda_events = [e for e in kdk["profile"].events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in cuda_events) / 1e3
    # the gravity kernels of that step by name: the single pass (row 2)
    # where its order, one drift old, widened the band window past the
    # band, else the base and band passes (rows 1 and 3) and their combine
    step_rows = {}
    for e in cuda_events:
        for key in ("direct_tile_kernel", "band_kernel", "combine_kernel"):
            if key in e.name:
                step_rows[key] = step_rows.get(key, 0.0) + e.device_time / 1e3
    log(f"(p.1) one KDK step of the flagship: {kdk['ms_per_step']:.1f} ms "
        f"({n * n / kdk['ms_per_step'] / 1e6:.1f} Gint/s), "
        f"{len(cuda_events)} CUDA kernels, {dev_ms:.1f} device ms, busy "
        f"share {dev_ms / kdk['ms_per_step']:.3f}; its gravity kernels' "
        f"device ms {step_rows}; peak device memory {peak:.2f} GiB")

    # the stars of the final state rendered on the card and the CPU in
    # the renderer's own frame (+-64 kpc about the origin), where the
    # 349,525 stars fall into a few 0.33 kpc pixels: the splat's float64
    # grid holds their mass there (a float32 grid lost 3.5e-5 of it)
    n_dark, n_star = species[0].N, species[1].N
    stars = slice(n_dark, n_dark + n_star)
    render = render_checks(dev, xv1[stars, :3], m[stars],
                           f"flagship stars ({n_star:,})",
                           npix=P_RENDER_NPIX, phase="p.1")
    return launches, branches, {
        "ic_s": ic_s, "field": field, "gravity": grav, "rows": rows,
        "single_pass": single,
        "ms_per_step": ms_step, "kdk_ms": kdk["ms_per_step"],
        "kdk_kernels": len(cuda_events), "kdk_device_ms": dev_ms,
        "kdk_rows_ms": step_rows,
        "peak_gib": peak, "summary": summ, "render": render}


def p_gates(dev, snaps):
    """(p.2)-(p.4) northstar's argsort, gate2m and gate1m at full width,
    the gates cut in depth, each gate's final state (its restart file)
    held against the float64 sum at P_SAMPLE targets; their launches and
    branches."""
    from nbody_streams_tpu_torch import nbody_io
    from nbody_streams_tpu_torch.benchmarks import northstar as ns
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    argsort_ms = ns.run_argsort(device=dev)
    log(f"(p.2) argsort of the x key at N=2,097,152: {argsort_ms:.4f} ms a "
        "sort (CUDA events, median of 5)")
    launches, branches, recs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for gate, run, steps, seed, kw in (
                ("gate2m", ns.run_gate2m, GATE2M_STEPS, 1,
                 {"save_snapshots": snaps}),
                ("gate1m", ns.run_gate1m, GATE1M_STEPS, 2, {})):
            phase = "p.3" if gate == "gate2m" else "p.4"
            zero_launches()
            rec = run(steps=steps, device=dev, out=Path(tmp) / gate, **kw)
            launches[gate], branches[gate] = read_launches(), dict(
                cd.BRANCHES)
            de = rec["abs_dE_over_E"] if gate == "gate2m" else rec["value"]
            log(f"({phase}) {gate} N={rec['n']:,}, {steps} steps: |dE/E| "
                f"{de:.3e} (limit 1e-4), launches {launches[gate]}, "
                f"branches {branches[gate]}")
            check(np.isfinite(de) and de < 1e-4, f"{gate} |dE/E| {de:.3e}")
            check(launches[gate]["base"] + launches[gate]["single"] > 0,
                  f"{gate} ran no direct kernel: {launches[gate]}")
            # the final state through the gate's solver against float64
            restart = nbody_io._load_restart(Path(tmp) / gate)
            check(restart[2] == steps, f"{gate}'s restart is at step "
                                       f"{restart[2]}")
            n, m = rec["n"], ns._plummer(rec["n"], seed)[1]
            soft = np.full(n, ns.SOFTENING)
            solver = DirectGravity(m, soft, impl="cuda", device=dev)
            idx = np.sort(np.random.default_rng(19).choice(n, P_SAMPLE,
                                                           replace=False))
            pos = torch.tensor(restart[0][:, :3], dtype=torch.float32,
                               device=dev)
            rec["gravity"] = p_gravity(dev, solver, pos, m, soft, idx,
                                       f"{gate} step {steps}", phase)[0]
            recs[gate] = rec
    check(recs["gate2m"]["restart"], "gate2m wrote no restart file")
    return launches, branches, {"argsort_ms": argsort_ms, **recs}


def phase_p(dev):
    """The scale drivers on the card: the flagship at N = 2,097,153 and
    the north-star gates at 2M and 1M, cut in depth."""
    from nbody_streams_tpu_torch import nbody_io

    t_phase = time.perf_counter()
    snaps = nbody_io.H5PY_AVAILABLE
    if not snaps:
        log("(p) h5py is not installed: the drivers run with snapshots "
            "off, and the restart files are read back instead")
    launches, branches, flag = p_flagship(dev, snaps)
    t_flag = time.perf_counter()
    gate_launches, gate_branches, gates = p_gates(dev, snaps)
    log(f"(p) wall {time.perf_counter() - t_phase:.1f} s (the flagship "
        f"{t_flag - t_phase:.1f} s, the gates "
        f"{time.perf_counter() - t_flag:.1f} s)")
    return ({"flagship": launches, **gate_launches},
            {"flagship": branches, **gate_branches}, {**flag, **gates})


def q_forms(dev, stats):
    """(q.1) kernels M (folded, unfolded) and F (acc, pot) as the base pass
    at the bench case, on the centred frame the sorted path gives them,
    against their plain versions at the wrapper's S; times by CUDA events
    beside rows 1 and 3 (re-timed here) and their bounds."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    xv, m = plummer_case(N_BENCH, 2)
    centred = xv[:, :3] - xv[:, :3].mean(0)
    tgt, src, start, nb, rows, _ = sorted_operands(
        centred, G * m, np.full(len(m), H), dev)
    ns = src.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cd.split_count("direct", N_BENCH, ns, sms, nb, cd.TN)
    pairs = N_BENCH * (ns - nb * cd.TN)
    mufu = mufu_rate(dev)
    out = {}
    for name, (mode, fold, fast) in MOMENT_FORMS.items():
        tol = FAST_TOL[mode] if fast else MOMENT_TOL

        def fn(s=None, mode=mode, fold=fold, fast=fast):
            return cd._moment_tile(tgt, src, "newtonian", mode, True, 1e-15,
                                   fold, fast, nb=nb, start=start, splits=s)

        def ref(mode=mode, fold=fold, fast=fast):
            return cd._moment_tile_reference(
                tgt, src, "newtonian", mode, True, 1e-15, fold, fast, nb=nb,
                start=start, splits=splits)

        got, want = fn(), ref()
        check(torch.equal(got, fn(splits)),
              f"(q.1) {name}: the wrapper's S is not split_count's {splits}")
        rel, absolute = rel_err(got, want)
        check(torch.isfinite(got).all().item() and rel < tol,
              f"(q.1) {name} at N={N_BENCH}: {rel:.2e} >= {tol} of its "
              "plain version")
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(ref, 2)
        b = bound(pairs * MOMENT_FLOPS[name], nbytes(tgt, src, start, got),
                  pairs, mufu, pairs * TENSOR_FLOPS[name])
        out[name] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                         plain_ms=plain_ms, splits=splits, tol=tol, **b)
        log(f"(q.1) {name} ({MOMENT_KERNELS[name]}) at N={N_BENCH} (nb={nb} "
            f"of {rows} rows), S={splits}: rel err {rel:.2e} (tol {tol:g}),"
            f" {ms:.4f} ms vs plain {plain_ms:.2f} ms; "
            f"{pairs / (ms * 1e-3):.6e} pairs/s; {describe(b, ms)}")
    for label, fn in (
            ("row 1 (VPU base pass, acc)", lambda: cd._direct_tile(
                tgt, src, "newtonian", "acc", True, 1e-15, False, nb, start)),
            ("row 1 potential form", lambda: cd._direct_tile(
                tgt, src, "newtonian", "pot", True, 1e-15, True, nb, start)),
            ("row 3 (band pass, acc)", lambda: cd._band(
                tgt, src, start, "acc", True, 1e-15, False, cd.TM, cd.TN,
                nb))):
        ms = cuda_ms(fn, 20)
        out[label] = ms
        log(f"(q.1) {label} in the same call: {ms:.4f} ms (phase b: "
            f"{stats['direct' if 'row 1' in label else 'band']['ms']:.4f} ms "
            "for the acc forms)")
    return out


def q_two_set(dev):
    """(q.2) kernel M's two-set form at the ring's D = RING_TILE_D far-tile
    shape (the sorted bench case's shard 1 against shard 3, centred)
    against its plain version, timed beside row 2's Newtonian tile.  (A
    self block is no far tile, and the form is built for none: its
    unsoftened close pairs, r ~ 1e-3 here, would cancel ~1,000-fold in
    the finalisation.)"""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.parallel.sharded import (
        slab_sort_for_sharding)

    xv, m = plummer_case(N_BENCH, 2)
    xv, m = slab_sort_for_sharding(xv, m)
    pos = torch.tensor(xv[:, :3] - xv[:, :3].mean(0), dtype=torch.float32,
                       device=dev)
    nl = len(m) // RING_TILE_D
    gm = torch.tensor(m * G, dtype=torch.float32, device=dev)
    pre = cd._soft_pre("newtonian", torch.full(
        (len(m),), H, dtype=torch.float32, device=dev))
    tgt = cd._targets(pos[nl:2 * nl], pre[nl:2 * nl])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mufu = mufu_rate(dev)
    src = cd._sources(pos[3 * nl:4 * nl], gm[3 * nl:4 * nl],
                      pre[3 * nl:4 * nl], cd.BLOCK)
    splits = cd.split_count("direct", nl, src.shape[1], sms)
    args = (tgt, src, "newtonian", "acc", True, 1e-15)
    got = cd._moment_tile(*args)
    rel, absolute = rel_err(got, cd._moment_tile_reference(
        *args, splits=splits))
    check(torch.isfinite(got).all().item() and rel < MOMENT_TOL,
          f"(q.2) two-set far tile: {rel:.2e} >= {MOMENT_TOL}")
    ms = cuda_ms(lambda: cd._moment_tile(*args), 20)
    plain_ms = cuda_ms(lambda: cd._moment_tile_reference(
        *args, splits=splits), 2)
    vpu_ms = cuda_ms(lambda: cd._direct_tile(*args), 20)
    pairs = nl * src.shape[1]
    b = bound(pairs * MOMENT_FLOPS["fold"], nbytes(tgt, src, got), pairs,
              mufu, pairs * TENSOR_FLOPS["fold"])
    log(f"(q.2) two-set far tile at {nl} x {src.shape[1]}, S={splits}: rel "
        f"err {rel:.2e} (tol {MOMENT_TOL:g}), {ms:.4f} ms vs plain "
        f"{plain_ms:.2f} ms, row 2's Newtonian tile {vpu_ms:.4f} ms; "
        f"{describe(b, ms)}")
    return dict(max_abs_err=absolute, rel=rel, ms=ms, plain_ms=plain_ms,
                splits=splits, shape=[nl, src.shape[1]], vpu_ms=vpu_ms, **b)


def q_fp64(dev):
    """(q.3) the sorted path with kernel M (folded, unfolded) and F, force
    and potential, against the float64 sum at RING_SAMPLE targets of the
    bench case: M within 3e-6 (the JAX package's tolerance; a lost 3xTF32
    split costs ~1e-3), F within FAST_FP64_TOL."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    xv, m = plummer_case(N_BENCH, 2)
    pos = torch.tensor(xv[:, :3], dtype=torch.float32, device=dev)
    mt = torch.tensor(m, dtype=torch.float32, device=dev)
    ht = torch.full((N_BENCH,), H, dtype=torch.float32, device=dev)
    idx = np.sort(np.random.default_rng(17).choice(N_BENCH, RING_SAMPLE,
                                                   replace=False))
    rows = torch.as_tensor(idx, device=dev)
    want = {mode: direct64_at(xv[:, :3], G * m, H, idx, dev, "spline", mode)
            for mode in ("acc", "pot")}
    out = {}
    for label, kw, tol in (
            ("M", dict(tile={"mxu": True}), 3e-6),
            ("M unfolded", dict(tile={"mxu": True, "fold_mass": False}),
             3e-6),
            ("F", dict(fast=True), FAST_FP64_TOL),
            ("VPU", {}, 3e-6)):
        for mode, fn in (("acc", cd.cuda_accel), ("pot", cd.cuda_potential)):
            got = fn(pos, mt, ht, G, "spline", True, **kw)[rows].cpu()
            rel, _ = rel_err(got, torch.as_tensor(want[mode]))
            out[f"{label} {mode}"] = rel
            check(rel < tol, f"(q.3) {label} {mode} vs fp64: {rel:.2e} >= "
                             f"{tol}")
    log("(q.3) the sorted path vs the fp64 sum at "
        f"{RING_SAMPLE} targets: " + ", ".join(
            f"{k} {v:.2e}" for k, v in out.items())
        + f" (tol 3e-6; F {FAST_FP64_TOL:g})")
    return out


def q_fast_bounds(dev):
    """(q.4) kernel F's guarantees on test_fast_tier_bounded_and_finite's
    clustered data at N = 65,536 (a core with outliers to 300 length
    units), against the default path: finite; per target max < 0.5,
    median < 5e-3 (acc) and < 1e-3 (pot)."""
    from nbody_streams_tpu_torch.ops import cuda_direct as cd

    rng = np.random.default_rng(31)
    n = N_BENCH
    r = 1.0 / np.sqrt(rng.uniform(1e-5, 1.0, n))
    u = rng.normal(size=(n, 3))
    pos = torch.tensor(u / np.linalg.norm(u, axis=1, keepdims=True)
                       * np.minimum(r, 300.0)[:, None], dtype=torch.float32,
                       device=dev)
    gm = torch.tensor(rng.uniform(0.5, 1.5, n) * G, dtype=torch.float32,
                      device=dev)
    soft = torch.full((n,), H, dtype=torch.float32, device=dev)
    out = {}
    for mode, fn, med_tol in (("acc", cd.cuda_accel, 5e-3),
                              ("pot", cd.cuda_potential, 1e-3)):
        before = dict(cd.BRANCHES)
        ref = fn(pos, gm, soft, 1.0, "spline", True).double()
        fast = fn(pos, gm, soft, 1.0, "spline", True, fast=True).double()
        two = cd.BRANCHES["two_pass"] - before["two_pass"]
        if mode == "acc":
            den = ref.norm(dim=1)
            err = (fast - ref).norm(dim=1) / den.clamp(min=den.mean() * 1e-3)
        else:
            err = (fast - ref).abs() / ref.abs().mean()
        finite = bool(torch.isfinite(fast).all())
        mx, med = err.max().item(), err.median().item()
        out[mode] = dict(max=mx, median=med, two_pass=two)
        log(f"(q.4) F {mode} on the clustered data at N={n}: finite "
            f"{finite}, max {mx:.3e} (< 0.5), median {med:.3e} (< {med_tol}),"
            f" two-pass calls {two} of 2")
        check(finite and mx < 0.5 and med < med_tol,
              f"(q.4) F {mode}: max {mx:.3e}, median {med:.3e}")
        check(two == 2, f"(q.4) F {mode} took the single pass")
    return out


def q_gate1m_state(dev, xyz, n):
    """(q.6) gate1m's final state (its restart file): the force through
    DirectGravity(target_drift=1e-8), the VPU form, against the float64
    sum at P_SAMPLE targets (3e-6 of max; the potential, the row sum,
    beside it); kernel M unfolded through the solver (tile_config {'mxu':
    True} with target_drift=1e-8) against the same sum (3e-6); and kernel
    M unfolded on the sorted, centred operands of that state against its
    plain version on the last two target tiles at the wrapper's S
    (MOMENT_TOL)."""
    from nbody_streams_tpu_torch.benchmarks import northstar as ns
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity

    m = ns._plummer(n, 2)[1]
    soft = np.full(n, ns.SOFTENING)
    solver = DirectGravity(m, soft, impl="cuda", device=dev,
                           target_drift=1e-8)
    idx = np.sort(np.random.default_rng(19).choice(n, P_SAMPLE,
                                                   replace=False))
    pos = torch.tensor(xyz, dtype=torch.float32, device=dev)
    before = dict(cd.LAUNCHES)
    tag = f"gate1m step {GATE1M_STEPS}, target_drift=1e-8"
    gravity, want = p_gravity(dev, solver, pos, m, soft, idx, tag, "q.6")
    check(cd.LAUNCHES["moment"] == before["moment"]
          and cd.LAUNCHES["base"] > before["base"],
          "(q.6) target_drift=1e-8 left the VPU form")
    unfolded = DirectGravity(m, soft, impl="cuda", device=dev,
                             target_drift=1e-8, tile_config={"mxu": True})
    before = cd.LAUNCHES["moment"]
    got = unfolded.accel(pos)[torch.as_tensor(idx, device=dev)].cpu()
    check(cd.LAUNCHES["moment"] > before,
          "(q.6) mxu=True with target_drift=1e-8 ran no kernel M")
    rel = (np.abs(got.numpy() - want["acc"]).max()
           / np.abs(want["acc"]).max())
    log(f"(q.6) {tag}, tile_config {{'mxu': True}} (kernel M unfolded): "
        f"DirectGravity acc vs the float64 sum at {len(idx)} targets: rel "
        f"err {rel:.3e} (tol 3e-6)")
    check(np.isfinite(got.numpy()).all() and rel <= 3e-6,
          f"(q.6) M unfolded vs fp64: {rel:.2e}")
    gravity["M unfolded acc"] = {"rel": rel}
    # the sorted path's operands of this state, centred as _self_sorted
    # centres them for the moment form
    order = cd.slab_sort_key(pos)
    centred = pos - pos[order].mean(0, keepdim=True)
    tgt, src, start, nb, rows, width = sorted_operands(
        centred, G * m, soft, dev, order=order)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = cd.split_count("direct", n, src.shape[1], sms, nb, cd.TN)
    got = cd._moment_tile(tgt, src, "newtonian", "acc", solver.kahan,
                          solver.eps2, False, nb=nb, start=start)
    last = 2 * cd.TM
    want = cd._moment_tile_reference(
        tgt[:, -last:].contiguous(), src, "newtonian", "acc", solver.kahan,
        solver.eps2, False, nb=nb, start=start[-2:].contiguous(),
        splits=splits)
    rel, absolute = rel_err(got[-last:], want)
    log(f"(q.6) kernel M unfolded at gate1m's final state (nb={nb} of "
        f"{rows} rows, band window {width}), S={splits}: the last {last} "
        f"targets vs plain rel err {rel:.2e} (tol {MOMENT_TOL:g})")
    check(torch.isfinite(got).all().item() and rel < MOMENT_TOL,
          f"(q.6) kernel M at gate1m's shape: {rel:.2e} >= {MOMENT_TOL}")
    return {"gravity": gravity, "moment_rel": rel, "moment_abs": absolute,
            "splits": splits, "nb": nb}


def q_runs(dev):
    """(q.5) 3 x 100 KDK steps of the bench case (bench.measure) with
    tile_config {'mxu': True} and with precision='float32_fast', each with
    its launches zeroed before and read after: ms/step and |dE/E| (the
    1e-4 contract); (q.6) gate1m at N = 1,048,576 for GATE1M_STEPS steps
    with target_drift=1e-8 (the VPU form: no kernel M launched): ms/step
    and |dE/E| from its float64 bracket, then its final state
    (``q_gate1m_state``); (q.7) the ring over ['cuda:0'] * RING_RUN_D with
    mxu=True on the slab-sorted bench case at (120, -80, 40) against one
    card, within 2e-6."""
    from nbody_streams_tpu_torch import bench, nbody_io
    from nbody_streams_tpu_torch.benchmarks import northstar as ns
    from nbody_streams_tpu_torch.ops.dispatch import DirectGravity
    from nbody_streams_tpu_torch.parallel.sharded import (
        slab_sort_for_sharding)

    launches, out = {}, {}
    xv, m = plummer_case(N_BENCH, 2)
    for path, kw in (("q_mxu_kdk", dict(tile_config={"mxu": True})),
                     ("q_fast_kdk", dict(precision="float32_fast"))):
        solver = DirectGravity(m, np.full(len(m), H), kernel="spline",
                               impl="cuda", device=dev, **kw)
        zero_launches()
        r = bench.measure(dev, windows=3, steps=100, solver=solver,
                          precision=kw.get("precision", "float32_kahan"))
        launches[path] = read_launches()
        out[path] = {"ms_per_step": r["ms_per_step"],
                     "windows_ms": r["windows_ms"], "de": r["de"]}
        key = "fast" if "precision" in kw else "moment"
        log(f"(q.5) {path}: {r['ms_per_step']:.3f} ms/step (windows "
            f"{', '.join(f'{w:.3f}' for w in r['windows_ms'])}), |dE/E| "
            f"{r['de']:.2e} over {r['steps']} steps; launches "
            f"{launches[path]}")
        check(r["de"] < 1e-4, f"(q.5) {path} |dE/E| {r['de']:.2e}")
        check(launches[path][key] > 0 and launches[path]["base"]
              == (0 if key == "fast" else launches[path]["base"]),
              f"(q.5) {path} did not run kernel {key}: {launches[path]}")
    with tempfile.TemporaryDirectory() as tmp:
        zero_launches()
        rec = ns.run_gate1m(steps=GATE1M_STEPS, device=dev,
                            out=Path(tmp) / "gate1m", target_drift=1e-8)
        launches["q_gate1m"] = read_launches()
        restart = nbody_io._load_restart(Path(tmp) / "gate1m")
    out["gate1m"] = {k: rec[k] for k in ("value", "ms_per_step", "steps",
                                         "n", "wall_s")}
    log(f"(q.6) gate1m with target_drift=1e-8, N={rec['n']:,}, "
        f"{rec['steps']} steps: {rec['ms_per_step']:.1f} ms/step, |dE/E| "
        f"{rec['value']:.3e} (limit 1e-4); launches {launches['q_gate1m']}")
    check(np.isfinite(rec["value"]) and rec["value"] < 1e-4,
          f"(q.6) gate1m |dE/E| {rec['value']:.3e}")
    check(launches["q_gate1m"]["moment"] == 0
          and launches["q_gate1m"]["base"] > 0,
          f"(q.6) gate1m with target_drift=1e-8 left the VPU form: "
          f"{launches['q_gate1m']}")
    check(restart[2] == GATE1M_STEPS,
          f"(q.6) gate1m's restart is at step {restart[2]}")
    out["gate1m"].update(q_gate1m_state(dev, restart[0][:, :3], rec["n"]))
    xs, ms_ = slab_sort_for_sharding(xv, m)
    xs = xs + np.array([120.0, -80.0, 40.0, 0.0, 0.0, 0.0])
    h = np.full(len(ms_), H)
    pos = torch.tensor(xs[:, :3], dtype=torch.float32, device=dev)
    one = DirectGravity(ms_, h, G=G, impl="cuda", device=dev).accel(pos)
    ring = DirectGravity(ms_, h, G=G, impl="sharded",
                         devices=[str(dev)] * RING_RUN_D,
                         sharded_opts={"mxu": True})
    zero_launches()
    got = ring.accel(pos)
    torch.cuda.synchronize()
    launches["q_ring"] = read_launches()
    rel, _ = rel_err(got, one)
    out["ring"] = dict(rel=rel, d=RING_RUN_D)
    log(f"(q.7) the ring with mxu=True over {RING_RUN_D} virtual shards at "
        f"(120, -80, 40): rel err {rel:.2e} vs one card (tol 2e-6); "
        f"launches {launches['q_ring']}")
    check(rel < 2e-6, f"(q.7) ring mxu {rel:.2e} >= 2e-6")
    check(launches["q_ring"]["moment_2set"] > 0,
          f"(q.7) the ring ran no far tile in kernel M: {launches['q_ring']}")
    return launches, out


def phase_q(dev, stats):
    """The tensor-core forms of the direct kernels: kernels M and F."""
    t0 = time.perf_counter()
    forms = q_forms(dev, stats)
    two_set = q_two_set(dev)
    fp64 = q_fp64(dev)
    bounds = q_fast_bounds(dev)
    launches, runs = q_runs(dev)
    log(f"(q) wall {time.perf_counter() - t0:.1f} s")
    return launches, {"forms": forms, "two_set": two_set, "fp64": fp64,
                      "fast_bounds": bounds, **runs}


def phase_l(dev):
    """The potential forms of the direct kernels on the card: checked
    against their plain versions and the fp64 oracle, timed by CUDA
    events, and their slots a pair read from the SASS."""
    from nbody_streams_tpu_torch.benchmarks import sass
    from nbody_streams_tpu_torch.ops import cuda_direct as cd
    from nbody_streams_tpu_torch.ops.pairwise import compute_potential_direct
    from nbody_streams_tpu_torch.potentials import fit

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mufu = mufu_rate(dev)
    kinds = ("newtonian", "plummer", "dehnen_k1", "dehnen_k2", "spline")
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(12)
    n = 4500
    pos = torch.tensor(rng.normal(0, 1, (n, 3)), **f32)
    gm = torch.tensor(rng.uniform(0.5, 2.0, n) * 0.43, **f32)
    soft = torch.tensor(rng.uniform(0.05, 0.3, n), **f32)
    # two-set, nt != ns, nt not a multiple of 64, the targets and sources
    # sharing their first min(nt, ns) particles (so the mask has pairs to
    # drop): every kind, mask off and on, S = 1 and the wrapper's S; 2e-6
    # * max, the Kahan tolerance
    worst = 0.0
    for nt, ns in ((3001, n), (n, 3001)):
        for kind in kinds:
            pre = cd._soft_pre(kind, soft)
            tgt = cd._targets(pos[:nt], pre[:nt])
            src = cd._sources(pos[:ns], gm[:ns], pre[:ns], cd.TN)
            auto = cd.split_count("direct", nt, src.shape[1], sms)
            for mask in (False, True):
                for splits in (1, None):
                    args = (tgt, src, kind, "pot", True, 1e-15, mask)
                    got = cd._direct_tile(*args, splits=splits)
                    want = cd._direct_tile_reference(*args,
                                                     splits=splits or auto)
                    rel, _ = rel_err(got, want)
                    check(torch.isfinite(got).all().item()
                          and rel < 2e-6, f"two-set {kind} nt={nt} ns={ns} "
                          f"mask={mask} S={splits}: {rel:.2e} >= 2e-6")
                    worst = max(worst, rel)
    log(f"(l) two-set potential, nt/ns 3001/{n} and {n}/3001, 5 laws x "
        f"mask off/on x S = 1 and the wrapper's: worst rel err vs plain "
        f"{worst:.2e} (tol 2e-6)")

    # the self-masked potential with a quarter of the particles at h = 0,
    # where a missed self pair is -G m / sqrt(eps2), ~1e7 x the physical
    # potential: finite and within 3e-6 of the fp64 oracle (the JAX
    # package's kernel-vs-oracle tolerance).  Single pass: every kind at
    # N = 3,000; sorted two-pass: the spline at N = 16,384
    cases = [(kind, 3000, 5) for kind in kinds] + [("spline", 16384, 4)]
    for kind, n_self, seed in cases:
        xv, m = plummer_case(n_self, seed)
        p = torch.tensor(xv[:, :3], **f32)
        mt = torch.tensor(m, **f32)
        h = torch.full((n_self,), H, **f32)
        h[::4] = 0.0
        before = dict(cd.BRANCHES)
        phi = cd.cuda_potential(p, mt, h, G, kind, True)
        two_pass = cd.BRANCHES["two_pass"] - before["two_pass"]
        check(two_pass == (n_self >= cd.SORT_MIN_N),
              f"{kind} N={n_self}: took the wrong branch {cd.BRANCHES}")
        want = compute_potential_direct(p.double(), mt.double(), h.double(),
                                        G=G, kernel=kind,
                                        precision="float64")
        rel, _ = rel_err(phi, want)
        check(torch.isfinite(phi).all().item() and rel < 3e-6,
              f"self {kind} N={n_self} with h = 0: {rel:.2e} >= 3e-6")
        log(f"(l) cuda_potential {kind} at N={n_self}, a quarter at h = 0 "
            f"({'sorted two-pass' if two_pass else 'single pass'}): rel "
            f"err vs fp64 {rel:.2e} (tol 3e-6), finite")

    stats = {}

    def form(key, label, flops, fn, ref, pairs, operands, reps,
             plain=False):
        """Check ``fn`` against ``ref`` (2e-6 * max), time it over
        ``reps`` launches, and its plain version once where ``plain``."""
        got, want = fn(), ref()
        rel, absolute = rel_err(got, want)
        check(torch.isfinite(got).all().item() and rel < 2e-6,
              f"{label}: {rel:.2e} >= 2e-6")
        ms = cuda_ms(fn, reps)
        b = bound(pairs * flops, nbytes(*operands, got), pairs, mufu)
        stats[key] = dict(max_abs_err=absolute, rel=rel, ms=ms,
                          plain_ms=cuda_ms(ref, 1) if plain else None, **b)
        log(f"(l) {label}: rel err {rel:.2e} (tol 2e-6), {ms:.4f} ms"
            + (f" vs plain {stats[key]['plain_ms']:.3f} ms" if plain
               else "") + f"; {flops} FP32 ops a pair, {describe(b, ms)}")

    # row 2b at the fit's shape: the CylSpline grid's probes of the bench
    # case's Plummer against its particles, h = 0 probes
    xv, m = plummer_case(N_BENCH, 2)
    centred = xv[:, :3] - xv[:, :3].mean(0)
    probes = fit.cylspline_grid(centred)[3]
    kind = "plummer"
    tgt = cd._targets(torch.tensor(probes, **f32),
                      cd._soft_pre(kind, torch.zeros(len(probes), **f32)))
    src = cd._sources(torch.tensor(centred, **f32),
                      torch.tensor(m * G, **f32),
                      cd._soft_pre(kind, torch.full((N_BENCH,), H, **f32)),
                      cd.TN)
    splits = cd.split_count("direct", tgt.shape[1], src.shape[1], sms)
    form("fit", f"two-set potential (fit), {tgt.shape[1]} x {N_BENCH}, "
         f"S={splits}", POT_FLOPS[kind],
         lambda: cd._direct_tile(tgt, src, kind, "pot", True, 1e-15),
         lambda: cd._direct_tile_reference(tgt, src, kind, "pot", True,
                                           1e-15, splits=splits),
         tgt.shape[1] * N_BENCH, (tgt, src), 50, plain=True)
    stats["fit"]["splits"] = splits

    # the self spline potential at the DF satellite: too compact for the
    # band, so the single pass (the bound_phi friction's potential)
    xd, md = df_case()
    tgt, src, _, nb, _, width = sorted_operands(xd, G * md,
                                                np.full(len(md), H), dev)
    check(width > nb, f"DF satellite window {width} fits the band {nb}")
    splits = cd.split_count("direct", N_BENCH, src.shape[1], sms)
    form("df_potential", "self spline potential single pass (DF "
         f"satellite), S={splits}", POT_FLOPS["spline"],
         lambda: cd._direct_tile(tgt, src, "spline", "pot", True, 1e-15,
                                 True),
         lambda: cd._direct_tile_reference(tgt, src, "spline", "pot", True,
                                           1e-15, True, splits=splits),
         N_BENCH * src.shape[1], (tgt, src), 10)

    # the sorted path at the bench case: the potential's base and band
    # passes (mask_self; at S = 1 and the wrapper's S), then rows 1 and 3
    tgt, src, start, nb, _, width = sorted_operands(
        xv, G * m, np.full(len(m), H), dev)
    check(width <= nb, f"bench case window {width} > {nb}")
    ns = src.shape[1]
    base_pairs, band_pairs = N_BENCH * (ns - nb * cd.TN), N_BENCH * nb * cd.TN
    for mode in ("pot", "acc"):
        what = "potential" if mode == "pot" else "acceleration"
        mask = mode == "pot"
        flops = POT_FLOPS if mask else PAIR_FLOPS
        for s in ((1, None) if mask else (None,)):
            s_base = s or cd.split_count("direct", N_BENCH, ns, sms, nb, cd.TN)
            s_band = s or cd.split_count("band", N_BENCH, ns, sms, nb, cd.TN)
            tag = f"{mode}_{'s1' if s else 'auto'}"
            form(f"base_{tag}", f"{what} base pass (bench case), S={s_base}",
                 flops["newtonian"],
                 lambda: cd._direct_tile(tgt, src, "newtonian", mode, True,
                                         1e-15, mask, nb, start, splits=s),
                 lambda: cd._direct_tile_reference(
                     tgt, src, "newtonian", mode, True, 1e-15, mask, nb,
                     start, splits=s_base),
                 base_pairs, (tgt, src, start), 20 if s is None else 2)
            form(f"band_{tag}", f"{what} band pass (bench case), "
                 f"S={s_band}", flops["spline"],
                 lambda: cd._band(tgt, src, start, mode, True, 1e-15, mask,
                                  cd.TM, cd.TN, nb, splits=s),
                 lambda: cd._band_reference(tgt, src, start, mode, True,
                                            1e-15, mask, cd.TM, cd.TN, nb,
                                            s_band),
                 band_pairs, (tgt, src, start), 20 if s is None else 2)

    # slots a pair and registers of the forms timed here
    prof = sass.library_profile()
    for label, r in prof.items():
        if "POT" in label or label.startswith(("direct_tile_kernel<NEWTON",
                                               "band_kernel<ACC")):
            log(f"(l) {label}: {r['registers']} registers, "
                f"{r['spill_bytes']} spill bytes, "
                f"{r['slots_per_pair']:.3f} slots a pair: "
                + ", ".join(f"{op} {v:g}" for op, v in
                            r["per_pair"].items()))
    stats["slots"] = {label: r.get("slots_per_pair")
                      for label, r in prof.items()}
    log(f"(l) wall {time.perf_counter() - t_phase:.1f} s")
    return stats


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", help="copy the nvcc build log here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # the package must come from this checkout: fail before printing
    # anything when the script stands alone
    import nbody_streams_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi, name = phase_a(args.log_dir)
    stats = phase_b(dev)
    phase_c(dev)
    launches = phase_d(dev)
    phase_e(dev)
    bench = phase_f(dev, smi, name)
    roof_stats, roof_launches = phase_g(dev, stats)
    phase_h(dev, stats)
    ext_stats, ext_launches = phase_i(dev, bench["ms_per_step"])
    df_stats, df_launches = phase_j(dev)
    scf_stats, scf_launches = phase_k(dev)
    pot_stats = phase_l(dev)
    m_launches = phase_m(dev)
    n_launches, n_stats = phase_n(dev)
    o_launches, o_stats = phase_o(dev)
    p_launches, p_branches, p_stats = phase_p(dev)
    q_launches, q_stats = phase_q(dev, stats)
    slots = pot_stats["slots"]
    # no single PyTorch call computes a softened all-pairs sum or an
    # fma / rsqrt chain: library_ms is null for every kernel
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_pipe")

    def measured(st):
        """The numbers of a kernel's entry, fp32_share the share of the
        FP32 bound alone."""
        return {**{k: st[k] for k in keys},
                "fp32_share": st["fp32_bound_ms"] / st["ms"]}
    # the run paths, each with its launch counts zeroed just before it (the
    # fit's launch has a row of its own below; the SCF ladder's reference
    # launches the single pass once)
    paths = {"bench": launches, **ext_launches, **df_launches,
             "quasispherical_run": scf_launches["quasispherical_run"],
             "scf_ladder": scf_launches["scf_ladder"], **m_launches,
             **n_launches, **o_launches, **p_launches}
    # the default paths take no tensor-core form: M and F run only where
    # an option asks for them (phase q's paths)
    tensor = {k: {f: p.get(f, 0) for f in ("moment", "moment_2set", "fast")}
              for k, p in paths.items()}
    check(not any(sum(v.values()) for v in tensor.values()),
          f"a default path launched kernel M or F: {tensor}")
    paths.update(q_launches)

    def row(name, key, replaces, st, source=SOURCE):
        by_path = {k: p.get(key, 0) for k, p in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **measured(st),
                "library_ms": None, "splits": st["splits"]}

    forms = q_stats["forms"]
    tensor_rows = [
        # rows 1m, 1f and 2m: the tensor-core forms (phase q)
        row("moment_tile_kernel M (base pass)", "moment",
            "nbody_streams_tpu/ops/pallas_direct.py:301 (_tile_sum mxu "
            ":244-273, finalised :467-469)", forms["fold"], MOMENT_SOURCE),
        row("moment_tile_kernel F (base pass, float32_fast)", "fast",
            "nbody_streams_tpu/ops/pallas_direct.py:301 (_tile_sum mxu_r2 "
            ":211-227)", forms["fast"], MOMENT_SOURCE),
        row("moment_tile_kernel M (two-set, the ring's far tile)",
            "moment_2set", "nbody_streams_tpu/ops/pallas_direct.py:771 "
            "(pallas_accel_2set mxu=True, _direct_kernel :301)",
            q_stats["two_set"], MOMENT_SOURCE)]
    tensor_rows[0]["unfolded"] = measured(forms["unfold"])
    tensor_rows[1]["potential"] = measured(forms["fast_pot"])
    tensor_rows[2]["shape"] = q_stats["two_set"]["shape"]
    for r, label in zip(tensor_rows, (
            "moment_tile_kernel<ACC,fold,Kahan,skip,exact> (M, base pass)",
            "moment_tile_kernel<ACC,fold,Kahan,skip,fast> (F, base pass)",
            "moment_tile_kernel<ACC,fold,Kahan,noskip,exact> (M two-set)")):
        r["slots"] = slots[label]
    kernels = [
        # rows 1 and 3: the sorted path's two passes at the bench case
        row("direct_tile_kernel (base pass)", "base",
            "nbody_streams_tpu/ops/pallas_direct.py:301", stats["direct"]),
        # row 2: the single pass, timed at the SCF ladder's shape with the
        # Plummer law (the ladder's exact reference)
        row("direct_tile_kernel (single pass)", "single",
            "nbody_streams_tpu/ops/pallas_direct.py:473 (_call_kernel, "
            "pallas_call :476)", scf_stats["row2"]),
        row("band_kernel", "band",
            "nbody_streams_tpu/ops/pallas_direct.py:494", stats["band"])]
    kernels[0]["slots"] = slots[
        "direct_tile_kernel<NEWTONIAN,ACC,Kahan,skip> (base pass)"]
    kernels[2]["slots"] = slots["band_kernel<ACC,Kahan> (band pass)"]
    # which branch the sorted path picked on the DF runs and phase (n)'s
    kernels[1]["branches_by_path"] = {
        **{k: df_stats[k]["branches"] for k in df_launches},
        **n_stats["branches"], **p_branches}
    # the flagship's kernels at N = 2,097,153 (p.1): rows 1 and 3 on the
    # fresh order, row 2 on the order one drift old that its steps take
    for i, key in ((0, "base"), (1, "single"), (2, "band")):
        if key in p_stats["rows"]:
            st = p_stats["rows"][key]
            kernels[i]["at_flagship"] = {
                "ms": st["ms"], "bound_ms": st["bound_ms"],
                "bound_pipe": st["bound_pipe"], "shape": st["shape"],
                "share": st["bound_ms"] / st["ms"]}
    kernels[1]["at_flagship"]["max_abs_err"] = max(
        p_stats["single_pass"][mode]["max_abs_err"] for mode in ("acc", "pot"))
    # the ring's forms of the single pass at its D = 4 tile shape (o.2)
    kernels[1]["ring_forms"] = {
        label: {**measured(st), "splits": st["splits"], "shape": st["shape"]}
        for label, st in o_stats["forms"].items()}
    # the two-set potential form of the single-pass kernel (the fit's
    # launch site; its launches from phase i's fit), timed at the fit's
    # shape in phase l
    label = "direct_tile_kernel<PLUMMER,POT,Kahan> (two-set, fit)"
    kernels.append({
        "name": label, "route": "cuda", "source": SOURCE,
        "replaces": "nbody_streams_tpu/ops/pallas_direct.py:790 (via "
                    "potentials/fit.py:296)",
        "launches": ext_stats["fit"]["launches"],
        **measured(pot_stats["fit"]), "library_ms": None,
        "splits": pot_stats["fit"]["splits"], "slots": slots[label]})
    replaces = {
        "fma_chain": "nbody_streams_tpu/ops/probe.py:62, bench.py:95, "
                     "benchmarks/tile_sweep.py:111",
        "rsqrt_chain": "benchmarks/tile_sweep.py:111",
        "tile_sol": "benchmarks/tile_sweep.py:193",
        "tile_sol_moment": "benchmarks/tile_sweep.py:193 (sol mxu=True)"}
    kernels += [{"name": f"{key}_kernel", "route": "cuda",
                 "source": ROOFLINE_SOURCE, "replaces": replaces[key],
                 "launches": roof_launches[key],
                 **measured(roof_stats[key]), "library_ms": None}
                for key in replaces]
    # tile_sol and tile_sol_moment at full occupancy (phase g): the
    # newtonian force tile, the moment tile (kernel M's fractions of it)
    kernels[-2].update(blocks=roof_stats["tile_sol"]["blocks"],
                       reps=roof_stats["tile_sol"]["reps"],
                       slots=slots["tile_sol_kernel<NEWTONIAN>"])
    kernels[-1].update(blocks=roof_stats["tile_sol_moment"]["blocks"],
                       reps=roof_stats["tile_sol_moment"]["reps"],
                       slots=slots["tile_sol_moment_kernel"],
                       m_fraction=roof_stats["m_vs_sol"])
    kernels += tensor_rows
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
