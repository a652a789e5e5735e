#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ssme_tpu_torch/csrc`` and drives
its paths through the port's own entry points, over the full SPY series
(T=3084): adaptive PMMH on univariate SVOL at the flagship size (C=64
chains x R=4 replicates x N=512 particles) through the SVOL filter
kernel, adaptive PMMH on SVOL with leverage at its tuned size (C=64 x
R=2 x N=512) through the generic filter kernel, the kernel swarm
forecast (32 parameter draws x N=1024) from that posterior, Liu-West
joint state + parameter filtering of SVOL with leverage (F=64 filters x
N=512) through the Liu-West kernel, and adaptive PMMH on Student-t SVOL
at the flagship size through the generic filter kernel, whose other
model families (Poisson AR, factor SVOL) and APF mode are held to the
JAX package's filters; then the roll-based Metropolis and rejection
resamplers of all three filter kernels, adaptive PMMH on SVOL at N=2048
particles through one generic-kernel launch per iteration, and the fused
SVOL step kernel; then the SVOL and Liu-West kernels at up to 4096
particles, adaptive PMMH on SVOL at N=2048 through one SVOL-kernel
launch per iteration, and the SPY flagship CLI; then the fixed-lag
smoother and the two tuning CLIs; then the parallel package at one rank
over NCCL; then the float64 oracle and the accuracy gate's own oracle
run.  Phases, one line each:

1. device   the card's name and power limit (no card: exit non-zero);
2. build    nvcc build of the kernels, with ptxas' register counts; every
            instance of the SVOL kernel (systematic and roll, each layout
            and its twin), of the generic kernel's systematic family (each
            functor, bootstrap and APF, at 2 and 4 particles per thread,
            and the instrumented twins) and roll family (the same at 2, 4,
            8 and 16 particles per thread, and its twins) and of the
            Liu-West kernel's systematic family (each functor at 2
            particles per thread in both layouts, and each one's twin) and
            roll family (each functor at 2, 4 and 8, and each one's twin)
            spills nothing; each paired Liu-West instance's static shared
            memory and its dynamic floor (lw_ring.cuh) fit a block;
3. philox   the Philox kernel against the plain Philox on 2^20 pairs;
4. select   the standalone selection kernel in the systematic families'
            layout (kPer neighbouring slots) at N=512 with 2 and 4 slots a
            thread, at N=32, 96 and 1024, on random, dominant and zero-run
            weights: ancestors bit for bit those of the kernel's own
            counts, marks and scan (the plain model) on the CDF it
            returns, the leaves moved by them, and against the plain law;
5. filter   the filter kernel against the plain filter with a gate that
            never fires (identical random bits, no resampling);
6. filter   full size, both schedules, two parameter points: kernel and
            plain means within 4 combined standard errors; times at B=256
            and at the flagship CLI's B=128; clock64 cycles of a step's
            parts, the selections' fix-ups and most marks a thread, and
            at every N of the systematic kernel's instances the
            barriers a step crossed and the layout it ran (``step_spans``:
            the barriers must be those its source note states);
7. pmmh     ``AdaptivePMMH`` + ``svol_batched_log_like``, a warm-up window
            then a timed one of 30 iterations per schedule; the kernel's
            launch count must rise by exactly iterations + 1 per run, and
            the iterations never synchronise with the host;
8. cli      ``ssme_tpu_torch.examples.estimate_univ_svol`` on the card;
9. megakernel-sis   the generic kernel against its plain version for
            both instances with a gate that never fires (totals, zero
            patterns, functional means, the final cloud), and its svol
            instance against the SVOL kernel on the same seed;
10. megakernel-full B=128 N=512, both instances, three schedules, two
            parameter points: kernel and plain means within 4 combined
            standard errors; times;
11. pmmh-leverage   ``AdaptivePMMH`` + ``megakernel_log_like`` on the
            leverage model, 30 iterations per gate stride, launches =
            iterations + 1, no host synchronisation;
12. posterior-leverage  ``ssme_tpu_torch.examples.estimate_svol_leverage
            --tuned`` for 2000 iterations at gate strides 1 and 8: the
            posterior means within 4 combined Monte-Carlo standard errors
            of the committed JAX posteriors;
13. swarm   ``ssme_tpu_torch.examples.swarm_forecast`` on the posterior
            samples of phase 12, and the swarm evidence against the plain
            version at N=1024;
14. lw-sis  the Liu-West kernel against its plain version for both
            instances (SISR, a gate that never fires: identical bits),
            and the leverage wrapper (K4) equal to the K3 instance;
15. lw-full F=64 N=512 over SPY, four schedules, and APF at F=128:
            kernel and plain means within 4 combined standard errors; each
            launch in the layout the rule gives (paired at F=64, one CTA a
            filter at F=128, more filters than the card holds pairs of
            CTAs); times; a forecast from the kernel's cloud;
16. lw-cli  ``ssme_tpu_torch.examples.liu_west_leverage`` on the card,
            both engines, against the JAX package's float32 results in
            ``data/spy_liu_west_jax.json``; exactly one kernel launch;
17. megakernel-families-sis  the generic kernel's svol_t, poisson_ar and
            factor_svol (4 and 5 assets) instances against the plain
            version with a gate that never fires (identical bits), and
            its APF mode for svol, svol_leverage, svol_t and poisson_ar
            (B=32, T=64: step 0 equal, most per-step lcls equal, the
            totals' errors printed);
18. families-full  svol_t and svol APF over SPY (B=256), poisson_ar
            bootstrap and APF (B=128, T=3084) and factor_svol with 4 assets
            (B=32, T=500), N=512: kernel and plain means within 4 combined
            standard errors, and the kernel within 4 of the JAX package's
            float32 filters in ``data/k2_families_jax.json`` (factor_svol
            also of its float64 filter); times;
19. pmmh-svol_t  ``AdaptivePMMH`` on Student-t SVOL through
            ``megakernel_log_like`` (C=64 x R=4 x N=512, SPY), 30 iterations
            per gate stride, launches = iterations + 1, no host
            synchronisation;
20. large-n ``megakernel_log_like`` above the kernel's 1024 particles: the
            generic bank with ``model=``, no kernel launch; without it, an
            error;
21. roll-sis    ``roll_select`` against the plain law on fixed weights
            (ancestors equal, both resamplers, N=512, 2048 and 4096, with a
            row of zeros that rejection runs to the 4096 cap), and the
            generic kernel (svol and svol_leverage bootstrap, svol APF;
            N=512, 2048 and 4096), the SVOL kernel and the Liu-West kernel
            (APF and SISR) under both resamplers against their plain
            versions (B=32, T=64: step 0 equal, most totals within 2e-3);
22. roll-full   the generic kernel on SVOL over SPY at ESS 0.5, B=256,
            N=2048 and 4096: rejection within 4 combined standard errors
            of the JAX bank in ``data/roll_resamplers_jax.json``,
            Metropolis (``metropolis_sweeps_for(0.5, T, 0.5)`` sweeps)
            within that plus its bias envelope; the SVOL kernel (N=512) and
            the Liu-West kernel (F=64, N=512, APF) under each resampler
            within 4 of their plain versions at T=256, and over SPY the
            SVOL kernel's roll runs within 4 of its systematic run (the
            Liu-West kernel's beside it: its evidence moves with the
            resampler); times, plain times at T=256;
23. pmmh-large-n  ``AdaptivePMMH`` on SVOL through ``megakernel_log_like``
            at N=2048 with ``resampler="rejection"`` (C=64 x R=4, SPY): one
            kernel launch per iteration, none through the bridge, no host
            synchronisation; ms per iteration beside phase 20's bridge;
            then the same proposals through the roll family's svol twin:
            the sweeps a resample ran (median, 99th percentile, maximum,
            the share at the 4096 cap), the votes and the tail's slots;
24. svol-step   the fused SVOL step kernel against its plain version
            (B=256, N=512), the moments of sigma eps over 8 seeds; at
            (B, N) = (256, 512), (1024, 2048) and (4096, 4096) its
            outputs on fixed inputs bit for bit those of the kernel before
            its non-coherent loads and streaming stores (their digests)
            and x' the plain version's, its device time (inputs cycled
            through 200 MB so that each launch reads outside L2), an empty
            kernel on its grid (the launch floor) and its byte and issue
            bounds;
25. k1-large-sis    the SVOL kernel at N=2048 and 4096 (8 particles per
            thread, 8 and 16 under the roll resamplers): the standalone
            systematic selection in its layout (phase 4's checks), and the
            filter under each
            resampler against its plain version on identical bits (B=32,
            T=64: no selection, then every step: step 0 equal, 90% of the
            totals within 2e-3 under the roll resamplers, of step 1's lcl
            under the systematic one, whose rows part at a boundary flip);
26. k1-large-full   the SVOL kernel at N=2048 and 4096 over SPY (B=256, ESS
            0.5) under each resampler within 4 combined standard errors of
            the JAX bank (Metropolis plus its bias envelope); times, bounds;
27. k3-large    the Liu-West kernel at N=2048 and 4096 (4 and 8 particles
            per thread) under both roll resamplers: on identical bits
            (F=16, T=64), against its plain version at T=128 within 4 SE,
            its time over SPY; the svol_leverage_lw_q instance (its own
            SISR proposal) against its plain version on identical bits and,
            at kappa 1, equal to svol_leverage_lw;
28. pmmh-large-n-k1  ``AdaptivePMMH`` on SVOL at N=2048 through the SVOL
            kernel's systematic selection (C=64 x R=4, SPY): one launch per
            iteration, no host synchronisation, ms per iteration beside
            phase 23's;
29. flagship-cli  ``ssme_tpu_torch.examples.spy_flagship`` at its width for
            500 iterations per schedule (every step, ESS 0.5): the samples'
            shape, finite, an accept rate in (0, 1), launches = iterations
            + 1, the summary on stdout;
30. k2-layout   the generic kernel's systematic family at N=32, 96, 512
            and 1024: the instrumented twins' barriers a step (3 / 2 / 0 in
            the bootstrap, 5 an APF step) and layout (kPer, threads), their
            outputs the plain instances' bits; its roll family's twins
            (svol_leverage bootstrap and APF, svol bootstrap) under both
            resamplers at N=32 to 4096: 2 barriers a check and 4 an APF
            step besides the selections' votes (one per chunk of 32
            sweeps) and tail barriers, the layout, the outputs the plain
            instances' bits; its svol instance against the SVOL kernel
            (the same CDF, selection, paired draws and offsets) at parity and
            ESS 0.5 over SPY, B=128: step 0 equal, step 1 within 2e-3 on
            90% of the rows, the means within 4 combined standard errors;
            the SVOL kernel's roll twins under both resamplers at N=32 to
            4096: 2 barriers a check besides the selections' votes and
            tail barriers, the layout, the outputs the plain instances'
            bits;
31. k3-layout   the Liu-West kernel's systematic family at N=32, 96, 512
            and 1024, every functor, in both layouts (paired at F=16: 2
            CTAs a filter and a wait on the ring; one CTA a filter at
            F=128: no wait): the instrumented twins' barriers a step (8 / 7
            an APF step that does / does not resample, 5 / 4 in SISR, 3 / 2
            at t = 0), layout (2 particles per thread, CTAs a filter) and
            clock64 spans, their outputs the plain instances' bits; its
            roll family's twins, every functor under both resamplers at
            N=32 to 4096: the same barriers besides the selections' votes
            and tail barriers, the layout, clock64 spans, the outputs the
            plain instances' bits;
32. smoother    ``filters.fixed_lag_smoother`` on the LGSSM on the card
            (T=500, N=4096, lag 10, 8 replicate smoothers as one batch):
            the smoothed means within the Monte-Carlo and truncation
            tolerance of ``tests/test_smoothing.py`` of the RTS smoother,
            closer than the filtered means, the log-likelihood within 4
            standard errors of the Kalman filter's; wall seconds;
33. tune-variance   ``examples.tune_variance`` in-process over SPY at
            N=512, 256 singles in two launches of 128 rows, R = 1, 2, 4:
            two SVOL-kernel launches, finite variances falling with R;
34. tune-pmmh   ``examples.tune_pmmh`` in-process over SPY (8 chains, N=512,
            R=2, 200 iterations in chunks of 50) under ``profiling.trace``:
            one SVOL-kernel launch per iteration and one for the init, a
            record with an accept rate in (0, 1), and a Chrome trace that
            names the SVOL kernel;
35. parallel    ``ssme_tpu_torch.parallel`` at one rank over NCCL (a
            ``file://`` store in a temporary directory; the group is
            destroyed at the end of the phase), at the flagship width
            (SPY T=3084, C=64, R=4, N=512): (a) the chain-sharded hooks
            ``sharded_megakernel_log_like`` (the generic kernel's svol
            instance) and ``shard_batched_log_like`` around the SVOL
            kernel's hook, each bit for bit its inner hook on the folded
            generator, one launch a call, without a host wait, and ms a
            call of the sharded and the inner hook; (b) ``sharded_pmmh``
            through the SVOL kernel for 20 iterations, bit for bit the
            rank's own ``run_from``, ms an iteration of both; (c) the
            particle-sharded bootstrap filter on CUDA tensors at N=4096
            over SPY at ESS 0.5, ring and allgather bit for bit on one
            seed, the ring's 4 seeds within 4 standard errors of the
            port's ``BootstrapFilter``, wall seconds; (d)
            ``ShardedLiuWest`` on SVOL with leverage over SPY's first
            1024 returns (one filter, N=512, ESS 0.5), the constant
            functional 42 to 1e-3;
            (e) ``BENCH_MODE=scaling python -m ssme_tpu_torch.bench``:
            its row at D=1;
36. oracle      the float64 oracle (``ssme_tpu_torch.oracle``) on the card:
            ``loglike_reps`` over SPY at the committed JAX chains'
            posterior mean (``data/accuracy_gate.json``), N=500, R=8, on
            4 seeds on the card and 4 on the CPU, the means within 4
            combined standard errors; 10 ``oracle_pmmh`` iterations at that
            width from the posterior mode, seconds an iteration; then
            ``examples.accuracy_gate`` in-process with its own oracle run
            (``--oracle-npy`` with no file: 5 iterations, N=500, R=2) and
            both engines for 300 iterations each: 301 SVOL-kernel
            launches an engine, finite means, nine comparisons, the draws
            saved beside its output;
37. k3-factor   K3's factor_svol_5_lw (the wide row) against its plain
            version at F=16 T=64 and over the whole 5-column panel at
            F=64 N=1024, its twin and both layouts' launches;
38. k2-factor-sv  K2's factor_svol_sv_10 (12 leaves, 10 columns) at the
            benchmark cell's shape (B=256, N=1024, T=3084): against its
            plain version on the same seed by the step-one rule and
            within 4 SE, the launch's ms against its bound, the twin's
            cycles a step by part; then AdaptivePMMH through
            ``megakernel_log_like`` over the instance (64 chains x 4
            replicates), one launch an iteration.

Any failure exits non-zero.  The line before the last is a JSON object
describing the kernels; the last is the ``{"ok": true, ...}`` contract.
Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ssme_tpu_torch import profiling  # noqa: E402
from ssme_tpu_torch.bench import (device_share, gpu_identity,  # noqa: E402
                                  max_sm_clock_hz)
from ssme_tpu_torch.examples import estimate_svol_leverage as lev_cli  # noqa: E402,E501
from ssme_tpu_torch.examples import liu_west_leverage as lw_cli  # noqa: E402
from ssme_tpu_torch.examples import tune_pmmh, tune_variance  # noqa: E402
from ssme_tpu_torch.filters import fixed_lag_smoother  # noqa: E402
from ssme_tpu_torch.inference import (AdaptivePMMH,  # noqa: E402
                                      forecast_from_cloud)
from ssme_tpu_torch.io import ParamSampler, read_data  # noqa: E402
from ssme_tpu_torch.models import (factor_svol, lgssm, svol,  # noqa: E402
                                   svol_leverage, svol_t)
from ssme_tpu_torch.ops import _cuda, _prng, _select  # noqa: E402
from ssme_tpu_torch.ops import filter_megakernel as fmk  # noqa: E402
from ssme_tpu_torch.ops import liu_west_megakernel as lwm  # noqa: E402
from ssme_tpu_torch.ops import svol_filter_kernel as sfk  # noqa: E402
from ssme_tpu_torch.ops import svol_kernel as k5  # noqa: E402
from ssme_tpu_torch.ops import svol_leverage_lw_kernel as k4  # noqa: E402
from ssme_tpu_torch.utils import logmeanexp  # noqa: E402

C, R, N = 64, 4, 512
B = C * R
ITERS = 30
SCHEDULES = {"parity": (1.0, 1), "adaptive": (0.5, 8)}
START = torch.tensor(svol.START_TRANS_THETA)

# the leverage path (estimate_svol_leverage --tuned) and its swarm
LC, LR = 64, 2
LB = LC * LR
K2_SCHEDULES = {"parity": (1.0, 1), "tuned": (0.5, 1), "adaptive": (0.5, 8)}
LEV_POINTS = {"start": lev_cli.START,
              "posterior": (0.958, -0.080, 0.311, -0.751)}
POSTERIORS = {1: "spy_leverage_pmmh_tuned.json",
              8: "spy_leverage_pmmh_tuned_stride8.json"}
SWARM_N, SWARM_M = 1024, 32

# the Liu-West path (liu_west_leverage --engine kernel)
LW_F, LW_N = 64, 512
LW_RUNS = {"apf": ("svol_leverage_lw", dict(variant="apf")),
           "apf-ess": ("svol_leverage_lw",
                       dict(variant="apf", ess_threshold=0.5)),
           "sisr": ("svol_leverage_lw", dict(variant="sisr")),
           "svol_t-apf": ("svol_t_lw", dict(variant="apf")),
           # more filters than the card holds pairs of CTAs at once: the
           # systematic family's one-CTA layout
           "apf-f128": ("svol_leverage_lw",
                        dict(variant="apf", num_filters=128))}

# the generic kernel's other families (phases 17-20): the JAX package's
# float32 yardsticks (scripts/k2_families_jax.py) and the points they are at
FAMILIES_JSON = os.path.join(ROOT, "data", "k2_families_jax.json")
SVOL_T_POINT = (0.868, 0.975, 0.064, 10.0)
POISSON_POINT = (0.9, 1.0, 0.3)
# svol's chain start with log nu = log 10 appended
SVOL_T_START = tuple(svol.START_TRANS_THETA) + (math.log(10.0),)
APF_B, APF_T = 32, 64
FACTOR_B = 32

# the roll resamplers (phases 21-23): the JAX bank's yardstick
# (scripts/roll_resamplers_jax.py) at phase 6's posterior point, the
# sizes of the kernel-vs-plain checks, of the full runs and of the PMMH
ROLL_JSON = os.path.join(ROOT, "data", "roll_resamplers_jax.json")
ROLL_POINT = (0.9, 0.98, 0.02)
ROLLS = ("metropolis", "rejection")
ROLL_B, ROLL_T, ROLL_ITERS = 32, 64, 16
ROLL_FULL_B, ROLL_PLAIN_T = 256, 256
ROLL_N = (2048, 4096)
# N of phase 21's roll_select and generic-kernel checks
ROLL_SIS_N = (512,) + ROLL_N
LARGE_N, LARGE_ITERS = 2048, 10
STEP_B, STEP_N = 256, 512
# the fused step's shapes (phase 24): the moments' and two where bytes
# and not the launch set the pace; ops/svol_kernel.py::digest of the
# outputs on fixed_inputs, seed words (5, 0), y 0.37, of the kernel
# before its loads and stores went through the non-coherent and
# streaming paths (scripts/k5_timing.py --bits)
STEP_SHAPES = {(256, 512): "08a3fe0fa99ad1bf",
               (1024, 2048): "73b50b47aa01738c",
               (4096, 4096): "a8681edfc72c921f"}
STEP_ROTATE_BYTES, STEP_REPS = 200e6, 50
# the smoother on the card (phase 32) and the tuning CLIs (33-34)
SMOOTH_T, SMOOTH_N, SMOOTH_LAG, SMOOTH_R = 500, 4096, 10, 8
SMOOTH_PARAMS = (0.8, 0.5, 0.7)
TUNE_N, TUNE_SINGLES, TUNE_ROWS = 512, 256, 128
TUNE_PMMH = ("smoke", 8, 512, 2, 1000)
TUNE_ITERS, TUNE_CHUNK = 200, 50
# K1 and K3 above 1024 particles, the q instance, the flagship CLI
# (phases 25-29)
K3_SIS_F, K3_LARGE_T = 16, 128
Q_KAPPA = 1.5
FLAGSHIP_ITERS = 500
# instances of the SVOL kernel (csrc/svol_filter_sys.cu launch_for:
# systematic kPer 2 and 4 at up to 256 threads, 8 at up to 256 and 512;
# roll kPer 2, 4, 8 and 16 at up to 256 threads; each also instrumented)
K1_SYS_INSTANCES = K1_ROLL_INSTANCES = 8
# the roll families' kPer at each N (svol_filter_sys.cu kper_for,
# lw_megakernel_sys.cuh roll_kper_for); phases 30 and 31 hold the twins'
# records to them
K1_ROLL_KPER = {32: 2, 512: 2, 1024: 4, 2048: 8, 4096: 16}
K3_ROLL_KPER = {32: 2, 512: 2, 1024: 2, 2048: 4, 4096: 8}
# instances of the generic kernel's systematic family
# (csrc/filter_megakernel_sys.cuh): per kPer (2, 4) the 7 functors'
# bootstrap, the 4 lookahead functors' APF and the 2 instrumented twins;
# of its roll family, per kPer (2, 4, 8, 16) the same and 3 twins
K2_SYS_INSTANCES = 2 * (8 + 4 + 3)
K2_ROLL_INSTANCES = 4 * (7 + 4 + 3)
# N at which phase 30 reads the twins' record (partial warps at 32 and 96),
# and the roll twins' (powers of two)
K2_RECORD_N = (32, 96, 512, 1024)
K2_ROLL_RECORD_N = (32, 512, 1024) + ROLL_N
# instances of the Liu-West kernel's systematic family
# (csrc/lw_megakernel_sys.cu, and the paired layout's in
# lw_megakernel_sys_pair.cu): the 3 functors and each one's instrumented
# twin in each layout; phase 31 reads the twins at K2_RECORD_N; of its
# roll family (csrc/lw_megakernel_sys_roll{2,4,8}.cu) the 3 functors and
# their twins at each kPer
K3_SYS_INSTANCES = 2 * 4 * 2
# of them in the paired layout: the 3 functors whose row keeps theta in
# registers (the ring's floor of dynamic shared memory) and
# factor_svol_5_lw's wide row (its cloud and a one-step ring, phase 37)
K3_PAIRED_INSTANCES = 2 * 4
# the shared memory an H100 block may take (sharedMemPerBlockOptin), static
# and dynamic together
K3_BLOCK_SMEM = 232448
K3_ROLL_INSTANCES = 3 * 2 * 3
# N at which phase 6 reads the systematic kernel's record: each of its
# instances
K1_RECORD_N = (32, N, 1024) + ROLL_N

# the parallel phase (35): sharded PMMH iterations held to run_from, the
# iterations of each timing window and the turns of four windows
# (sharded, run_from, run_from, sharded, and the reverse every other
# turn: each turn's ratio cancels the host's drift), timing calls of the hooks, the scaling bench's
# iterations a window, the sharded bootstrap filter's particles and
# seeds, the sharded Liu-West filter's particles and steps (cut to keep
# the script under 600 s)
PAR_ITERS, PAR_TIME_ITERS, PAR_TURNS, PAR_REPS = 20, 100, 8, 10
PAR_SCALING_ITERS = 200
PAR_PF_N, PAR_PF_SEEDS, PAR_PF_ALLGATHER = 4096, 4, 1
PAR_LW_N, PAR_LW_T = 512, 1024
PAR_POINT = (0.849, 0.9744, 0.0659)
# the filters resample when the global ESS falls under half the cloud
# (the flagship's schedule): the sharded filters' steps are host-bound,
# and a step that does not resample issues fewer operations
PAR_ESS = 0.5

# the float64 oracle (36): the width of the committed JAX chains (N, R),
# the seeds of its likelihood on each device, the iterations timed, and
# the gate's own short run (its oracle's and each engine's iterations,
# the engines' burn-in and adaptation restart)
ORACLE_N, ORACLE_R, ORACLE_SEEDS, ORACLE_ITERS = 500, 8, 4, 10
GATE_ORACLE_ITERS, GATE_ENGINE_ITERS, GATE_BURN = 5, 300, 100

# the least time of a kernel's work: the larger of its bytes over the HBM
# rate and its operations over the float32 rate outside the tensor cores
# (H100 SXM data sheet; integer and special-
# function operations run no faster, so the bound stays a lower bound)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# operations per particle and step, counted from the sources; a normal is
# half a Philox4x32-10 call (10 rounds x 2 mul-hi, 2 mul, 4 xor, 2 key
# adds = 100) plus its half of Box-Muller (~12): 56, which is what every
# family of the SVOL, generic and Liu-West kernels computes (one call per
# pair of particles).  Resampling inside a gated schedule depends on the
# data and is left out (a lower bound).
NORMAL_OPS = 56
STEP_OPS = {
    # normal, phi x + sigma e, the weight (exp, 2 mul, fma), max/exp/3 sums
    "svol_filter": NORMAL_OPS + 2 + 6 + 8,
    # the leverage transition mean (exp, 3 mul, fma, clamp) adds 10
    "filter_megakernel": NORMAL_OPS + 12 + 6 + 8,
    # P + 1 = 5 normals; moments (exp, 5 sums, 10 Gram terms x 3); shrink
    # 8; four constrains (7 each); lookahead 12; three weights (6 each);
    # first-stage max/exp and selection (scan, 9-step search, 6 gathers)
    # 20; kernel draw 10 fma = 20; transition 14; weigh 8; the every-step
    # resample (scan, search, 5 gathers) 15
    "lw_megakernel": 5 * NORMAL_OPS + 36 + 8 + 28 + 12 + 18 + 20 + 20 + 14
                     + 8 + 15,
    # its svol instance: the SVOL kernel's step
    "filter_megakernel/svol": NORMAL_OPS + 2 + 6 + 8,
    # the generic kernel's other instances (bootstrap): svol_t's weight
    # adds a divide, a log1p and two multiplies to svol's (10)
    "filter_megakernel/svol_t": NORMAL_OPS + 2 + 10 + 8,
    # transition mean (sub, fma) + fma 3; weight (mul, exp, 2 sub) 4
    "filter_megakernel/poisson_ar": NORMAL_OPS + 3 + 4 + 8,
    # two normals, two transitions (3 each); weight: v1, v2, yy over 4
    # assets (3 x 4 fma + 4 mul), 2 exp + 2 add, det 2, the quadratic form
    # 8 + a divide, log + 3 adds, 3 for the result: 36
    "filter_megakernel/factor_svol_4": 2 * NORMAL_OPS + 6 + 36 + 8,
    # the factor SV model as published, 10 assets (PR 25; the benchmark's
    # paths["filter_megakernel.factor_svol_sv_10"]): 12 normals; 12
    # transitions (sub, mul, fma) and their clamps (min, max); the weight:
    # per asset exp(-u), A's 3 fma, y e^-u, v1, v2, yy 3 fma, sum u (9 x
    # 10), then factor_svol's 2 x 2 solve 20
    "filter_megakernel/factor_svol_sv_10": 12 * NORMAL_OPS + 36 + 24 + 90
                                           + 20 + 8,
    # APF adds per step: the lookahead twice (svol: 1 each), two more
    # weights (6 each), the first-stage add and exp/max 2, and the
    # selection (scan, 9-step search, gather) 20
    "filter_megakernel/svol/apf": NORMAL_OPS + 2 + 6 + 8 + 2 * 1 + 2 * 6
                                  + 2 + 20,
    # poisson_ar: lookahead 2 each, weights 4 each
    "filter_megakernel/poisson_ar/apf": NORMAL_OPS + 3 + 4 + 8 + 2 * 2
                                        + 2 * 4 + 2 + 20,
}


_PHASE_CLOCK = [time.perf_counter()]


def phase(num, name, msg):
    """The phase's line, ending in the wall seconds since the last one
    (the script's time limit is shared by every phase)."""
    now = time.perf_counter()
    print(f"phase {num} {name}: ok {msg} [{now - _PHASE_CLOCK[0]:.1f} s]",
          flush=True)
    _PHASE_CLOCK[0] = now


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` by CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(name, num_rows, num_particles, num_steps, in_bytes, out_bytes):
    """(bound_ms, bound_by) of one launch of kernel ``name``."""
    ops = STEP_OPS[name] * num_rows * num_particles * num_steps
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else
            "operations")


def event_ms(fn):
    """(result, milliseconds) of one call of ``fn`` by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# the filter kernels' entries in the launch table of ops/_cuda.py
K1, K2, K3 = "ssme_svol_filter", "ssme_filter_megakernel", "ssme_lw_megakernel"
_ZERO = {}


def zero_launches(*entries):
    """Count the launches of ``entries`` from 0 from here on."""
    for entry in entries:
        _ZERO[entry] = _cuda.launches(entry)


def launched(entry):
    """The launches of ``entry`` since :func:`zero_launches` zeroed it."""
    return _cuda.launches(entry) - _ZERO.get(entry, 0)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs on the card only")
    ident = gpu_identity()
    phase(1, "device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{ident} | count {torch.cuda.device_count()}")
    print(ident, flush=True)
    return ident


def _k1_key(name, roll):
    """The SVOL kernel's instance of a mangled entry name in the
    systematic family (roll False) or the roll family (roll True)."""
    t = re.search(r"svol_filter_sys_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                  name)
    if not t or (t.group(4) == "1") != roll:
        return None
    return (f"kper{t.group(1)}/threads{t.group(2)}"
            + ("/spans" if t.group(3) == "1" else ""))


def _k2_key(name, roll):
    """The generic kernel's instance of a mangled entry name in the
    systematic family (roll False) or the roll family (roll True)."""
    t = re.search(r"filter_megakernel_sysIN4ssme\d+(\w+?Model)(?:ILi(\d+)EE)?"
                  r"ELb(\d)ELi(\d+)ELb(\d)ELb(\d)E", name)
    if not t or (t.group(6) == "1") != roll:
        return None
    return (f"{t.group(1)}{t.group(2) or ''}/"
            f"{'apf' if t.group(3) == '1' else 'bootstrap'}/"
            f"kper{t.group(4)}" + ("/spans" if t.group(5) == "1" else ""))


def _k3_key(name, roll):
    """The Liu-West kernel's instance of a mangled entry name in the
    systematic family (roll False) or the roll family (roll True)."""
    t = re.search(r"lw_megakernel_sysIN4ssme\d+(\w+?LW)ELi(\d+)ELi(\d+)ELb"
                  r"(\d)ELb(\d)ELb(\d)E", name)
    if not t or (t.group(5) == "1") != roll:
        return None
    return (f"{t.group(1)}/kper{t.group(2)}/threads{t.group(3)}"
            + ("/paired" if t.group(6) == "1" else "")
            + ("/twin" if t.group(4) == "1" else ""))


def _ptxas_instances(ptxas, key):
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    entries whose mangled name ``key`` maps to an instance, from ptxas' -v
    lines, in their order."""
    out, name, spill = {}, None, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and spill is None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and spill:
            out[name] = (int(m.group(1)),) + spill
            name = spill = None
    return out


def _ptxas_smem(ptxas, key):
    """{instance: static shared memory bytes} of the entries whose mangled
    name ``key`` maps to an instance, from ptxas' -v lines."""
    out, name = {}, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = key(m.group(1))
            continue
        m = re.search(r"Used \d+ registers.*?(\d+) bytes smem", ln)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def _k3_pair_floor():
    """csrc/lw_ring.cuh's kPairFloorBytes: each paired CTA's dynamic shared
    memory at every N (tests/test_torch_lw_megakernel.py holds the ring
    inside it)."""
    with open(os.path.join(ROOT, "ssme_tpu_torch", "csrc",
                           "lw_ring.cuh")) as f:
        return 1024 * int(re.search(
            r"constexpr int kPairFloorBytes = (\d+) \* 1024;",
            f.read()).group(1))


def phase_build():
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    ptxas = info.get("ptxas", [])
    found = {}
    for kernel, key, want in (("SVOL kernel's systematic family",
                               lambda n: _k1_key(n, False), K1_SYS_INSTANCES),
                              ("SVOL kernel's roll family",
                               lambda n: _k1_key(n, True), K1_ROLL_INSTANCES),
                              ("generic kernel's systematic family",
                               lambda n: _k2_key(n, False), K2_SYS_INSTANCES),
                              ("generic kernel's roll family",
                               lambda n: _k2_key(n, True), K2_ROLL_INSTANCES),
                              ("Liu-West kernel's systematic family",
                               lambda n: _k3_key(n, False), K3_SYS_INSTANCES),
                              ("Liu-West kernel's roll family",
                               lambda n: _k3_key(n, True),
                               K3_ROLL_INSTANCES)):
        inst = _ptxas_instances(ptxas, key)
        require(len(inst) == want, f"ptxas reports {len(inst)} instances of "
                f"the {kernel}, want {want}: {inst}")
        spilled = {k: v for k, v in inst.items() if v[1] or v[2]}
        require(not spilled, f"{kernel} instances spill: {spilled}")
        found[kernel] = inst
    # each paired K3 CTA's static arrays and its dynamic floor fit the
    # card's 227 KB a block
    floor = _k3_pair_floor()
    smem = {k: v for k, v in _ptxas_smem(
        ptxas, lambda n: _k3_key(n, False)).items() if "/paired" in k}
    factor = lwm.factor_svol_lw_kernel_model()
    wide_bytes = {False: lwm.wide_row_bytes(factor, 1024),
                  True: lwm.wide_row_bytes(factor, 1024, paired=True)}

    def dynamic(k):
        if "FactorSvolLW" in k:
            return wide_bytes["/paired" in k]
        return floor if "/paired" in k else 0

    smem = _ptxas_smem(ptxas, lambda n: _k3_key(n, False))
    paired = [k for k in smem if "/paired" in k]
    wide = {k: v for k, v in smem.items() if "FactorSvolLW" in k}
    require(len(paired) == K3_PAIRED_INSTANCES and len(wide) == 4 and all(
        v + dynamic(k) <= K3_BLOCK_SMEM for k, v in smem.items()),
        f"K3's static shared memory {smem} and its dynamic bytes (the ring's "
        f"floor {floor}, the wide row's {wide_bytes} at N=1024) exceed "
        f"{K3_BLOCK_SMEM} or instances are missing")
    phase(2, "build", f"{time.perf_counter() - t0:.3f} s (nvcc "
          f"{info.get('seconds', 0.0):.3f} s); static shared memory of the "
          f"paired K3 instances (+ {floor} dynamic, at most {K3_BLOCK_SMEM}):"
          " " + ", ".join(f"{k} {v}" for k, v in smem.items()
                          if "/paired" in k and k not in wide)
          + f"; of the wide ones (+ {wide_bytes[False]} dynamic at N=1024, "
          f"{wide_bytes[True]} paired): "
          + ", ".join(f"{k} {v}" for k, v in wide.items())
          + "; (registers, spill stores, spill loads) of " + "; ".join(
              f"the {kernel}: " + ", ".join(f"{k} {v}" for k, v in
                                            inst.items())
              for kernel, inst in found.items()) + " | " + " | ".join(ptxas))
    return tuple(found.values())


def phase_philox(dev):
    seed = _prng.seed_words(0x243F6A8885A308D3, device=dev)
    rows, n, step = 256, 8192, 3084        # 2^20 Box-Muller pairs
    got = _prng.philox_fill(seed, rows, n, step)
    want = _prng.philox_fill_reference(seed, rows, n, step)
    for key in ("bits", "u1", "u2", "offsets"):
        require(torch.equal(got[key], want[key]), f"philox {key} differ")
    require(bool((got["u1"] > 0).all()) and bool((got["offsets"] > 0).all())
            and bool((got["offsets"] < 1).all()), "uniform edge rule broken")
    # the kernel's logf/sqrtf/sincosf and torch's may differ in the last
    # bit or two of float32: 1e-6 relative, 1e-7 absolute near zero
    torch.testing.assert_close(got["normals"], want["normals"], rtol=1e-6,
                               atol=1e-7)
    err = float((got["normals"] - want["normals"]).abs().max())
    phase(3, "philox", f"{rows * n // 2} pairs: bits, uniforms, offsets "
          f"bitwise equal; normals max abs err {err:.3e}")


def _weights(rng, rows, n, case):
    """Selection weights (rows, n): gamma, or one dominant particle per
    row over weights of 1e-12, or gamma with three long zero runs."""
    w = rng.gamma(1.0, 1.0, (rows, n)).astype(np.float32)
    if case == "dominant":
        w *= np.float32(1e-12)
        w[np.arange(rows), rng.integers(0, n, rows)] = 1.0
    elif case == "zero_runs":
        for r in range(rows):
            for _ in range(3):
                a = rng.integers(0, n)
                w[r, a:a + rng.integers(n // 8, n // 2)] = 0.0
    return w


def _systematic_agreement(dev, rng, rows, n, kper, case="random"):
    """The standalone selection kernel at ``kper`` slots per thread on
    ``case`` weights (rows, n): its ancestors are bit for bit those of the
    plain model of its counts, marks and scan
    (``systematic_ancestors_marks``) on the CDF it returns, which never
    falls (row_select.cuh);
    the ids leaf is the ancestors and the values leaf moves by them; under
    1% of the slots differ from the plain law (torch.cumsum), each within
    1e-5 of the total of a CDF boundary.  Returns (differing slots, their
    share, the worst distance)."""
    w = torch.as_tensor(_weights(rng, rows, n, case), device=dev)
    ids = torch.arange(n, dtype=torch.float32, device=dev).expand(rows, n)
    vals = torch.as_tensor(rng.normal(size=(rows, n)).astype(np.float32),
                           device=dev)
    leaves = torch.stack([ids, vals]).contiguous()
    u0 = _prng.offsets(_prng.seed_words(5, device=dev),
                       torch.arange(rows, device=dev), 1)
    picked, anc, cdf_k = _select.systematic_select(w, leaves, u0, kper=kper,
                                                   return_cdf=True)
    _, anc_plain = _select.systematic_select_reference(w, leaves, u0)
    anc, anc_plain = anc.long(), anc_plain.long()
    tag = f"N={n} kper={kper} {case}"
    require(torch.equal(anc, _select.systematic_ancestors_marks(
        cdf_k, u0, kper).ancestors), f"{tag}: ancestors differ from the "
            "counts, marks and scan on the kernel's CDF")
    require(bool((cdf_k[:, 1:] >= cdf_k[:, :-1]).all()),
            f"{tag}: the CDF falls")
    require(torch.equal(picked[0].long(), anc), f"{tag}: ids leaf != ancestors")
    require(torch.equal(picked[1], torch.gather(vals, 1, anc)),
            f"{tag}: values leaf not moved by the same ancestors")
    diff = anc != anc_plain
    frac = float(diff.float().mean())
    require(frac < 0.01, f"{tag}: {frac:.4%} of ancestor slots disagree")
    # every disagreement must sit within 1e-5 * total of a CDF boundary
    # between the two ancestors chosen (float64 CDF and points)
    w64 = w.double()
    cdf = torch.cumsum(w64, dim=1)
    total = cdf[:, -1:]
    u = (torch.arange(n, device=dev, dtype=torch.float64)[None]
         + u0.double()[:, None]) * total / n
    worst = 0.0
    for b_, j in diff.nonzero().tolist():
        lo, hi = sorted((int(anc[b_, j]), int(anc_plain[b_, j])))
        gap = float((cdf[b_, lo:hi] - u[b_, j]).abs().min() / total[b_, 0])
        worst = max(worst, gap)
        require(gap <= 1e-5, f"{tag} row {b_} slot {j}: disagreement "
                f"{gap:.2e} of the total away from a boundary")
    return int(diff.sum()), frac, worst


# (N, kPer) of phase 4: the SVOL kernel's at N=512 and the generic
# kernel's at 1024 (4), at the partial warps of N=32 and 96, and at 1024
SELECT_LAYOUTS = ((N, 4), (N, 2), (32, 2), (96, 2), (1024, 4))
SELECT_CASES = ("random", "dominant", "zero_runs")


def _select_checks(dev, rng, rows, layouts):
    """_systematic_agreement at each (N, kPer) and weight case: the
    summary strings."""
    out = []
    for n, kper in layouts:
        for case in SELECT_CASES:
            ndiff, frac, worst = _systematic_agreement(dev, rng, rows, n,
                                                       kper, case)
            if case == "random" or ndiff:
                out.append(f"N={n} kPer {kper} {case}: {ndiff} slots "
                           f"({frac:.5%}) off the plain law, worst "
                           f"{worst:.2e}")
    return out


def phase_select(dev):
    sel = _select_checks(dev, np.random.default_rng(4), B, SELECT_LAYOUTS)
    phase(4, "select", f"B={B}, {len(SELECT_LAYOUTS) * len(SELECT_CASES)} "
          "cases, ancestors bit for bit the counts, marks and scan on the "
          "kernel's CDF; " + "; ".join(sel) + "; leaves move jointly")


def phase_filter_sis(dev, ys_all):
    """No resampling: identical bits through identical recursions."""
    ys = ys_all[:512].reshape(-1).contiguous()
    params = torch.tensor([[1.0, 0.5, math.sqrt(2e-4)]] * (B // 2)
                          + [[0.9, 0.98, math.sqrt(0.02)]] * (B // 2),
                          device=dev)
    errs = []
    for g in (1, 8):
        kw = dict(num_particles=N, ess_threshold=1e-6, gate_stride=g)
        tot, lcl, xm = sfk.svol_filter(7, params, ys, **kw)
        tot_p, lcl_p, xm_p = sfk.svol_filter_reference(7, params, ys, **kw)
        # float32 throughout; the kernel fuses multiply-adds and reduces
        # in another order than torch, so each step differs by a few ulp
        # and the totals by far less than 1e-4 relative
        torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3)
        require(torch.equal(lcl != 0, lcl_p != 0), f"g={g}: zero pattern")
        torch.testing.assert_close(xm, xm_p, rtol=1e-3, atol=1e-3)
        errs.append(float((tot - tot_p).abs().max()))
    phase(5, "filter-sis", f"B={B} N={N} T=512 strides 1, 8: totals max abs"
          f" err {errs[0]:.3e}, {errs[1]:.3e}; lcl zero patterns identical")
    return max(errs)


def phase_filter_full(dev, ys):
    points = {"start": svol.make_model().transform.constrain(START),
              "posterior": torch.tensor([0.9, 0.98, 0.02])}
    times, spans = {}, {}
    plain_start = {}
    for sched, (ess, g) in SCHEDULES.items():
        for pname, theta in points.items():
            row = torch.stack([theta[0], theta[1], torch.sqrt(theta[2])])
            params = row.to(dev).expand(B, 3).contiguous()
            kw = dict(num_particles=N, ess_threshold=ess, gate_stride=g)
            tot = sfk.svol_filter(11, params, ys, **kw)[0]
            tot_p = sfk.svol_filter_reference(12, params, ys, **kw)[0]
            require(bool(torch.isfinite(tot).all())
                    and bool(torch.isfinite(tot_p).all()), "NaN totals")
            se = math.sqrt(float(tot.var()) / B + float(tot_p.var()) / B)
            d = abs(float(tot.mean()) - float(tot_p.mean()))
            require(d <= 4 * se, f"{sched}/{pname}: means differ by {d:.3f}"
                    f" > 4 SE {4 * se:.3f}")
            if pname == "start":
                plain_start[sched] = tot_p
                half = params[:B // 2].contiguous()
                times[sched] = (
                    cuda_ms(lambda: sfk.svol_filter(11, params, ys, **kw), 5),
                    cuda_ms(lambda: sfk.svol_filter_reference(
                        12, params, ys, **kw), 1),
                    cuda_ms(lambda: sfk.svol_filter(11, half, ys, **kw), 5))
                spans[sched] = sfk.step_spans(11, params, ys, **kw)
                spans[sched].pop("outputs")
            print(f"  {sched}/{pname}: kernel mean {float(tot.mean()):.4f} "
                  f"plain mean {float(tot_p.mean()):.4f} (4 SE "
                  f"{4 * se:.4f})", flush=True)
    # the barriers and layout of every instance, read on the card
    start = svol.make_model().transform.constrain(START)
    params = torch.stack([start[0], start[1], torch.sqrt(start[2])]).to(
        dev).expand(B, 3).contiguous()
    layout = {}
    for n in K1_RECORD_N:
        for sched, (ess, g) in SCHEDULES.items():
            rec = sfk.step_spans(11, params, ys[:512].contiguous(), n, ess, g)
            _require_barriers(f"N={n} {sched}", rec)
        layout[str(n)] = {"kper": rec["kper"], "threads": rec["threads"]}
    for sched, sp in spans.items():
        _require_barriers(f"N={N} {sched} over SPY", sp)
    phase(6, "filter-full", f"B={B} N={N} T={ys.shape[0]}: " + "; ".join(
        f"{s} kernel {k:.4f} ms (B={B // 2}: {h:.4f} ms), plain {p:.4f} ms"
        for s, (k, p, h) in times.items()) + "; clock64 cycles a step by "
        "part (thread 0 of each row, mean): " + "; ".join(
            f"{s} " + ", ".join(f"{k} {v:.1f}" for k, v in
                                sp["cycles_per_step"].items())
            + f" ({sp['checks']:.0f} checks, {sp['resamples']:.0f} "
            f"resamples; the selections' fix-ups {sp['fixups']:.0f}, most "
            f"marks a thread {sp['most_marks']})" for s, sp in spans.items())
        + "; barriers a step (resample, check, other) " + "; ".join(
            f"{s} {sp['barriers_per_step']}" for s, sp in spans.items())
        + "; layout (kPer, threads) " + ", ".join(
            f"N={n} ({v['kper']}, {v['threads']})" for n, v in layout.items()))
    return times, plain_start, spans, layout


def _require_barriers(tag, rec):
    """The barriers a step of each kind crossed on the card are those the
    systematic kernel's source note states (sfk.BARRIERS_PER_STEP)."""
    for kind, want in sfk.BARRIERS_PER_STEP.items():
        got = rec["barriers_per_step"][kind]
        require(got is None or got == want, f"K1 {tag}: {got} barriers a "
                f"{kind} step, the source note states {want}")


def phase_pmmh(dev, ys, ident, plain_start):
    props_per_run = ITERS * C * R * N * ys.shape[0]   # init not timed
    zero_launches(K1)
    rates, counts = {}, {}
    for sched, (ess, g) in SCHEDULES.items():
        before = launched(K1)
        pmmh = AdaptivePMMH(svol.make_model(), num_particles=N,
                            num_replicates=R, t0=150, t1=1000,
                            batched_log_like=sfk.svol_batched_log_like(
                                N, R, ess_threshold=ess, gate_stride=g))
        state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
        torch.cuda.synchronize()
        # the loop must never wait for the device: any synchronising call
        # (a device-to-host read, a pageable host-to-device copy) raises;
        # a warm-up window of ITERS iterations first, as the bench's
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm = pmmh.run_from(state, ITERS, ys).final_state
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            res = pmmh.run_from(warm, ITERS, ys)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[sched] = launched(K1) - before
        require(counts[sched] == 2 * ITERS + 1,
                f"{sched}: {counts[sched]} kernel launches, want "
                f"{2 * ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"{sched}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"{sched}: no proposal accepted")
        # the chains' starting log-likelihoods against the plain filter's
        # replicate-averaged ones at the same point and schedule
        ref = logmeanexp(plain_start[sched].reshape(C, R), dim=-1)
        se = math.sqrt(float(state.log_like.var()) / C
                       + float(ref.var()) / C)
        d = abs(float(state.log_like.mean()) - float(ref.mean()))
        require(d <= 4 * se, f"{sched}: init log-likelihood off by {d:.3f}")
        rates[sched] = props_per_run / secs
        print(f"  {sched}: {counts[sched]} launches, {n_acc} accepts, "
              f"{secs:.4f} s, {rates[sched]:.6e} props/s on {ident}",
              flush=True)
    total = launched(K1)
    phase(7, "pmmh", f"C={C} R={R} N={N} T={ys.shape[0]} {ITERS} iters "
          "after as many of warm-up: "
          + "; ".join(f"{s} {r:.6e} props/s" for s, r in rates.items())
          + f" ({ident})")
    return total, rates


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "ssme_tpu_torch.examples.estimate_univ_svol",
               os.path.join(ROOT, "data", "spy_returns.csv"),
               os.path.join(tmp, "samples"), os.path.join(tmp, "messages"),
               "10", "4", "--chains", "8", "--particles", "512",
               "--device", "cuda", "--no-timestamp"]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        require(out.returncode == 0, f"CLI exited {out.returncode}:\n"
                f"{out.stderr[-4000:]}")
        for c in range(8):
            with open(os.path.join(tmp, f"samples_chain{c}")) as f:
                rows = [ln.split(",") for ln in f.read().splitlines()]
            require(len(rows) == 10 and all(len(r) == 3 for r in rows),
                    f"chain {c}: bad samples file")
            require(all(math.isfinite(float(v)) for r in rows for v in r),
                    f"chain {c}: non-finite sample")
            with open(os.path.join(tmp, f"messages_chain{c}")) as f:
                lines = f.read().splitlines()
            require(len(lines) == 11 and lines[0].startswith("iter number"),
                    f"chain {c}: bad messages file")
    phase(8, "cli", "10 iterations x 8 chains on cuda: sample and message "
          "files well formed")


def _svol_rows(theta, rows):
    """Constrained (beta, phi, ss) -> (rows, 3) kernel rows."""
    row = torch.tensor([float(theta[0]), float(theta[1]),
                        math.sqrt(float(theta[2]))])
    return row.expand(rows, 3).contiguous()


def _instances(zs):
    """(name, kernel model, covariates) of both generic-kernel instances."""
    return [("svol", fmk.svol_kernel_model(), None),
            ("svol_leverage", fmk.svol_leverage_kernel_model(), zs)]


def _compare_sis(name, km, rows, ys, zs, g, errs):
    """Kernel against plain on identical bits, a gate that never fires:
    totals, zero patterns, functional means, the cloud and its weights;
    records the totals' max abs error in ``errs`` and returns the
    kernel's totals."""
    kw = dict(num_particles=N, ess_threshold=1e-6, gate_stride=g,
              return_cloud=True)
    tot, lcl, fm, cloud, clw = fmk.filter_megakernel(km, 7, rows, ys, zs,
                                                     **kw)
    tot_p, lcl_p, fm_p, cloud_p, clw_p = fmk.filter_megakernel_reference(
        km, 7, rows, ys, zs, **kw)
    # float32 throughout; fused multiply-adds and another reduction order
    # put a few ulp into each step (see phase 5)
    torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3,
                               msg=f"{name} g={g}: totals")
    require(torch.equal(lcl != 0, lcl_p != 0), f"{name} g={g}: zero pattern")
    torch.testing.assert_close(fm, fm_p, rtol=1e-3, atol=1e-3,
                               msg=f"{name} g={g}: functional means")
    for leaf, (a, b) in enumerate(zip(cloud, cloud_p)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3,
                                   msg=f"{name} g={g}: cloud leaf {leaf}")
    torch.testing.assert_close(torch.exp(clw), torch.exp(clw_p), rtol=1e-3,
                               atol=1e-3, msg=f"{name} g={g}: weights")
    errs[f"{name}/g{g}"] = float((tot - tot_p).abs().max())
    return tot


def phase_megakernel_sis(dev, ys_all):
    """No resampling: identical bits through identical recursions."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    half = LB // 2
    params = {
        "svol": torch.cat([_svol_rows((1.0, 0.5, 2e-4), half),
                           _svol_rows((0.9, 0.98, 0.02), half)]).to(dev),
        "svol_leverage": torch.tensor(
            [LEV_POINTS["start"]] * half + [LEV_POINTS["posterior"]] * half,
            device=dev)}
    errs, k1_errs = {}, []
    for name, km, z in _instances(zs):
        for g in (1, 8):
            tot = _compare_sis(name, km, params[name], ys, z, g, errs)
            if name == "svol":
                tot_k1 = sfk.svol_filter(7, params[name], ys,
                                         num_particles=N, ess_threshold=1e-6,
                                         gate_stride=g)[0]
                k1_errs.append(float((tot - tot_k1).abs().max()))
                require(k1_errs[-1] <= 1e-3,
                        f"g={g}: svol instance vs svol_filter differ by "
                        f"{k1_errs[-1]:.3e}")
    phase(9, "megakernel-sis", f"B={LB} N={N} T=512 strides 1, 8: totals max"
          f" abs err {', '.join(f'{e:.3e}' for e in errs.values())} (svol "
          f"g1, g8, leverage g1, g8); cloud and weights within 1e-3; svol "
          f"instance vs svol_filter {k1_errs[0]:.3e}, {k1_errs[1]:.3e}")
    return max(errs.values())


def phase_megakernel_full(dev, ys_all, ident):
    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    points = {
        "svol": {"start": svol.make_model().transform.constrain(START),
                 "posterior": (0.9, 0.98, 0.02)},
        "svol_leverage": LEV_POINTS}
    times = {}
    for name, km, z in _instances(zs):
        for sched, (ess, g) in K2_SCHEDULES.items():
            kw = dict(num_particles=N, ess_threshold=ess, gate_stride=g)
            for pname, theta in points[name].items():
                params = (_svol_rows(theta, LB) if name == "svol"
                          else torch.tensor([theta] * LB)).to(dev)
                tot = fmk.filter_megakernel(km, 11, params, ys, z, **kw)[0]
                tot_p = fmk.filter_megakernel_reference(km, 12, params, ys, z,
                                                        **kw)[0]
                require(bool(torch.isfinite(tot).all())
                        and bool(torch.isfinite(tot_p).all()),
                        f"{name}/{sched}/{pname}: NaN totals")
                se = math.sqrt(float(tot.var()) / LB + float(tot_p.var()) / LB)
                d = abs(float(tot.mean()) - float(tot_p.mean()))
                require(d <= 4 * se, f"{name}/{sched}/{pname}: means differ "
                        f"by {d:.3f} > 4 SE {4 * se:.3f}")
                print(f"  {name}/{sched}/{pname}: kernel mean "
                      f"{float(tot.mean()):.4f} plain mean "
                      f"{float(tot_p.mean()):.4f} (4 SE {4 * se:.4f})",
                      flush=True)
                if pname == "start":
                    times[f"{name}/{sched}"] = (
                        cuda_ms(lambda: fmk.filter_megakernel(
                            km, 11, params, ys, z, **kw), 5),
                        cuda_ms(lambda: fmk.filter_megakernel_reference(
                            km, 12, params, ys, z, **kw), 1))
    phase(10, "megakernel-full", f"B={LB} N={N} T={ys.shape[0]}: " + "; ".join(
        f"{s} kernel {k:.4f} ms, plain {p:.4f} ms"
        for s, (k, p) in times.items()) + f" ({ident})")
    return times


def phase_pmmh_leverage(dev, ys_all, ident):
    ys = ys_all
    zs = svol_leverage.lagged_covariates(ys)
    model = svol_leverage.make_model(prior_bounds=lev_cli.PRIOR_BOUNDS)
    start = model.transform.unconstrain(torch.tensor(lev_cli.START))
    props_per_run = ITERS * LC * LR * N * ys.shape[0]   # init not timed
    # the counts start at 0 just before this path and are read just after
    zero_launches(K1, K2)
    rates = {}
    for g in (1, 8):
        before = launched(K2)
        pmmh = AdaptivePMMH(model, num_particles=N, num_replicates=LR,
                            t0=150, t1=10 ** 9,
                            batched_log_like=fmk.megakernel_log_like(
                                fmk.svol_leverage_kernel_model(), N, LR,
                                ess_threshold=0.5, gate_stride=g))
        state = pmmh.init(0, start, ys, zs=zs, num_chains=LC)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = pmmh.run_from(state, ITERS, ys, zs=zs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = launched(K2) - before
        require(count == ITERS + 1,
                f"g={g}: {count} kernel launches, want {ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"g={g}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"g={g}: no proposal accepted")
        rates[g] = props_per_run / secs
        print(f"  g={g}: {count} launches, {n_acc} accepts, {secs:.4f} s, "
              f"{rates[g]:.6e} props/s on {ident}", flush=True)
    require(launched(K1) == 0, "the SVOL kernel ran on this path")
    launches = launched(K2)
    phase(11, "pmmh-leverage", f"C={LC} R={LR} N={N} T={ys.shape[0]} {ITERS} "
          f"iters: " + "; ".join(f"g{g} {r:.6e} props/s"
                                 for g, r in rates.items()) + f" ({ident})")
    return launches


def _run_cli(module, args, timeout):
    cmd = [sys.executable, "-m", module, *args]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    require(out.returncode == 0, f"{module} exited {out.returncode}:\n"
            f"{out.stderr[-4000:]}")
    return out


def _cli_launches(stderr):
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("filter_megakernel launches:")]
    require(len(lines) == 1, "the CLI did not report its kernel launches")
    return int(lines[0].split(":")[1])


def phase_posterior_leverage(tmp, ident):
    samples_csv = os.path.join(tmp, "leverage_samples.csv")
    lines = []
    for g, ref_name in POSTERIORS.items():
        out_json = os.path.join(tmp, f"leverage_g{g}.json")
        extra = ["--samples-out", samples_csv] if g == 1 else []
        res = _run_cli("ssme_tpu_torch.examples.estimate_svol_leverage",
                       ["--tuned", "--engine", "kernel", "--device", "cuda",
                        "--iters", "2000", "--burn", "500", "--gate-stride",
                        str(g), "--out", out_json, *extra], 900)
        launches = _cli_launches(res.stderr)
        require(launches == 2001, f"g={g}: {launches} kernel launches, "
                "want 2001 (init + 2000 iterations)")
        with open(out_json) as f:
            got = json.load(f)
        with open(os.path.join(ROOT, "data", ref_name)) as f:
            ref = json.load(f)
        parts = []
        for name in lev_cli.NAMES:
            a, b = got["posterior"][name], ref["posterior"][name]
            se = math.hypot(a["sd"] / math.sqrt(a["ess"]),
                            b["sd"] / math.sqrt(b["ess"]))
            d = abs(a["mean"] - b["mean"])
            require(d <= 4 * se, f"g={g} {name}: port mean {a['mean']:.5f} "
                    f"vs JAX {b['mean']:.5f}, diff {d:.5f} > 4 SE "
                    f"{4 * se:.5f}")
            parts.append(f"{name} {a['mean']:.5f} (JAX {b['mean']:.5f}, "
                         f"4 SE {4 * se:.5f}, ESS/s "
                         f"{a['ess'] / got['secs']:.3f})")
        line = (f"g{g}: accept {got['accept']:.4f}, {got['secs']:.3f} s, "
                + "; ".join(parts))
        print(f"  {line} on {ident}", flush=True)
        lines.append(line)
    phase(12, "posterior-leverage", "C=64 R=2 N=512 T=3084 2000 iters "
          "(500 burn-in), within 4 combined MC-SE of both JAX posteriors | "
          + " | ".join(lines))
    return samples_csv


def phase_swarm(dev, ys_all, samples_csv, ident):
    data = os.path.join(ROOT, "data", "spy_returns.csv")
    t0 = time.perf_counter()
    res = _run_cli("ssme_tpu_torch.examples.swarm_forecast",
                   [data, samples_csv, "--model", "svol_leverage", "--engine",
                    "kernel", "--device", "cuda"], 600)
    cli_secs = time.perf_counter() - t0
    ev_line = [ln for ln in res.stdout.splitlines()
               if ln.startswith("total conditional evidence:")]
    require(len(ev_line) == 1, "swarm CLI printed no evidence line")
    evidence = float(ev_line[0].split(":")[1].split()[0])
    require(math.isfinite(evidence), "non-finite swarm evidence")
    quants = [ln.split(":")[1].split() for ln in res.stderr.splitlines()
              if ln.strip().startswith("t+")]
    require(len(quants) == 10 and all(
        math.isfinite(float(v)) for q in quants for v in q),
        "swarm forecast quantiles missing or not finite")
    require(_cli_launches(res.stderr) >= 1, "the swarm CLI ran no kernel")

    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    km = fmk.svol_leverage_kernel_model()
    draws = ParamSampler(samples_csv, dim_param=4).samp(
        torch.Generator(device=dev).manual_seed(3), SWARM_M).contiguous()
    # the counts start at 0 just before this path and are read just after
    zero_launches(K2)
    ev = fmk.megakernel_swarm_evidence(km, 21, draws, ys, zs,
                                       num_particles=SWARM_N,
                                       return_cloud=True)
    launches = launched(K2)
    require(launches == 1, f"{launches} kernel launches for the swarm")
    obs = forecast_from_cloud(svol_leverage.make_model(), draws,
                              ev["final_cloud"], ev["final_log_weights"],
                              torch.Generator(device=dev).manual_seed(4), 10,
                              last_obs=ys[-1:])
    require(obs.shape == (SWARM_M, 10, SWARM_N, 1)
            and bool(torch.isfinite(obs).all()), "bad forecast paths")
    tot_k = ev["per_model_log_cond_likes"].sum(-1)
    tot_p = fmk.filter_megakernel_reference(km, 22, draws, ys, zs,
                                            num_particles=SWARM_N)[0]
    require(bool(torch.isfinite(tot_k).all())
            and bool(torch.isfinite(tot_p).all()), "NaN swarm totals")
    diff = (tot_k - tot_p).double()
    se = float(diff.std()) / math.sqrt(SWARM_M)
    require(abs(float(diff.mean())) <= 4 * se,
            f"swarm: kernel minus plain {float(diff.mean()):.4f} > 4 SE "
            f"{4 * se:.4f}")
    times = (cuda_ms(lambda: fmk.megakernel_swarm_evidence(
                 km, 21, draws, ys, zs, num_particles=SWARM_N,
                 return_cloud=True), 5),
             cuda_ms(lambda: fmk.filter_megakernel_reference(
                 km, 22, draws, ys, zs, num_particles=SWARM_N,
                 return_cloud=True), 1))
    phase(13, "swarm", f"CLI evidence {evidence:.2f}, 10 forecast steps "
          f"finite, {cli_secs:.3f} s wall; M={SWARM_M} N={SWARM_N}: kernel minus plain totals "
          f"{float(diff.mean()):.4f} (4 SE {4 * se:.4f}); kernel "
          f"{times[0]:.4f} ms, plain {times[1]:.4f} ms ({ident})")
    return launches, times


def _lw_instances(zs):
    return {"svol_leverage_lw": (lwm.svol_leverage_lw_kernel_model(), zs),
            "svol_t_lw": (lwm.svol_t_lw_kernel_model(), None)}


def phase_lw_sis(dev, ys_all):
    """SISR with a gate that never fires: identical bits, no selection."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    kw = dict(num_filters=32, num_particles=LW_N, variant="sisr",
              ess_threshold=0.5 / LW_N)
    errs = {}
    for name, (km, z) in _lw_instances(zs).items():
        got = (k4.svol_leverage_lw(7, ys, **kw) if name == "svol_leverage_lw"
               else lwm.lw_megakernel(km, 7, ys, z, **kw))
        want = lwm.lw_megakernel_reference(km, 7, ys, z, **kw)
        err = float((got["log_likelihood"] - want["log_likelihood"])
                    .abs().max())
        # float32 throughout; fused multiply-adds and another reduction
        # order put a few ulp into each step, as in phases 5 and 9
        require(err <= 2e-3, f"{name}: totals differ by {err:.3e}")
        s_rows = km.num_state
        for rows, what in ((slice(0, s_rows), "state"),
                           (slice(s_rows + 1, None), "theta")):
            torch.testing.assert_close(got["cloud"][:, rows],
                                       want["cloud"][:, rows], rtol=0,
                                       atol=1e-3, msg=f"{name} {what} rows")
        # negligible particles carry log-weights far below -100: compare
        # the normalised weights
        torch.testing.assert_close(lwm.lw_cloud_weights(km, got["cloud"]),
                                   lwm.lw_cloud_weights(km, want["cloud"]),
                                   rtol=0, atol=1e-3)
        if km.functionals:
            torch.testing.assert_close(got["functional_paths"][0],
                                       want["functional_paths"][0], rtol=0,
                                       atol=1e-3)
        errs[name] = err
    # K4 is the K3 instance: the same launch, bit for bit, APF every step
    km, z = _lw_instances(zs)["svol_leverage_lw"]
    a = k4.svol_leverage_lw(9, ys, num_filters=32, num_particles=LW_N)
    b = lwm.lw_megakernel(km, 9, ys, z, num_filters=32, num_particles=LW_N)
    for key in ("log_cond_likes", "cloud"):
        require(torch.equal(a[key], b[key]), f"K4 != K3 instance: {key}")
    phase(14, "lw-sis", f"F=32 N={LW_N} T=512 SISR, gate never fires: totals"
          f" max abs err {errs['svol_leverage_lw']:.3e} (leverage, through "
          f"svol_leverage_lw), {errs['svol_t_lw']:.3e} (svol_t); state, "
          "theta, weights and the svol_t path within 1e-3; svol_leverage_lw "
          "== K3 instance bit for bit (APF, every step)")
    return errs


def phase_lw_full(dev, ys_all, ident):
    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    inst = _lw_instances(zs)
    times, clouds, layouts = {}, {}, {}
    for run, (name, kw) in LW_RUNS.items():
        km, z = inst[name]
        kw = dict(dict(num_filters=LW_F, num_particles=LW_N), **kw)
        f = kw["num_filters"]
        keys = {k: lwm.launch_key(km.cuda_instance, k) for k in lwm.LAYOUTS}
        before = {k: _cuda.launches(K3, keys[k]) for k in lwm.LAYOUTS}
        out = lwm.lw_megakernel(km, 11, ys, z, **kw)
        layouts[run] = next(k for k in lwm.LAYOUTS
                            if _cuda.launches(K3, keys[k]) > before[k])
        want = lwm.layout_for(f, lwm._max_clusters(lwm._model_id(km), LW_N))
        require(layouts[run] == want, f"{run}: F={f} ran the "
                f"{layouts[run]} layout, the rule gives {want}")
        ref, plain_ms = event_ms(
            lambda: lwm.lw_megakernel_reference(km, 12, ys, z, **kw))
        tot, tot_p = out["log_likelihood"], ref["log_likelihood"]
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()), f"{run}: NaN totals")
        se = math.sqrt(float(tot.var()) / f + float(tot_p.var()) / f)
        d = abs(float(tot.mean()) - float(tot_p.mean()))
        require(d <= 4 * se, f"{run}: means differ by {d:.3f} > 4 SE "
                f"{4 * se:.3f}")
        print(f"  {run}: kernel mean {float(tot.mean()):.4f} sd "
              f"{float(tot.std()):.4f}, plain mean {float(tot_p.mean()):.4f}"
              f" sd {float(tot_p.std()):.4f} (4 SE {4 * se:.4f})",
              flush=True)
        times[run] = (cuda_ms(lambda: lwm.lw_megakernel(km, 11, ys, z, **kw),
                              5), plain_ms)
        clouds[run] = out["cloud"]
    require(set(layouts.values()) == set(lwm.LAYOUTS),
            f"not every layout ran: {layouts}")
    k4_ms = cuda_ms(lambda: k4.svol_leverage_lw(11, ys, num_filters=LW_F,
                                                num_particles=LW_N), 5)
    fut = lwm.lw_kernel_sim_future_obs(
        inst["svol_leverage_lw"][0], svol_leverage.make_model(),
        clouds["apf"], torch.Generator(device=dev).manual_seed(5), 10,
        last_obs=ys[-1:])
    require(fut.shape == (LW_F, 10, LW_N, 1)
            and bool(torch.isfinite(fut).all()), "bad Liu-West forecast")
    phase(15, "lw-full", f"F={LW_F} (apf-f128: F=128) N={LW_N} "
          f"T={ys.shape[0]}, each within 4 SE of its plain version: "
          + "; ".join(
              f"{r} kernel {k:.4f} ms ({layouts[r]} layout), plain "
              f"{p:.4f} ms" for r, (k, p) in times.items())
        + f"; svol_leverage_lw {k4_ms:.4f} ms; 10-step forecast finite "
        f"({ident})")
    return times, k4_ms


def _run_in_process(main, argv):
    """(stdout, stderr) of an entry point's ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _cli_params(stderr):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s+(\w+)\s+= ([-+]?\d+\.\d+) \+-", stderr, re.M)}


def phase_lw_cli(ident):
    data = os.path.join(ROOT, "data", "spy_returns.csv")
    with open(os.path.join(ROOT, "data", "spy_liu_west_jax.json")) as f:
        ref = json.load(f)
    # the kernel engine: the counts start at 0 just before and are read
    # just after
    zero_launches(K3)
    k4.svol_leverage_lw.launches = 0
    t0 = time.perf_counter()
    out, err = _run_in_process(lw_cli.main, [
        data, "--engine", "kernel", "--filters", str(LW_F), "--particles",
        str(LW_N), "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches = (launched(K3), k4.svol_leverage_lw.launches)
    require(launches == (1, 1), f"{launches} kernel launches, want 1")
    m = re.search(r"log-likelihood: ([-\d.]+) \+- ([\d.]+) \((\d+) "
                  r"filters\)", out)
    require(m is not None, f"no log-likelihood line in {out!r}")
    mean, sd, f = float(m.group(1)), float(m.group(2)), int(m.group(3))
    # the kernel selects its first stage systematically: its yardstick is
    # the JAX filter with that selection
    jax_k = ref["systematic_first_stage"]
    se = math.hypot(sd / math.sqrt(f), jax_k["log_likelihood"]["sd"]
                    / math.sqrt(ref["filters"]))
    d = abs(mean - jax_k["log_likelihood"]["mean"])
    require(d <= 4 * se, f"kernel CLI mean {mean:.2f} vs JAX "
            f"{jax_k['log_likelihood']['mean']:.2f}: {d:.2f} > 4 SE "
            f"{4 * se:.2f}")
    params = _cli_params(err)
    for name in ("phi", "sigma", "rho"):
        want = jax_k["params"][name]
        require(abs(params[name] - want["mean"]) <= 2 * want["sd"],
                f"kernel CLI {name} {params[name]:.4f} outside JAX "
                f"{want['mean']:.4f} +- 2 x {want['sd']:.4f}")
    # the generic engine (multinomial first stage, as the JAX filter)
    t1 = time.perf_counter()
    gout, _ = _run_in_process(lw_cli.main, [
        data, "--engine", "generic", "--particles", str(LW_N), "--forecast",
        "10", "--device", "cuda"])
    gsecs = time.perf_counter() - t1
    g_ll = float(re.search(r"log-likelihood: ([-\d.]+)", gout).group(1))
    jax_g = ref["generic"]["log_likelihood"]
    require(math.isfinite(g_ll) and abs(g_ll - jax_g["mean"])
            <= 4 * jax_g["sd"], f"generic CLI log-likelihood {g_ll:.2f} vs "
            f"JAX {jax_g['mean']:.2f} +- 4 x {jax_g['sd']:.2f}")
    quants = [ln.split(":")[1].split() for ln in gout.splitlines()
              if ln.strip().startswith("t+")]
    require(len(quants) == 10 and all(math.isfinite(float(v))
                                      for q in quants for v in q),
            "generic CLI forecast quantiles missing or not finite")
    phase(16, "lw-cli", f"kernel engine F={f} N={LW_N}: {mean:.2f} +- "
          f"{sd:.2f} (JAX systematic first stage "
          f"{jax_k['log_likelihood']['mean']:.2f}, 4 SE {4 * se:.2f}), phi "
          f"{params['phi']:.4f} sigma {params['sigma']:.4f} rho "
          f"{params['rho']:.4f}, 1 launch, {secs:.3f} s; generic engine "
          f"{g_ll:.2f} (JAX {jax_g['mean']:.2f} +- {jax_g['sd']:.2f}), "
          f"10 forecast steps finite, {gsecs:.3f} s ({ident})")
    return launches[0]


def _families(dev):
    """The JAX yardsticks and the series of phases 17-18."""
    with open(FAMILIES_JSON) as f:
        ref = json.load(f)
    counts = fmk.poisson_obs_rows(torch.tensor(ref["poisson_ar_counts"]))
    fys = torch.tensor(ref["factor_svol_ys"], dtype=torch.float32)
    fparams = torch.tensor(ref["factor_svol_params"], dtype=torch.float32)
    return (ref, counts.to(dev).contiguous(), fys.to(dev).contiguous(),
            fparams)


def _factor5(dev):
    """Parameters and a T=500 series of the port's 5-asset factor SVOL,
    both from a seeded generator."""
    gen = torch.Generator().manual_seed(17)
    params = factor_svol.make_model(5, 2).sample_prior(gen)
    _, ys = factor_svol.simulate(gen, params, 500, 5, 2)
    return params, ys.to(dev).contiguous()


def phase_families_sis(dev, ys_all):
    ref, counts, fys, fparams = _families(dev)
    ys = ys_all[:512, 0].contiguous()
    half = LB // 2
    f5_params, f5_ys = _factor5(dev)
    cases = [
        ("svol_t", fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * half
                         + [(1.0, 0.9, 0.05, 4.0)] * half)).to(dev), ys),
        ("poisson_ar", fmk.poisson_ar_kernel_model(), torch.tensor(
            [POISSON_POINT] * half + [(0.8, 0.5, 0.4)] * half, device=dev),
         counts[:512].contiguous()),
        ("factor_svol_4", fmk.factor_svol_kernel_model(4),
         fparams.expand(LB, -1).contiguous().to(dev), fys),
        ("factor_svol_5", fmk.factor_svol_kernel_model(5),
         f5_params.expand(LB, -1).contiguous().to(dev), f5_ys)]
    errs = {}
    for name, km, rows, y in cases:
        for g in (1, 8):
            _compare_sis(name, km, rows, y, None, g, errs)
    # APF: identical bits; after the first selection the kernel's CDF and
    # torch.cumsum may pick different neighbours at a CDF boundary, so
    # only step 0 must agree to float tolerance, and most (row, step)
    # cells: a flip is rare (phase 4), and a row agrees until its first
    # flip
    ys_apf = ys_all[:APF_T, 0].contiguous()
    apf_cases = [
        ("svol", fmk.svol_kernel_model(),
         _svol_rows(SVOL_T_POINT[:3], APF_B).to(dev), ys_apf, None),
        ("svol_leverage", fmk.svol_leverage_kernel_model(),
         torch.tensor([LEV_POINTS["posterior"]] * APF_B, device=dev), ys_apf,
         svol_leverage.lagged_covariates(ys_apf)),
        ("svol_t", fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * APF_B)).to(dev), ys_apf, None),
        ("poisson_ar", fmk.poisson_ar_kernel_model(),
         torch.tensor([POISSON_POINT] * APF_B, device=dev),
         counts[:APF_T].contiguous(), None)]
    apf_errs = {}
    for name, km, rows, y, z in apf_cases:
        kw = dict(num_particles=N, mode="apf")
        tot, lcl, _ = fmk.filter_megakernel(km, 9, rows, y, z, **kw)
        tot_p, lcl_p, _ = fmk.filter_megakernel_reference(km, 9, rows, y, z,
                                                          **kw)
        torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5,
                                   atol=1e-4, msg=f"apf {name}: step 0")
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()),
                f"apf {name}: non-finite totals")
        agree = float(((lcl - lcl_p).abs() <= 1e-3).float().mean())
        require(agree >= 0.5, f"apf {name}: only {agree:.3f} of the lcl "
                "cells agree within 1e-3")
        apf_errs[name] = (float((lcl[:, 0] - lcl_p[:, 0]).abs().max()),
                          float((tot - tot_p).abs().max()), agree)
    phase(17, "megakernel-families-sis", f"B={LB} N={N} T=512 (factor T=500)"
          " strides 1, 8, gate never fires: totals max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; cloud and weights within 1e-3 | APF B={APF_B} T={APF_T}: "
          + ", ".join(f"{k} step 0 {a:.3e} totals {b:.3e} cells within "
                      f"1e-3 {c:.4f}" for k, (a, b, c) in apf_errs.items()))
    return max(errs.values())


def phase_families_full(dev, ys_all, ident):
    ref, counts, fys, fparams = _families(dev)
    ys = ys_all[:, 0].contiguous()
    f = ref["filters"]
    runs = {
        "svol_t": (fmk.svol_t_kernel_model(), fmk.svol_t_param_rows(
            torch.tensor([SVOL_T_POINT] * B)), ys, "bootstrap",
            [("JAX", ref["svol_t_bootstrap"])]),
        "svol/apf": (fmk.svol_kernel_model(), _svol_rows(SVOL_T_POINT[:3], B),
                     ys, "apf",
                     [("JAX systematic first stage",
                       ref["svol_apf"]["first_stage"]["systematic"])]),
        "poisson_ar": (fmk.poisson_ar_kernel_model(),
                       torch.tensor([POISSON_POINT] * LB), counts,
                       "bootstrap", [("JAX", ref["poisson_ar_bootstrap"])]),
        "poisson_ar/apf": (fmk.poisson_ar_kernel_model(),
                           torch.tensor([POISSON_POINT] * LB), counts, "apf",
                           [("JAX systematic first stage",
                             ref["poisson_ar_apf"]["first_stage"]
                             ["systematic"])]),
        # F2: the float32 kernel against the float64 ground truth
        "factor_svol_4": (fmk.factor_svol_kernel_model(4),
                          fparams.expand(FACTOR_B, -1), fys, "bootstrap",
                          [("JAX f32", ref["factor_svol_f32"]),
                           ("JAX f64 (F2)", ref["factor_svol_f64"])]),
    }
    results = {}
    for name, (km, rows, y, mode, yardsticks) in runs.items():
        rows = rows.contiguous().to(dev)
        b = rows.shape[0]
        kw = dict(num_particles=N, ess_threshold=1.0, mode=mode)
        before = launched(K2)
        tot = fmk.filter_megakernel(km, 11, rows, y, **kw)[0]
        launches = launched(K2) - before
        out_p, plain_ms = event_ms(lambda: fmk.filter_megakernel_reference(
            km, 12, rows, y, **kw))
        tot_p = out_p[0]
        require(bool(torch.isfinite(tot).all())
                and bool(torch.isfinite(tot_p).all()), f"{name}: NaN totals")
        mean, sd = float(tot.mean()), float(tot.std())
        se = math.sqrt(float(tot.var()) / b + float(tot_p.var()) / b)
        d = abs(mean - float(tot_p.mean()))
        require(d <= 4 * se, f"{name}: kernel {mean:.3f} vs plain "
                f"{float(tot_p.mean()):.3f}, {d:.3f} > 4 SE {4 * se:.3f}")
        line = (f"  {name}: kernel {mean:.4f} sd {sd:.4f}, plain "
                f"{float(tot_p.mean()):.4f} (4 SE {4 * se:.4f})")
        for label, jx in yardsticks:
            se_j = math.hypot(sd / math.sqrt(b), jx["sd"] / math.sqrt(f))
            d_j = abs(mean - jx["mean"])
            require(d_j <= 4 * se_j, f"{name}: kernel {mean:.3f} vs {label} "
                    f"{jx['mean']:.3f}, {d_j:.3f} > 4 SE {4 * se_j:.3f}")
            line += f"; {label} {jx['mean']:.4f} (4 SE {4 * se_j:.4f})"
        print(line, flush=True)
        ms = cuda_ms(lambda: fmk.filter_megakernel(km, 11, rows, y, **kw), 5)
        t_len, d_obs = y.shape[0], km.dim_obs
        bnd = bound(f"filter_megakernel/{name}", b, N, t_len, 4 * (t_len * d_obs + b * km.num_params)
                    + 16, 4 * b * (2 * t_len + 1))
        results[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                         "bound_by": bnd[1], "rows": b, "T": t_len,
                         "check_launches": launches, "mean": mean,
                         "sd": sd}
    phase(18, "families-full", f"N={N}: " + "; ".join(
        f"{k} B={v['rows']} T={v['T']} kernel {v['ms']:.4f} ms, plain "
        f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
        for k, v in results.items()) + f" ({ident})")
    return results


def phase_pmmh_svol_t(dev, ys_all, ident):
    ys = ys_all
    model = svol_t.make_model()
    props_per_run = ITERS * C * R * N * ys.shape[0]   # init not timed
    # the counts start at 0 just before this path and are read just after
    zero_launches(K1, K2)
    rates = {}
    for g in (1, 8):
        before = launched(K2)
        pmmh = AdaptivePMMH(model, num_particles=N, num_replicates=R,
                            t0=150, t1=1000,
                            batched_log_like=fmk.megakernel_log_like(
                                fmk.svol_t_kernel_model(), N, R,
                                constrain=fmk.svol_t_param_rows,
                                ess_threshold=0.5, gate_stride=g))
        state = pmmh.init(0, SVOL_T_START, ys, num_chains=C)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = pmmh.run_from(state, ITERS, ys)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count = launched(K2) - before
        require(count == ITERS + 1,
                f"g={g}: {count} kernel launches, want {ITERS + 1}")
        require(bool(torch.isfinite(state.log_like).all())
                and bool(torch.isfinite(res.log_likes).all()),
                f"g={g}: non-finite log-likelihoods")
        n_acc = int(res.accepted.sum())
        require(n_acc >= 1, f"g={g}: no proposal accepted")
        rates[g] = props_per_run / secs
        print(f"  g={g}: {count} launches, {n_acc} accepts, init mean "
              f"log-likelihood {float(state.log_like.mean()):.4f}, "
              f"{secs:.4f} s, {rates[g]:.6e} props/s on {ident}", flush=True)
    require(launched(K1) == 0, "the SVOL kernel ran on this path")
    launches = launched(K2)
    phase(19, "pmmh-svol_t", f"C={C} R={R} N={N} T={ys.shape[0]} {ITERS} "
          f"iters: " + "; ".join(f"g{g} {r:.6e} props/s"
                                 for g, r in rates.items()) + f" ({ident})")
    return launches


def phase_large_n(dev, ys_all, ident):
    model = svol_t.make_model()
    km = fmk.svol_t_kernel_model()
    params = model.transform.constrain(torch.tensor(SVOL_T_START)).expand(
        2, 4).contiguous().to(dev)
    before = launched(K2)
    ll = fmk.megakernel_log_like(km, 2048, 2, constrain=fmk.svol_t_param_rows,
                                 model=model)
    out, ms = event_ms(lambda: ll(torch.Generator(device=dev).manual_seed(6),
                                  params, ys_all))
    require(out.shape == (2,) and bool(torch.isfinite(out).all()),
            f"large-N bridge: {out}")
    require(launched(K2) == before,
            "the large-N bridge launched the kernel")
    refused = False
    try:
        fmk.megakernel_log_like(km, 2048, 2)
    except ValueError:
        refused = True
    require(refused, "N=2048 without model= did not raise")
    phase(20, "large-n", f"N=2048 R=2 C=2 T={ys_all.shape[0]} through the "
          f"generic bank: {', '.join(f'{v:.4f}' for v in out.tolist())}, "
          f"{ms:.3f} ms, no kernel launch; without model= it raises "
          f"({ident})")
    return ms


def _agree(name, tot, tot_p, lcl, lcl_p, min_close=0.75):
    """Kernel against plain on identical bits under a roll resampler: step
    0 equal to float tolerance, most rows' totals within 2e-3 (an expf
    against torch.exp ulp can flip one accept decision, and the row then
    follows another path); returns the totals' largest error."""
    torch.testing.assert_close(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4,
                               msg=f"{name}: step 0")
    require(bool(torch.isfinite(tot).all())
            and bool(torch.isfinite(tot_p).all()), f"{name}: NaN totals")
    close = float(((tot - tot_p).abs() <= 2e-3).float().mean())
    require(close >= min_close, f"{name}: only {close:.3f} of the rows' "
            "totals within 2e-3")
    return float((tot - tot_p).abs().max())


def phase_roll_sis(dev, ys_all):
    rng = np.random.default_rng(21)
    sel_lines = []
    for n in ROLL_SIS_N:
        # beside gamma rows: zeros (rejection runs them to the 4096 cap,
        # where every slot keeps itself) and one dominant particle
        w = rng.gamma(1.0, 1.0, (ROLL_B, n)).astype(np.float32)
        w[0] = 0.0
        w[1] *= np.float32(1e-12)
        w[1, n // 5] = 1.0
        w = torch.as_tensor(w, device=dev)
        leaves = torch.stack([
            torch.arange(n, dtype=torch.float32, device=dev).expand(ROLL_B, n),
            torch.as_tensor(rng.normal(size=(ROLL_B, n)).astype(np.float32),
                            device=dev)]).contiguous()
        for r in ROLLS:
            picked, anc = _select.roll_select(w, leaves, 5, step=7,
                                              resampler=r,
                                              metropolis_iters=ROLL_ITERS)
            want, anc_p = _select.roll_select_reference(
                w, leaves, 5, step=7, resampler=r,
                metropolis_iters=ROLL_ITERS)
            require(torch.equal(anc, anc_p), f"roll_select {r} N={n}: "
                    "ancestors differ")
            require(torch.equal(picked, want), f"roll_select {r} N={n}: "
                    "leaves differ")
            require(r != "rejection" or torch.equal(
                anc[0].long(), torch.arange(n, device=dev)),
                f"roll_select {r} N={n}: a slot of the row at the cap moved")
            sel_lines.append(f"{r} N={n}")
    ys = ys_all[:ROLL_T, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    svol_rows = _svol_rows(ROLL_POINT, ROLL_B).to(dev)
    lev_rows = torch.tensor([LEV_POINTS["posterior"]] * ROLL_B, device=dev)
    errs = {}
    for r in ROLLS:
        roll = dict(resampler=r, metropolis_iters=ROLL_ITERS)
        for n in ROLL_SIS_N:
            for name, km, rows, z, mode in (
                    ("svol", fmk.svol_kernel_model(), svol_rows, None,
                     "bootstrap"),
                    ("svol_leverage", fmk.svol_leverage_kernel_model(),
                     lev_rows, zs, "bootstrap"),
                    ("svol/apf", fmk.svol_kernel_model(), svol_rows, None,
                     "apf")):
                kw = dict(num_particles=n, ess_threshold=1.0, mode=mode,
                          **roll)
                tot, lcl, _ = fmk.filter_megakernel(km, 9, rows, ys, z, **kw)
                tot_p, lcl_p, _ = fmk.filter_megakernel_reference(
                    km, 9, rows, ys, z, **kw)
                key = f"K2 {name} {r} N={n}"
                errs[key] = _agree(key, tot, tot_p, lcl, lcl_p)
        kw = dict(num_particles=N, ess_threshold=1.0, **roll)
        tot, lcl, _ = sfk.svol_filter(9, svol_rows, ys, **kw)
        tot_p, lcl_p, _ = sfk.svol_filter_reference(9, svol_rows, ys, **kw)
        errs[f"K1 {r}"] = _agree(f"K1 {r}", tot, tot_p, lcl, lcl_p)
        km, z = _lw_instances(zs[:, 0].contiguous())["svol_leverage_lw"]
        for variant in ("apf", "sisr"):
            kw = dict(num_filters=ROLL_B, num_particles=N, variant=variant,
                      **roll)
            got = lwm.lw_megakernel(km, 9, ys, z, **kw)
            want = lwm.lw_megakernel_reference(km, 9, ys, z, **kw)
            key = f"K3 {variant} {r}"
            errs[key] = _agree(key, got["log_likelihood"],
                               want["log_likelihood"], got["log_cond_likes"],
                               want["log_cond_likes"])
    phase(21, "roll-sis", f"roll_select ancestors equal ({', '.join(sel_lines)}"
          "; a row at the 4096 cap kept itself under rejection); "
          f"B={ROLL_B} T={ROLL_T} {ROLL_ITERS} Metropolis sweeps, totals "
          "max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return max(errs.values())


def _within(name, mean, sd, b, ref_mean, ref_sd, ref_b, slack=0.0):
    """Require |mean - ref_mean| <= 4 combined standard errors + slack."""
    se = math.hypot(sd / math.sqrt(b), ref_sd / math.sqrt(ref_b))
    d = abs(mean - ref_mean)
    require(d <= 4 * se + slack, f"{name}: {mean:.4f} vs {ref_mean:.4f}, "
            f"{d:.4f} > 4 SE {4 * se:.4f} + {slack:.4f}")
    return d, 4 * se + slack


def phase_roll_full(dev, ys_all, ident):
    with open(ROLL_JSON) as f:
        ref = json.load(f)
    ys = ys_all[:, 0].contiguous()
    t_len = ys.shape[0]
    ys_short = ys[:ROLL_PLAIN_T].contiguous()
    b = ROLL_FULL_B
    rows = _svol_rows(ROLL_POINT, b).to(dev)
    sweeps = _select.metropolis_sweeps_for(0.5, t_len, 0.5)
    envelope = _select.metropolis_bias_estimate(sweeps, t_len, 0.5)
    km = fmk.svol_kernel_model()
    out = {"K2": {}, "K1": {}, "K3": {}, "sweeps": sweeps,
           "bias_envelope": envelope}
    for n in ROLL_N:
        jx = ref[f"n{n}"]
        for r in ROLLS:
            kw = dict(num_particles=n, ess_threshold=0.5, resampler=r,
                      metropolis_iters=sweeps)
            tot = fmk.filter_megakernel(km, 11, rows, ys, **kw)[0]
            require(bool(torch.isfinite(tot).all()), f"K2 {r} N={n}: NaN")
            mean, sd = float(tot.mean()), float(tot.std())
            d, lim = _within(f"K2 {r} N={n} vs JAX", mean, sd, b, jx["mean"],
                             jx["sd"], jx["filters"],
                             envelope if r == "metropolis" else 0.0)
            ms = cuda_ms(lambda: fmk.filter_megakernel(km, 11, rows, ys, **kw),
                         3)
            _, plain_ms = event_ms(lambda: fmk.filter_megakernel_reference(
                km, 12, rows, ys_short, **kw))
            out["K2"][f"{r}/N{n}"] = {
                "ms": ms, "plain_ms": plain_ms, "plain_T": ROLL_PLAIN_T,
                "mean": mean, "sd": sd, "jax_mean": jx["mean"],
                "jax_sd": jx["sd"], "diff": d, "limit": lim}
            print(f"  K2 {r} N={n}: {mean:.4f} sd {sd:.4f} (JAX "
                  f"{jx['mean']:.4f} sd {jx['sd']:.4f}, |diff| {d:.4f} <= "
                  f"{lim:.4f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"at T={ROLL_PLAIN_T}", flush=True)
    for n in (N, 1024):
        kw = dict(num_particles=n, ess_threshold=0.5)
        out["K2"][f"systematic/N{n}"] = {"ms": cuda_ms(
            lambda: fmk.filter_megakernel(km, 11, rows, ys, **kw), 3)}
    # the rejection loop's sweeps grow with max w / mean w: at phase 23's
    # starting point, far from the posterior, the weights are more uneven
    start_rows = _svol_rows(svol.make_model().transform.constrain(START),
                            b).to(dev)
    for r in ROLLS:
        kw = dict(num_particles=LARGE_N, ess_threshold=0.5, resampler=r,
                  metropolis_iters=sweeps)
        out["K2"][f"{r}/N{LARGE_N}/start"] = {"ms": cuda_ms(
            lambda: fmk.filter_megakernel(km, 11, start_rows, ys, **kw), 3)}

    # K1 and K3: each resampler's kernel against its plain version at
    # T=256 (other seeds); at full T each roll run beside the same
    # kernel's systematic run, required within 4 SE for K1 only: Liu-West's
    # evidence depends on the resampler's offspring variance (the JAX
    # filter's multinomial first stage sits 82 nats under its systematic
    # one, data/spy_liu_west_jax.json)
    lw_km, lw_z = _lw_instances(
        svol_leverage.lagged_covariates(ys)[:, 0].contiguous())[
        "svol_leverage_lw"]
    runs = {
        "K1": (lambda r, y, seed: sfk.svol_filter(
            seed, rows, y, num_particles=N, ess_threshold=0.5, resampler=r,
            metropolis_iters=sweeps)[0],
            lambda r, y, seed: sfk.svol_filter_reference(
                seed, rows, y, num_particles=N, ess_threshold=0.5,
                resampler=r, metropolis_iters=sweeps)[0], b),
        "K3": (lambda r, y, seed: lwm.lw_megakernel(
            lw_km, seed, y, lw_z[:y.shape[0]].contiguous(), num_filters=LW_F,
            num_particles=LW_N, resampler=r,
            metropolis_iters=sweeps)["log_likelihood"],
            lambda r, y, seed: lwm.lw_megakernel_reference(
                lw_km, seed, y, lw_z[:y.shape[0]].contiguous(),
                num_filters=LW_F, num_particles=LW_N, resampler=r,
                metropolis_iters=sweeps)["log_likelihood"], LW_F)}
    for k, (kern, plain, rows_k) in runs.items():
        base = kern("systematic", ys, 11)
        for r in ("systematic",) + ROLLS:
            tot = base if r == "systematic" else kern(r, ys, 11)
            require(bool(torch.isfinite(tot).all()), f"{k} {r}: NaN")
            mean, sd = float(tot.mean()), float(tot.std())
            ms = cuda_ms(lambda: kern(r, ys, 11), 3)
            tot_p, plain_ms = event_ms(lambda: plain(r, ys_short, 12))
            short = kern(r, ys_short, 11)
            d_p, lim_p = _within(f"{k} {r} kernel vs plain at T="
                                 f"{ROLL_PLAIN_T}", float(short.mean()),
                                 float(short.std()), rows_k,
                                 float(tot_p.mean()), float(tot_p.std()),
                                 rows_k)
            row = {"ms": ms, "plain_ms": plain_ms, "plain_T": ROLL_PLAIN_T,
                   "mean": mean, "sd": sd, "short_diff": d_p,
                   "short_limit": lim_p}
            line = (f"  {k} {r}: {mean:.4f} sd {sd:.4f}; kernel {ms:.4f} ms,"
                    f" plain {plain_ms:.4f} ms; at T={ROLL_PLAIN_T} kernel "
                    f"minus plain {d_p:.4f} (4 SE {lim_p:.4f})")
            if r != "systematic":
                se = math.hypot(sd, float(base.std())) / math.sqrt(rows_k)
                d = mean - float(base.mean())
                if k == "K1":
                    _within(f"{k} {r} vs systematic", mean, sd, rows_k,
                            float(base.mean()), float(base.std()), rows_k)
                row.update(diff_vs_systematic=d, se=se)
                line += (f"; minus systematic {d:.4f} (SE {se:.4f})")
            out[k][r] = row
            print(line, flush=True)
    phase(22, "roll-full", f"SPY T={t_len} ESS 0.5, {sweeps} Metropolis "
          f"sweeps (envelope {envelope:.4f} nats): " + "; ".join(
              f"K2 {k} {v['ms']:.4f} ms" for k, v in out["K2"].items())
          + "; " + "; ".join(f"{k} {r} {v['ms']:.4f} ms"
                             for k in ("K1", "K3")
                             for r, v in out[k].items()) + f" ({ident})")
    return out


def phase_pmmh_large_n(dev, ys_all, ident, bridge_ms):
    ys = ys_all
    model = svol.make_model()
    props_per_run = LARGE_ITERS * C * R * LARGE_N * ys.shape[0]
    log_like = fmk.megakernel_log_like(
        fmk.svol_kernel_model(), LARGE_N, R, constrain=fmk.svol_kernel_rows,
        ess_threshold=0.5, resampler="rejection", model=model)
    proposals = []

    def recorded(gen, params, ys, zs=None):
        proposals.append(params.clone())     # on the device, no sync
        return log_like(gen, params, ys, zs)

    # the counts start at 0 just before this path and are read just after
    zero_launches(K1, K2)
    pmmh = AdaptivePMMH(model, num_particles=LARGE_N, num_replicates=R,
                        t0=150, t1=1000, batched_log_like=recorded)
    state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        res = pmmh.run_from(state, LARGE_ITERS, ys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launched(K2)
    require(launches == LARGE_ITERS + 1,
            f"{launches} kernel launches, want {LARGE_ITERS + 1}")
    require(launched(K1) == 0, "the SVOL kernel ran on this path")
    require(bool(torch.isfinite(state.log_like).all())
            and bool(torch.isfinite(res.log_likes).all()),
            "non-finite log-likelihoods")
    n_acc = int(res.accepted.sum())
    require(n_acc >= 1, "no proposal accepted")
    rate = props_per_run / secs
    ms_iter = secs * 1e3 / LARGE_ITERS
    # two more iterations under the profiler (not counted above): the
    # device's busy share and its ms per iteration by kernel
    busy, top = device_share(lambda: pmmh.run_from(res.final_state, 2, ys),
                             2)
    sweeps = _proposal_sweeps(proposals, ys[:, 0].contiguous())
    phase(23, "pmmh-large-n", f"C={C} R={R} N={LARGE_N} T={ys.shape[0]} "
          f"{LARGE_ITERS} iters, rejection: {launches} launches, {n_acc} "
          f"accepts, init mean log-likelihood "
          f"{float(state.log_like.mean()):.4f}, {ms_iter:.4f} ms per "
          f"iteration, {rate:.6e} props/s; device busy share {busy}, device"
          f" ms per iteration {top}; phase 20's bridge {bridge_ms:.3f} ms "
          f"for one C=2 x R=2 call at the same N ({ident}) | sweeps a "
          f"resample on these proposals (the svol twin): {sweeps}")
    return launches, {"ms_per_iteration": ms_iter, "props_per_s": rate,
                      "bridge_ms_per_call": bridge_ms, "accepts": n_acc,
                      "device_busy_share": busy,
                      "device_ms_per_iteration": top, "sweeps": sweeps}


def _proposal_sweeps(proposals, ys):
    """Each launch's proposals (C, 3) again, R rows each as
    ``megakernel_log_like`` makes them, through the roll family's svol twin
    under rejection at phase 23's N and ESS: the sweeps its resamples ran
    (1 + the last accept sweep, 4096 at the cap) over all the launches'
    rows and steps, and the twin's own time per launch."""
    got, ratios, votes, tail, ms = [], [], 0.0, 0.0, []
    for k, p in enumerate(proposals):
        rows = fmk.svol_kernel_rows(p)
        rows = rows[:, None].expand(-1, R, -1).reshape(-1, 3).contiguous()
        rec, t_ms = event_ms(lambda: fmk.step_spans(
            100 + k, rows, ys, None, LARGE_N, ess_threshold=0.5,
            resampler="rejection", kmodel=fmk.svol_kernel_model()))
        hit = rec["sweeps"] > 0
        got.append(rec["sweeps"][hit].double())
        ratios.append(rec["ratio"][hit].double())
        votes += rec["votes"]
        tail += rec["tail_slots"]
        ms.append(t_ms)
    sw, ratio = torch.cat(got), torch.cat(ratios)
    top = sw >= torch.quantile(sw, 0.99)
    return {"resamples": int(sw.numel()),
            "median": float(torch.quantile(sw, 0.5)),
            "p99": float(torch.quantile(sw, 0.99)), "max": float(sw.max()),
            "mean": float(sw.mean()),
            "cap_share": float((sw >= _prng.ROLL_MAX_ITERS).double().mean()),
            "ratio_median": float(torch.quantile(ratio, 0.5)),
            "ratio_median_at_top1pct_sweeps": float(torch.quantile(
                ratio[top], 0.5)),
            "votes_per_resample": votes / sw.numel(),
            "tail_slots_per_resample": tail / sw.numel(),
            "twin_ms_per_launch": ms}


def _device_ms(run, name):
    """Device ms a launch of kernel ``name`` over the STEP_REPS launches
    of ``run()``, by torch.profiler."""
    _, top = device_share(run, STEP_REPS)
    require(name in top, f"no {name} in the trace: {top}")
    return top[name]


def _step_shape(dev, b, n, sms, clock):
    """The fused step at (B, N): digest and x' against the plain version
    on fixed inputs, device ms a launch over inputs cycled through
    STEP_ROTATE_BYTES, the empty kernel on its grid, its bounds."""
    seed = torch.tensor([5, 0], dtype=torch.int64, device=dev)
    params, x, lw = k5.fixed_inputs(b, n, dev)
    got = k5.fused_svol_propagate_weight(seed, 0.37, params, x, lw)
    digest = k5.digest(*got)
    require(digest == STEP_SHAPES[(b, n)], f"svol_step ({b}, {n}): digest "
            f"{digest}, want {STEP_SHAPES[(b, n)]}")
    want = k5.fused_svol_propagate_weight_reference(seed, 0.37, params, x,
                                                    lw)
    require(torch.equal(got[0], want[0]),
            f"svol_step ({b}, {n}): x' differs from the plain version's")
    err = float((got[1] - want[1]).abs().max())
    del x, lw, got, want
    copies = max(1, math.ceil(STEP_ROTATE_BYTES / (16 * b * n)))
    gen = torch.Generator(device=dev).manual_seed(b * 7919 + n)
    bufs = [(torch.randn((b, n), generator=gen, device=dev),
             torch.randn((b, n), generator=gen, device=dev))
            for _ in range(copies)]

    def launches():
        for k in range(STEP_REPS):
            k5.fused_svol_propagate_weight(seed, 0.37, params,
                                           *bufs[k % copies])

    launches()
    ms = _device_ms(launches, "svol_step_kernel")
    grid = k5.launch_grid(b, n)

    def empties():
        for _ in range(STEP_REPS):
            k5.empty_launch(grid, dev)

    empties()
    floor_ms = _device_ms(empties, "empty_kernel")
    del bufs
    torch.cuda.empty_cache()
    bnd, by, byte_ms, issue_ms = k5.step_bounds(b, n, sms, clock)
    return {"ms": ms, "floor_ms": floor_ms, "bound_ms": bnd, "bound_by": by,
            "byte_bound_ms": byte_ms, "issue_bound_ms": issue_ms,
            "digest": digest, "logw_max_abs_err": err, "grid": list(grid)}


def phase_svol_step(dev, ident):
    gen = torch.Generator().manual_seed(24)
    x = torch.randn((STEP_B, STEP_N), generator=gen).to(dev)
    lw = torch.randn((STEP_B, STEP_N), generator=gen).to(dev)
    params = torch.tensor([[1.3, 0.7, 0.2]] * STEP_B, device=dev)
    y = torch.full((1,), 0.37, device=dev)
    got = k5.fused_svol_propagate_weight(3, y, params, x, lw)
    want = k5.fused_svol_propagate_weight_reference(3, y, params, x, lw)
    # x' = phi x + sigma eps, rounded step by step on both sides, from the
    # same Philox words: equal up to the libraries' log, sin and cos in eps
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-5)
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    # the op itself is this kernel's path: 8 seeds at y = 0 from x = 0
    zeros = torch.zeros_like(x)
    zero_launches("ssme_svol_step")
    xs = torch.stack([k5.fused_svol_propagate_weight(
        seed, 0.0, params, zeros, zeros)[0] for seed in range(8)])
    launches = launched("ssme_svol_step")
    require(launches == 8, f"{launches} svol_step launches, want 8")
    mean, sd = float(xs.mean()), float(xs.std())
    # five standard errors of the mean and of the sd of 0.2 eps
    se = 0.2 / math.sqrt(xs.numel())
    require(abs(mean) < 5 * se and abs(sd - 0.2) < 5 * se / math.sqrt(2),
            f"sigma eps moments: mean {mean:.5f}, sd {sd:.5f} (want 0, 0.2)")
    require(not torch.equal(xs[0], xs[1]), "two seeds drew the same normals")
    # events around back-to-back calls time the wrapper (the host enqueue
    # paces it at this size)
    call_ms = cuda_ms(lambda: k5.fused_svol_propagate_weight(
        3, y, params, x, lw), 200)
    plain_ms = cuda_ms(lambda: k5.fused_svol_propagate_weight_reference(
        3, y, params, x, lw), 20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    shapes = {f"{b}x{n}": _step_shape(dev, b, n, sms, clock)
              for b, n in STEP_SHAPES}
    top = shapes[f"{STEP_B}x{STEP_N}"]
    big = shapes["4096x4096"]
    phase(24, "svol-step", f"B={STEP_B} N={STEP_N}: kernel vs plain max abs "
          f"err {err:.3e}; 8 seeds at y=0: mean {mean:.6f}, sd {sd:.6f} "
          f"(sigma 0.2); {call_ms:.5f} ms per call (events), plain "
          f"{plain_ms:.5f} ms; digests equal the earlier kernel's and x' "
          "the plain version's at " + ", ".join(shapes) + "; device ms "
          "(profiler) / empty-kernel floor / bound (bytes, issue): "
          + "; ".join(
              f"{k} {v['ms']:.5f} / {v['floor_ms']:.5f} / "
              f"{v['bound_ms']:.5f} ({v['byte_bound_ms']:.5f}, "
              f"{v['issue_bound_ms']:.5f})" for k, v in shapes.items())
          + f"; {big['bound_ms'] / big['ms']:.1%} of the bound at 4096x4096 "
          f"({ident})")
    return {"launches": launches, "max_abs_err": err, "ms": top["ms"],
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "floor_ms": top["floor_ms"],
            "byte_bound_ms": top["byte_bound_ms"],
            "issue_bound_ms": top["issue_bound_ms"], "per_shape": shapes,
            "max_sm_clock_hz": clock}


def phase_smoother(dev, ident):
    params = torch.tensor(SMOOTH_PARAMS, device=dev)
    _, ys = lgssm.simulate(torch.Generator().manual_seed(32),
                           torch.tensor(SMOOTH_PARAMS), SMOOTH_T)
    ys = ys.to(dev)
    smooth = fixed_lag_smoother(lgssm.make_model(), num_particles=SMOOTH_N,
                                lag=SMOOTH_LAG)
    gen = torch.Generator(device=dev).manual_seed(33)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm, filt, ll = smooth(gen, params.expand(SMOOTH_R, 3), ys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(sm.device.type == dev.type
            and sm.shape == (SMOOTH_R, SMOOTH_T, 1)
            and bool(torch.isfinite(sm).all())
            and bool(torch.isfinite(ll).all()),
            f"smoother outputs {tuple(sm.shape)} on {sm.device}")
    rts, _ = lgssm.kalman_smoother(params, ys)
    kf_lls, _, _ = lgssm.kalman_filter(params, ys)
    inner = slice(0, SMOOTH_T - SMOOTH_LAG)
    err_sm = (sm[:, inner, 0] - rts[inner]).abs()
    err_filt = (filt[:, inner, 0] - rts[inner]).abs()
    mean_err, max_err = float(err_sm.mean()), float(err_sm.max())
    ratio = mean_err / float(err_filt.mean())
    # tests/test_smoothing.py's tolerances at N=4096 (lag 8 there: lag 10
    # truncates less)
    require(mean_err < 0.05 and max_err < 0.25 and ratio < 0.5,
            f"smoothed means vs RTS: mean {mean_err:.4f} (< 0.05), max "
            f"{max_err:.4f} (< 0.25), against the filter {ratio:.3f} (< 0.5)")
    gap = float(ll.mean() - kf_lls.sum())
    four_se = 4 * float(ll.std()) / math.sqrt(SMOOTH_R)
    require(abs(gap) < four_se, f"log-likelihood {float(ll.mean()):.4f} vs "
            f"Kalman {float(kf_lls.sum()):.4f}: beyond 4 SE {four_se:.4f}")
    phase(32, "smoother", f"LGSSM T={SMOOTH_T} N={SMOOTH_N} lag {SMOOTH_LAG}"
          f" x{SMOOTH_R} on {sm.device}: smoothed vs RTS mean abs "
          f"{mean_err:.4f}, max {max_err:.4f}, {ratio:.3f} of the filter's; "
          f"log-likelihood {float(ll.mean()):.4f} vs Kalman "
          f"{float(kf_lls.sum()):.4f} (4 SE {four_se:.4f}); {wall:.3f} s "
          f"({ident})")
    return {"wall_s": wall, "mean_abs_err": mean_err, "max_abs_err": max_err,
            "ll_gap": gap}


def _json_lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def phase_tune_variance(tmp, ident):
    out = os.path.join(tmp, "tune_variance.jsonl")
    zero_launches(K1)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        tune_variance.main(["--particles", str(TUNE_N), "--singles",
                            str(TUNE_SINGLES), "--launch-rows",
                            str(TUNE_ROWS), "--replicates", "1", "2", "4",
                            "--out", out])
    launches = launched(K1)
    want = math.ceil(TUNE_SINGLES / TUNE_ROWS)
    require(launches == want, f"tune_variance: {launches} SVOL-kernel "
            f"launches, want {want}")
    recs = _json_lines(out)
    var = [r["var_logl"] for r in recs]
    require([r["R"] for r in recs] == [1, 2, 4]
            and all(math.isfinite(v) and v > 0 for v in var)
            and var[0] > var[1] > var[2] and recs[0]["T"] == 3084,
            f"tune_variance records: {recs}")
    phase(33, "tune-variance", f"N={TUNE_N} T=3084 {TUNE_SINGLES} singles in "
          f"{launches} launches: Var[log L] at R=1, 2, 4: " + ", ".join(
              f"{v:.3f}" for v in var) + f"; {recs[0]['sec_per_row']:.3e} s "
          f"a row ({ident})")
    return launches, recs


def phase_tune_pmmh(tmp, ident):
    out = os.path.join(tmp, "tune_pmmh.jsonl")
    trace_dir = os.path.join(tmp, "trace")
    zero_launches(K1)
    with profiling.trace(trace_dir), \
            contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        tune_pmmh.main(["--iters", str(TUNE_ITERS), "--chunk",
                        str(TUNE_CHUNK), "--configs",
                        ",".join(map(str, TUNE_PMMH)), "--out", out])
    launches = launched(K1)
    require(launches == TUNE_ITERS + 1, f"tune_pmmh: {launches} SVOL-kernel "
            f"launches, want {TUNE_ITERS + 1}")
    (rec,) = _json_lines(out)
    require(0.0 < rec["accept_rate"] < 1.0 and rec["sec_per_iter"] > 0
            and all(math.isfinite(v) for v in rec["posterior_mean"])
            and rec["device"] == torch.cuda.get_device_name(0),
            f"tune_pmmh record: {rec}")
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k1 = sorted(n for n in names if "svol_filter_sys_kernel" in n)
    require(k1, "the trace names no SVOL-kernel launch")
    phase(34, "tune-pmmh", f"{TUNE_PMMH[0]} C={TUNE_PMMH[1]} "
          f"N={TUNE_PMMH[2]} R={TUNE_PMMH[3]} {TUNE_ITERS} iters: {launches} "
          f"launches, accept {rec['accept_rate']:.3f}, "
          f"{rec['sec_per_iter'] * 1e3:.3f} ms an iteration, min ESS "
          f"{rec['min_ess']:.1f}; the trace names {len(k1)} SVOL-kernel "
          f"instance(s) ({ident})")
    return launches, rec


def phase_k1_large_sis(dev, ys_all):
    """K1 above 1024 particles (kPer 8 systematic, 8 and 16 under the roll
    resamplers) on identical bits: the
    standalone systematic selection against the plain law, and the filter
    under each resampler against its plain version."""
    sel = _select_checks(dev, np.random.default_rng(25), ROLL_B,
                         [(n, 8) for n in ROLL_N])
    ys = ys_all[:ROLL_T, 0].contiguous()
    rows = _svol_rows(ROLL_POINT, ROLL_B).to(dev)
    errs, plain, sys_close = {}, {}, {}
    for n in ROLL_N:
        for r in ("systematic",) + ROLLS:
            kw = dict(num_particles=n, resampler=r,
                      metropolis_iters=ROLL_ITERS)
            # a gate that never fires: no selection, the same recursion
            tot = sfk.svol_filter(9, rows, ys, ess_threshold=1e-6, **kw)[0]
            tot_p = sfk.svol_filter_reference(9, rows, ys, ess_threshold=1e-6,
                                              **kw)[0]
            torch.testing.assert_close(tot, tot_p, rtol=1e-4, atol=1e-3,
                                       msg=f"K1 N={n} {r}: no selection")
            tot, lcl, _ = sfk.svol_filter(9, rows, ys, ess_threshold=1.0,
                                          **kw)
            (tot_p, lcl_p, _), ms = event_ms(lambda: sfk.svol_filter_reference(
                9, rows, ys, ess_threshold=1.0, **kw))
            key = f"{r}/N{n}"
            plain[key] = ms
            if r != "systematic":
                errs[key] = _agree(f"K1 {key}", tot, tot_p, lcl, lcl_p,
                                   min_close=0.9)
                continue
            # the block scan rounds the CDF otherwise than torch.cumsum, so a
            # point within rounding of a boundary picks the neighbour (the
            # check above) and the row then follows another path: step 0
            # equal, step 1 (one selection) close on 90% of the rows
            _agree(f"K1 {key} to step 1", lcl[:, 1], lcl_p[:, 1], lcl,
                   lcl_p, min_close=0.9)
            errs[key] = float((lcl[:, :2] - lcl_p[:, :2]).abs().max())
            sys_close[key] = float(((tot - tot_p).abs() <= 2e-3)
                                   .float().mean())
    phase(25, "k1-large-sis", f"systematic_select B={ROLL_B}: "
          + "; ".join(sel) + f" | K1 B={ROLL_B} T={ROLL_T} every step, max "
          "abs err (systematic: of steps 0-1) " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + "; systematic rows' totals within 2e-3 " + ", ".join(
              f"{k} {v:.3f}" for k, v in sys_close.items()))
    return max(errs.values()), plain


def phase_k1_large_full(dev, ys_all, ident, plain, layout):
    """K1 at N=2048 and 4096 over SPY (B=256, ESS 0.5) against the JAX
    bank of data/roll_resamplers_jax.json; times by CUDA events."""
    with open(ROLL_JSON) as f:
        ref = json.load(f)
    ys = ys_all[:, 0].contiguous()
    t_len, b = ys.shape[0], ROLL_FULL_B
    rows = _svol_rows(ROLL_POINT, b).to(dev)
    sweeps = _select.metropolis_sweeps_for(0.5, t_len, 0.5)
    envelope = _select.metropolis_bias_estimate(sweeps, t_len, 0.5)
    out = {}
    for n in ROLL_N:
        jx = ref[f"n{n}"]
        bnd = bound("svol_filter", b, n, t_len, 4 * t_len + 12 * b + 16,
                    4 * b * (2 * t_len + 1))
        for r in ("systematic",) + ROLLS:
            kw = dict(num_particles=n, ess_threshold=0.5, resampler=r,
                      metropolis_iters=sweeps)
            tot = sfk.svol_filter(11, rows, ys, **kw)[0]
            require(bool(torch.isfinite(tot).all()), f"K1 {r} N={n}: NaN")
            mean, sd = float(tot.mean()), float(tot.std())
            d, lim = _within(f"K1 {r} N={n} vs JAX", mean, sd, b, jx["mean"],
                             jx["sd"], jx["filters"],
                             envelope if r == "metropolis" else 0.0)
            ms = cuda_ms(lambda: sfk.svol_filter(11, rows, ys, **kw), 3)
            key = f"{r}/N{n}"
            out[key] = {"ms": ms, "plain_ms": plain[key], "plain_B": ROLL_B,
                        "plain_T": ROLL_T, "bound_ms": bnd[0],
                        "bound_by": bnd[1],
                        "kper": (layout[str(n)]["kper"]
                                 if r == "systematic" else K1_ROLL_KPER[n]),
                        "mean": mean,
                        "sd": sd, "jax_mean": jx["mean"], "diff": d,
                        "limit": lim}
            print(f"  K1 {key}: {mean:.4f} sd {sd:.4f} (JAX {jx['mean']:.4f}"
                  f", |diff| {d:.4f} <= {lim:.4f}); kernel {ms:.4f} ms, "
                  f"bound {bnd[0]:.4f} ms", flush=True)
    phase(26, "k1-large-full", f"SPY T={t_len} B={b} ESS 0.5, {sweeps} "
          "Metropolis sweeps: " + "; ".join(
              f"{k} {v['ms']:.4f} ms" for k, v in out.items())
          + f" ({ident})")
    return out


def phase_k3_large(dev, ys_all, ident):
    """K3 at N=2048 and 4096 (kPer 4 and 8) under both roll resamplers:
    on identical bits at a small size, against its plain version at
    T=K3_LARGE_T within 4 SE, times over SPY; the svol_leverage_lw_q
    instance against its plain version on identical bits (phase 14's
    form) and at kappa = 1 equal to svol_leverage_lw's SISR."""
    ys = ys_all[:, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    t_len = ys.shape[0]
    km = lwm.svol_leverage_lw_kernel_model()
    sweeps = _select.metropolis_sweeps_for(0.5, t_len, 0.5)
    ys_s, zs_s = ys[:ROLL_T].contiguous(), zs[:ROLL_T].contiguous()
    ys_m, zs_m = ys[:K3_LARGE_T].contiguous(), zs[:K3_LARGE_T].contiguous()
    errs, out = {}, {}
    for n in ROLL_N:
        bnd = bound("lw_megakernel", LW_F, n, t_len, 8 * t_len + 16,
                    4 * LW_F * (t_len + 6 * n))
        for r in ROLLS:
            for variant in ("apf", "sisr"):
                kw = dict(num_filters=K3_SIS_F, num_particles=n,
                          variant=variant, resampler=r,
                          metropolis_iters=ROLL_ITERS)
                got = lwm.lw_megakernel(km, 9, ys_s, zs_s, **kw)
                want = lwm.lw_megakernel_reference(km, 9, ys_s, zs_s, **kw)
                key = f"{r}/N{n}/{variant}"
                errs[key] = _agree(f"K3 {key}", got["log_likelihood"],
                                   want["log_likelihood"],
                                   got["log_cond_likes"],
                                   want["log_cond_likes"])
            kw = dict(num_filters=LW_F, num_particles=n, resampler=r,
                      metropolis_iters=sweeps)
            tot = lwm.lw_megakernel(km, 11, ys_m, zs_m, **kw)[
                "log_likelihood"]
            tot_p, plain_ms = event_ms(lambda: lwm.lw_megakernel_reference(
                km, 12, ys_m, zs_m, **kw)["log_likelihood"])
            d, lim = _within(f"K3 {r} N={n} kernel vs plain at "
                             f"T={K3_LARGE_T}", float(tot.mean()),
                             float(tot.std()), LW_F, float(tot_p.mean()),
                             float(tot_p.std()), LW_F)
            full, ms = event_ms(lambda: lwm.lw_megakernel(
                km, 11, ys, zs, **kw)["log_likelihood"])
            require(bool(torch.isfinite(full).all()), f"K3 {r} N={n}: NaN")
            out[f"{r}/N{n}"] = {
                "ms": ms, "plain_ms": plain_ms, "plain_T": K3_LARGE_T,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "kper": K3_ROLL_KPER[n],
                "short_diff": d, "short_limit": lim,
                "mean": float(full.mean()), "sd": float(full.std())}
            print(f"  K3 {r} N={n}: at T={K3_LARGE_T} kernel minus plain "
                  f"{d:.4f} (4 SE {lim:.4f}); over SPY "
                  f"{float(full.mean()):.4f} sd {float(full.std()):.4f}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
                  f"T={K3_LARGE_T}", flush=True)
    # the custom SISR proposal: phase 14's form, a gate that never fires
    ys5, zs5 = ys[:512].contiguous(), zs[:512].contiguous()
    kq = lwm.svol_leverage_lw_q_kernel_model(Q_KAPPA)
    kw = dict(num_filters=32, num_particles=LW_N, variant="sisr",
              ess_threshold=0.5 / LW_N)
    got = lwm.lw_megakernel(kq, 7, ys5, zs5, **kw)
    want, q_plain_ms = event_ms(lambda: lwm.lw_megakernel_reference(
        kq, 7, ys5, zs5, **kw))
    q_err = float((got["log_likelihood"] - want["log_likelihood"])
                  .abs().max())
    # float32 throughout, as phase 14; log f - log q adds two logs and two
    # divides a step, so the totals (about -600 nats) differ by a few ulp
    # a step: within 1e-5 relative
    torch.testing.assert_close(got["log_likelihood"],
                               want["log_likelihood"], rtol=1e-5, atol=1e-3,
                               msg="svol_leverage_lw_q: totals")
    for rows, what in ((slice(0, 1), "state"), (slice(2, None), "theta")):
        torch.testing.assert_close(got["cloud"][:, rows],
                                   want["cloud"][:, rows], rtol=0, atol=1e-3,
                                   msg=f"svol_leverage_lw_q {what} rows")
    torch.testing.assert_close(lwm.lw_cloud_weights(kq, got["cloud"]),
                               lwm.lw_cloud_weights(kq, want["cloud"]),
                               rtol=0, atol=1e-3)
    one = lwm.lw_megakernel(lwm.svol_leverage_lw_q_kernel_model(1.0), 7, ys5,
                            zs5, **kw)
    base = lwm.lw_megakernel(km, 7, ys5, zs5, **kw)
    require(torch.equal(one["log_cond_likes"], base["log_cond_likes"])
            and torch.equal(one["cloud"], base["cloud"]),
            "svol_leverage_lw_q at kappa 1 != svol_leverage_lw SISR")
    q_ms = cuda_ms(lambda: lwm.lw_megakernel(kq, 7, ys5, zs5, **kw), 3)
    q = {"kappa": Q_KAPPA, "max_abs_err": q_err, "ms": q_ms,
         "plain_ms": q_plain_ms, "F": 32, "N": LW_N, "T": 512}
    phase(27, "k3-large", f"identical bits F={K3_SIS_F} T={ROLL_T} totals "
          "max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; F={LW_F} " + "; ".join(
              f"{k} kernel {v['ms']:.4f} ms, at T={K3_LARGE_T} minus plain "
              f"{v['short_diff']:.4f} (4 SE {v['short_limit']:.4f})"
              for k, v in out.items())
          + f" | svol_leverage_lw_q kappa {Q_KAPPA} F=32 N={LW_N} T=512 "
          f"SISR: totals max abs err {q_err:.3e}, kernel {q_ms:.4f} ms; "
          f"kappa 1 == svol_leverage_lw bit for bit ({ident})")
    return max(errs.values()), out, q


def phase_pmmh_large_n_k1(dev, ys_all, ident):
    """SVOL PMMH at N=2048 through K1 systematic (kPer 8): one launch per
    iteration, no host synchronisation; beside phase 23's K2 rejection."""
    ys = ys_all
    model = svol.make_model()
    props_per_run = LARGE_ITERS * C * R * LARGE_N * ys.shape[0]
    # the counts start at 0 just before this path and are read just after
    zero_launches(K1, K2)
    pmmh = AdaptivePMMH(model, num_particles=LARGE_N, num_replicates=R,
                        t0=150, t1=1000,
                        batched_log_like=sfk.svol_batched_log_like(
                            LARGE_N, R, ess_threshold=0.5))
    state = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        res = pmmh.run_from(state, LARGE_ITERS, ys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launched(K1)
    require(launches == LARGE_ITERS + 1,
            f"{launches} kernel launches, want {LARGE_ITERS + 1}")
    require(launched(K2) == 0,
            "the generic kernel ran on this path")
    require(bool(torch.isfinite(state.log_like).all())
            and bool(torch.isfinite(res.log_likes).all()),
            "non-finite log-likelihoods")
    n_acc = int(res.accepted.sum())
    require(n_acc >= 1, "no proposal accepted")
    ms_iter = secs * 1e3 / LARGE_ITERS
    busy, top = device_share(lambda: pmmh.run_from(res.final_state, 2, ys),
                             2)
    phase(28, "pmmh-large-n-k1", f"C={C} R={R} N={LARGE_N} T={ys.shape[0]} "
          f"{LARGE_ITERS} iters, SVOL kernel systematic: {launches} "
          f"launches, {n_acc} accepts, init mean log-likelihood "
          f"{float(state.log_like.mean()):.4f}, {ms_iter:.4f} ms per "
          f"iteration, {props_per_run / secs:.6e} props/s; device busy share "
          f"{busy}, device ms per iteration {top}; phase 23 (the generic "
          f"kernel, rejection) beside it ({ident})")
    return launches, {"ms_per_iteration": ms_iter,
                      "props_per_s": props_per_run / secs, "accepts": n_acc,
                      "device_busy_share": busy,
                      "device_ms_per_iteration": top}


def phase_flagship_cli(dev, ident):
    """``ssme_tpu_torch.examples.spy_flagship`` at its full width for
    FLAGSHIP_ITERS iterations per schedule, in this process."""
    from ssme_tpu_torch.examples import spy_flagship
    lines, launches = [], 0
    with tempfile.TemporaryDirectory() as tmp:
        for ess in (1.0, 0.5):
            tag = f"smoke_ess{ess}"
            zero_launches(K1)
            t0 = time.perf_counter()
            out, _ = _run_in_process(spy_flagship.main, [
                "--iters", str(FLAGSHIP_ITERS), "--burn",
                str(FLAGSHIP_ITERS // 2), "--chunk",
                str(FLAGSHIP_ITERS // 2), "--ess", str(ess), "--tag", tag,
                "--out-dir", tmp, "--device", dev.type])
            secs = time.perf_counter() - t0
            count = launched(K1)
            launches += count
            require(count == FLAGSHIP_ITERS + 1, f"ess {ess}: {count} kernel "
                    f"launches, want {FLAGSHIP_ITERS + 1}")
            summary = json.loads(out.strip().splitlines()[-1])
            samples = np.load(os.path.join(
                tmp, f"torch_spy_posterior_samples_{tag}.npy"))
            require(samples.shape == (FLAGSHIP_ITERS,
                                      summary["config"]["chains"], 3),
                    f"ess {ess}: samples {samples.shape}")
            require(bool(np.isfinite(samples).all()),
                    f"ess {ess}: non-finite samples")
            acc = summary["accept_rate"]
            require(0.0 < acc < 1.0, f"ess {ess}: accept rate {acc}")
            require(summary["kernel_launches"] == count,
                    f"ess {ess}: the summary's launch count")
            post, cfg = summary["posterior"], summary["config"]
            lines.append(f"ess {ess}: accept {acc:.4f}, {secs:.3f} s, "
                         + ", ".join(f"{k} {post[k]['mean']:.4f}"
                                     for k in ("beta", "phi", "ss")))
            print(f"  {lines[-1]}", flush=True)
    phase(29, "flagship-cli", f"spy_flagship C={cfg['chains']} "
          f"R={cfg['R']} N={cfg['N']} T={cfg['T']} {FLAGSHIP_ITERS} iters "
          f"(burn {FLAGSHIP_ITERS // 2}): "
          + " | ".join(lines) + f"; {FLAGSHIP_ITERS + 1} launches each "
          f"({ident})")
    return launches


def _require_k2_barriers(tag, rec):
    """The barriers a step of each kind crossed on the card are those the
    generic kernel's systematic source note states
    (fmk.BARRIERS_PER_STEP)."""
    for kind, want in fmk.BARRIERS_PER_STEP.items():
        got = rec["barriers_per_step"][kind]
        require(got is None or got == want, f"K2 {tag}: {got} barriers a "
                f"{kind} step, the source note states {want}")


def _k2_roll_twins(dev, ys, zs):
    """The roll family's instrumented twins at every layout under both
    resamplers: 2 barriers a check and 4 an APF step besides the
    selections' votes and tail barriers (fmk.ROLL_BARRIERS_PER_STEP), the
    layout, the outputs the plain instances' bits.  Returns (layout,
    barriers and votes per selection by run)."""
    rows = {"svol_leverage": torch.tensor([LEV_POINTS["posterior"]] * 64,
                                          device=dev),
            "svol": _svol_rows(ROLL_POINT, 64).to(dev)}
    layout, counted = {}, {}
    for n in K2_ROLL_RECORD_N:
        for r in ROLLS:
            for name, mode in fmk.SPAN_TWINS["roll"]:
                km = (fmk.svol_kernel_model() if name == "svol"
                      else fmk.svol_leverage_kernel_model())
                z = zs if name == "svol_leverage" else None
                kw = dict(mode=mode, resampler=r, metropolis_iters=ROLL_ITERS,
                          ess_threshold=1.0 if mode == "apf" else 0.5)
                rec = fmk.step_spans(13, rows[name], ys, z, n, kmodel=km, **kw)
                plain = fmk.filter_megakernel(km, 13, rows[name], ys, z,
                                              num_particles=n, **kw)
                tag = f"K2 roll N={n} {r} {name} {mode}"
                require(all(torch.equal(a, b)
                            for a, b in zip(plain, rec["outputs"])),
                        f"{tag}: the twin's outputs are not the plain "
                        "instance's bits")
                for kind, want in fmk.ROLL_BARRIERS_PER_STEP.items():
                    got = rec["barriers_per_step"][kind]
                    require(got is None or got == want, f"{tag}: {got} "
                            f"barriers a {kind} step besides the votes, the "
                            f"source note states {want}")
                sel = int((rec["sweeps"] > 0).sum())
                require(sel > 0 and (r == "rejection" or rec["votes"] == 0),
                        f"{tag}: {sel} selections, {rec['votes']} votes")
                counted[f"N{n}/{r}/{name}/{mode}"] = dict(
                    rec["barriers_per_step"], votes_per_selection=rec[
                        "votes"] / sel, tail_slots_per_selection=rec[
                        "tail_slots"] / sel)
            require(rec["threads"] == -(-n // rec["kper"] // 32) * 32
                    and rec["threads"] <= 256,
                    f"K2 roll N={n}: {rec['threads']} threads at kPer "
                    f"{rec['kper']}")
        layout[str(n)] = {"kper": rec["kper"], "threads": rec["threads"]}
    return layout, counted


def _k1_roll_twins(dev, ys):
    """The SVOL kernel's roll twins at every layout under both resamplers,
    both schedules: 2 barriers a check besides the selections' votes and
    tail barriers (sfk.ROLL_BARRIERS_PER_STEP), the layout of
    K1_ROLL_KPER, the outputs the plain instances' bits.  Returns (layout,
    barriers, votes and sweeps per selection by run)."""
    rows = _svol_rows(ROLL_POINT, 64).to(dev)
    layout, counted = {}, {}
    for n in K2_ROLL_RECORD_N:
        for r in ROLLS:
            for tag, ess, g in (("parity", 1.0, 1), ("adaptive", 0.5, 8)):
                kw = dict(resampler=r, metropolis_iters=ROLL_ITERS)
                rec = sfk.step_spans(13, rows, ys, n, ess, g, **kw)
                plain = sfk.svol_filter(13, rows, ys, n, ess, g, **kw)
                key = f"N{n}/{r}/{tag}"
                require(all(torch.equal(a, b)
                            for a, b in zip(plain, rec["outputs"])),
                        f"K1 roll {key}: the twin's outputs are not the "
                        "plain instance's bits")
                for kind, want in sfk.ROLL_BARRIERS_PER_STEP.items():
                    got = rec["barriers_per_step"][kind]
                    require(got is None or got == want, f"K1 roll {key}: "
                            f"{got} barriers a {kind} step besides the "
                            f"votes, the source note states {want}")
                sel = rec["resamples"] * rows.shape[0]
                require(sel > 0 and (r == "rejection") == (rec["votes"] > 0),
                        f"K1 roll {key}: {sel} selections, {rec['votes']} "
                        "votes")
                counted[key] = dict(
                    rec["barriers_per_step"], votes_per_selection=rec[
                        "votes"] / sel, sweeps_per_selection=rec[
                        "sweeps"] / sel)
                require(rec["kper"] == K1_ROLL_KPER[n]
                        and rec["threads"] == -(-n // rec["kper"] // 32) * 32
                        and rec["threads"] <= 256,
                        f"K1 roll {key}: {rec['threads']} threads at kPer "
                        f"{rec['kper']}")
        layout[str(n)] = {"kper": rec["kper"], "threads": rec["threads"]}
    return {"layout": layout, "barriers_per_step": counted}


def phase_k2_layout(dev, ys_all):
    """The systematic family's instrumented twins at every layout, the roll
    family's, and the svol instance against K1 on the same bits over
    SPY."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)
    params = torch.tensor([LEV_POINTS["posterior"]] * 64, device=dev)
    layout, counted = {}, {}
    for n in K2_RECORD_N:
        for tag, kw in (("parity", dict(ess_threshold=1.0)),
                        ("tuned", dict(ess_threshold=0.5)),
                        ("adaptive", dict(ess_threshold=0.5, gate_stride=8)),
                        ("apf", dict(mode="apf"))):
            rec = fmk.step_spans(13, params, ys, zs, n, **kw)
            plain = fmk.filter_megakernel(fmk.svol_leverage_kernel_model(),
                                          13, params, ys, zs,
                                          num_particles=n, **kw)
            require(all(torch.equal(a, b)
                        for a, b in zip(plain, rec["outputs"])),
                    f"K2 N={n} {tag}: the twin's outputs are not the plain "
                    "instance's bits")
            _require_k2_barriers(f"N={n} {tag}", rec)
            require(rec["checks"] == (512 if tag != "adaptive" else 64)
                    and (rec["apf_steps"] == 511) == (tag == "apf"),
                    f"K2 N={n} {tag}: {rec['checks']} checks, "
                    f"{rec['apf_steps']} APF steps")
            counted[f"N{n}/{tag}"] = rec["barriers_per_step"]
        layout[str(n)] = {"kper": rec["kper"], "threads": rec["threads"]}
        require(rec["threads"] == -(-n // rec["kper"] // 32) * 32,
                f"K2 N={n}: {rec['threads']} threads at kPer {rec['kper']}")
    roll_layout, roll_counted = _k2_roll_twins(dev, ys, zs)
    k1_roll = _k1_roll_twins(dev, ys)
    # the svol instance against K1: the same bits, CDF, selection and
    # offsets, but each kernel fuses its own multiply-adds, so a point
    # within an ulp of a CDF entry now and then picks the neighbour and the
    # row parts
    # (over SPY every row does, some step): phase 25's rule (step 0 equal,
    # step 1 close on 90% of the rows) and the means within 4 combined SE
    rows = _svol_rows((0.9, 0.98, 0.02), LB).to(dev)
    ys = ys_all[:, 0].contiguous()
    vs_k1 = {}
    for n in (N, 1024):
        for sched, ess in (("parity", 1.0), ("ess0.5", 0.5)):
            kw = dict(num_particles=n, ess_threshold=ess)
            tot, lcl, _ = fmk.filter_megakernel(fmk.svol_kernel_model(), 21,
                                                rows, ys, **kw)
            tot1, lcl1, _ = sfk.svol_filter(21, rows, ys, **kw)
            key = f"K2 svol vs K1 N={n} {sched}"
            _agree(f"{key} to step 1", lcl[:, 1], lcl1[:, 1], lcl, lcl1,
                   min_close=0.9)
            se = math.sqrt(float(tot.var()) / LB + float(tot1.var()) / LB)
            d = abs(float(tot.mean()) - float(tot1.mean()))
            require(d <= 4 * se, f"{key}: means differ by {d:.3f} > 4 SE "
                    f"{4 * se:.3f}")
            vs_k1[f"N{n}/{sched}"] = {
                "max_abs_err_steps_0_1": float(
                    (lcl[:, :2] - lcl1[:, :2]).abs().max()),
                "mean_diff": d, "four_se": 4 * se}
    phase(30, "k2-layout", "twins' barriers a step (resample, check, other, "
          "apf) " + "; ".join(f"{k} {v}" for k, v in counted.items())
          + "; layout (kPer, threads) " + ", ".join(
              f"N={n} ({v['kper']}, {v['threads']})"
              for n, v in layout.items())
          + " | roll twins' barriers a step besides the votes, votes and "
          "tail slots a selection: " + "; ".join(
              f"{k} {v}" for k, v in roll_counted.items())
          + "; layout " + ", ".join(f"N={n} ({v['kper']}, {v['threads']})"
                                    for n, v in roll_layout.items())
          + " | SVOL kernel's roll twins' barriers a step besides the votes,"
          " votes and sweeps a selection: " + "; ".join(
              f"{k} {v}" for k, v in k1_roll["barriers_per_step"].items())
          + "; layout " + ", ".join(
              f"N={n} ({v['kper']}, {v['threads']})"
              for n, v in k1_roll["layout"].items())
          + f" | svol instance vs K1 over SPY, B={LB}: " + ", ".join(
              f"{k} steps 0-1 max abs err {v['max_abs_err_steps_0_1']:.3e},"
              f" means {v['mean_diff']:.4f} apart (4 SE {v['four_se']:.4f})"
              for k, v in vs_k1.items()))
    return (layout, counted, vs_k1,
            {"layout": roll_layout, "barriers_per_step": roll_counted},
            k1_roll)


# the filters at which phase 31 reads the Liu-West systematic twins, and
# the CTAs a filter each must run: a few filters, paired; more than the
# card holds pairs of CTAs at once, one CTA a filter
K3_RECORD_LAYOUTS = ((16, 2), (128, 1))
# the schedules phase 31 reads the Liu-West twins at, and the kinds of
# step each must show
K3_RECORD_RUNS = {
    "apf": (dict(variant="apf"), ("first_resample", "resample")),
    "apf-ess": (dict(variant="apf", ess_threshold=0.5), ("other",)),
    "sisr": (dict(variant="sisr"), ("first_resample", "resample")),
    "sisr-no-selection": (dict(variant="sisr"), ("first_other", "other")),
}


# phase 37: factor_svol_5_lw, K3's wide row, over the 5-column panel of
# benchmark/data: the kernel against its plain version at F=16 T=64 (both
# N) and at the benchmark cell's F=64 N=1024 over the whole panel, then
# there the twin and the launch in both layouts (single at F=128, more
# clusters than the card holds: one CTA a filter, one wave)
FACTOR_LW_CHECK = (16, 64)
FACTOR_LW_F, FACTOR_LW_N = 64, 1024


def _vs_plain(what, tot, lcl, plain, rows):
    """Kernel totals ``tot`` and log-likelihood increments ``lcl`` of
    ``rows`` filters against ``plain()``'s, its plain version on the same
    seed: finite totals, phase 25's step-one rule (step 0 within float32
    rounding, step 1 within 2e-3 in 90% of the filters) and the mean
    totals within 4 SE; the means, 4 SE and the plain version's ms."""
    (tot_p, lcl_p), plain_ms = event_ms(plain)
    require(bool(torch.isfinite(tot).all())
            and bool(torch.isfinite(tot_p).all()), f"{what}: NaN totals")
    require(bool(torch.allclose(lcl[:, 0], lcl_p[:, 0], rtol=1e-5, atol=1e-4))
            and float(((lcl[:, 1] - lcl_p[:, 1]).abs() <= 2e-3).float()
                      .mean()) >= 0.9, f"{what}: step-one rule")
    se = math.sqrt(float(tot.var()) / rows + float(tot_p.var()) / rows)
    d = abs(float(tot.mean()) - float(tot_p.mean()))
    require(d <= 4 * se, f"{what}: means differ by {d:.3f} > 4 SE "
            f"{4 * se:.3f}")
    return {"kernel_mean": float(tot.mean()),
            "plain_mean": float(tot_p.mean()), "four_se": 4 * se,
            "plain_ms": plain_ms}


def _factor_vs_plain(km, seed, ys, f, n, out=None):
    """The factor kernel's outputs (``out``, else launched here) against
    its plain version on the same seed by :func:`_vs_plain`."""
    if out is None:
        out = lwm.lw_megakernel(km, seed, ys, None, f, n)

    def plain():
        ref = lwm.lw_megakernel_reference(km, seed, ys, None, f, n)
        return ref["log_likelihood"], ref["log_cond_likes"]
    return _vs_plain(f"factor F={f} N={n} T={ys.shape[0]}",
                     out["log_likelihood"], out["log_cond_likes"], plain, f)


def phase_k3_factor(dev, ident, k3_ptxas):
    """K3's factor_svol_5_lw instance (21 parameters a particle, the wide
    row): its ptxas figures (phase 2 holds them at 0 spills), the kernel
    within 4 SE of its plain version and by phase 25's step-one rule at
    F=16 T=64 (APF, N=512 and 1024) and at the benchmark cell's F=64
    N=1024 over all 3084 x 5 steps; there the twin's parts, barriers and
    layout (its outputs the plain instance's bits) and the launch's ms in
    the layout the rule takes and, at F=128, in the single one (each
    counted under factor_svol_5_lw.<layout>)."""
    path = os.path.join(ROOT, "benchmark", "data", "factor_svol_5_returns.csv")
    panel = torch.as_tensor(np.loadtxt(path, delimiter=",", ndmin=2),
                            dtype=torch.float32, device=dev).contiguous()
    km = lwm.factor_svol_lw_kernel_model()
    f_check, t_check = FACTOR_LW_CHECK
    f, n = FACTOR_LW_F, FACTOR_LW_N
    checks = {f"N{m}/T{t_check}": _factor_vs_plain(km, 31, panel[:t_check],
                                                  f_check, m)
              for m in (512, 1024)}
    clusters = lwm._max_clusters(lwm._model_id(km), n)
    layouts = {f: lwm.layout_for(f, clusters),
               2 * f: lwm.layout_for(2 * f, clusters)}
    require(layouts[2 * f] == "single", f"factor: F={2 * f} ran paired")
    keys = {g: lwm.launch_key("factor_svol_5_lw", k)
            for g, k in layouts.items()}
    before = {g: _cuda.launches(K3, k) for g, k in keys.items()}
    # the whole panel: the launch in the rule's layout, timed, then its
    # plain version
    out, ms_rule = event_ms(lambda: lwm.lw_megakernel(km, 34, panel, None,
                                                      f, n))
    checks[f"N{n}/T{panel.shape[0]}"] = _factor_vs_plain(km, 34, panel, f, n,
                                                         out)
    ms = {f: ms_rule,
          2 * f: cuda_ms(lambda: lwm.lw_megakernel(km, 35, panel, None,
                                                   2 * f, n), 1)}
    require(_cuda.launches(K3, keys[f]) == before[f] + 1
            and _cuda.launches(K3, keys[2 * f]) == before[2 * f] + 2,
            f"factor launches not counted under {keys}")
    rec = lwm.step_spans(32, panel, None, f, n, kmodel=km)
    plain = lwm.lw_megakernel(km, 32, panel, None, f, n)
    require(all(torch.equal(plain[k], rec["outputs"][k])
                for k in ("log_cond_likes", "cloud")),
            "factor twin: outputs are not the plain instance's bits")
    want = lwm.barriers_per_step(km, "apf")
    got = {k: v for k, v in rec["barriers_per_step"].items() if v is not None}
    require(got == {k: want[k] for k in got}
            and rec["cluster"] == (2 if layouts[f] == "paired" else 1)
            and rec["kper"] == 2 and rec["threads"] == n // 2,
            f"factor twin: barriers {got}, layout ({rec['kper']}, "
            f"{rec['threads']}, {rec['cluster']})")
    ptx = {k: v for k, v in k3_ptxas.items() if "FactorSvolLW" in k}
    cycles = rec["cycles_per_step"]
    phase(37, "k3-factor", "factor_svol_5_lw within 4 SE of plain and by "
          "the step-one rule: " + "; ".join(
              f"F={f_check if k.endswith(f'T{t_check}') else f} {k} kernel "
              f"{v['kernel_mean']:.3f} plain {v['plain_mean']:.3f} (4 SE "
              f"{v['four_se']:.3f}, plain {v['plain_ms']:.0f} ms)"
              for k, v in checks.items())
          + f" | N={n} T={panel.shape[0]} x 5 APF: ms a launch " + ", ".join(
              f"{keys[g]} F={g} {v:.3f}" for g, v in ms.items())
          + "; twin cycles a step " + ", ".join(
              f"{p} {c:.0f}" for p, c in cycles.items())
          + f" (sum {sum(cycles.values()):.0f}); barriers {got}; ptxas "
          "(registers, spill stores, spill loads) " + ", ".join(
              f"{k} {v}" for k, v in ptx.items()) + f" ({ident})")
    return {"ms": {keys[g]: v for g, v in ms.items()},
            "layout": layouts[f], "check": checks, "clock64_spans": cycles,
            "barriers_per_step": got, "ptxas": ptx}


# phase 38: factor_svol_sv_10, K2's 12-leaf instance, over the 10-column
# panel of benchmark/data at the benchmark cell's shape (B=256, N=1024,
# T=3084 x 10): the kernel against its plain version on the same seed,
# the launch timed, its twin, then the cell's entry point (AdaptivePMMH
# over megakernel_log_like, C=64 chains x R=4) for a few iterations
FACTOR_SV_C, FACTOR_SV_R, FACTOR_SV_N = 64, 4, 1024
FACTOR_SV_ITERS = 4


def phase_k2_factor_sv(dev, ident, k2_ptxas):
    """K2's factor_svol_sv_10 instance (the factor SV model as published:
    12 leaves, 56 parameters, a particle's own D in the Woodbury density)
    at the benchmark cell's shape, every-step resampling: its ptxas
    figures (phase 2 holds them at 0 spills), the kernel against its
    plain version on the same seed by phase 25's step-one rule and within
    4 SE, the launch's ms, its bound and share, and the twin's cycles a
    step by part (its outputs the plain instance's bits); then
    FACTOR_SV_ITERS AdaptivePMMH iterations through
    ``megakernel_log_like`` over the instance, the K2 launches counted
    from 0 before the path (one for the start, one an iteration, all
    under the instance)."""
    from ssme_tpu_torch.examples.estimate_factor_svol import EPS, START_SV
    path = os.path.join(ROOT, "benchmark", "data",
                        "factor_svol_sv_10_returns.csv")
    panel = torch.as_tensor(np.loadtxt(path, delimiter=",", ndmin=2),
                            dtype=torch.float32, device=dev).contiguous()
    km = fmk.factor_svol_sv_kernel_model(10)
    start = torch.tensor(START_SV, device=dev)
    c, r, n, t_len = FACTOR_SV_C, FACTOR_SV_R, FACTOR_SV_N, panel.shape[0]
    b = c * r
    full = start.expand(b, -1).contiguous()
    key = "factor_svol_sv_10"
    before = _cuda.launches(K2, key)
    out = fmk.filter_megakernel(km, 38, full, panel, num_particles=n)
    check = _vs_plain(f"factor sv B={b} N={n} T={t_len}", out[0], out[1],
                      lambda: fmk.filter_megakernel_reference(
                          km, 38, full, panel, num_particles=n)[:2], b)
    ms = cuda_ms(lambda: fmk.filter_megakernel(km, 40, full, panel,
                                               num_particles=n), 3)
    require(_cuda.launches(K2, key) == before + 5,
            "factor sv launches not counted under the instance")
    rec = fmk.step_spans(41, full, panel, None, n, kmodel=km)
    plain = fmk.filter_megakernel(km, 41, full, panel, num_particles=n)
    require(all(torch.equal(a, x) for a, x in zip(plain, rec["outputs"])),
            "factor sv twin: outputs are not the plain instance's bits")
    got = {k: v for k, v in rec["barriers_per_step"].items() if v is not None}
    require(got == {k: fmk.BARRIERS_PER_STEP[k] for k in got}
            and (rec["kper"], rec["threads"]) == (4, 256),
            f"factor sv twin: barriers {got}, layout ({rec['kper']}, "
            f"{rec['threads']})")
    # inputs read once (the series, 56 parameters a row, the seed),
    # outputs written once (lcl, means, totals)
    bound_ms = bound("filter_megakernel/factor_svol_sv_10", b, n, t_len,
                     40 * t_len + 224 * b + 16, 4 * b * (2 * t_len + 1))[0]
    # the cell's entry point: the counts start at 0 just before this path
    model = factor_svol.make_sv_model(10, 2)
    d = model.dim_param
    zero_launches(K2)
    before = _cuda.launches(K2, key)
    pmmh = AdaptivePMMH(model, num_particles=n, num_replicates=r, t0=150,
                        t1=1000, eps=EPS,
                        batched_log_like=fmk.megakernel_log_like(
                            km, n, r, ess_threshold=1.0, gate_stride=1))
    state = pmmh.init(0, model.transform.unconstrain(start.cpu()), panel,
                      c0=2.4 * 2.4 / d * EPS * torch.eye(d), num_chains=c)
    t0 = time.perf_counter()
    res = pmmh.run_from(state, FACTOR_SV_ITERS, panel)
    torch.cuda.synchronize()
    iter_ms = 1e3 * (time.perf_counter() - t0) / FACTOR_SV_ITERS
    launches = launched(K2)
    require(launches == FACTOR_SV_ITERS + 1
            and _cuda.launches(K2, key) - before == launches,
            f"pmmh: {launches} K2 launches, want {FACTOR_SV_ITERS + 1} "
            "under the instance")
    require(bool(torch.isfinite(state.log_like).all())
            and bool(torch.isfinite(res.log_likes).all()),
            "pmmh: non-finite log-likelihoods")
    ptx = {k: v for k, v in k2_ptxas.items() if "FactorSvolSvModel" in k}
    cycles = rec["cycles_per_step"]
    phase(38, "k2-factor-sv", f"factor_svol_sv_10 at B={b} N={n} T={t_len} "
          f"x 10 by the step-one rule and within 4 SE of plain: kernel "
          f"{check['kernel_mean']:.3f} plain {check['plain_mean']:.3f} (4 SE "
          f"{check['four_se']:.3f}, plain {check['plain_ms']:.0f} ms); "
          f"{ms:.3f} ms a launch, bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / ms:.2f}%); twin cycles a step " + ", ".join(
              f"{p} {v:.0f}" for p, v in cycles.items())
          + f" (sum {sum(cycles.values()):.0f}); barriers {got}; "
          f"AdaptivePMMH C={c} R={r}: {launches} launches for "
          f"{FACTOR_SV_ITERS} iterations, {iter_ms:.1f} ms an iteration, "
          f"{int(res.accepted.sum())} accepts; ptxas (registers, spill "
          "stores, spill loads) " + ", ".join(
              f"{k} {v}" for k, v in ptx.items()) + f" ({ident})")
    return {"ms": ms, "bound_ms": bound_ms, "check": check,
            "clock64_spans": cycles, "barriers_per_step": got, "ptxas": ptx,
            "pmmh": {"launches": launches, "iter_ms": iter_ms}}


def phase_k3_layout(dev, ys_all):
    """The Liu-West kernel's systematic twins, every functor at every
    layout, in both of the family's layouts (K3_RECORD_LAYOUTS): barriers
    per kind of step, layout, ring wait, spans, and their outputs the
    plain instances' bits."""
    ys = ys_all[:512, 0].contiguous()
    zs = svol_leverage.lagged_covariates(ys)[:, 0].contiguous()
    functors = dict(_lw_instances(zs), svol_leverage_lw_q=(
        lwm.svol_leverage_lw_q_kernel_model(Q_KAPPA), zs))
    counted, layout, spans = {}, {}, {}
    for f, cluster in K3_RECORD_LAYOUTS:
        for n in K2_RECORD_N:
            for name, (km, zs_k) in functors.items():
                for run, (kw, kinds) in K3_RECORD_RUNS.items():
                    kw = dict(kw)
                    if run == "sisr-no-selection":
                        kw["ess_threshold"] = 0.5 / n
                    tag = f"K3 {name} F={f} N={n} {run}"
                    rec = lwm.step_spans(13, ys, zs_k, f, n, kmodel=km, **kw)
                    seed, ys_, zs_ = lwm._validate(
                        km, 13, ys, zs_k, f, n, 1, kw["variant"],
                        kw.get("ess_threshold", 0.0), "systematic")
                    plain = lwm._launch(km, seed, ys_, zs_, f, n, 0.99, 1,
                                        kw["variant"],
                                        kw.get("ess_threshold", 0.0))
                    require(all(torch.equal(plain[k], rec["outputs"][k])
                                for k in ("log_cond_likes", "cloud")),
                            f"{tag}: the twin's outputs are not the plain "
                            "instance's bits")
                    want = lwm.BARRIERS_PER_STEP[kw["variant"]]
                    got = rec["barriers_per_step"]
                    for kind, v in got.items():
                        require(v is None or v == want[kind],
                                f"{tag}: {v} barriers a {kind} step, the "
                                f"source note states {want[kind]}")
                    require(all(got[k] is not None for k in kinds),
                            f"{tag}: no {kinds} step: {got}")
                    wait = rec["cycles_per_step"]["ring_wait"]
                    require(rec["kper"] == 2
                            and rec["threads"] == -(-n // 2 // 32) * 32
                            and rec["cluster"] == cluster
                            and (wait > 0) == (cluster == 2),
                            f"{tag}: ran kPer {rec['kper']} at "
                            f"{rec['threads']} threads, {rec['cluster']} "
                            f"CTAs a filter, ring wait {wait:.0f} (want "
                            f"{cluster} CTAs, a wait iff paired)")
                    counted[f"{name}/F{f}/N{n}/{run}"] = {
                        k: v for k, v in got.items() if v is not None}
                    if n == 512:
                        spans[f"{name}/F{f}/{run}"] = rec["cycles_per_step"]
            layout[f"F{f}/N{n}"] = {"kper": rec["kper"],
                                    "threads": rec["threads"],
                                    "cluster": rec["cluster"]}
    f = K3_RECORD_LAYOUTS[0][0]
    roll = _k3_roll_twins(ys, functors, f)
    phase(31, "k3-layout", "twins' barriers a step (first_resample, "
          "first_other, resample, other) " + "; ".join(
              f"{k} {v}" for k, v in counted.items())
          + "; layout (kPer, threads, CTAs a filter) " + ", ".join(
              f"{k} ({v['kper']}, {v['threads']}, {v['cluster']})"
              for k, v in layout.items())
          + " | clock64 cycles a step at N=512 T=512: " + "; ".join(
              f"{k} " + ", ".join(f"{p} {c:.0f}" for p, c in v.items())
              for k, v in spans.items())
          + " | roll twins' barriers a step besides the selections', votes "
          "and sweeps a selection: " + "; ".join(
              f"{k} {v}" for k, v in roll["barriers_per_step"].items())
          + "; layout " + ", ".join(
              f"N={n} ({v['kper']}, {v['threads']})"
              for n, v in roll["layout"].items())
          + " | roll clock64 cycles a step at F=16 T=512, N=512 and 4096: "
          + "; ".join(f"{k} " + ", ".join(f"{p} {c:.0f}"
                                          for p, c in v.items())
                      for k, v in roll["spans"].items()))
    return layout, counted, spans, roll


def _k3_roll_twins(ys, functors, f):
    """The Liu-West kernel's roll twins, every functor at every layout
    under both resamplers: the barriers a step crosses besides the
    selections' (lwm.BARRIERS_PER_STEP, as the systematic family), the
    layout of K3_ROLL_KPER, the outputs the plain instances' bits; the
    votes and sweeps a selection and, at N=512 and 4096, the clock64
    spans."""
    layout, counted, spans = {}, {}, {}
    for n in K2_ROLL_RECORD_N:
        for name, (km, zs_k) in functors.items():
            for r in ROLLS:
                for run in ("apf", "apf-ess", "sisr"):
                    kw = dict(K3_RECORD_RUNS[run][0], resampler=r,
                              metropolis_iters=ROLL_ITERS)
                    tag = f"K3 roll {name} N={n} {r} {run}"
                    rec = lwm.step_spans(13, ys, zs_k, f, n, kmodel=km, **kw)
                    plain = lwm.lw_megakernel(km, 13, ys, zs_k, f, n, **kw)
                    require(all(torch.equal(plain[k], rec["outputs"][k])
                                for k in ("log_cond_likes", "cloud")),
                            f"{tag}: the twin's outputs are not the plain "
                            "instance's bits")
                    want = lwm.BARRIERS_PER_STEP[kw["variant"]]
                    got = rec["barriers_per_step"]
                    for kind, v in got.items():
                        require(v is None or v == want[kind],
                                f"{tag}: {v} barriers a {kind} step besides "
                                f"the selections', the source note states "
                                f"{want[kind]}")
                    sel = f * (rec["first_resamples"] + rec["resamples"]
                               + (ys.shape[0] - 1
                                  if kw["variant"] == "apf" else 0))
                    require(sel > 0 and (r == "rejection") == (
                        rec["votes"] > 0), f"{tag}: {sel} selections, "
                        f"{rec['votes']} votes")
                    require(rec["kper"] == K3_ROLL_KPER[n]
                            and rec["threads"]
                            == -(-n // rec["kper"] // 32) * 32,
                            f"{tag}: ran kPer {rec['kper']} at "
                            f"{rec['threads']} threads")
                    counted[f"{name}/N{n}/{r}/{run}"] = dict(
                        {k: v for k, v in got.items() if v is not None},
                        votes_per_selection=rec["votes"] / sel,
                        sweeps_per_selection=rec["sweeps"] / sel)
                    if n in (512, 4096) and name == "svol_leverage_lw":
                        spans[f"N{n}/{r}/{run}"] = rec["cycles_per_step"]
        layout[str(n)] = {"kper": rec["kper"], "threads": rec["threads"]}
    return {"layout": layout, "barriers_per_step": counted, "spans": spans}


def _copy(gen):
    """A generator in ``gen``'s state."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _sharded_hook_checks(dev, ys, counter, name, sharded, inner, params):
    """One sharded hook against its inner hook on the folded generator:
    bit for bit, one launch of the entry ``counter`` a call, no host
    wait; then ms a call of each."""
    from ssme_tpu_torch.ops._prng import fold_generator

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    ref = _copy(gen)
    before = _cuda.launches(counter)
    got = sharded(gen, params, ys)
    launches = _cuda.launches(counter) - before
    require(launches == 1, f"{name}: {launches} launches a call, want 1")
    want = inner(fold_generator(ref, 0), params, ys)
    require(torch.equal(got, want), f"{name}: the sharded hook is not its "
            "inner hook on the folded generator")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = _cuda.launches(counter)
        sharded(gen, params, ys)
        launches += _cuda.launches(counter) - before
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = _cuda.launches(counter)
    ms = cuda_ms(lambda: sharded(gen, params, ys), PAR_REPS)
    launches += _cuda.launches(counter) - before
    inner_ms = cuda_ms(lambda: inner(gen, params, ys), PAR_REPS)
    return launches, {"ms": ms, "inner_ms": inner_ms}


def phase_parallel(dev, ys, ident):
    """Phase 35: the parallel package at one rank over NCCL."""
    import torch.distributed as dist

    from ssme_tpu_torch import parallel
    from ssme_tpu_torch.filters import BootstrapFilter
    from ssme_tpu_torch.parallel.sharded_pf import sharded_log_likelihood_fn

    zero_launches(K1, K2)
    model = svol.make_model()
    rng = np.random.default_rng(35)
    trans = torch.tensor(svol.START_TRANS_THETA) + 0.05 * torch.as_tensor(
        rng.normal(size=(C, 3)), dtype=torch.float32)
    params = model.transform.constrain(trans).to(dev)
    out = {"nvidia_smi": ident}
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize_distributed(
            "file://" + os.path.join(tmp, "store"), 1, 0, "cuda")
        try:
            mesh = parallel.make_mesh(1, 1)
            require(dist.get_backend() == "nccl", dist.get_backend())
            # (a) the chain-sharded hooks, adaptive schedule
            inner_k1 = sfk.svol_batched_log_like(N, R, ess_threshold=0.5,
                                                 gate_stride=8)
            k1_hook, out["k1_hook"] = _sharded_hook_checks(
                dev, ys, K1, "K1",
                parallel.shard_batched_log_like(inner_k1, mesh), inner_k1,
                params)
            inner_k2 = fmk.megakernel_log_like(
                fmk.svol_kernel_model(), N, R, constrain=svol.kernel_rows,
                ess_threshold=0.5, gate_stride=8)
            k2_hook, out["k2_hook"] = _sharded_hook_checks(
                dev, ys, K2, "K2 svol",
                parallel.sharded_megakernel_log_like(
                    fmk.svol_kernel_model(), N, R, mesh,
                    constrain=svol.kernel_rows, ess_threshold=0.5,
                    gate_stride=8), inner_k2, params)
            # (b) sharded_pmmh through K1 against the rank's run_from
            pmmh = AdaptivePMMH(model, num_particles=N, num_replicates=R,
                                t0=150, t1=1000, batched_log_like=inner_k1)
            run = parallel.sharded_pmmh(pmmh, mesh, PAR_ITERS)
            a = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
            b = pmmh.init(0, svol.START_TRANS_THETA, ys, num_chains=C)
            before = launched(K1)
            res = run(parallel.shard_chain_state(a, mesh), ys)
            pmmh_launches = launched(K1) - before
            require(pmmh_launches == PAR_ITERS, f"sharded PMMH: "
                    f"{pmmh_launches} launches, want {PAR_ITERS}")
            ref = pmmh.run_from(b, PAR_ITERS, ys)
            for k in ("samples", "log_likes", "accepted"):
                require(torch.equal(getattr(res, k), getattr(ref, k)),
                        f"sharded PMMH {k} differ from run_from's")
            # windows of PAR_TIME_ITERS in PAR_TURNS turns: sharded,
            # unsharded, unsharded, sharded, then the reverse
            run = parallel.sharded_pmmh(pmmh, mesh, PAR_TIME_ITERS)
            states = {"sharded": res.final_state,
                      "run_from": ref.final_state}
            ms = {"sharded": [], "run_from": []}
            abba = ("sharded", "run_from", "run_from", "sharded")
            for side in (abba + abba[::-1]) * (PAR_TURNS // 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                before = launched(K1)
                if side == "sharded":
                    states[side] = run(states[side], ys).final_state
                    pmmh_launches += launched(K1) - before
                else:
                    states[side] = pmmh.run_from(states[side], PAR_TIME_ITERS,
                                                 ys).final_state
                torch.cuda.synchronize()
                ms[side].append(1e3 * (time.perf_counter() - t0)
                                / PAR_TIME_ITERS)
            med = {k: float(np.median(v)) for k, v in ms.items()}
            ratio = [sum(ms["sharded"][2 * i:2 * i + 2])
                     / sum(ms["run_from"][2 * i:2 * i + 2])
                     for i in range(PAR_TURNS)]
            out["pmmh"] = {"ms_per_iteration": ms["sharded"],
                           "run_from_ms_per_iteration": ms["run_from"],
                           "median_ms": med, "turn_ratios": ratio,
                           "median_ratio": float(np.median(ratio)),
                           "iters_per_window": PAR_TIME_ITERS,
                           "accepted": int(res.accepted.sum())}
            # (c) the particle-sharded bootstrap filter at N=4096
            point = torch.tensor(PAR_POINT, device=dev)
            group = mesh.get_group("particle")
            lls, secs = {}, {}
            for exchange, seeds in (("ring", PAR_PF_SEEDS),
                                    ("allgather", PAR_PF_ALLGATHER)):
                ll = sharded_log_likelihood_fn(model, PAR_PF_N, group,
                                               ess_threshold=PAR_ESS,
                                               exchange=exchange)
                vals = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for seed in range(seeds):
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(seed)
                    vals.append(float(ll(gen, point, ys)))
                secs[exchange] = (time.perf_counter() - t0) / seeds
                lls[exchange] = np.asarray(vals)
            require(np.array_equal(lls["allgather"],
                                   lls["ring"][:PAR_PF_ALLGATHER]),
                    f"ring {lls['ring'][:PAR_PF_ALLGATHER]} != allgather "
                    f"{lls['allgather']}")
            gen = torch.Generator(device=dev)
            gen.manual_seed(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = BootstrapFilter(model, PAR_PF_N,
                                    ess_threshold=PAR_ESS).run(
                gen, point.expand(PAR_PF_SEEDS, 3), ys).log_likelihood
            plain = plain.cpu().numpy().astype(np.float64)
            plain_s = time.perf_counter() - t0
            ring = lls["ring"]
            se = math.sqrt(ring.var(ddof=1) / len(ring)
                           + plain.var(ddof=1) / len(plain))
            d = abs(ring.mean() - plain.mean())
            require(np.isfinite(ring).all() and d <= 4 * se,
                    f"sharded PF {ring.mean():.4f} vs BootstrapFilter "
                    f"{plain.mean():.4f}: {d:.4f} > 4 SE {4 * se:.4f}")
            out["sharded_pf"] = {
                "mean": float(ring.mean()), "sd": float(ring.std(ddof=1)),
                "plain_mean": float(plain.mean()),
                "plain_sd": float(plain.std(ddof=1)), "se": se,
                "s_per_run": secs, "plain_s_as_one_batch": plain_s}
            # (d) the particle-sharded Liu-West filter, one filter
            lev = svol_leverage.make_model()
            lw = parallel.ShardedLiuWest(lev, PAR_LW_N, ess_threshold=PAR_ESS,
                                         functionals=(
                lambda x, z, p: torch.full(x.shape[:-1] + (1,), 42.0,
                                           device=x.device),))
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lw_ys = ys[:PAR_LW_T]
            lw_res = parallel.make_sharded_lw_runner(lw, mesh)(
                gen, lw_ys, svol_leverage.lagged_covariates(lw_ys))
            torch.cuda.synchronize()
            lw_s = time.perf_counter() - t0
            lw42 = float((lw_res.expectations[0] - 42.0).abs().max())
            require(lw42 < 1e-3 and bool(torch.isfinite(
                lw_res.log_cond_likes).all()),
                f"sharded Liu-West: |E[42] - 42| = {lw42}")
            out["sharded_lw"] = {"log_likelihood": float(
                lw_res.log_likelihood), "abs_err_42": lw42, "s": lw_s,
                "t_len": PAR_LW_T}
        finally:
            dist.destroy_process_group()
    # (e) the scaling mode of the bench, in a process of its own
    res = subprocess.run([sys.executable, "-m", "ssme_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(
                             os.environ, BENCH_MODE="scaling",
                             BENCH_ITERS=str(PAR_SCALING_ITERS)))
    require(res.returncode == 0, f"scaling bench exited {res.returncode}:\n"
            f"{res.stderr[-4000:]}")
    scaling = json.loads(res.stdout.strip().splitlines()[-1])
    rows = scaling["rows"]
    require(scaling["metric"] == "pmmh_chain_scaling" and len(rows) == 1
            and rows[0]["devices"] == 1
            and math.isfinite(rows[0]["props_per_sec"]),
            f"scaling bench rows {rows}")
    out["scaling"] = scaling
    out["launches"] = {"svol_filter": k1_hook + pmmh_launches,
                       "filter_megakernel": k2_hook}
    phase(35, "parallel", "NCCL at one rank: sharded K1 / K2 hooks bit for "
          f"bit their inner hooks, {k1_hook} / {k2_hook} launches, ms a call "
          f"{out['k1_hook']['ms']:.4f} / {out['k1_hook']['inner_ms']:.4f} "
          f"(K1 sharded / inner), {out['k2_hook']['ms']:.4f} / "
          f"{out['k2_hook']['inner_ms']:.4f} (K2); sharded_pmmh {PAR_ITERS} "
          f"iters equal to run_from, ms an iteration over {2 * PAR_TURNS} "
          f"windows of {PAR_TIME_ITERS} each, median (least-most) sharded "
          f"{med['sharded']:.4f} ({min(ms['sharded']):.4f}-"
          f"{max(ms['sharded']):.4f}), run_from {med['run_from']:.4f} "
          f"({min(ms['run_from']):.4f}-{max(ms['run_from']):.4f}), "
          f"sharded / run_from a turn median {np.median(ratio):.4f} "
          f"({min(ratio):.4f}-{max(ratio):.4f}); "
          f"sharded PF N={PAR_PF_N} {ring.mean():.4f} +- {se:.4f} vs "
          f"{plain.mean():.4f}, {secs['ring']:.3f} s a run (ring), "
          f"{secs['allgather']:.3f} (allgather); sharded Liu-West |E[42]-42| "
          f"{lw42:.2g} in {lw_s:.3f} s (T={PAR_LW_T}); scaling D=1 "
          f"{rows[0]['props_per_sec']:.6e} props/s (median "
          f"{rows[0]['props_per_sec_median']:.6e}, least "
          f"{rows[0]['props_per_sec_min']:.6e} of {rows[0]['windows']} "
          f"windows of {PAR_SCALING_ITERS} iterations) ({ident})")
    return out


def phase_oracle(ys, ident):
    """Phase 36: the float64 oracle on the card, against its own CPU run,
    timed; then the accuracy gate with its own oracle run."""
    from ssme_tpu_torch import oracle
    from ssme_tpu_torch.examples import accuracy_gate

    with open(os.path.join(ROOT, "data", "accuracy_gate.json")) as f:
        theta = json.load(f)["results"]["oracle"]["mean"]
    z = torch.tensor([theta[0], 2.0 * math.atanh(theta[1]),
                      math.log(theta[2])], dtype=torch.float64)
    ys64 = ys.reshape(-1).double()
    rows = oracle._pf_rows(torch.Generator(device="cuda").manual_seed(0),
                           oracle.constrain(z), ys64, ORACLE_N, ORACLE_R)
    require(rows.is_cuda and rows.dtype == torch.float64,
            f"the oracle's filter ran on {rows.device}, {rows.dtype}")
    lls, secs = {}, {}
    for device in ("cuda", "cpu"):
        y = ys64.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lls[device] = np.array([oracle.loglike_reps(
            torch.Generator(device=device).manual_seed(seed), z, y,
            ORACLE_N, ORACLE_R) for seed in range(ORACLE_SEEDS)])
        secs[device] = (time.perf_counter() - t0) / ORACLE_SEEDS
        require(bool(np.isfinite(lls[device]).all()),
                f"{device}: log-likelihoods {lls[device]}")
    se = math.sqrt((lls["cuda"].var(ddof=1) + lls["cpu"].var(ddof=1))
                   / ORACLE_SEEDS)
    diff = float(lls["cuda"].mean() - lls["cpu"].mean())
    require(abs(diff) < 4 * se, f"oracle likelihood card "
            f"{lls['cuda'].mean():.4f} vs CPU {lls['cpu'].mean():.4f}, "
            f"4 SE {4 * se:.4f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain = oracle.oracle_pmmh(11, ys64, accuracy_gate.MODE_START_Z,
                               ORACLE_ITERS, ORACLE_N, ORACLE_R, t0=150,
                               t1=10 ** 9, device="cuda")
    s_iter = (time.perf_counter() - t0) / ORACLE_ITERS
    require(chain.shape == (ORACLE_ITERS, 3) and chain.dtype == np.float64
            and bool(np.isfinite(chain).all()), f"oracle chain {chain}")
    # the gate end to end: its oracle stage, then both engines through K1
    with tempfile.TemporaryDirectory() as tmp:
        out_json = os.path.join(tmp, "gate.json")
        zero_launches(K1)
        t0 = time.perf_counter()
        _, err = _run_in_process(accuracy_gate.main, [
            "--oracle-npy", "--oracle-iters", str(GATE_ORACLE_ITERS),
            "--engine-iters", str(GATE_ENGINE_ITERS), "--ext-burn",
            str(GATE_BURN), "--restart", str(GATE_BURN), "--out", out_json])
        gate_secs = time.perf_counter() - t0
        launches = launched(K1)
        require(launches == 2 * (GATE_ENGINE_ITERS + 1),
                f"the gate: {launches} SVOL-kernel launches, want "
                f"{2 * (GATE_ENGINE_ITERS + 1)}")
        with open(out_json) as f:
            gate_out = json.load(f)
        saved = np.load(os.path.join(tmp, "gate_samples.npz"))
        shapes = {k: saved[k].shape for k in ("oracle", "parity",
                                              "adaptive")}
        require(shapes == {"oracle": (GATE_ORACLE_ITERS, 1, 3),
                           "parity": (GATE_ENGINE_ITERS, 64, 3),
                           "adaptive": (GATE_ENGINE_ITERS, 64, 3)},
                f"the gate's saved draws {shapes}")
    res = gate_out["results"]
    require(all(np.isfinite(res[k]["mean"]).all()
                for k in ("oracle", "parity", "adaptive")),
            f"the gate's means {res}")
    require(len(gate_out["gate"]["comparisons"]) == 9
            and gate_out["gate"]["t_len"] == ys.shape[0],
            f"the gate: {gate_out['gate']}")
    require(res["oracle"]["device"] == "cuda" and res["oracle"]["secs"] > 0,
            f"the gate's oracle run {res['oracle']}")
    out = {"nvidia_smi": ident, "N": ORACLE_N, "R": ORACLE_R,
           "theta": theta, "loglike_cuda": lls["cuda"].tolist(),
           "loglike_cpu": lls["cpu"].tolist(), "combined_se": se,
           "loglike_s_cuda": secs["cuda"], "loglike_s_cpu": secs["cpu"],
           "pmmh_iters": ORACLE_ITERS, "pmmh_s_per_iter": s_iter,
           "gate": {"secs": gate_secs, "k1_launches": launches,
                    "oracle_secs": res["oracle"]["secs"],
                    "oracle_iters": GATE_ORACLE_ITERS,
                    "engine_iters": GATE_ENGINE_ITERS,
                    "pass": gate_out["gate"]["pass"]}}
    phase(36, "oracle", f"float64 loglike_reps N={ORACLE_N} R={ORACLE_R} "
          f"T={ys.shape[0]} card {lls['cuda'].mean():.4f} vs CPU "
          f"{lls['cpu'].mean():.4f} (combined SE {se:.4f}, "
          f"{ORACLE_SEEDS} seeds each; {secs['cuda']:.3f} / "
          f"{secs['cpu']:.3f} s a likelihood); oracle_pmmh {s_iter:.4f} s "
          f"an iteration over {ORACLE_ITERS}; accuracy_gate with its own "
          f"oracle ({GATE_ORACLE_ITERS} iterations, R=2, "
          f"{res['oracle']['secs']:.1f} s) and {GATE_ENGINE_ITERS} "
          f"iterations an engine: {launches} SVOL-kernel launches, "
          f"{gate_secs:.1f} s ({ident})")
    return launches, out


def main():
    ident = phase_device()
    dev = torch.device("cuda")
    (k1_ptxas, k1_roll_ptxas, k2_ptxas, k2_roll_ptxas, k3_ptxas,
     k3_roll_ptxas) = phase_build()
    phase_philox(dev)
    phase_select(dev)
    ys = torch.as_tensor(read_data(os.path.join(ROOT, "data",
                                                "spy_returns.csv"),
                                   num_cols=1), device=dev)
    sis_err = phase_filter_sis(dev, ys)
    times, plain_start, k1_spans, k1_layout = phase_filter_full(dev, ys)
    launches, _ = phase_pmmh(dev, ys, ident, plain_start)
    phase_cli()
    k2_err = phase_megakernel_sis(dev, ys)
    k2_times = phase_megakernel_full(dev, ys, ident)
    k2_launches = phase_pmmh_leverage(dev, ys, ident)
    with tempfile.TemporaryDirectory() as tmp:
        samples_csv = phase_posterior_leverage(tmp, ident)
        swarm_launches, swarm_times = phase_swarm(dev, ys, samples_csv,
                                                  ident)
    lw_errs = phase_lw_sis(dev, ys)
    lw_times, k4_ms = phase_lw_full(dev, ys, ident)
    lw_launches = phase_lw_cli(ident)
    fam_err = phase_families_sis(dev, ys)
    fam = phase_families_full(dev, ys, ident)
    svol_t_launches = phase_pmmh_svol_t(dev, ys, ident)
    bridge_ms = phase_large_n(dev, ys, ident)
    roll_err = phase_roll_sis(dev, ys)
    roll = phase_roll_full(dev, ys, ident)
    large_launches, large = phase_pmmh_large_n(dev, ys, ident, bridge_ms)
    step = phase_svol_step(dev, ident)
    k1_large_err, k1_plain = phase_k1_large_sis(dev, ys)
    k1_large = phase_k1_large_full(dev, ys, ident, k1_plain, k1_layout)
    k3_large_err, k3_large, lw_q = phase_k3_large(dev, ys, ident)
    k1_pmmh_launches, k1_pmmh = phase_pmmh_large_n_k1(dev, ys, ident)
    flagship_launches = phase_flagship_cli(dev, ident)
    k2_layout, k2_barriers, k2_vs_k1, k2_roll, k1_roll = phase_k2_layout(
        dev, ys)
    k3_layout, k3_barriers, k3_spans, k3_roll = phase_k3_layout(dev, ys)
    smoother = phase_smoother(dev, ident)
    with tempfile.TemporaryDirectory() as tmp:
        tune_var_launches, tune_var = phase_tune_variance(tmp, ident)
        tune_pmmh_launches, tune_rec = phase_tune_pmmh(tmp, ident)
    par = phase_parallel(dev, ys, ident)
    par_launches = par["launches"]
    gate_launches, oracle_rec = phase_oracle(ys, ident)
    k3_factor = phase_k3_factor(dev, ident, k3_ptxas)
    k2_factor_sv = phase_k2_factor_sv(dev, ident, k2_ptxas)

    t_len = ys.shape[0]
    k_ms, p_ms, _ = times["adaptive"]
    k2_ms, k2_plain = k2_times["svol_leverage/tuned"]
    lw_ms, lw_plain = lw_times["apf"]
    # bytes: inputs read once (series, covariates, parameter rows, seed),
    # outputs written once (lcl, means or paths, totals, cloud)
    k1_bound = bound("svol_filter", B, N, t_len, 4 * t_len + 12 * B + 16,
                     4 * B * (2 * t_len + 1))
    k2_bound = bound("filter_megakernel", LB, N, t_len,
                     8 * t_len + 16 * LB + 16, 4 * LB * (2 * t_len + 1))
    lw_bound = bound("lw_megakernel", LW_F, LW_N, t_len, 8 * t_len + 16,
                     4 * LW_F * (t_len + 6 * LW_N))
    print(json.dumps({"kernels": [{
        "name": "svol_filter",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/svol_filter_sys.cu",
        "roll_source": "ssme_tpu_torch/csrc/svol_filter_sys.cu",
        "roll_selection": "ssme_tpu_torch/csrc/roll_select.cuh",
        "replaces": "ssme_tpu/ops/svol_filter_kernel.py:317",
        "launches": (launches + k1_pmmh_launches + flagship_launches
                     + tune_var_launches + tune_pmmh_launches
                     + par_launches["svol_filter"] + gate_launches),
        "main_path_launches": {"pmmh": launches,
                               "pmmh/N2048": k1_pmmh_launches,
                               "spy_flagship": flagship_launches,
                               "tune_variance": tune_var_launches,
                               "tune_pmmh": tune_pmmh_launches,
                               "parallel": par_launches["svol_filter"],
                               "accuracy_gate": gate_launches},
        "tune_variance": tune_var,
        "tune_pmmh": tune_rec,
        "max_abs_err": max(sis_err, k1_large_err),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "ms_parity": times["parity"][0],
        "plain_ms_parity": times["parity"][1],
        "ms_b128": {s: v[2] for s, v in times.items()},
        "layout": k1_layout,
        "barriers_per_step": {s: sp["barriers_per_step"]
                              for s, sp in k1_spans.items()},
        "clock64_spans": k1_spans,
        "ptxas": {k: dict(zip(("registers", "spill_stores", "spill_loads"),
                              v)) for k, v in k1_ptxas.items()},
        "roll_layout": k1_roll["layout"],
        "roll_barriers_per_step": k1_roll["barriers_per_step"],
        "roll_ptxas": {k: dict(zip(("registers", "spill_stores",
                                    "spill_loads"), v))
                       for k, v in k1_roll_ptxas.items()},
        "per_resampler": roll["K1"],
        "per_kper": k1_large,
        "pmmh_large_n": k1_pmmh,
    }, {
        "name": "filter_megakernel",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/filter_megakernel_sys.cuh",
        "roll_source": "ssme_tpu_torch/csrc/filter_megakernel_sys.cuh",
        "roll_selection": "ssme_tpu_torch/csrc/roll_select.cuh",
        "replaces": "ssme_tpu/ops/filter_megakernel.py:466",
        "launches": (k2_launches + swarm_launches + svol_t_launches
                     + large_launches + par_launches["filter_megakernel"]),
        "max_abs_err": max(k2_err, fam_err, roll_err),
        "ms": k2_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
        "per_schedule": {s: {"ms": k, "plain_ms": p}
                         for s, (k, p) in k2_times.items()},
        "swarm_ms": swarm_times[0],
        "swarm_plain_ms": swarm_times[1],
        "per_instance": {k: v for k, v in fam.items() if "/apf" not in k},
        "apf": {k: v for k, v in fam.items() if "/apf" in k},
        "main_path_launches": {"svol_leverage": k2_launches + swarm_launches,
                               "svol_t": svol_t_launches,
                               "svol/rejection/N2048": large_launches,
                               "parallel": par_launches["filter_megakernel"]},
        "per_resampler": dict(roll["K2"], sweeps=roll["sweeps"],
                              bias_envelope=roll["bias_envelope"]),
        "pmmh_large_n": large,
        "sweeps": large["sweeps"],
        "layout": k2_layout,
        "barriers_per_step": k2_barriers,
        "roll_layout": k2_roll["layout"],
        "roll_barriers_per_step": k2_roll["barriers_per_step"],
        "ptxas": {k: dict(zip(("registers", "spill_stores", "spill_loads"),
                              v)) for k, v in k2_ptxas.items()},
        "roll_ptxas": {k: dict(zip(("registers", "spill_stores",
                                    "spill_loads"), v))
                       for k, v in k2_roll_ptxas.items()},
        "svol_vs_svol_filter": k2_vs_k1,
        "factor_svol_sv_10": k2_factor_sv,
    }, {
        "name": "lw_megakernel",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/lw_megakernel_sys.cuh",
        "roll_source": "ssme_tpu_torch/csrc/lw_megakernel_sys.cuh",
        "roll_selection": "ssme_tpu_torch/csrc/roll_select.cuh",
        "replaces": "ssme_tpu/ops/liu_west_megakernel.py:500",
        "launches": lw_launches,
        "max_abs_err": max(max(lw_errs.values()), k3_large_err),
        "ms": lw_ms,
        "plain_ms": lw_plain,
        "bound_ms": lw_bound[0],
        "bound_by": lw_bound[1],
        "library_ms": None,
        "per_schedule": {r: {"ms": k, "plain_ms": p}
                         for r, (k, p) in lw_times.items()},
        "per_resampler": roll["K3"],
        "per_kper": k3_large,
        "svol_leverage_lw_q": lw_q,
        "factor_svol_5_lw": k3_factor,
        "layout": k3_layout,
        "barriers_per_step": k3_barriers,
        "clock64_spans": k3_spans,
        "ptxas": {k: dict(zip(("registers", "spill_stores", "spill_loads"),
                              v)) for k, v in k3_ptxas.items()},
        "roll_layout": k3_roll["layout"],
        "roll_barriers_per_step": k3_roll["barriers_per_step"],
        "roll_clock64_spans": k3_roll["spans"],
        "roll_ptxas": {k: dict(zip(("registers", "spill_stores",
                                    "spill_loads"), v))
                       for k, v in k3_roll_ptxas.items()},
    }, {
        "name": "svol_leverage_lw",
        "route": "cuda",
        "instance_of": "lw_megakernel (its svol_leverage_lw instance)",
        "source": "ssme_tpu_torch/csrc/lw_megakernel_sys.cuh",
        "replaces": "ssme_tpu/ops/svol_leverage_lw_kernel.py:331",
        "launches": lw_launches,
        "max_abs_err": lw_errs["svol_leverage_lw"],
        "ms": k4_ms,
        "plain_ms": lw_plain,
        "bound_ms": lw_bound[0],
        "bound_by": lw_bound[1],
        "library_ms": None,
    }, {
        "name": "svol_step",
        "route": "cuda",
        "source": "ssme_tpu_torch/csrc/svol_step.cu",
        "replaces": "ssme_tpu/ops/svol_kernel.py:83",
        "launches": step["launches"],
        "max_abs_err": step["max_abs_err"],
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "library_ms": None,
        "ms_source": "torch.profiler device time per launch, inputs "
                     "cycled through 200 MB",
        "call_ms": step["call_ms"],
        "floor_ms": step["floor_ms"],
        "byte_bound_ms": step["byte_bound_ms"],
        "issue_bound_ms": step["issue_bound_ms"],
        "max_sm_clock_hz": step["max_sm_clock_hz"],
        "per_shape": step["per_shape"],
    }], "smoother": smoother, "parallel": par, "oracle": oracle_rec}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
